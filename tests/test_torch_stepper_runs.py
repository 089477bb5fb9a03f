"""The port's time integrators (solver/steppers.py) and the driver's
--stepper, --exact-t-end and --steps-per-dispatch, against the JAX
package on the CPU. The fused stage programs and the adaptive S metric
are in tests/test_torch_steppers.py; the two files are kept apart so that
each holds fewer tests than tests/test_oracle_and_e2e.py, which
pytest-xdist's loadfile scheduling then starts among the first files.

Tolerances:
- the five stepper modes on a deterministic linear ODE with a fixed SPD
  metric: dt, y and the recorded observable to 1e-14 relative, attempt
  counts equal -- the same f64 arithmetic, the metric's product in
  another association;
- the driver's runs against closed forms within 5 standard errors, and
  the port's own determinism (--steps-per-dispatch 3 against 1): bit for
  bit.
"""

import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import rel_err, t64
from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.solver import steppers
from vmc_pde_tpu.solver import steppers as jsteppers

torch.set_num_threads(1)

# -- the stepper classes on a toy ODE --------------------------------------

D = 3
_rng = np.random.default_rng(0)
_B = _rng.standard_normal((D, D))
K_ODE = _B @ _B.T / D + np.eye(D)       # dy/dt = -K y + sin(3 t) c
C_ODE = _rng.standard_normal(D)
_B = _rng.standard_normal((D, D))
S_METRIC = _B @ _B.T + 0.5 * np.eye(D)  # the fixed SPD metric
Y0 = _rng.standard_normal(D)


def _toy(lib):
    """(f, norm) of the toy ODE in one package: f counts its calls and
    returns the first coordinate as an observable and a NaN flag. The
    products run in numpy for both, so that only the steppers'
    arithmetic differs."""
    xp = jnp if lib == "jax" else torch
    conv = jnp.asarray if lib == "jax" else t64

    def f(y, t, key, intStep=0):
        f.calls += 1
        k = -(K_ODE @ np.asarray(y)) + math.sin(3.0 * t) * C_ODE
        return conv(k), {"obs": y[0], "nan": xp.isnan(y).any()}

    def norm(v, S):
        v = np.asarray(v)
        return float(v @ (S @ v))

    f.calls = 0
    f.SExp = S_METRIC
    return f, norm


MODES = {
    "heun": lambda m: m.FixedStepper(0.01, 0.1, 1.5, mode="Heun"),
    "euler": lambda m: m.FixedStepper(0.01, 0.1, 1.5, mode="Euler"),
    "rk3": lambda m: m.FixedStepper(0.01, 0.1, 1.5, mode="RK3"),
    "adaptive_heun": lambda m: m.AdaptiveHeun(0.4, tol=1e-6, maxStep=0.3),
    "adaptive_rk23": lambda m: m.AdaptiveRK23(0.4, tol=1e-8, maxStep=0.3),
}


def _toy_run(lib, mode, t_end):
    """Steps of ``mode`` from Y0: to t_end with dt_cap = t_end - t (the
    driver's exact_t_end), or 8 steps uncapped (t_end None). Returns per
    step (t, dt_used, y, obs, RHS calls, the stepper's dt)."""
    m = jsteppers if lib == "jax" else steppers
    st = MODES[mode](m)
    f, norm = _toy(lib)
    y = jnp.asarray(Y0) if lib == "jax" else t64(Y0)
    t, rows = 0.0, []
    while (t < t_end - 1e-12) if t_end else len(rows) < 8:
        calls = f.calls
        res = st.step(t, f, y, None, normFunction=norm,
                      dt_cap=None if t_end is None else t_end - t)
        y = res.y
        rows.append((t, res.dt_used, np.asarray(y), float(res.info["obs"]),
                     f.calls - calls, st.dt))
        t += res.dt_used
        assert not bool(res.info["nan"])
    return rows


@pytest.mark.parametrize("t_end", [None, 0.7])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_steppers_match_jax(mode, t_end):
    """Each mode steps the toy ODE as the JAX class does: the same dt
    sequence (with dt_cap landing on t_end and the uncapped suggestion
    kept), RHS calls per step (attempts x stages), y and the stage-0
    observable."""
    got, want = _toy_run("torch", mode, t_end), _toy_run("jax", mode, t_end)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[4] == w[4]
        for a, b in zip(g[:4] + g[5:], w[:4] + w[5:]):
            assert rel_err(a, b) < 1e-14
    if t_end:
        assert abs(got[-1][0] + got[-1][1] - t_end) < 1e-12
    if mode.startswith("adaptive"):
        assert max(r[4] for r in got) > min(r[4] for r in got)  # a retry


# -- the driver ------------------------------------------------------------

@functools.cache
def _mwe_adaptive_heun(k):
    """mwe with adaptive_heun (f64, CPU; the dense SExp on eigh), 3 steps
    at N=1024 and steps_per_dispatch k: (theta, the recorded arrays)."""
    state, rec = driver.run(preset(
        "mwe", device="cpu", precision="f64", n_samples_tdvp=1024,
        n_samples_obs=1024, stepper="adaptive_heun", verbose=False,
        steps_per_dispatch=k), max_steps=3)
    return state.get_parameters(), rec.as_arrays()


def test_driver_mwe_adaptive_heun_closed_forms():
    """mwe with adaptive_heun: covariance diagonal 1 + 2t and entropy
    log(2 pi e (1 + 2t)) within 5 standard errors at every step, residual
    ~1e-14, one attempt or more per step with a finite error, t rising."""
    a = _mwe_adaptive_heun(1)[1]
    var = 1.0 + 2.0 * a["times"]
    cov = np.diagonal(a["covar"], axis1=1, axis2=2)
    assert np.abs(cov - var[:, None]).max() < 5 * math.sqrt(2 / 1024) * 1.1
    ent = np.log(2 * math.pi * math.e * var)
    assert np.abs(a["entropy"] - ent).max() < 5 * math.sqrt(1 / 1024)
    assert a["solver_res"].max() < 1e-10 and not a["nan"].any()
    assert (a["attempts"] >= 1).all() and np.isfinite(a["step_error"]).all()
    assert (np.diff(a["times"]) > 0).all()


@pytest.mark.parametrize("stepper", ["fixed_heun", "adaptive_rk23"])
def test_exact_t_end_lands(stepper):
    """--exact-t-end clamps the last step onto t_end: every step ends
    before t_end but the last, which ends on it; without the flag the loop
    (the same for every stepper) runs on while t < t_end + dt."""
    t_end = 2.5e-7
    args = ["mwe", "--device", "cpu", "--precision", "f64", "--samples",
            "128", "--t-end", str(t_end), "--stepper", stepper]
    a = driver.main(args + ["--exact-t-end"])[1].as_arrays()
    ends = a["times"] + a["dt"]
    assert len(ends) >= 2 and a["times"][-1] < t_end
    assert ends[-1] == pytest.approx(t_end, rel=1e-12)
    assert max(ends[:-1]) < t_end
    if stepper == "fixed_heun":
        a = driver.main(args)[1].as_arrays()
        assert a["times"][-1] + a["dt"][-1] >= t_end


@pytest.mark.parametrize("stepper", ["fixed_heun", "fixed_rk3",
                                     "adaptive_heun"])
def test_steps_per_dispatch_is_bitwise_one(stepper):
    """steps_per_dispatch 3 against 1 (NaN flags read once per 3 steps
    instead of every nan_check_every), 3 steps: the same theta bit for bit
    and the same recorded rows."""
    if stepper == "adaptive_heun":
        runs = [_mwe_adaptive_heun(k) for k in (1, 3)]
    else:
        cfg = preset("mwe", dim=4, offset=(0.0,) * 4, device="cpu",
                     precision="f64", n_samples_tdvp=128, n_samples_obs=128,
                     stepper=stepper, verbose=False)
        runs = []
        for k in (1, 3):
            state, rec = driver.run(dataclasses.replace(
                cfg, steps_per_dispatch=k), max_steps=3)
            runs.append((state.get_parameters(), rec.as_arrays()))
    (th1, a1), (th3, a3) = runs
    assert torch.equal(th1, th3)
    assert set(a1) == set(a3) and a1["times"].shape == (3,)
    for k in a1:
        np.testing.assert_array_equal(a1[k], a3[k], err_msg=k)


def test_fluidpaper_adaptive_heun_counts_every_attempt():
    """fluidpaper (Metropolis chains in the RHS) with adaptive_heun for 2
    steps: each step's recorded proposals are the budget times 5 stages
    times its attempts, the accepted count within them."""
    _, rec = driver.run(preset("fluidpaper", device="cpu",
                               stepper="adaptive_heun", n_samples_tdvp=600,
                               n_samples_obs=600, verbose=False),
                        max_steps=2)
    a = rec.as_arrays()
    assert a["times"].shape == (2,) and not a["nan"].any()
    np.testing.assert_array_equal(a["mcmc_proposed"], 600 * 5 * a["attempts"])
    assert (0 < a["mcmc_accepted"]).all()
    assert (a["mcmc_accepted"] < a["mcmc_proposed"]).all()
