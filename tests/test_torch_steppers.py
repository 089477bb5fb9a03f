"""The port's time integrators (solver/steppers.py), fused stage programs
and adaptive S metric (solver/tdvp.py), and the driver's --stepper,
--exact-t-end and --steps-per-dispatch, against the JAX package on the CPU.

Tolerances:
- the five stepper modes on a deterministic linear ODE with a fixed SPD
  metric: dt, y and the recorded observable to 1e-14 relative, attempt
  counts equal -- the same f64 arithmetic, the metric's product in
  another association;
- the fused steps against the same composition of JAX RHS evaluations on
  shared latent draws, f64: dy and the error to 1e-8 relative, the RHS
  bar of tests/test_torch_tdvp.py (the solves take different LAPACK
  paths);
- the dense SExp against the JAX package's, f32: 1e-4 of the largest
  value, the bar of the A-moment tests (tests/test_torch_chunked.py);
- the matrix-free quadratic against the JAX package's, f64: 1e-12
  relative (the same formula, summed in one pass here), and the O rows'
  contraction against the forward-mode plain version to 1e-12; under the
  f32 solve, against the centred f64 form of the same a, 1e-6 relative
  where the mean of a is 1e4 times its spread;
- the port's own determinism (fused attempt against per-stage rhs()
  calls, --steps-per-dispatch 3 against 1): bit for bit.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_chunked import _problem as f32_problem
from test_torch_chunked import _samples
from test_torch_models import normal, rel_err, t64
from test_torch_tdvp import DIM, N
from test_torch_tdvp import _problem as f64_problem
from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.kernels import persample
from vmc_pde_torch.ops import score
from vmc_pde_torch.solver import steppers
from vmc_pde_torch.solver.tdvp import TDVP, TDVPConfig
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


# -- the fused stage programs against JAX RHS compositions -----------------

@pytest.fixture(scope="module")
def problems():
    """f64 problems of tests/test_torch_tdvp.py (d=4 Fokker-Planck, N=64)
    in both packages: the dense SExp on eigh, the matrix-free S metric on
    cholesky."""
    out = {"dense": f64_problem("affine", sexp_mode="auto"),
           "matfree": f64_problem("affine", sexp_mode="auto",
                                  eigh_max_params=16, spectrum_topk=0)}
    jtdvp = out["matfree"][0]
    jtdvp.sexp_quad_jit = jax.jit(jtdvp._sexp_quad)
    return out


def _jax_error(jtdvp, aux_last, theta_last, diff):
    if "SExp" in aux_last:
        return diff @ (aux_last["SExp"] @ diff)
    return float(jtdvp.sexp_quad_jit(
        jnp.asarray(theta_last), jnp.asarray(aux_last["_x"]),
        jnp.asarray(aux_last["_logp"]), jnp.asarray(aux_last["_logw"]),
        jnp.asarray(diff)))


def _jax_step(jtdvp, kind, theta, t, dt, zs):
    """(dy, err) of one step or attempt composed of JAX RHS evaluations
    (without observables), stage i on zs[i]."""
    th = theta.numpy()
    stage = iter(zs)

    def k(y, ts):
        aux = jtdvp._fused(jnp.asarray(y), ts, jax.random.PRNGKey(0),
                           jnp.asarray(next(stage)), None, None, None, n=N,
                           n_obs=N, with_obs=False)
        k.aux = {key: np.asarray(val) for key, val in aux.items()}
        return k.aux["update"]

    if kind == "rk3":
        k0 = k(th, t)
        k1 = k(th + dt * k0, t + dt)
        k2 = k(th + 0.25 * dt * (k0 + k1), t + 0.5 * dt)
        return dt / 6.0 * (k0 + k1 + 4.0 * k2), None
    if kind == "heun":
        k0 = k(th, t)
        k1 = k(th + dt * k0, t + dt)
        dy0 = 0.5 * dt * (k0 + k1)
        k10 = k(th + 0.5 * dt * k0, t + 0.5 * dt)
        dy1 = 0.25 * dt * (k0 + k10)
        y2 = th + dy1
        k01 = k(y2, t + 0.5 * dt)
        y3 = y2 + 0.5 * dt * k01
        k11 = k(y3, t + dt)
        dy1 = dy1 + 0.25 * dt * (k01 + k11)
        return dy1, _jax_error(jtdvp, k.aux, y3, dy1 - dy0)
    k0 = k(th, t)
    k1 = k(th + 0.5 * dt * k0, t + 0.5 * dt)
    k2 = k(th + 0.75 * dt * k1, t + 0.75 * dt)
    dy3 = dt * (2.0 / 9.0 * k0 + 1.0 / 3.0 * k1 + 4.0 / 9.0 * k2)
    k3 = k(th + dy3, t + dt)
    dy2 = dt * (7.0 / 24.0 * k0 + 0.25 * k1 + 1.0 / 3.0 * k2 + 0.125 * k3)
    return dy3, _jax_error(jtdvp, k.aux, th + dy3, dy3 - dy2)


@pytest.mark.parametrize("kind,metric", [
    ("rk3", "dense"), ("heun", "dense"), ("heun", "matfree"),
    ("rk23", "dense"), ("rk23", "matfree")])
def test_fused_steps_match_jax(kind, metric, problems):
    """rk3_triple, heun_attempt and rk23_attempt on shared per-stage draws
    against the same composition of JAX RHS evaluations: dy and the error
    in the last stage's S metric (dense SExp at eigh, matrix-free at
    cholesky)."""
    jtdvp, tdvp, theta = problems[metric]
    assert tdvp._sexp_matfree == jtdvp._sexp_matfree == (metric ==
                                                          "matfree")
    n_stages = {"rk3": 3, "heun": 5, "rk23": 4}[kind]
    zs = [normal((N, DIM), 60 + i) for i in range(n_stages)]
    t, dt = 0.1, 1e-5
    want_dy, want_err = _jax_step(jtdvp, kind, theta, t, dt, zs)
    fn = {"rk3": tdvp.rk3_triple, "heun": tdvp.heun_attempt,
          "rk23": tdvp.rk23_attempt}[kind]
    out = fn(theta, t, dt, 5, z_ext=[t64(z) for z in zs])
    assert out[0].dtype == torch.float64
    assert rel_err(out[0], want_dy) < 1e-8
    if want_err is not None:
        assert rel_err(out[1], want_err) < 1e-8
    assert not bool(out[-1]["nan"]) and "_sexp" not in out[-1]


@pytest.mark.parametrize("cls,metric", [("AdaptiveHeun", "dense"),
                                        ("AdaptiveRK23", "matfree")])
def test_fused_attempt_matches_per_stage_calls(cls, metric, problems):
    """The fused attempt and the stepper's per-stage attempt through rhs()
    and the driver's norm (TDVP.stepper_norm) draw the same stage keys
    and, in f64, give the same results bit for bit. Heun: whole steps, a
    rejected attempt first, then the retry's keys (y, dt and the accepted
    attempt's error). RK23: one attempt at a retry's keys (dy and error)."""
    tdvp = problems[metric][1]
    theta = tdvp.state.get_parameters()
    norm = tdvp.stepper_norm
    attempt_fn = (tdvp.heun_attempt if cls == "AdaptiveHeun"
                  else tdvp.rk23_attempt)

    def f(y, t, key, intStep=0):
        out = tdvp.rhs(y, t, key, intStep=intStep)
        f.SExp = tdvp.SExp
        return out

    if cls == "AdaptiveRK23":
        staged = steppers.AdaptiveRK23(timeStep=1e-5, tol=1e-2)
        dy, err, _ = attempt_fn(theta, 0.2, 1e-5, 9, attempt=1)
        dy_p, diff, _ = staged._attempt_plain(f, theta, 0.2, 1e-5, 9, 5)
        assert torch.equal(dy, dy_p)
        assert float(err) == float(norm(diff, f.SExp))
        return
    # a tolerance that rejects the first attempt
    tol = 0.5 * float(attempt_fn(theta, 0.2, 1e-5, 9)[1])
    fused = steppers.AdaptiveHeun(timeStep=1e-5, tol=tol, maxStep=1e-4,
                                  attempt_fn=attempt_fn)
    staged = steppers.AdaptiveHeun(timeStep=1e-5, tol=tol, maxStep=1e-4)
    a = fused.step(0.2, f, theta, 9)
    b = staged.step(0.2, f, theta, 9, normFunction=norm)
    assert torch.equal(a.y, b.y) and a.dt_used == b.dt_used
    assert a.info["attempts"] == b.info["attempts"] >= 2
    assert a.info["step_error"] == b.info["step_error"]


# -- the dense SExp and the matrix-free quadratic --------------------------

@pytest.fixture(scope="module")
def sexp_reference():
    """The f32 problem of tests/test_torch_chunked.py (d=2 Fokker-Planck,
    N=2048, chunks of 512) with the JAX package's dense SExp, S0 and A on
    one batch of samples (its f32 Gram, the Pallas per-sample kernel in
    interpret mode)."""
    jtdvp, tdvp, theta, jflat = f32_problem(compute_sexp=True)
    x = _samples(tdvp, theta, 54)
    jst = jax.jit(jtdvp._direct_stats)(jflat, 0.25, jnp.asarray(x.numpy()))
    return tdvp, theta, x, {k: np.asarray(jst[k]) for k in ("SExp", "S0",
                                                             "A")}


@pytest.mark.parametrize("backend,cross,fn", [
    ("xla", "auto", "_direct_stats"), ("syrk", "auto", "_direct_stats"),
    ("tri2", "bf16", "_direct_stats"), ("tri2", "int8", "_direct_stats"),
    ("syrk", "auto", "_chunked_stats"), ("tri2", "int8", "_chunked_stats")])
def test_dense_sexp_matches_jax(backend, cross, fn, sexp_reference):
    """SExp = E[logp^2 O_c^T O_c] beside S0 and A through the f32 Gram,
    syrk's plain version (weighted with logp^2) and tri2 with the bf16 or
    int8 cross term, direct and chunked (the split kernel's path for
    tri2), against the JAX package's on the same samples."""
    base, theta, x, ref = sexp_reference
    tdvp = TDVP(base.state, base.equation, TDVPConfig(
        per_sample_backend="cuda", chunk_size=512, gram_precision="high",
        gram_backend=backend, gram_cross=cross, compute_sexp=True),
        n_samples=x.shape[0], precision=base.precision)
    st = getattr(tdvp, fn)(theta.float(), 0.25, x)
    assert st["SExp"].dtype == torch.float32
    for key in ("SExp", "S0", "A"):
        assert rel_err(st[key], ref[key]) < 1e-4, key


@pytest.mark.parametrize("weighted", [False, True])
def test_sexp_quad_matches_jax(weighted, problems):
    """The matrix-free v^T SExp v at the same (theta, x, logp, log_w, v) as
    the JAX package's _sexp_quad (log_w = 0 there without IS weights): with
    the kept O and with O re-made by the per-sample route; and equal to
    the dense SExp's quadratic form on the same samples."""
    jtdvp, tdvp, theta = problems["matfree"]
    params = tdvp.flow.layout.unravel(theta)
    x, logp = tdvp.flow.push(params, t64(normal((N, DIM), 71)))
    v = t64(normal(tdvp.n_params, 72))
    log_w = t64(0.3 * normal(N, 73)) if weighted else None
    lw = log_w.numpy() if weighted else np.zeros(N)
    want = float(jtdvp.sexp_quad_jit(jnp.asarray(theta.numpy()),
                                  jnp.asarray(x.numpy()),
                                  jnp.asarray(logp.numpy()),
                                  jnp.asarray(lw), jnp.asarray(v.numpy())))
    O = persample.per_sample_plain(tdvp.flow, theta, x)[3]
    for kept in (O, None):
        got = tdvp._sexp_quad(theta, x, logp, log_w, kept, v)
        assert rel_err(got, want) < 1e-12
    if not weighted:
        Oc = O - O.mean(0)
        dense = v @ ((Oc * (logp**2)[:, None]).T @ Oc / N) @ v
        assert rel_err(dense, want) < 1e-12


def test_sexp_quad_f32_solve_survives_a_large_mean(sexp_reference):
    """Under the f32 solve of the 'tpu' policy, with IS weights and a = O v
    whose mean is 1e4 times its spread: the quadratic against the centred
    f64 form of the same f32 a (the one-pass sums in f32 would cancel to
    noise)."""
    tdvp, theta = sexp_reference[:2]
    assert tdvp.precision.solve == torch.float32
    n, p = 512, 8
    O = torch.from_numpy((1e4 + normal((n, p), 76)).astype(np.float32))
    v = torch.full((p,), 1.0 / p)
    logp = torch.from_numpy(normal(n, 77).astype(np.float32))
    log_w = torch.from_numpy(0.3 * normal(n, 78).astype(np.float32))
    got = tdvp._sexp_quad(theta.float(), None, logp, log_w, O, v)
    a = (O @ v).double()
    w = torch.exp(log_w.double() - log_w.double().max())
    m = (w * a).sum() / w.sum()
    want = (w * logp.double()**2 * (a - m)**2).sum() / w.sum()
    assert got.dtype == torch.float32 and rel_err(got, want) < 1e-6


def test_kernel_route_contraction_matches_jvp(problems):
    """a = O v from the per-sample route's O rows (the kernel's wrapper,
    its plain version on the CPU) against the forward-mode plain version
    through the flow's log-density, chunk by chunk and whole."""
    tdvp = problems["matfree"][1]
    theta = tdvp.state.get_parameters()
    params = tdvp.flow.layout.unravel(theta)
    x = tdvp.flow.push(params, t64(normal((N, DIM), 74)))[0]
    v = t64(normal(tdvp.n_params, 75))
    want = score.batched_param_jvp(
        score.make_flat_log_prob(tdvp.flow, tdvp.flow.layout.unravel),
        theta, x, v)
    assert want.dtype == torch.float64
    O = persample.per_sample(tdvp.flow, theta, x)[3]
    assert rel_err(tdvp._sexp_a(theta, x, v, O), want) < 1e-12
    assert rel_err(tdvp._sexp_a(theta, x, v), want) < 1e-12


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
