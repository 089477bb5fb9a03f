"""Multi-step dispatch of the port (TDVP.heun_multi, TDVP.adaptive_multi
and the driver's batched branches, --steps-per-dispatch) on the CPU,
where a batch runs its steps eagerly -- the plain version of the card's
captured graphs (solver/graphs.py) -- against the per-step path and the
JAX package. The card's graph replay against eager is
tests/test_torch_cuda.py's.

Tolerances:
- K > 1 against K = 1 of the port: fixed steppers bit for bit (theta and
  every recorded row); adaptive steppers: times to rtol 1e-12 (the
  JAX package's bar, tests/test_multistep.py:100-121; the controller's
  f64 arithmetic in tensors on the device against Python floats) and the
  attempts equal;
- the controller against the JAX package's _adaptive_multi_impl on a
  shared deterministic attempt stand-in: t_at, dt_used, theta and the
  final (t, dt) to 1e-12 relative, attempts and active equal;
- the driver's choice of batch or step, and the checkpoint files, equal
  to the JAX driver's on the same configuration (both packages' steps
  stubbed).
The Jacobi eigensolve's tests are tests/test_torch_jacobi.py's.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmc_pde_torch import driver
from vmc_pde_torch.config import RunConfig, preset
from vmc_pde_torch.solver.tdvp import TDVP, fold_in
from vmc_pde_tpu import driver as jdriver
from vmc_pde_tpu.config import RunConfig as JRunConfig
from vmc_pde_tpu.solver import tdvp as jtdvp

torch.set_num_threads(1)

# a first-order equation: no Hessian trace, so a step costs a fifth of a
# diffusion step here (the batching is the same; the card's phase M runs
# the Fokker-Planck equation)
BASE = dict(name="multistep", dim=4, offset=(0.0,) * 4, latent_name="Gauss",
            equation="advection_hamiltonian", variant="scale", dt0=1e-3,
            max_step=1e-2, increase_fac=1.3, t_end=0.0045, n_samples_tdvp=64,
            n_samples_obs=64, seed=3, sample_seed=3, precision="f64",
            workdir=None, verbose=False)


def _cfg(**kw):
    return RunConfig(**{**BASE, "device": "cpu", **kw})


def _spy(monkeypatch, name, calls=None):
    """Count the calls of TDVP.<name> and the steps each one ran."""
    calls = [] if calls is None else calls
    orig = getattr(TDVP, name)

    def spy(self, *args, **kw):
        out = orig(self, *args, **kw)
        n = (len(args[3]) if name == "heun_multi"
             else int(out[-1]["active"].sum()))
        calls.append(n)
        return out

    monkeypatch.setattr(TDVP, name, spy)
    return calls


@functools.lru_cache(maxsize=None)
def _per_step(items):
    """The K = 1 run of a configuration (shared by the tests)."""
    state, rec = driver.run(_cfg(steps_per_dispatch=1, **dict(items)))
    return state.get_parameters(), rec.as_arrays()


def _runs(**kw):
    """(the K = 1 run, the K = 3 run with the steps of each batch call)
    of a configuration."""
    return [_per_step(tuple(sorted(kw.items()))), _batched(
        tuple(sorted(kw.items())), TDVP.max_graph_attempts)]


@functools.lru_cache(maxsize=None)
def _batched(items, max_graph_attempts):
    """The K = 3 run (shared by the K-vs-1 cases and the schema case)."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("heun_multi", "adaptive_multi"):
            _spy(mp, name, calls)
        state, rec = driver.run(_cfg(steps_per_dispatch=3, **dict(items)))
    return state.get_parameters(), rec.as_arrays(), calls


# -- K > 1 against K = 1 ----------------------------------------------------

@pytest.mark.parametrize("stepper", ["fixed_heun", "fixed_rk3"])
def test_fixed_batches_equal_per_step(stepper):
    (th1, a1), (th3, a3, calls) = _runs(stepper=stepper)
    # a batch of 3, then one step: the ramp passes t_end inside the next
    assert calls == [3]
    assert torch.equal(th1, th3)
    assert set(a1) == set(a3) and len(a1["times"]) == 4
    for k in a1:
        np.testing.assert_array_equal(a1[k], a3[k], err_msg=k)


# tolerances that reject some attempts (attempts [3, 2, 2, 1] for Heun,
# [3, 2, 1] for RK23)
ADAPTIVE = dict(tol=1e-10, dt0=3e-3, max_step=2e-2, t_end=0.004)
ADAPTIVE_RK23 = dict(tol=1e-10, dt0=1e-2, max_step=2e-2, t_end=0.011)


@pytest.mark.parametrize("stepper", ["adaptive_heun", "adaptive_rk23"])
def test_adaptive_batches_equal_per_step(stepper):
    """With rejections (attempts > 1 somewhere): the same steps, attempts
    and rows as K = 1."""
    (th1, a1), (th3, a3, calls) = _runs(
        stepper=stepper,
        **(ADAPTIVE_RK23 if stepper == "adaptive_rk23" else ADAPTIVE))
    assert calls
    assert (a1["attempts"] > 1).any()
    np.testing.assert_array_equal(a1["attempts"], a3["attempts"])
    np.testing.assert_allclose(a3["times"], a1["times"], rtol=1e-12)
    np.testing.assert_allclose(a3["dt"], a1["dt"], rtol=1e-12)
    assert set(a1) == set(a3)
    torch.testing.assert_close(th3, th1, rtol=1e-12, atol=0)


def test_step_past_the_captured_attempts_finishes_on_host(monkeypatch):
    """max_graph_attempts = 1: a step that needs a retry halts its batch
    and finishes on the host, and the run is still K = 1's."""
    monkeypatch.setattr(TDVP, "max_graph_attempts", 1)
    finished = []
    orig = TDVP._finish_on_host

    def spy(self, *a, **kw):
        finished.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(TDVP, "_finish_on_host", spy)
    (th1, a1), (th3, a3, _) = _runs(stepper="adaptive_heun", **ADAPTIVE)
    assert finished
    np.testing.assert_array_equal(a1["attempts"], a3["attempts"])
    np.testing.assert_allclose(a3["times"], a1["times"], rtol=1e-12)
    torch.testing.assert_close(th3, th1, rtol=1e-12, atol=0)


def test_exact_t_end_last_batch_is_short(monkeypatch):
    """exact_t_end: the last batch runs fewer slots than K (the rest
    masked), lands on t_end and records no overshoot row."""
    calls = _spy(monkeypatch, "adaptive_multi")
    t_end = 0.005
    state, rec = driver.run(_cfg(stepper="adaptive_heun", exact_t_end=True,
                                 steps_per_dispatch=3,
                                 **{**ADAPTIVE, "t_end": t_end}))
    a = rec.as_arrays()
    assert calls[-1] < 3 and sum(calls) == len(a["times"])
    assert a["times"][-1] < t_end
    assert abs(a["times"][-1] + a["dt"][-1] - t_end) < 1e-15


# -- the driver's batch plan against the JAX driver's ------------------------

def _stub_aux(xp, k=None):
    shape = () if k is None else (k,)
    return {"nan": xp.zeros(shape, dtype=bool),
            **{name: xp.zeros(shape) for name in
               ("solver_res", "tdvp_error", "entropy")}}


@pytest.fixture
def stubbed(monkeypatch):
    """Both packages' fused steps replaced by stubs that log what the
    driver asked for: ("batch", K) or ("step",)."""
    log = {"jax": [], "torch": []}

    def multi(lib, xp):
        def fn(self, theta, ts, dts, keys, kind="heun"):
            log[lib].append(("batch", len(ts)))
            aux = _stub_aux(xp, len(ts))
            aux["dist_params"] = xp.zeros((len(ts), 0))
            return theta, aux
        return fn

    def step(lib, xp):
        def fn(self, theta, t, *rest, **kw):
            log[lib].append(("step",))
            return xp.zeros_like(theta), _stub_aux(xp)
        return fn

    for cls, lib, xp in ((TDVP, "torch", torch),
                         (jtdvp.TDVP, "jax", jnp)):
        monkeypatch.setattr(cls, "heun_multi", multi(lib, xp))
        for name in ("heun_pair", "rk3_triple", "rhs"):
            monkeypatch.setattr(cls, name, step(lib, xp))
    monkeypatch.setattr(jax.profiler, "start_trace", lambda *a, **k: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda *a, **k: None)
    monkeypatch.setattr(driver, "profiler_trace",
                        lambda *a, **k: torch.profiler.record_function("x"))
    return log


PLANS = {
    "heun": ({}, 10**9),
    "rk3": ({"stepper": "fixed_rk3"}, 10**9),
    "budget": ({}, 7),
    "checkpoint": ({"checkpoint_every": 4}, 10**9),
    "euler": ({"stepper": "fixed_euler"}, 10**9),
    "verbose": ({"verbose": True}, 10**9),
    "profiler": ({"profile_dir": "prof", "profile_steps": (1, 3)}, 10**9),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_dispatch_plan_matches_jax(case, stubbed, tmp_path):
    """The batches and the per-step fallbacks (Euler, verbose output, the
    profiler window, the step budget, checkpoints) the JAX driver's
    multi_ok / plan_batch take, and the checkpoint files both write."""
    kw, max_steps = PLANS[case]
    kw = dict(kw, steps_per_dispatch=3, t_end=0.06)
    files = {}
    for lib, run, Cfg, extra in (
            ("jax", jdriver.run, JRunConfig, {}),
            ("torch", driver.run, RunConfig, {"device": "cpu"})):
        wdir = tmp_path / lib
        over = dict(kw)
        if case == "checkpoint":
            over["workdir"] = str(wdir)
        if case == "profiler":
            over["profile_dir"] = str(tmp_path / f"prof_{lib}")
        cfg = Cfg(**{**BASE, **extra, **over})
        if case == "checkpoint":
            # no infos.hdf5 (store_infos) in the comparison: checkpoints
            run(cfg, max_steps=max_steps)
            files[lib] = sorted(f for f in os.listdir(wdir)
                                if f.startswith("ckpt"))
        else:
            run(cfg, max_steps=max_steps)
    assert stubbed["torch"] == stubbed["jax"]
    batched = ("batch", 3) in stubbed["torch"]
    assert batched == (case in ("heun", "rk3", "budget", "checkpoint"))
    if case == "checkpoint":
        assert files["torch"] == files["jax"] and len(files["jax"]) > 1


# -- what a batch records ----------------------------------------------------

def test_batched_rows_schema_matches_jax():
    """The rows a batched run records (the fixed Heun K = 3 run of the
    cases above): the JAX driver's batched rows, plus what the port
    records on every step (dt)."""
    _, jrec = jdriver.run(JRunConfig(**BASE, steps_per_dispatch=2),
                          max_steps=2)
    keys = set(_runs(stepper="fixed_heun")[1][1])
    assert keys == set(jrec.as_arrays()) | {"dt"}


def _fluid(**kw):
    return driver.build_problem(preset(
        "fluidpaper", device="cpu", precision="f64", n_samples_tdvp=128,
        n_samples_obs=128, n_chains=32, verbose=False, **kw))


def test_fluidpaper_batch_sums_chain_counts():
    """fluidpaper (the torch Metropolis chain in the RHS): three Heun
    steps in one batch are three heun_pair calls bit for bit, chain state
    included, and the sampler's counts are the rows' sums."""
    keys = [fold_in(9, i) for i in range(3)]
    ts, dts = [0.0, 1e-4, 2.3e-4], [1e-4, 1.3e-4, 1.69e-4]
    state, tdvp = _fluid()[:2]
    theta = state.get_parameters()
    y, rows = theta.clone(), []
    for t, dt, k in zip(ts, dts, keys):
        dy, aux = tdvp.heun_pair(y, t, dt, k)
        y = y + dy
        rows.append(aux)
    chains = tdvp.sampler.chain_state().clone()
    state2, tdvp2 = _fluid()[:2]
    th3, auxs = tdvp2.heun_multi(theta, ts, dts, keys)
    assert torch.equal(th3, y)
    assert torch.equal(tdvp2.sampler.chain_state(), chains)
    np.testing.assert_array_equal(
        auxs["mcmc_accepted"].numpy(), [int(r["mcmc_accepted"]) for r in rows])
    assert (auxs["mcmc_proposed"] == 2 * 128).all()
    info = tdvp2.sampler.last_info
    assert int(info.num_accepted) == int(auxs["mcmc_accepted"].sum())
    assert int(info.num_proposed) == 3 * 2 * 128


# -- the controller against the JAX package's --------------------------------

def _h(xp, t):
    # the stand-in's largest accepted dt, varying in t so that some steps
    # are rejected
    return 1.2e-3 * (1.0 + 0.5 * xp.sin(300.0 * t))


def _jax_attempt(self, theta_c, t, dt, key, off, chain_state, rw_scale, n,
                 n_obs):
    err = 1e-6 * (dt / _h(jnp, t)) ** 3
    aux = {"nan": jnp.zeros((), bool), "entropy": t * 2.0, "eloc_mean": dt}
    return 0.5 * dt * (1.0 + jnp.cos(theta_c)), err, aux


def _torch_attempt(self, theta_c, t, dt, key, off, z_ext=None,
                   chain_state=None):
    err = 1e-6 * (dt / _h(torch, t)) ** 3
    aux = {"nan": torch.zeros((), dtype=torch.bool), "entropy": t * 2.0,
           "eloc_mean": dt.clone()}
    return 0.5 * dt * (1.0 + torch.cos(theta_c)), err, aux


@pytest.mark.parametrize("exact", [False, True])
def test_adaptive_controller_matches_jax(exact, monkeypatch):
    """adaptive_multi of both packages on a deterministic attempt stand-in
    (a forced rejection at the first step, others where _h shrinks; with
    exact the clamp at t_end - t and masked slots)."""
    monkeypatch.setattr(jtdvp.TDVP, "_heun_attempt_impl", _jax_attempt)
    monkeypatch.setattr(TDVP, "_heun_attempt_impl", _torch_attempt)
    cfg = dict(BASE, n_samples_tdvp=16, n_samples_obs=16,
               stepper="adaptive_heun")
    K, tol, max_step = 8, 1e-6, 2e-3
    t_end = 6e-3 if exact else 1.0
    args = (0.0, 5e-3, 5e-3)
    jstate, jt = jdriver.build_problem(JRunConfig(**cfg))[:2]
    state, tt = driver.build_problem(RunConfig(**cfg, device="cpu"))[:2]
    theta = jstate.get_parameters()
    jout = jt.adaptive_multi(theta, *args,
                             jnp.stack([jax.random.PRNGKey(i)
                                        for i in range(K)]),
                             t_end, 1e-12, tol, max_step, exact=exact)
    out = tt.adaptive_multi(torch.as_tensor(np.asarray(theta)), *args,
                            list(range(K)), t_end, 1e-12, tol, max_step,
                            exact=exact)
    jo, o = jout[-1], out[-1]
    active = np.asarray(jo["active"])
    np.testing.assert_array_equal(o["active"].numpy(), active)
    np.testing.assert_array_equal(o["attempts"].numpy(),
                                  np.asarray(jo["attempts"]))
    assert (np.asarray(jo["attempts"]) > 1).any()
    assert active.all() != exact
    for key in ("t_at", "dt_used"):
        np.testing.assert_allclose(o[key].numpy()[active],
                                   np.asarray(jo[key])[active], rtol=1e-12)
    np.testing.assert_allclose(o["aux"]["entropy"].numpy(),
                               np.asarray(jo["aux"]["entropy"]), rtol=1e-12)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout[0]),
                               rtol=1e-12)
    np.testing.assert_allclose(out[1:4], [float(v) for v in jout[1:4]],
                               rtol=1e-12)
