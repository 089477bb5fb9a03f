"""The port's TDVP main path against the JAX package, on the CPU in f64:
E_loc of the two ported equations, one full right-hand side on shared
latent draws (eigh at small P; cholesky with a lowered eigh_max_params),
one fixed-Heun pair, and the port's driver end to end on ``mwe``.

Tolerances (relative to the largest value unless stated):
- E_loc and the velocity field: 1e-12 -- the same closed-form f64
  arithmetic in another operation order.
- RHS update, force-derived diagnostics and observables: 1e-8. Samples,
  O rows and the statistics agree to ~1e-13 (test_torch_models), but the
  solves take different LAPACK paths (torch's and XLA's eigh/Cholesky).
  The problems use svd_tol=1e-6: at the default 1e-11 the soft cutoff
  falls where the Gram's eigenvalues carry relative rounding of ~1e-5
  (eps * lambda_max / lambda), which moves the update by ~1e-7 between
  any two correct eigensolvers; at 1e-6 the measured gap is ~1e-11.
- Top-k Ritz values of the randomized spectrum: 1e-2, because the random
  test matrix Omega differs between the frameworks.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import normal, parity_flow, rel_err, t64
from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.models.state import VarState
from vmc_pde_torch.ops import evolution
from vmc_pde_torch.parallel import mesh as tparallel
from vmc_pde_torch.sampling.sampler import Sampler
from vmc_pde_torch.solver.steppers import FixedStepper
from vmc_pde_torch.solver.tdvp import TDVP, TDVPConfig, fold_in
from vmc_pde_torch.utils.dtypes import Precision
from vmc_pde_tpu.models.state import VarState as JVarState
from vmc_pde_tpu.ops import evolution as jevolution
from vmc_pde_tpu.parallel.mesh import ParallelCtx
from vmc_pde_tpu.sampling.sampler import Sampler as JSampler
from vmc_pde_tpu.solver.tdvp import TDVP as JTDVP
from vmc_pde_tpu.solver.tdvp import TDVPConfig as JTDVPConfig
from vmc_pde_tpu.utils.dtypes import Precision as JPrecision

torch.set_num_threads(1)

DIM = 4
N = 64
FP = ("advection_hamiltonian_wDiss", {"T": (2.0, 3.0), "coupled": True,
                                      "onsite": 0.5})


@pytest.mark.parametrize("name,params", [
    ("diffusion", {"D": 0.7}),
    ("advection_hamiltonian_wDiss", {"T": 10.0, "coupled": True}),
    ("advection_hamiltonian_wDiss", {"T": (2.0, 3.0, 5.0), "coupled": True,
                                     "onsite": 0.5}),
    ("advection_hamiltonian_wDiss", {"lam": 0.3, "v2": -2.0, "gamma": 0.5}),
])
def test_eloc_matches_jax(name, params):
    eq = evolution.make_equation(name, 6, **params)
    jeq = jevolution.make_equation(name, 6, **params)
    x, g, h = normal((10, 6), 1), normal((10, 6), 2), normal((10,), 3)
    np.testing.assert_array_equal(eq.hessian_trace_dirs(6),
                                  jeq.hessian_trace_dirs(6))
    want = jeq.eloc(jnp.asarray(x), jnp.asarray(g), jnp.asarray(h), 0.3)
    assert rel_err(eq.eloc(t64(x), t64(g), t64(h), 0.3), want) < 1e-12
    if hasattr(jeq, "velocity"):
        assert rel_err(eq.velocity(t64(x), 0.3),
                       jeq.velocity(jnp.asarray(x), 0.3)) < 1e-12
        kw = {k: getattr(eq, k)
              for k in ("m", "omega", "lam", "coupled", "v2", "onsite")}
        want = jax.vmap(lambda c: jevolution.hamiltonian(c, **kw))(
            jnp.asarray(x))
        assert rel_err(evolution.hamiltonian(t64(x), **kw), want) < 1e-12


def test_unported_paths_raise():
    """Nothing the JAX package accepts is refused as not ported any more.
    The adaptive steppers, minsr, cg, f64acc, the Hessian block mode and
    the MC sphere integrals, refused before they were ported, build and
    give a finite step or RHS on one device; cg, minsr (direct and
    streaming), the host solve and the gram precisions beyond the f32
    product, refused on a mesh before, build at a world of 2 (the rank
    processes of tests/test_torch_mesh_gspmd.py run them), on the dp-only
    mesh and at dp 1 x tp 2, where they take the GSPMD route."""
    _, tdvp, stepper = driver.build_problem(preset(
        "mwe", device="cpu", stepper="adaptive_heun", n_samples_tdvp=256,
        n_samples_obs=256))[:3]
    res = stepper.step(0.0, tdvp.rhs, tdvp.state.get_parameters(), 1)
    assert math.isfinite(res.info["step_error"]) and res.dt_used > 0
    with pytest.raises(ValueError, match="unknown sexp_mode"):
        TDVP(tdvp.state, tdvp.equation, TDVPConfig(sexp_mode="exact"))
    _, _, flow, theta = parity_flow("scale", dim=DIM)
    state = VarState(flow, theta, sampler=Sampler(DIM, dtype=torch.float64),
                     precision=Precision.f64_everywhere())
    eq = evolution.make_equation("diffusion", DIM)
    for cfg in (TDVPConfig(solver_method="minsr"),
                TDVPConfig(solver_method="cg"),
                TDVPConfig(gram_precision="f64acc", chunk_size=4),
                TDVPConfig(hessian_mode="block"),
                TDVPConfig(integrals=True)):
        update, aux = TDVP(state, eq, cfg, n_samples=8).rhs(theta, 0.0, 3)
        assert torch.isfinite(update).all() and not bool(aux["nan"])
    assert torch.isfinite(aux["integral_0.5sigma"])
    for dp, tp in ((2, 1), (1, 2)):
        ctx = tparallel.ParallelCtx(dp=dp, tp=tp, rank=1)
        mstate = VarState(flow, theta, sampler=Sampler(
            DIM, dtype=torch.float64, ctx=ctx),
            precision=Precision.f64_everywhere(), ctx=ctx)
        for cfg in (TDVPConfig(solver_method="cg"),
                    TDVPConfig(solver_method="minsr"),
                    TDVPConfig(solver_method="minsr", chunk_size=4),
                    TDVPConfig(gram_precision="f64acc", chunk_size=4),
                    TDVPConfig(gram_precision="f64"),
                    TDVPConfig(gram_precision="default"),
                    TDVPConfig(solve_on_device=False),
                    TDVPConfig(stats_partitioning="gspmd", chunk_size=4)):
            tdvp = TDVP(mstate, eq, cfg, n_samples=8)
            assert tdvp._gspmd != tdvp._stats_shardmap
            assert tdvp.ctx.world == (dp if tdvp._gspmd else 2)
            assert (tdvp._rows is not None) == (tdvp._gspmd and tp > 1)


@pytest.mark.parametrize("latent_name,cfg,match", [
    ("Gauss", dict(is_gamma=0.5), "Student_t"),
    ("Student_t", dict(is_gamma=0.5, chunk_size=4), "direct"),
    ("Student_t", dict(is_gamma=1.5), "0, 1"),
    ("Gauss", dict(eloc_clip=3.0, chunk_size=4), "chunk_size=0"),
    ("Gauss", dict(eloc_clip=-1.0), ">= 0"),
])
def test_is_gamma_and_eloc_clip_refusals(latent_name, cfg, match):
    """The JAX package's ValueErrors: importance tempering needs the exact
    Student-t latent, the direct statistics and a gamma in (0, 1);
    E_loc clipping the direct statistics and a nonnegative width."""
    _, _, flow, theta = parity_flow("scale", dim=DIM,
                                    latent_name=latent_name)
    state = VarState(flow, theta,
                     sampler=Sampler(DIM, latent_name, dtype=torch.float64),
                     precision=Precision.f64_everywhere())
    with pytest.raises(ValueError, match=match):
        TDVP(state, evolution.make_equation("diffusion", DIM),
             TDVPConfig(**cfg), n_samples=8)


def _port_tdvp(flow, theta, **cfg):
    prec = Precision.f64_everywhere()
    state = VarState(flow, theta, sampler=Sampler(DIM, dtype=torch.float64),
                     precision=prec)
    return TDVP(state, evolution.make_equation(FP[0], DIM, **FP[1]),
                TDVPConfig(**cfg), n_samples=N, precision=prec)


def _problem(variant, **cfg):
    """The same TDVP problem in both packages: flow, f64 policy, the
    Fokker-Planck equation with per-site T, N samples, svd_tol=1e-6."""
    cfg.setdefault("svd_tol", 1e-6)
    jflow, jparams, flow, theta = parity_flow(variant, dim=DIM, seed=21)
    ctx = ParallelCtx.single_device()
    jprec = JPrecision.f64_everywhere()
    jstate = JVarState(jflow, jparams, ctx=ctx, precision=jprec,
                       sampler=JSampler(dim=DIM, ctx=ctx, name="Gauss",
                                        dtype=jnp.float64))
    jtdvp = JTDVP(jstate, jevolution.make_equation(FP[0], DIM, **FP[1]),
                  JTDVPConfig(**cfg), n_samples=N, precision=jprec)
    return jtdvp, _port_tdvp(flow, theta, **cfg), theta


def _jax_rhs(jtdvp, theta, t, z):
    aux = jtdvp._fused(jnp.asarray(np.asarray(theta)), t,
                       jax.random.PRNGKey(0), jnp.asarray(z), None, None,
                       None, n=N, n_obs=N, with_obs=True)
    return {k: np.asarray(v) for k, v in aux.items()}


def _compare(aux, jaux, keys, tol=1e-8):
    for k in keys:
        assert rel_err(aux[k], jaux[k]) < tol, k


OBS = ("x1", "covar", "entropy", "x3", "x4", "x5", "x6", "eloc_mean",
       "eloc_var", "tdvp_error")


def test_rhs_eigh_matches_jax():
    """One RHS with the spectral eigh solve (P <= eigh_max_params): the
    update, the spectrum, the SNR of the non-negligible modes, the
    residual and the observables on the same latent draws."""
    jtdvp, tdvp, theta = _problem("affine")
    assert tdvp.solver_method == jtdvp.solver_method == "eigh"
    z = normal((N, DIM), 31)
    jaux = _jax_rhs(jtdvp, theta, 0.25, z)
    aux = tdvp._rhs_impl(theta, 0.25, 0, t64(z))
    _compare(aux, jaux, ("update", "ev", "solver_res") + OBS)
    live = jaux["ev"] > 1e-8 * jaux["ev"][-1]
    assert rel_err(aux["snr"].numpy()[live], jaux["snr"][live]) < 1e-8


def test_rhs_cholesky_matches_jax():
    """The large-P branch at small P: Tikhonov-Cholesky with the power-
    iteration lambda_max (spectrum_topk=0 keeps it deterministic)."""
    jtdvp, tdvp, theta = _problem("affine", eigh_max_params=16,
                                  spectrum_topk=0)
    assert tdvp.solver_method == jtdvp.solver_method == "cholesky"
    z = normal((N, DIM), 32)
    jaux = _jax_rhs(jtdvp, theta, 0.0, z)
    aux = tdvp._rhs_impl(theta, 0.0, 0, t64(z))
    _compare(aux, jaux, ("update", "lambda_max", "solver_res") + OBS)


def test_rhs_cholesky_topk_spectrum():
    """With the randomized top-k spectrum on, the leading Ritz values
    agree loosely (Omega differs), and lambda_max comes from them."""
    jtdvp, tdvp, theta = _problem("scale", eigh_max_params=16,
                                  spectrum_topk=8)
    z = normal((N, DIM), 33)
    jaux = _jax_rhs(jtdvp, theta, 0.0, z)
    aux = tdvp._rhs_impl(theta, 0.0, 0, t64(z))
    assert aux["ev_topk"].shape == (8,)
    assert rel_err(aux["ev_topk"][-4:], jaux["ev_topk"][-4:]) < 1e-2
    assert float(aux["lambda_max"]) == float(aux["ev_topk"][-1])
    assert rel_err(aux["spectrum_trace"], jaux["spectrum_trace"]) < 1e-8
    assert np.isfinite(aux["snr_topk"].numpy()).all()


def test_heun_pair_matches_jax():
    """One fixed-Heun step dy = dt/2 (k0 + k1), each stage on its own
    shared latent draws: the port's heun_pair against the same
    composition of two JAX RHS evaluations."""
    jtdvp, tdvp, theta = _problem("affine")
    z0, z1 = normal((N, DIM), 41), normal((N, DIM), 42)
    t, dt = 0.1, 1e-5
    k0 = _jax_rhs(jtdvp, theta, t, z0)["update"]
    k1 = _jax_rhs(jtdvp, theta.numpy() + dt * k0, t + dt, z1)["update"]
    dy, aux = tdvp.heun_pair(theta, t, dt, key=3, z_ext=(t64(z0), t64(z1)))
    assert dy.dtype == torch.float64
    assert rel_err(dy, 0.5 * dt * (k0 + k1)) < 1e-8
    assert not bool(aux["nan"])
    assert tdvp.solverResidual is aux["solver_res"]


def test_stepper_pair_and_stage_calls_agree():
    """FixedStepper through heun_pair and through two rhs() calls draws
    the same stage keys and, in f64, gives the same step bit for bit; dt
    follows the geometric ramp."""
    _, _, flow, theta = parity_flow("scale", dim=DIM, seed=21)
    tdvp = _port_tdvp(flow, theta, svd_tol=1e-6)
    fused = FixedStepper(timeStep=1e-4, maxStep=2e-4, increase_fac=1.5,
                         pair_fn=tdvp.heun_pair)
    staged = FixedStepper(timeStep=1e-4, maxStep=2e-4, increase_fac=1.5)
    for step, dt in enumerate((1.5e-4, 2e-4)):
        a = fused.step(0.0, tdvp.rhs, theta, step)
        b = staged.step(0.0, tdvp.rhs, theta, step)
        assert a.dt_used == b.dt_used == pytest.approx(dt, rel=1e-15)
        assert torch.equal(a.y, b.y)


def test_backend_switch_and_keys():
    """per_sample_backend='cuda' on CPU tensors takes the plain pipeline
    through the kernel wrapper, bit for bit; fold_in derives distinct
    reproducible keys."""
    _, _, flow, theta = parity_flow("scale", dim=DIM, seed=21)
    tdvp = _port_tdvp(flow, theta)
    tdvp_k = _port_tdvp(flow, theta, per_sample_backend="cuda")
    assert tdvp_k.uses_kernel and not tdvp.uses_kernel
    a = tdvp.rhs(theta, 0.0, 7)[0]
    b = tdvp_k.rhs(theta, 0.0, 7)[0]
    assert torch.equal(a, b)
    keys = {fold_in(7, i) for i in range(100)}
    assert len(keys) == 100 and fold_in(7, 3) == fold_in(7, 3)


def test_driver_mwe_closed_forms():
    """The port's driver on mwe (2-D Gaussian diffusion, f64, CPU):
    covariance diagonal 1 + 2t and entropy d/2 log(2 pi e (1 + 2t)) at
    every recorded step, within 5 standard errors of N=1024 estimates."""
    _, rec = driver.main(["mwe", "--device", "cpu", "--precision", "f64",
                          "--samples", "1024", "--max-steps", "10"])
    a = rec.as_arrays()
    assert a["times"].shape == (10,)
    var = 1.0 + 2.0 * a["times"]
    cov = np.diagonal(a["covar"], axis1=1, axis2=2)
    assert np.abs(cov - var[:, None]).max() < 5 * math.sqrt(2 / 1024) * 1.1
    ent = np.log(2 * math.pi * math.e * var)
    assert np.abs(a["entropy"] - ent).max() < 5 * math.sqrt(1 / 1024)
    assert a["solver_res"].max() < 1e-10
    assert not a["nan"].any()


@pytest.mark.parametrize("mode", ["mwe", "fluidpaper", "doubleWell"])
def test_driver_cuda_without_card_raises(mode):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main([mode, "--max-steps", "1"])
