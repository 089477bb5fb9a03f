"""The port's Hessian block mode and MC sphere integrals against the JAX
package, on the CPU in f64: ops/score.py's hessian_block, each
equation's E_loc on the block against the trace, block-mode right-hand
sides on shared draws, the mode's selection and refusals, the
integrals on shared ball points and against mwe's closed form, and
--hessian-mode with the integrals through the driver.

Tolerances (relative to the largest value):
- hessian_block: 1e-12 (the same forward-over-reverse derivatives in
  another operation order; test_torch_models holds the flow to 1e-10 at
  values ~1e3, its scores to 1e-12).
- E_loc on the block against the trace: 1e-10 (one a diagonal sum of
  the block, the other forward-over-forward second derivatives).
- block-mode RHS against the JAX package's: 1e-8, test_torch_tdvp.py's
  RHS tolerance (the solves take different LAPACK paths).
- the integrals on shared points: 1e-12; mwe's closed form: 5 Monte
  Carlo standard errors.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from test_torch_models import normal, parity_flow, rel_err, t64
from test_torch_tdvp import DIM, FP, N, _jax_rhs, _port_tdvp, _problem
from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.models.state import VarState
from vmc_pde_torch.ops import evolution, score
from vmc_pde_torch.parallel.mesh import ParallelCtx
from vmc_pde_torch.sampling.sampler import Sampler
from vmc_pde_torch.solver import tdvp as tdvp_mod
from vmc_pde_torch.solver.tdvp import TDVP, TDVPConfig
from vmc_pde_torch.utils.dtypes import Precision
from vmc_pde_tpu.models.state import VarState as JVarState
from vmc_pde_tpu.ops import evolution as jevolution
from vmc_pde_tpu.ops import score as jscore
from vmc_pde_tpu.parallel.mesh import ParallelCtx as JParallelCtx
from vmc_pde_tpu.sampling.sampler import Sampler as JSampler
from vmc_pde_tpu.solver.tdvp import TDVP as JTDVP
from vmc_pde_tpu.solver.tdvp import TDVPConfig as JTDVPConfig
from vmc_pde_tpu.utils.dtypes import Precision as JPrecision

torch.set_num_threads(1)


@pytest.mark.parametrize("idx", [None, (1, 3)])
def test_hessian_block_matches_jax(idx):
    jflow, jparams, flow, theta = parity_flow("affine", dim=DIM, seed=9)
    x = normal((16, DIM), 4)
    jtheta, unravel = ravel_pytree(jparams)
    jf = jscore.make_flat_log_prob(jflow, unravel)
    want = jax.jit(jax.vmap(
        lambda xs: jscore.hessian_block(jf, jtheta, xs, idx)))(jnp.asarray(x))
    f = score.make_flat_log_prob(flow, flow.layout.unravel)
    got = score.batched_hessian_block(f, theta, t64(x), idx)
    k = DIM if idx is None else len(idx)
    assert got.shape == (16, k, k) and got.dtype == torch.float64
    assert rel_err(got, want) < 1e-12, rel_err(got, want)
    got32 = score.batched_hessian_block(f, theta.float(), t64(x).float(),
                                        idx)
    assert got32.dtype == torch.float32


@pytest.mark.parametrize("name,params", [
    ("diffusion", {"D": 0.7}),
    ("diffusion_drift", {}),
    ("diffusion_anisotropic", {}),
    FP,
])
def test_eloc_block_against_trace(name, params):
    """Each equation with a Hessian, on the block of its hessian_coords
    and on the quadratic trace along its directions, in both packages."""
    _, _, flow, theta = parity_flow("affine", dim=DIM, seed=9)
    eq = evolution.make_equation(name, DIM, **params)
    jeq = jevolution.make_equation(name, DIM, **params)
    x = t64(normal((32, DIM), 5))
    f = score.make_flat_log_prob(flow, flow.layout.unravel)
    _, g, _ = score.batched_value_score_and_param_grad(f, theta, x)
    quad = score.batched_quad_trace(f, theta, x,
                                    eq.hessian_trace_dirs(DIM))
    block = score.batched_hessian_block(f, theta, x,
                                        eq.hessian_coords(DIM))
    assert block.ndim == 3
    e_trace = eq.eloc(x, g, quad, 0.3)
    e_block = eq.eloc(x, g, block, 0.3)
    assert rel_err(e_block, e_trace) < 1e-10, rel_err(e_block, e_trace)
    want = jeq.eloc(jnp.asarray(x.numpy()), jnp.asarray(g.numpy()),
                    jnp.asarray(block.numpy()), 0.3)
    assert rel_err(e_block, want) < 1e-12


class _BlockOnly(evolution.FokkerPlanck):
    """The Fokker-Planck equation declaring its momentum block and no
    trace directions: "auto" must build the block."""

    def hessian_trace_dirs(self, dim):
        return None


class _JBlockOnly(jevolution.FokkerPlanck):
    def hessian_trace_dirs(self, dim):
        return None


class _TraceOnly(evolution.Diffusion):
    """Trace directions and no block: "block" cannot serve it."""

    def hessian_coords(self, dim):
        return None


def _pair(eq, jeq, **cfg):
    """test_torch_tdvp's problem (f64, N samples, svd_tol 1e-6) with the
    equations ``eq`` and ``jeq``: (JAX TDVP, port TDVP, theta)."""
    cfg.setdefault("svd_tol", 1e-6)
    jflow, jparams, flow, theta = parity_flow("affine", dim=DIM, seed=21)
    ctx = JParallelCtx.single_device()
    jprec = JPrecision.f64_everywhere()
    jstate = JVarState(jflow, jparams, ctx=ctx, precision=jprec,
                       sampler=JSampler(dim=DIM, ctx=ctx, name="Gauss",
                                        dtype=jnp.float64))
    jtdvp = JTDVP(jstate, jeq, JTDVPConfig(**cfg), n_samples=N,
                  precision=jprec)
    tdvp = _port_tdvp(flow, theta, **cfg)
    tdvp = TDVP(tdvp.state, eq, tdvp.cfg, n_samples=N,
                precision=tdvp.precision)
    return jtdvp, tdvp, theta


@pytest.mark.parametrize("name,params,mode", [
    ("diffusion", {"D": 0.7}, "block"),
    FP + ("block",),
    FP + ("auto",),
])
def test_block_rhs_matches_jax(name, params, mode):
    """One block-mode RHS on shared draws against the JAX package's, and
    against the port's trace-mode RHS on the same draws; mode "auto" on
    an equation with a block and no trace directions (defined here in
    both packages) takes the block."""
    if mode == "auto":
        eq, jeq = _BlockOnly(**params), _JBlockOnly(**params)
    else:
        eq = evolution.make_equation(name, DIM, **params)
        jeq = jevolution.make_equation(name, DIM, **params)
    jtdvp, tdvp, theta = _pair(eq, jeq, hessian_mode=mode)
    trace = _pair(evolution.make_equation(name, DIM, **params), jeq)[1]
    assert tdvp._hess_block is not None and tdvp._hess_dirs is None
    assert trace._hess_block is None and not tdvp.uses_kernel
    z = normal((N, DIM), 33)
    jaux = _jax_rhs(jtdvp, theta, 0.25, z)
    aux = tdvp._rhs_impl(theta, 0.25, 0, t64(z))
    for k in ("update", "ev", "solver_res", "eloc_mean", "eloc_var",
              "tdvp_error"):
        assert rel_err(aux[k], jaux[k]) < 1e-8, (k, rel_err(aux[k], jaux[k]))
    ref = trace._rhs_impl(theta, 0.25, 0, t64(z))
    assert rel_err(aux["update"], ref["update"]) < 1e-8


@pytest.mark.parametrize("cfg", [
    dict(chunk_size=16), dict(solver_method="cg", svd_tol=1e-4,
                              cg_maxiter=600, cg_tol=1e-10),
    dict(solver_method="minsr"), dict(solver_method="minsr", chunk_size=16),
    dict(solver_method="cholesky", eigh_max_params=8)])
def test_block_mode_on_every_path(cfg):
    """Block mode on the chunked statistics, cg, direct and streaming
    minSR and cholesky: each RHS equals its trace-mode RHS on the same
    draws: 1e-8, and 1e-6 for cg, converged as in test_torch_solvers.py's
    parity case (svd_tol 1e-4, cg_tol 1e-10): the ~1e-13 differences of
    E_loc pass through ~250 iterations on a system of condition 1e4, so
    the bound is cg_tol times the condition."""
    tdvp = _problem("affine", hessian_mode="block", **cfg)[1]
    ref = _problem("affine", **cfg)[1]
    z = t64(normal((N, DIM), 34))
    aux = tdvp._rhs_impl(tdvp.state.theta, 0.1, 0, z)
    want = ref._rhs_impl(ref.state.theta, 0.1, 0, z)
    tol = 1e-6 if cfg.get("solver_method") == "cg" else 1e-8
    assert rel_err(aux["update"], want["update"]) < tol


def test_tri2_int8_block_mode_takes_the_plain_pipeline():
    """f32 chunked tri2 + int8 in block mode: the plain pipeline split in
    the Gram (no split kernel), the statistics those of trace mode on the
    same samples to f32's rounding of E_loc (1e-5)."""
    out = {}
    for mode in ("block", "trace"):
        cfg = preset("fokkerPlanck32", device="cpu", dim=8,
                     offset=(0.0,) * 8, n_samples_tdvp=512,
                     n_samples_obs=512, chunk_size=256, gram_backend="tri2",
                     gram_cross="int8", hessian_mode=mode)
        state, tdvp = driver.build_problem(cfg)[:2]
        assert tdvp._ps_split is None and not tdvp.uses_kernel
        theta = state.theta
        params = state.flow.layout.unravel(theta)
        x, _ = state.flow.push(params, state.flow.latent_sample(
            torch.Generator().manual_seed(1), params, 512, torch.float32))
        out[mode] = tdvp._chunked_stats(theta, 0.0, x)
    for k in ("S0", "F0"):
        assert rel_err(out["block"][k], out["trace"][k]) < 1e-5, k


def test_hessian_mode_refusals():
    _, _, flow, theta = parity_flow("affine", dim=DIM, seed=9)
    state = VarState(flow, theta, sampler=Sampler(DIM, dtype=torch.float64),
                     precision=Precision.f64_everywhere())
    fp = evolution.make_equation(*FP[:1], DIM, **FP[1])
    with pytest.raises(ValueError, match="unknown hessian_mode"):
        TDVP(state, fp, TDVPConfig(hessian_mode="full"), n_samples=8)
    with pytest.raises(ValueError, match="'trace' is not available"):
        TDVP(state, _BlockOnly(**FP[1]), TDVPConfig(hessian_mode="trace"),
             n_samples=8)
    with pytest.raises(ValueError, match="hessian_mode='block' cannot"):
        TDVP(state, _TraceOnly(), TDVPConfig(hessian_mode="block"),
             n_samples=8)
    with pytest.raises(ValueError, match="per_sample_backend='cuda'"):
        TDVP(state, fp, TDVPConfig(hessian_mode="block",
                                   per_sample_backend="cuda"), n_samples=8)
    # an equation with no Hessian takes none in block mode
    t = TDVP(state, evolution.make_equation("advection_hamiltonian", DIM),
             TDVPConfig(hessian_mode="block"), n_samples=8)
    assert t._hess_block is None and t._hess_dirs is None


def test_integrals_match_jax_on_shared_points():
    """The integrals of one RHS against the JAX package's, the port's
    sphere_integrals fed the JAX package's ball points (its k_int key)."""
    jtdvp, tdvp, theta = _problem("affine", integrals=True)
    z = normal((N, DIM), 35)
    jaux = _jax_rhs(jtdvp, theta, 0.25, z)
    k_int = jax.random.split(jax.random.PRNGKey(0), 4)[2]
    k_dir, k_r = jax.random.split(k_int)
    dirs = np.asarray(jax.random.normal(k_dir, (N, DIM), dtype=jnp.float64))
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    radii = np.asarray(jax.random.uniform(k_r, (N,), dtype=jnp.float64))
    ball = t64(dirs * radii[:, None] ** (1.0 / DIM))
    got = tdvp_mod.sphere_integrals(ParallelCtx.single_device(), tdvp.flow,
                                    tdvp.flow.layout.unravel(theta), ball,
                                    tdvp.cfg.integral_T)
    keys = ("integral_1sigma", "integral_0.5sigma", "integral_0.1sigma")
    assert sorted(got) == sorted(keys)
    for k in keys:
        assert rel_err(got[k], jaux[k]) < 1e-12, (k, rel_err(got[k], jaux[k]))
    aux = tdvp._rhs_impl(theta, 0.25, 0, t64(z))
    assert all(torch.isfinite(aux[k]) for k in keys)
    assert tdvp_mod._ball_volume(2, 2.0) == pytest.approx(4.0 * math.pi)


def test_integrals_closed_form_and_driver(tmp_path):
    """mwe in f64 with the integrals for 3 steps: each within 5 Monte
    Carlo standard errors of 1 - exp(-r^2 / (2 sigma^2(t))), sigma^2(t) =
    1 + 2t, and infos.hdf5 holding them (with --qmc and the block mode);
    then --hessian-mode block through the CLI."""
    import h5py

    n = 4096
    cfg = preset("mwe", device="cpu", precision="f64", n_samples_tdvp=n,
                 n_samples_obs=n, integrals=True, hessian_mode="block",
                 qmc=True, workdir=str(tmp_path), verbose=False, dt0=1e-2)
    _, rec = driver.run(cfg, max_steps=3)
    a = rec.as_arrays()
    s2 = 1.0 + 2.0 * a["times"]
    for label, lim in (("1", 1.0), ("0.5", 0.5), ("0.1", 0.1)):
        r2 = lim**2 * 10.0
        est = a[f"integral_{label}sigma"]
        exact = 1.0 - np.exp(-r2 / (2.0 * s2))
        # uniform in a 2-D ball, rho^2 is uniform on [0, r^2]: the first
        # two moments of p = exp(-rho^2 / (2 s2)) / (2 pi s2) there
        m1 = exact / (math.pi * r2)
        m2 = (1.0 - np.exp(-r2 / s2)) / (4.0 * math.pi**2 * s2 * r2)
        se = math.pi * r2 * np.sqrt((m2 - m1**2) / n)
        assert (np.abs(est - exact) < 5 * se).all(), (label, est, exact, se)
    with h5py.File(tmp_path / "infos.hdf5", "r") as f:
        for label in ("1", "0.5", "0.1"):
            assert f[f"integral_{label}sigma"].shape == (3,)
    state, rec = driver.main(["mwe", "--device", "cpu", "--precision",
                              "f64", "--samples", "512", "--max-steps", "2",
                              "--hessian-mode", "block", "--qmc"])
    assert state.flow.qmc
    a = rec.as_arrays()
    assert "integral_1sigma" not in a
    assert (a["solver_res"] < 1e-10).all()
