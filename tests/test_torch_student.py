"""The port's Student-t latent, learned global affine, importance-sampled
and E_loc-clipped statistics, the remaining equations and the presets that
use them, against the JAX package on the CPU in f64, at small shapes
(d <= 8, depth <= 3, N <= 64 per sample, N <= 256 for the statistics).

Tolerances, relative to the largest value unless stated:
- latent, coupling and equations: 1e-12, the same f64 formulas in
  another operation order (torch's batched products and triangular solve
  against XLA's; lgamma/log1p from two libraries);
- the per-sample pipeline and the statistics: 1e-10, as tests/test_torch_
  persample.py holds the O rows: on the perturbed flows E_loc reaches
  5e5 and the two packages' E_loc already differ by ~4e-13 of that, which
  the centred force and the weighted Gram amplify to ~1e-11;
- the flat layout and weights carried across: bit for bit;
- ``random_spd_matrix``: its normal draw bit for bit against
  jax.random.normal; the matrix D = A^T A bit for bit at (2, 0) and
  (5, 3), and at (12, 0) bit for bit in its first 8 columns and within
  1e-13 of the largest entry elsewhere: XLA's eager 12 x 12 f64 product
  sums the last 4 columns in an order the port does not replay (no fixed
  summation order or fused multiply-add scheme reproduces them).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from test_torch_models import block_tuples, normal, parity_flow, rel_err, t64
from vmc_pde_torch import config, driver
from vmc_pde_torch.kernels import persample
from vmc_pde_torch.models import coupling, latent
from vmc_pde_torch.models.convert import from_jax
from vmc_pde_torch.models.state import VarState
from vmc_pde_torch.ops import evolution
from vmc_pde_torch.parallel import stats
from vmc_pde_torch.sampling.sampler import Sampler
from vmc_pde_torch.solver.tdvp import TDVP, TDVPConfig, fold_in
from vmc_pde_torch.utils import threefry
from vmc_pde_torch.utils.dtypes import Precision
from vmc_pde_tpu import config as jconfig
from vmc_pde_tpu.kernels import persample as jpersample
from vmc_pde_tpu.models import coupling as jcoupling
from vmc_pde_tpu.models import latent as jlatent
from vmc_pde_tpu.models.state import VarState as JVarState
from vmc_pde_tpu.ops import evolution as jevolution
from vmc_pde_tpu.parallel.mesh import ParallelCtx
from vmc_pde_tpu.sampling.sampler import Sampler as JSampler
from vmc_pde_tpu.solver.tdvp import TDVP as JTDVP
from vmc_pde_tpu.solver.tdvp import TDVPConfig as JTDVPConfig
from vmc_pde_tpu.utils.dtypes import Precision as JPrecision

torch.set_num_threads(1)


def _student_pair(seed=5, global_affine=False, variant="scale", dim=4):
    return parity_flow(variant, dim=dim, seed=seed, latent_name="Student_t",
                       global_affine=global_affine)


def test_student_t_log_prob_nu_and_tempered_weights():
    """nu, log t_nu on a perturbed latent (nu moved off 2), and the
    tempered proposal's log_w on the port's own draws, each against the
    JAX package's functions."""
    jflow, jparams, flow, theta = _student_pair(seed=3)
    lat, jlat = flow.layout.unravel(theta)["latent"], jparams["latent"]
    assert float(latent.nu_value(lat)) != 2.0
    assert rel_err(latent.nu_value(lat), jlatent.nu_value(jlat)) < 1e-12
    x = normal((32, 4), 1) * 3.0
    want = jax.vmap(lambda v: jlatent.student_t_log_prob(jlat, 4, v))(x)
    assert rel_err(latent.student_t_log_prob(lat, 4, t64(x)), want) < 1e-12
    gamma = 0.5
    z, log_w = latent.student_t_tempered_sample(
        torch.Generator().manual_seed(0), lat, 4, 64, gamma, torch.float64)
    nu_q = max(gamma * float(jlatent.nu_value(jlat)), 1.05)
    q = dict(jlat, dist_params=jnp.log(jnp.asarray([nu_q - 1.0])))
    want_w = jax.vmap(lambda v: jlatent.student_t_log_prob(jlat, 4, v)
                      - jlatent.student_t_log_prob(q, 4, v))(z.numpy())
    assert rel_err(log_w, want_w) < 1e-12
    # nu_q floors at 1.05
    _, w_lo = latent.student_t_tempered_sample(
        torch.Generator().manual_seed(0), lat, 4, 8, 0.01, torch.float64)
    q_lo = dict(jlat, dist_params=jnp.log(jnp.asarray([0.05])))
    assert torch.isfinite(w_lo).all() and float(jlatent.nu_value(q_lo)) \
        == pytest.approx(1.05)


def test_student_t_sampler_on_shared_draws():
    """Sampler.sample on a Student-t flow is z = mu + (U eps) sqrt(nu /
    chi2) + offset, with eps and chi2 = 2 Gamma(nu/2) drawn in that order
    from the caller's generator: the JAX package's formula evaluated on the
    same eps and chi2 gives the same z (1e-12). The chi2 draws have mean
    nu within 5 standard errors."""
    jflow, jparams, flow, theta = _student_pair(seed=4)
    params = flow.layout.unravel(theta)
    n = 64
    z, _ = Sampler(4, "Student_t", dtype=torch.float64).sample(
        torch.Generator().manual_seed(9), flow, params, n)
    gen = torch.Generator().manual_seed(9)
    eps = torch.randn((n, 4), generator=gen, dtype=torch.float64)
    nu = float(jlatent.nu_value(jparams["latent"]))
    chi2 = 2.0 * torch._standard_gamma(
        torch.full((n,), 0.5 * nu, dtype=torch.float64), generator=gen)
    L = jlatent.chol_factor(jparams["latent"], 4)
    want = ((eps.numpy() @ np.asarray(L).T)
            * np.sqrt(nu / chi2.numpy())[:, None]
            + np.asarray(jparams["latent"]["mu"]))
    assert rel_err(z, want) < 1e-12
    big = 2.0 * torch._standard_gamma(
        torch.full((40000,), 0.5 * nu, dtype=torch.float64),
        generator=torch.Generator().manual_seed(1))
    assert abs(float(big.mean()) - nu) < 5 * math.sqrt(2 * nu / 40000)


@pytest.mark.parametrize("variant", ["additive", "affine"])
def test_global_affine_forward_inverse(variant):
    """coupling.forward/inverse with the learned global affine (g_scale and
    g_offset perturbed off 1 and 0) against the JAX package's, and the
    round trip."""
    jflow, jparams, flow, theta = parity_flow(variant, seed=6,
                                              global_affine=True)
    params = flow.layout.unravel(theta)
    spec, jspec = flow.blocks[0], jflow.blocks[0]
    p, jp = params["blocks"][0], jparams["blocks"][0]
    assert float(p["g_scale"][0]) != 1.0
    x = normal((16, 4), 2)
    y, lj = coupling.forward(p, spec, t64(x))
    yj, ljj = jax.vmap(lambda v: jcoupling.forward(jp, jspec, v))(x)
    assert rel_err(y, yj) < 1e-12 and rel_err(lj, ljj) < 1e-12
    xi, lji = coupling.inverse(p, spec, y)
    xij, ljij = jax.vmap(lambda v: jcoupling.inverse(jp, jspec, v))(yj)
    assert rel_err(xi, xij) < 1e-12 and rel_err(lji, ljij) < 1e-12
    assert rel_err(xi, x) < 1e-12 and rel_err(lji, -lj) < 1e-12


def test_from_jax_and_layout_order():
    """A Student-t flow with the global affine in every block: from_jax
    gives ravel_pytree's vector bit for bit, unravel returns every JAX leaf
    at its path, and the flat order is ravel_pytree's (g_offset, g_scale
    before the nets; L, L_diag, dist_params, mu)."""
    jflow, jparams, flow, theta = _student_pair(seed=7, global_affine=True,
                                                variant="affine")
    flat, _ = ravel_pytree(jparams)
    _, theta2 = from_jax(block_tuples(jflow),
                         jax.tree.map(np.asarray, jparams),
                         latent_name="Student_t")
    np.testing.assert_array_equal(theta2.numpy(), np.asarray(flat))
    assert all(s.global_affine for s in flow.blocks)
    tree = flow.layout.unravel(theta)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = tree
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    paths = [path for path, *_ in flow.layout.leaves]
    assert [p[2] for p in paths if p[:2] == ("blocks", 0)][:3] == [
        "g_offset", "g_scale", "s1"]
    assert [p[1] for p in paths if p[0] == "latent"] == [
        "L", "L_diag", "dist_params", "mu"]
    assert flow.layout.shapes["latent"]["dist_params"] == (1,)


CASES = [(v, ga, lat) for lat in ("Gauss", "Student_t")
         for ga in (False, True) for v in ("scale", "affine")]


@pytest.mark.parametrize("variant,ga,lat", CASES)
def test_plain_per_sample_matches_jax_reference(variant, ga, lat):
    """The port's plain per-sample pipeline (the CUDA kernel's plain
    version) against the JAX kernel's own reference functions,
    tile_value_and_grads (logp, g, O with the nu row and the global-affine
    rows) and tile_quad(impl="jet") along non-axis directions, d=4,
    depth 2, N=16: 1e-10."""
    jflow, jparams, flow, theta = parity_flow(
        variant, seed=11, latent_name=lat, global_affine=ga)
    x = normal((16, 4), 12)
    dirs = normal((3, 4), 13)
    lp_j, g_j, O_j = jpersample.tile_value_and_grads(jflow, jparams,
                                                     jnp.asarray(x))
    q_j = jpersample.tile_quad(jflow, jparams, jnp.asarray(x),
                               jnp.asarray(dirs), impl="jet")
    got = persample.per_sample_plain(flow, theta, t64(x), t64(dirs))
    for name, g_, w_ in zip(("logp", "g", "quad", "O"), got,
                            (lp_j, g_j, q_j, O_j)):
        assert g_.shape == tuple(w_.shape), name
        assert rel_err(g_, w_) < 1e-10, name
    assert persample.supports(flow, dirs, None)


def test_block_plan_student_t_and_global_affine():
    """The plan's new fields: the latent code and the dist_params offset
    in the header, the global-affine flag in each block record and the
    g_scale/g_offset offsets at GA_REC; every theta row is still covered
    once."""
    _, _, flow, _ = _student_pair(seed=2, global_affine=True,
                                  variant="affine")
    meta, _ = persample.block_plan(flow, n_dirs=2)
    lay = flow.layout
    assert meta[8] == persample.LATENT_CODES["Student_t"]
    assert meta[9] == lay.offset(("latent", "dist_params"))
    for b in range(len(flow.blocks)):
        r = persample.HDR + b * persample.BLOCK_REC
        assert meta[r + 7] == 1
        assert meta[r + persample.GA_REC] == lay.offset(
            ("blocks", b, "g_scale"))
        assert meta[r + persample.GA_REC + 1] == lay.offset(
            ("blocks", b, "g_offset"))
    consts = persample.student_t_consts(flow, torch.zeros(lay.size))
    nu = 2.0
    c0 = (math.lgamma(3.0) - math.lgamma(1.0) - 2.0 * math.log(2 * math.pi))
    assert rel_err(consts, [nu, c0, consts[2]]) < 1e-6


@pytest.mark.parametrize("r,c,k", [(9, 11, 13), (40, 37, 16), (24, 8, 8)])
def test_int8_product_pads_odd_sizes(r, c, k):
    """stats._mm_int8 zero-pads the sizes cuBLASLt refuses (the int8 cross
    term at P=9397, the Student-t fokkerPlanck32 flow with the global
    affine): the product is the exact int32 one, bit for bit."""
    gen = torch.Generator().manual_seed(r)
    a = torch.randint(-127, 128, (r, k), dtype=torch.int8, generator=gen)
    b = torch.randint(-127, 128, (c, k), dtype=torch.int8, generator=gen)
    got = stats._mm_int8(a, b)
    assert got.dtype == torch.int32 and got.shape == (r, c)
    assert torch.equal(got, (a.long() @ b.long().T).int())


def _stats_problem(**cfg):
    """The same Student-t diffusion problem in both packages (f64, d=4,
    N=256), and the shared samples x."""
    cfg.setdefault("svd_tol", 1e-6)
    jflow, jparams, flow, theta = _student_pair(seed=21, variant="affine")
    ctx = ParallelCtx.single_device()
    jprec = JPrecision.f64_everywhere()
    n = 256
    eq = ("diffusion", {"D": 0.7})
    jstate = JVarState(jflow, jparams, ctx=ctx, precision=jprec,
                       sampler=JSampler(dim=4, ctx=ctx, name="Student_t",
                                        dtype=jnp.float64))
    jtdvp = JTDVP(jstate, jevolution.make_equation(eq[0], 4, **eq[1]),
                  JTDVPConfig(**cfg), n_samples=n, precision=jprec)
    prec = Precision.f64_everywhere()
    state = VarState(flow, theta, sampler=Sampler(4, "Student_t",
                                                  dtype=torch.float64),
                     precision=prec)
    tdvp = TDVP(state, evolution.make_equation(eq[0], 4, **eq[1]),
                TDVPConfig(**cfg), n_samples=n, precision=prec)
    x = flow.push(flow.layout.unravel(theta), t64(normal((n, 4), 31)))[0]
    return jtdvp, tdvp, theta, x


@pytest.mark.parametrize("is_gamma,clip", [(0.5, 0.0), (1.0, 3.0),
                                           (0.5, 3.0)])
def test_direct_stats_weighted_and_clipped_match_jax(is_gamma, clip):
    """The direct statistics with IS log-weights and/or E_loc clipping
    against the JAX package's _direct_stats on the same x and log_w:
    E_loc moments, F0, S0 and A (1e-10)."""
    jtdvp, tdvp, theta, x = _stats_problem(is_gamma=is_gamma,
                                           eloc_clip=clip)
    log_w = None
    if is_gamma != 1.0:
        log_w = normal((x.shape[0],), 5)
    jst = jtdvp._direct_stats(jnp.asarray(theta.numpy()), 0.2,
                              jnp.asarray(x.numpy()),
                              log_w=None if log_w is None
                              else jnp.asarray(log_w))
    st = tdvp._direct_stats(theta, 0.2, x,
                            log_w=None if log_w is None else t64(log_w))
    for key in ("eloc", "eloc_mean", "eloc_abs_mean", "eloc_var",
                "eloc_sq_mean", "F0", "S0", "A"):
        assert rel_err(st[key], jst[key]) < 1e-10, key
    if clip:
        assert float(st["eloc"].max()) < float(
            tdvp._per_sample_batch(theta, x, 0.2)[1].max())


def test_is_gamma_rhs_resamples_observables():
    """An is_gamma RHS draws from the proposal, weights the statistics
    (effective sample share in (0, 1], a finite update) and takes the
    observables from a fresh draw of the target under the observables'
    key, as the JAX package does."""
    _, tdvp, theta, _ = _stats_problem(is_gamma=0.5)
    aux = tdvp._rhs_impl(theta, 0.0, 3)
    assert 0.0 < float(aux["is_ess_share"]) <= 1.0
    assert torch.isfinite(aux["update"]).all() and not bool(aux["nan"])
    params = tdvp.flow.layout.unravel(theta)
    z = tdvp.flow.latent_sample(tdvp._gen(fold_in(3, 1)), params,
                                tdvp.n_samples_obs, torch.float64)
    x_o = tdvp.flow.push(params, z)[0]
    assert torch.equal(aux["x1"], x_o.mean(0))


@pytest.mark.parametrize("name,params", [
    ("diffusion_drift", {"D": 0.7, "mu": 1.5}),
    ("diffusion_anisotropic", {"seed": 3}),
    ("advection_hamiltonian", {"lam": 0.3, "coupled": True}),
])
def test_remaining_equations_match_jax(name, params):
    """E_loc and the trace directions of the three equations ported
    here, against the JAX package's (1e-12)."""
    eq = evolution.make_equation(name, 6, **params)
    jeq = jevolution.make_equation(name, 6, **params)
    x, g, h = normal((10, 6), 1), normal((10, 6), 2), normal((10,), 3)
    dirs, jdirs = eq.hessian_trace_dirs(6), jeq.hessian_trace_dirs(6)
    assert (dirs is None) == (jdirs is None)
    if dirs is not None:
        assert rel_err(dirs, jdirs) < 1e-12
    want = jeq.eloc(jnp.asarray(x), jnp.asarray(g), jnp.asarray(h), 0.3)
    assert rel_err(eq.eloc(t64(x), t64(g), t64(h), 0.3), want) < 1e-12


@pytest.mark.parametrize("dim,seed", [(12, 0), (2, 0), (5, 3)])
def test_random_spd_matrix_matches_jax(dim, seed):
    with jax.enable_x64(True):
        A = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                         (dim, dim), dtype=jnp.float64))
    np.testing.assert_array_equal(threefry.normal_f64(seed, (dim, dim)), A)
    D = evolution.random_spd_matrix(dim, seed)
    want = jevolution.random_spd_matrix(dim, seed)
    np.testing.assert_array_equal(D[:, :8], want[:, :8])
    if dim <= 8:
        np.testing.assert_array_equal(D, want)
    assert np.abs(D - want).max() <= 1e-13 * np.abs(want).max()


NEW_PRESETS = ("diffusion", "diffusion_anisotropic", "harmonicOsc",
               "harmonicOsc_diff")


@pytest.mark.parametrize("name", NEW_PRESETS)
def test_presets_match_jax(name):
    """Every field the two RunConfigs share has the JAX preset's value."""
    ours, theirs = config.PRESETS[name], jconfig.PRESETS[name]
    shared = ({f.name for f in dataclasses.fields(ours)}
              & {f.name for f in dataclasses.fields(theirs)})
    assert {"eloc_clip", "is_gamma", "latent_name", "equation"} <= shared
    for field in sorted(shared):
        assert getattr(ours, field) == getattr(theirs, field), field


@pytest.mark.parametrize("args", [[], ["--is-gamma", "0.5"]])
def test_driver_diffusion_cpu(args):
    """Two steps of the d=8 Student-t diffusion preset through the CLI on
    the CPU in f64, with and without the tempered importance sampling:
    finite, nu recorded per step, and the solver residual below 1e-3 (at
    N=256 < P=365 the Gram is singular, and the regularized solve leaves
    ~1e-6 of the force unmatched)."""
    _, rec = driver.main(["diffusion", "--device", "cpu", "--precision",
                          "f64", "--samples", "256", "--max-steps", "2",
                          *args])
    a = rec.as_arrays()
    assert a["times"].shape == (2,) and not a["nan"].any()
    assert a["solver_res"].max() < 1e-3
    assert a["dist_params"].shape == (2, 1)
    assert np.isfinite(a["entropy"]).all()
    if args:
        assert ((0 < a["is_ess_share"]) & (a["is_ess_share"] <= 1)).all()
