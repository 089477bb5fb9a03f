"""The port's multi-rank path (parallel/mesh.py; the sharded statistics in
solver/tdvp.py; kernels' per_sample_sharded and metropolis_chain_sharded)
on the CPU: rank processes over gloo (tests/torch_mesh_worker.py, which
imports nothing of JAX), held against the JAX package's sharded programs
on the 8-device virtual CPU mesh and against the port's own one rank.

- The shard_map statistics on 4 ranks against the JAX package's
  _stats_sharded on ParallelCtx.create(dp=4) and (dp=2, tp=2), with the
  same theta (carried across by models/convert) and the same x (numpy,
  seeded), d=4, N=2048, as tests/test_parallel.py:306-366: the direct f32
  Gram, the direct tri2 + int8 Gram, the chunked tri2 + int8 statistics in
  global chunks of 512 (the port on its split-kernel path, the JAX
  package on its Pallas kernels in interpret mode). S0 and A to 5e-5 of
  max |S|, F0 to rtol 1e-4, atol 1e-7 (that test's bars: f32 sums in
  another order, and int8 cross terms whose per-shard scales agree on the
  same mesh; the chunked F0's floor is 5e-6 of its largest value, see
  _f0_floor); the chunked case also against the port's one rank to that test's
  bars; the f32-Gram direct case in f64 to 1e-12 of the largest value
  (the same f64 formulas in another order).
- The GSPMD counterpart (eloc_clip, is_gamma) on 2 ranks against the JAX
  package's dp=2 mesh (f64, 1e-10 of the largest value: the two packages'
  f64 per-sample pipelines differ at 1e-15 and the clip's median is the
  same order statistic) and against the port's one rank on the same draws
  (statistics to 1e-12; the RHS update to the JAX mesh test's bar, rtol
  1e-3 and atol 2e-5, which allows for the regularized pseudo-inverse
  amplifying summation-order ulps on near-null modes); its sym2 + int8
  Gram in f32 against one rank (1e-6: global int8 scales) and the JAX
  package's GSPMD result (5e-5).
- fluidpaper's and doubleWell's chains in the RHS on 2 ranks: the same
  accept counts and random-walk scale as one rank, bit for bit (every
  rank draws the global block and keeps its chains' columns).
- ``metropolis_chain_sharded`` (plain) on 4 ranks replays the single call
  bit for bit, with external uniforms and with Philox.
- Two driver processes (``driver.main`` with the CLI's arguments, mwe,
  f64) replay the one-process run to 1e-12, with theta bitwise equal
  across ranks after every step and infos.hdf5 written once.
- Every refusal's message.

Each scenario is one group of rank processes, with a time limit of its
own, so that a hang fails the test instead of eating the suite's limit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import torch_mesh_worker as worker
from test_torch_models import normal, parity_flow, rel_err
from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.kernels import metropolis, persample
from vmc_pde_torch.models.flow import build_flow, perturb_theta
from vmc_pde_torch.parallel import mesh
from vmc_pde_torch.parallel.mesh import MeshConfig, ParallelCtx
from vmc_pde_tpu.models.state import VarState as JVarState
from vmc_pde_tpu.ops import evolution as jevolution
from vmc_pde_tpu.parallel.mesh import ParallelCtx as JParallelCtx
from vmc_pde_tpu.sampling.sampler import Sampler as JSampler
from vmc_pde_tpu.solver.tdvp import TDVP as JTDVP
from vmc_pde_tpu.solver.tdvp import TDVPConfig as JTDVPConfig
from vmc_pde_tpu.utils.dtypes import resolve as jresolve

torch.set_num_threads(1)

N = 2048
EQ = ("advection_hamiltonian_wDiss", {"T": 3.0})
CASES = [label for label, _, _ in worker.STATS_CASES]
C_MCMC, SWEEPS = 8 * 128, 16


# -- the problems, built once ---------------------------------------------

@pytest.fixture(scope="module")
def problems():
    """The flows and inputs every scenario shares: a perturbed d=4 Gauss
    flow and a d=2 Student-t flow made by the JAX package and carried into
    the port, fluidpaper's and doubleWell's flows, the x batches, the IS
    draws and the Metropolis inputs."""
    jflow, jparams, flow, theta = parity_flow("affine", dim=4, seed=21,
                                              out_scale=0.05)
    jflow_t, jparams_t, flow_t, theta_t = parity_flow(
        "affine", dim=2, seed=22, out_scale=0.05, latent_name="Student_t")
    params = flow.layout.unravel(theta)
    x64 = flow.push(params, torch.as_tensor(normal((N, 4), 51)))[0]
    gen = torch.Generator().manual_seed(52)
    z_t, log_w = flow_t.latent_sample_tempered(
        gen, flow_t.layout.unravel(theta_t), N, 0.6, torch.float64)
    x_t = flow_t.push(flow_t.layout.unravel(theta_t), z_t)[0]
    spec = {"gauss": worker.spec_of(flow, *EQ),
            "student": worker.spec_of(flow_t, "diffusion")}
    inputs = dict(theta=theta.numpy(), x=x64.float().numpy(),
                  x64=x64.numpy(), theta_t=theta_t.numpy(),
                  x_t=x_t.numpy(), log_w=log_w.numpy(),
                  v=normal(4096, 53))
    for label in ("fluid", "dw"):
        cfg = preset("fluidpaper" if label == "fluid" else "doubleWell")
        f, th = build_flow(cfg.seed, cfg.dim, depth=cfg.depth,
                           hidden=cfg.hidden_resolved(), variant=cfg.variant,
                           latent_name=cfg.latent_name, offset=cfg.offset,
                           dtype=torch.float64)
        th = perturb_theta(f, th, np.random.default_rng(3), out_scale=0.02)
        spec[label] = dict(worker.spec_of(f, cfg.equation,
                                          cfg.equation_params),
                           bound=cfg.mcmc_bound)
        inputs[f"theta_{label}"] = th.numpy()
    rng = np.random.default_rng(7)
    inputs.update(
        init=np.tile(np.float32([0.25, 0.25]), (C_MCMC, 1)),
        uniforms=rng.uniform(1e-7, 1 - 1e-7, (6, SWEEPS * C_MCMC))
        .astype(np.float32),
        sweeps=np.int64(SWEEPS))
    return dict(jflow=jflow, jparams=jparams, flow=flow, theta=theta,
                jflow_t=jflow_t, jparams_t=jparams_t, spec=spec,
                inputs=inputs)


def _jax_tdvp(ctx, jflow, jparams, eq, cfg, precision, latent="Gauss"):
    jprec = jresolve(precision)
    jparams = jax.tree.map(lambda a: a.astype(jprec.compute), jparams)
    dim = jflow.dim
    st = JVarState(jflow, jparams, ctx=ctx, precision=jprec,
                   sampler=JSampler(dim=dim, ctx=ctx, name=latent,
                                    dtype=jprec.compute))
    tdvp = JTDVP(st, jevolution.make_equation(eq[0], dim, **eq[1]),
                 JTDVPConfig(**cfg), n_samples=N, n_samples_obs=N,
                 precision=jprec)
    theta_c = ravel_pytree(jparams)[0]
    return tdvp, theta_c, jprec.compute


def _np(a):
    return np.asarray(a, dtype=np.float64)


# -- the shard_map statistics on 4 ranks -----------------------------------

@pytest.fixture(scope="module")
def stats_run(problems, tmp_path_factory):
    return worker.run_ranks("stats", 4, str(tmp_path_factory.mktemp("st")),
                            problems["spec"], problems["inputs"])


@pytest.fixture(scope="module")
def jax_stats(problems):
    """The JAX package's _stats_sharded on dp=4 and dp=2 x tp=2 for every
    case (its per-sample pipeline is the plain one on the CPU)."""
    out = {}
    for mesh_name, ctx in (("dp4tp1", JParallelCtx.create(dp=4)),
                           ("dp2tp2", JParallelCtx.create(dp=2, tp=2))):
        for label, precision, cfg in worker.STATS_CASES:
            if "per_sample_backend" in cfg:
                # the port's split-kernel path against the JAX package's:
                # its Pallas kernels in interpret mode, at a tile that
                # divides the local chunk of 512 / 4 rows
                cfg = dict(cfg, per_sample_backend="pallas",
                           per_sample_tile=128)
            tdvp, theta_c, dt = _jax_tdvp(
                ctx, problems["jflow"], problems["jparams"], EQ,
                dict(cfg, gram_precision="high", compute_snr=True),
                precision)
            assert tdvp._stats_shardmap
            x = problems["inputs"]["x" if precision == "tpu" else "x64"]
            xs = jax.device_put(jnp.asarray(x, dt),
                                ctx.sharding(ctx.samples_spec))
            st = jax.jit(tdvp._stats_sharded, static_argnums=3)(
                theta_c, 0.25, xs, N)
            out[label, mesh_name] = {k: _np(st[k]) for k in ("S0", "F0",
                                                               "A")}
    return out


@pytest.mark.parametrize("mesh_name", ["dp4tp1", "dp2tp2"])
@pytest.mark.parametrize("label", ["f32", "tri2_int8", "chunked"])
def test_shardmap_stats_match_jax(label, mesh_name, stats_run, jax_stats):
    """S0, A and F0 of the port's 4 ranks against the JAX package's
    _stats_sharded on the same mesh shape, theta and x."""
    ref = jax_stats[label, mesh_name]
    got = stats_run[0]
    for k in ("S0", "A"):
        a = ref[k]
        np.testing.assert_allclose(got[f"{label}/{mesh_name}/{k}"], a,
                                   atol=5e-5 * np.abs(a).max(), rtol=0,
                                   err_msg=f"{label} {mesh_name} {k}")
    np.testing.assert_allclose(got[f"{label}/{mesh_name}/F0"], ref["F0"],
                               rtol=1e-4, atol=_f0_floor(label, ref["F0"]))


def _f0_floor(label, ref):
    """F0's absolute floor: 1e-7, or on the chunked path 5e-6 of max |F0|.
    There F0 = E[f y] - m_f m_y cancels in f32 on this perturbed flow's
    large force (max |F0| = 177): the JAX package's own 4-device chunked F0
    lies up to 4.0e-6 of that from its single device's, at 2.1e-4 relative
    on its small elements, past the elementwise bar alone."""
    return 5e-6 * np.abs(ref).max() if label == "chunked" else 1e-7


def test_jax_chunked_f0_spread(problems, jax_stats):
    """Why the chunked F0 has its floor: the JAX package's own chunked
    tri2 + int8 F0 on 4 devices misses its single device's by more than
    rtol 1e-4, atol 1e-7 on some small elements, and stays within 5e-6 of
    max |F0| (4.0e-6 on this problem)."""
    _, precision, cfg = worker.STATS_CASES[2]
    cfg = dict(cfg, per_sample_backend="pallas", per_sample_tile=128,
               gram_precision="high", compute_snr=True)
    tdvp, theta_c, dt = _jax_tdvp(JParallelCtx.single_device(),
                                  problems["jflow"], problems["jparams"],
                                  EQ, cfg, precision)
    one = _np(tdvp._chunked_stats(
        theta_c, 0.25, jnp.asarray(problems["inputs"]["x"], dt))["F0"])
    four = jax_stats["chunked", "dp4tp1"]["F0"]
    diff = np.abs(four - one)
    assert (diff > 1e-7 + 1e-4 * np.abs(one)).any()
    assert diff.max() <= _f0_floor("chunked", one)


@pytest.mark.parametrize("mesh_name", ["dp4tp1", "dp2tp2"])
def test_chunked_shardmap_matches_one_rank(mesh_name, stats_run, problems):
    """The chunked tri2 + int8 statistics of 4 ranks (per-shard int8
    scales, the pilot shift averaged) against the port's one rank on the
    same x, to the JAX package's own sharded-vs-single bars
    (tests/test_parallel.py:306-366), with F0's chunked floor."""
    _, precision, cfg = worker.STATS_CASES[2]
    tdvp = _tdvp(problems, ParallelCtx.single_device(), precision,
                 compute_snr=True, **cfg)
    st = tdvp._chunked_stats(tdvp.state.theta, 0.25,
                             torch.as_tensor(problems["inputs"]["x"]))
    got = stats_run[0]
    for k in ("S0", "A"):
        a = st[k].double().numpy()
        np.testing.assert_allclose(got[f"chunked/{mesh_name}/{k}"], a,
                                   atol=5e-5 * np.abs(a).max(), rtol=0)
    ref = st["F0"].double().numpy()
    np.testing.assert_allclose(got[f"chunked/{mesh_name}/F0"], ref,
                               rtol=1e-4, atol=_f0_floor("chunked", ref))


@pytest.mark.parametrize("mesh_name", ["dp4tp1", "dp2tp2"])
def test_shardmap_stats_f64_match_jax(mesh_name, stats_run, jax_stats):
    """The direct f32-Gram statistics in f64: 1e-12 of the largest
    value."""
    for k in ("S0", "F0", "A"):
        assert rel_err(stats_run[0][f"f64/{mesh_name}/{k}"],
                       jax_stats["f64", mesh_name][k]) < 1e-12, k


@pytest.mark.parametrize("label", CASES)
def test_shardmap_moments_identical_on_every_rank(label, stats_run):
    """After the one all-reduce every rank holds the same bits, on both
    mesh shapes (a dp x tp mesh is W sample shards: the same sums)."""
    for key, v in stats_run[0].items():
        if key.startswith(f"{label}/"):
            for out in stats_run[1:]:
                np.testing.assert_array_equal(out[key], v, err_msg=key)
            other = key.replace("dp4tp1", "dp2tp2")
            np.testing.assert_array_equal(stats_run[0][other], v)


@pytest.mark.parametrize("label", ["ext", "philox"])
def test_metropolis_sharded_replays_single_call(label, stats_run,
                                                problems):
    """4 ranks of 256 chains, gathered, against one call on all 1024
    chains: the same samples, final states and accept count, bit for bit
    (external uniforms split by chain column; Philox through chain_base)."""
    inp = problems["inputs"]
    u = torch.as_tensor(inp["uniforms"]) if label == "ext" else None
    s, f, acc = metropolis.metropolis_chain_plain(
        5, torch.as_tensor(inp["init"]), SWEEPS, 0.25, (0.25, 0.25), u)
    for out in stats_run:
        np.testing.assert_array_equal(out[f"mcmc/{label}/samples"],
                                      s.numpy())
        np.testing.assert_array_equal(out[f"mcmc/{label}/final"], f.numpy())
        assert int(out[f"mcmc/{label}/acc"]) == int(acc)


def test_philox_chain_base_is_the_global_chain_index():
    """A launch of chains [256, 512) with chain_base 256 draws columns
    256..511 of the whole ensemble's Philox block."""
    whole = metropolis.philox_uniforms(9, 512, 8, 2)
    part = metropolis.philox_uniforms(9, 256, 8, 2, chain_base=256)
    np.testing.assert_array_equal(
        part.reshape(6, 8, 256), whole.reshape(6, 8, 512)[:, :, 256:])


# -- the GSPMD counterpart and the chains on 2 ranks -----------------------

@pytest.fixture(scope="module")
def gspmd_run(problems, tmp_path_factory):
    return worker.run_ranks("gspmd", 2, str(tmp_path_factory.mktemp("gs")),
                            problems["spec"], problems["inputs"])


@pytest.fixture(scope="module")
def one_rank(problems):
    """The same calls on the port's one rank."""
    return worker.scenario_gspmd(ParallelCtx.single_device(),
                                 problems["spec"], problems["inputs"])


@pytest.fixture(scope="module")
def jax_gspmd(problems):
    """The JAX package's direct statistics under GSPMD on its dp=2 mesh."""
    ctx = JParallelCtx.create(dp=2)
    inp = problems["inputs"]
    out = {}
    for label, jflow, jparams, eq, cfg, x, log_w, latent in (
            ("clip", problems["jflow"], problems["jparams"], EQ,
             dict(eloc_clip=2.0), inp["x64"], None, "Gauss"),
            ("is", problems["jflow_t"], problems["jparams_t"],
             ("diffusion", {}), dict(is_gamma=0.6), inp["x_t"],
             inp["log_w"], "Student_t")):
        tdvp, theta_c, _ = _jax_tdvp(ctx, jflow, jparams, eq,
                                     dict(cfg, compute_snr=True), "f64",
                                     latent)
        assert not tdvp._stats_shardmap
        spec = ctx.sharding(ctx.samples_spec)
        xs = jax.device_put(jnp.asarray(x), spec)
        lw = None if log_w is None else jax.device_put(jnp.asarray(log_w),
                                                       spec)
        st = jax.jit(lambda th, xx, ww: tdvp._direct_stats(
            th, 0.25, xx, log_w=ww))(theta_c, xs, lw)
        out[label] = {k: _np(st[k]) for k in ("S0", "F0", "A", "eloc_mean",
                                                "eloc_var")}
    # the sym2 Gram (the split Gram GSPMD takes) with the int8 cross term
    # in f32: its operand is sharded over the mesh, so the int8 column
    # scales are global
    tdvp, theta_c, _ = _jax_tdvp(
        ctx, problems["jflow"], problems["jparams"], EQ,
        dict(stats_partitioning="gspmd", gram_backend="sym2",
             gram_cross="int8", compute_snr=True), "tpu")
    assert not tdvp._stats_shardmap
    xs = jax.device_put(jnp.asarray(inp["x"]),
                        ctx.sharding(ctx.samples_spec))
    st = jax.jit(lambda th, xx: tdvp._direct_stats(th, 0.25, xx))(theta_c,
                                                                  xs)
    out["int8"] = {k: _np(st[k]) for k in ("S0", "A")}
    return out


@pytest.mark.parametrize("label", ["clip", "is"])
def test_gspmd_stats_match_jax(label, gspmd_run, jax_gspmd):
    for k, ref in jax_gspmd[label].items():
        assert rel_err(gspmd_run[0][f"{label}/{k}"], ref) < 1e-10, k


@pytest.mark.parametrize("label", ["clip", "is"])
def test_gspmd_matches_one_rank(label, gspmd_run, one_rank):
    """The statistics on the same draws to 1e-12; a whole RHS (global
    draws, sliced) to the mesh test's bar; both ranks the same bits."""
    keys = ["S0", "F0", "A", "eloc_mean", "eloc_var"]
    if label == "is":
        keys.append("is_ess_share")
    for k in keys:
        assert rel_err(gspmd_run[0][f"{label}/{k}"],
                       one_rank[f"{label}/{k}"]) < 1e-12, k
    np.testing.assert_allclose(gspmd_run[0][f"{label}/update"],
                               one_rank[f"{label}/update"], rtol=1e-3,
                               atol=2e-5)
    assert rel_err(gspmd_run[0][f"{label}/entropy"],
                   one_rank[f"{label}/entropy"]) < 1e-12
    np.testing.assert_array_equal(gspmd_run[1][f"{label}/update"],
                                  gspmd_run[0][f"{label}/update"])


def test_gspmd_int8_cross_term_takes_global_scales(gspmd_run, one_rank,
                                                   jax_gspmd):
    """The GSPMD counterpart's sym2 Gram with the int8 cross term (f32) on
    2 ranks quantizes with the global column scales: its S0 and A equal
    the port's one rank on the same rows to 1e-6 of their largest value
    (the int8 products are exact, so only f32 rounding of the de-scaled
    sums differs; per-rank scales differ at the int8 class), and match
    the JAX package's GSPMD statistics on its dp=2 mesh to 5e-5 (the
    shard_map int8 case's bar above: f32 sums in another order)."""
    for k in ("S0", "A"):
        got = gspmd_run[0][f"int8/{k}"]
        np.testing.assert_array_equal(got, gspmd_run[1][f"int8/{k}"])
        assert rel_err(got, one_rank[f"int8/{k}"]) < 1e-6, k
        assert rel_err(got, jax_gspmd["int8"][k]) < 5e-5, k


@pytest.mark.parametrize("label", ["direct", "chunked", "is"])
def test_s_metric_on_two_ranks_matches_one_rank(label, gspmd_run, one_rank):
    """The adaptive steppers' S metric in f64 on 2 ranks (the dense SExp in
    the moments' one all-reduce; the matrix-free quadratic's sums in one
    all-reduce) equals one rank's on the same rows to 1e-12 of the largest
    value (f64 sums in another order), on the direct shard_map statistics
    with the kept O rows, the chunked ones with O re-made per chunk, and
    the IS-weighted GSPMD counterpart; and on each, v^T SExp v equals the
    matrix-free quadratic to 1e-12."""
    for out in gspmd_run:
        for k in ("dense", "quad"):
            key = f"sexp/{label}/{k}"
            assert rel_err(out[key], one_rank[key]) < 1e-12, k
    dense = one_rank[f"sexp/{label}/dense"]
    v = one_rank["sexp/v"][:dense.shape[0]]
    assert rel_err(v @ dense @ v, one_rank[f"sexp/{label}/quad"]) < 1e-12


@pytest.mark.parametrize("label", ["fluid", "dw"])
def test_chains_in_the_rhs_match_one_rank(label, gspmd_run, one_rank):
    """Two RHS of fluidpaper's (independence) and doubleWell's (random
    walk, adapted between calls) chains: the accept counts, proposals and
    adapted scale equal one rank's, the update agrees."""
    for out in gspmd_run:
        for k in ("accepted", "proposed", "rw_scale"):
            assert out[f"{label}/{k}"] == one_rank[f"{label}/{k}"], k
        np.testing.assert_allclose(out[f"{label}/update"],
                                   one_rank[f"{label}/update"], rtol=1e-3,
                                   atol=2e-5)


def test_standalone_sampler_matches_one_rank(gspmd_run, one_rank):
    """Sampler.sample on fluidpaper's chains (the torch chain on the CPU):
    every chain's sweeps and the acceptance equal one rank's."""
    for out in gspmd_run:
        np.testing.assert_array_equal(out["fluid/sample"],
                                      one_rank["fluid/sample"])
        assert out["fluid/sample_accepted"] == one_rank[
            "fluid/sample_accepted"]


# -- the driver: two processes against one ---------------------------------

DRIVER_ARGV = ["mwe", "--precision", "f64", "--device", "cpu", "--samples",
               "512", "--max-steps", "3"]


@pytest.fixture(scope="module")
def driver_runs(problems, tmp_path_factory):
    wdir = str(tmp_path_factory.mktemp("drv"))
    ranks = worker.run_ranks("driver", 2, wdir, {},
                             dict(argv=json.dumps(DRIVER_ARGV)))
    thetas = []
    single = os.path.join(wdir, "single")
    driver.main(DRIVER_ARGV + ["--workdir", single], callbacks=[
        lambda n, t, state, info: thetas.append(
            state.get_parameters().numpy().copy())])
    return ranks, np.stack(thetas), wdir


def test_driver_two_ranks_replay_one(driver_runs):
    ranks, single, _ = driver_runs
    assert ranks[0]["theta"].shape == single.shape == (3, single.shape[1])
    for step in range(3):
        assert rel_err(ranks[0]["theta"][step], single[step]) < 1e-12, step


def test_driver_theta_bitwise_across_ranks(driver_runs):
    ranks, _, _ = driver_runs
    for out in ranks:
        assert out["same"].all() and len(out["same"]) == 3
    np.testing.assert_array_equal(ranks[1]["theta"], ranks[0]["theta"])


def test_driver_writes_infos_once(driver_runs):
    import h5py

    _, _, wdir = driver_runs
    # infos.hdf5 and the driver's density snapshot at t = 0, rank 0's only
    assert sorted(os.listdir(os.path.join(wdir, "r0"))) == [
        "infos.hdf5", "t_0.000.pdf"]
    assert not os.path.exists(os.path.join(wdir, "r1"))
    with h5py.File(os.path.join(wdir, "r0", "infos.hdf5")) as f, \
            h5py.File(os.path.join(wdir, "single", "infos.hdf5")) as g:
        assert sorted(f) == sorted(g)
        assert f["times"].shape[0] == 3
        for key in ("times", "entropy", "x1", "covar"):
            assert rel_err(f[key][:], g[key][:]) < 1e-12, key


# -- refusals and the mesh's own rules (no processes) ----------------------

def _ctx(dp=2, tp=1):
    """Rank 0 of a mesh, for checks that run before any collective."""
    return ParallelCtx(dp=dp, tp=tp, rank=0, device=torch.device("cpu"))


def _tdvp(problems, ctx, precision="tpu", n=N, **cfg):
    return worker.tdvp_on(ctx, problems["spec"]["gauss"],
                          problems["inputs"]["theta"], precision, n, cfg)


@pytest.mark.parametrize("cfg", [dict(stats_partitioning="shard_map",
                                      eloc_clip=2.0),
                                 dict(stats_partitioning="shard_map",
                                      chunk_size=510)])
def test_shard_map_refusal_is_the_jax_packages(cfg, problems):
    with pytest.raises(ValueError, match="stats_partitioning='shard_map' "
                       "needs a multi-device mesh, solver_method "
                       "eigh/cholesky, no eloc_clip/is_gamma"):
        _tdvp(problems, _ctx(4), **cfg)
    with pytest.raises(ValueError, match="needs a multi-device mesh"):
        _tdvp(problems, ParallelCtx.single_device(),
              stats_partitioning="shard_map")


def test_syrk_refused_on_a_mesh(problems):
    with pytest.raises(ValueError, match="gram_backend='syrk' is a "
                       "single-device kernel"):
        _tdvp(problems, _ctx(2), gram_backend="syrk")


def test_tri2_under_gspmd_is_the_jax_packages_refusal(problems):
    """gram_backend='tri2' on a mesh whose statistics are not shard_map
    raises the JAX package's ValueError (tdvp.py:751-758)."""
    for cfg in (dict(stats_partitioning="gspmd"), dict(eloc_clip=2.0)):
        with pytest.raises(ValueError, match=(
                "gram_backend='tri2' on a multi-device mesh needs the "
                "shard_map stats path")):
            _tdvp(problems, _ctx(2, 2), gram_backend="tri2", **cfg)
    assert _tdvp(problems, _ctx(2, 2), gram_backend="tri2")._stats_shardmap


def test_auto_keeps_gspmd_at_tp2_above_16384_params():
    """At tp > 1 and P > 16384 the JAX package's auto keeps its GSPMD
    tp-row-sharded Gram, and so does the port: samples over dp (the
    view's world is 2), rank 3's Gram rows the second half."""
    cfg = preset("fokkerPlanck32", depth=8)
    flow, theta = build_flow(1, 32, depth=8, hidden=cfg.hidden_resolved(),
                             variant="affine", dtype=torch.float32)
    P = flow.layout.size
    assert P > 16384
    spec = worker.spec_of(flow, cfg.equation, cfg.equation_params)
    ctx = ParallelCtx(dp=2, tp=2, rank=3, device=torch.device("cpu"))
    tdvp = worker.tdvp_on(ctx, spec, theta.numpy(), "tpu", 2048, {})
    assert tdvp._gspmd and not tdvp._stats_shardmap
    assert (tdvp.ctx.world, tdvp.ctx.rank) == (2, 1)
    assert tdvp.sampler.ctx is tdvp.ctx
    assert tdvp._rows == (-(-P // 2), P)
    tdvp = worker.tdvp_on(_ctx(2, 2), spec, theta.numpy(), "tpu", 2048,
                          dict(stats_partitioning="shard_map"))
    assert tdvp._stats_shardmap and tdvp._rows is None


def test_unknown_stats_partitioning(problems):
    with pytest.raises(ValueError, match="unknown stats_partitioning"):
        _tdvp(problems, _ctx(2), stats_partitioning="pmap")


@pytest.mark.parametrize("cfg,route", [
    (dict(), "shard_map"), (dict(stats_partitioning="gspmd"), "gspmd"),
    (dict(eloc_clip=2.0), "gspmd"), (dict(chunk_size=512), "shard_map")])
def test_auto_and_explicit_routes(cfg, route, problems):
    tdvp = _tdvp(problems, _ctx(2), precision="f64", **cfg)
    assert tdvp._stats_shardmap == (route == "shard_map")
    assert tdvp._gspmd == (route == "gspmd")


def test_gspmd_runs_the_sharded_per_sample_wrapper(problems):
    """The GSPMD counterpart takes per_sample_sharded (the kernel's path on
    the card); shard_map the per-rank plain-mode wrapper."""
    g = _tdvp(problems, _ctx(2), stats_partitioning="gspmd",
              per_sample_backend="cuda")
    assert g._per_sample.func is persample.per_sample_sharded
    s = _tdvp(problems, _ctx(2), per_sample_backend="cuda")
    assert s._per_sample is persample.per_sample


def test_per_sample_sharded_checks_the_global_count(problems):
    flow = problems["flow"]
    x = torch.zeros((8, 4), dtype=torch.float64)
    out = persample.per_sample_sharded(_ctx(4), flow, problems["theta"], x)
    assert out[3].shape == (8, flow.layout.size)
    for n_global in (30, 64):
        with pytest.raises(ValueError, match="does not shard over 4"):
            persample.per_sample_sharded(_ctx(4), flow, problems["theta"],
                                         x, n_global=n_global)


def test_metropolis_sharded_refuses_shards_off_128():
    init = torch.full((64, 2), 0.25)
    with pytest.raises(ValueError, match="128"):
        metropolis.metropolis_chain_sharded(_ctx(4), 5, init, 8, 0.25,
                                            (0.25, 0.25))


def test_mesh_rules():
    assert MeshConfig(-1, 2).resolve(4) == (2, 2)
    with pytest.raises(ValueError, match="needs 6 ranks"):
        MeshConfig(3, 2).resolve(4)
    ctx = ParallelCtx(dp=2, tp=2, rank=3)
    assert ctx.world == 4 and (ctx.dp, ctx.tp) == (2, 2)
    assert ctx.shard_samples(1001) == 1004
    assert ctx.shard_samples(1000, multiple_of=30) == 1020
    np.testing.assert_array_equal(ctx.local_rows(np.arange(8)), [6, 7])
    with pytest.raises(ValueError, match="do not shard"):
        ctx.local_rows(np.arange(6))
    one = ParallelCtx.single_device()
    assert one.world == 1 and mesh.is_coordinator()
    t = torch.arange(3.0)
    assert mesh.all_reduce_sum(one, [t, None])[0] is t
    assert mesh.all_gather_rows(one, t) is t


def test_mesh_rounds_chains_and_budgets(problems):
    """30 chains on 4 ranks become 32, and budgets round to lcm(world,
    chains); the kernel's gate is 128 chains per rank."""
    spec = problems["spec"]["fluid"]
    info = {"offset": np.asarray(spec["offset"]), "bound": 0.25}
    from vmc_pde_torch.sampling.sampler import Sampler

    s = Sampler(2, "cos_dist", n_chains=30, mcmc_info=info, ctx=_ctx(4))
    assert s.n_chains == 32 and s.local_chains == 8
    assert s.rounded_budget(1000) == 1024
    assert not s._kernel_target()
    assert Sampler(2, "cos_dist", n_chains=512, mcmc_info=info,
                   ctx=_ctx(4))._kernel_target()
    assert not Sampler(2, "cos_dist", n_chains=256, mcmc_info=info,
                       ctx=_ctx(4))._kernel_target()
