"""The port's GSPMD statistics on a dp x tp mesh, its chunked GSPMD
statistics, and cg, minSR, the host solve and the default/f64/f64acc
Gram precisions on a mesh (parallel/mesh.py, solver/tdvp.py), on the
CPU: one group of 4 rank processes and one of 2 over gloo
(tests/torch_mesh_worker.py's "mesh_gspmd" scenario, which imports
nothing of JAX), on the d=4, N=2048 problem of tests/test_torch_mesh.py
(theta carried across by models/convert, x seeded with numpy).

- Against the JAX package's GSPMD programs on the 8-device virtual CPU
  mesh, at its own mesh tests' bars (tests/test_parallel.py:132-145: S0
  and A to 5e-5 of max |S|, F0 to rtol 1e-4 and atol 1e-7; f32 sums in
  another order, and int8 cross terms with the same global column
  scales; f64 to 1e-10 of the largest value, the two packages' f64
  per-sample pipelines differing at 1e-15): the direct statistics with
  the tp-row-sharded f32 Gram, with the sym2 + int8 Gram, and with
  eloc_clip in f64, all on dp=2 x tp=2; the chunked sym2 + int8
  statistics with chunks inside a rank (dp=2, chunks of 512) and
  spanning ranks (dp=4, chunks of 1024); minSR on dp=2
  (tests/test_tdvp.py:910-927's bar, rtol 1e-7 and atol 1e-10, f64).
- Against the port's one rank on the same draws: cg, minSR streaming
  (chunks inside and across ranks), the host solve (eigh, cholesky), the
  tp-row Gram at P % tp != 0 (dp=1 x tp=4, P=150), the f64 cases to 1e-12
  of the largest value (cg to 1e-10: 76 Krylov iterations); the f32
  statistics (sym2 + int8 on chunks that start mid-rank, f64, default and
  f64acc on the shard_map and the GSPMD route) to F32_BAR.
- The layout: at dp2 x tp2 under GSPMD each (P, P) moment crosses the dp
  group as a (ceil(P/2), P) block, and no collective carries N P values.
- Every rank holds the same bits after each reduction and solve.

Each group of ranks has its own time limit, so that a hang fails its
tests instead of eating the suite's limit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import torch_mesh_worker as worker
from test_torch_models import normal, parity_flow, rel_err
from vmc_pde_torch.parallel import mesh
from vmc_pde_torch.parallel.mesh import ParallelCtx
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
CASES = {c[0]: c for c in worker.MESH4_CASES + worker.MESH2_CASES}
# The f32-fed statistics against one rank, relative to the largest value:
# the f32 per-sample rows come out of batches of another size (512 or
# 1024 rows against 2048; torch's CPU kernels round them a few ulps
# apart) and the f32 sums run in another order. Measured: up to 6.1e-7
# (the chunks of 768 that start mid-rank), 1.2e-8 with f64 sums.
F32_BAR = 2e-6
F64_SUMS_BAR = 1e-7


@pytest.fixture(scope="module")
def problems():
    """The d=4 Gauss flow made by the JAX package and carried into the
    port, the x batches (f32 and f64; 2304 rows for the chunks of 768)."""
    jflow, jparams, flow, theta = parity_flow("affine", dim=4, seed=21,
                                              out_scale=0.05)
    params = flow.layout.unravel(theta)
    x64 = flow.push(params, torch.as_tensor(normal((N, 4), 51)))[0]
    x_mixed = flow.push(params, torch.as_tensor(normal((2304, 4), 54)))[0]
    inputs = {"theta": theta.numpy(), "x": x64.float().numpy(),
              "x64": x64.numpy(),
              "x/chunked_mixed": x_mixed.float().numpy()}
    return dict(jflow=jflow, jparams=jparams, P=flow.layout.size,
                spec={"gauss": worker.spec_of(flow, *EQ)}, inputs=inputs)


@pytest.fixture(scope="module")
def started(problems, tmp_path_factory):
    """Both groups of ranks, started: the references below are computed
    while they run."""
    return {world: worker.start_ranks(
        "mesh_gspmd", world, str(tmp_path_factory.mktemp(f"mg{world}")),
        problems["spec"], problems["inputs"], timeout=150)
        for world in (4, 2)}


@pytest.fixture(scope="module")
def mesh4(started, jax_ref, one_rank):
    return started[4]()


@pytest.fixture(scope="module")
def mesh2(started, jax_ref, one_rank):
    return started[2]()


@pytest.fixture(scope="module")
def one_rank(problems, started):
    """Every case on the port's one rank (GSPMD is a mesh's route: one
    rank runs the single-device statistics whatever the partitioning)."""
    out = {}
    for label, _, precision, cfg, kind in CASES.values():
        cfg = {k: v for k, v in cfg.items() if k != "stats_partitioning"}
        for k, v in worker.mesh_case(ParallelCtx.single_device(),
                                     problems["spec"], problems["inputs"],
                                     label, precision, cfg, kind).items():
            out[f"{label}/{k}"] = v
    return out


def _np(a):
    return np.asarray(a, dtype=np.float64)


@pytest.fixture(scope="module")
def jax_ref(problems, started):
    """The JAX package's GSPMD programs on its virtual mesh: the direct
    statistics on dp=2 x tp=2, the chunked ones on dp=4 and dp=2, minSR's
    RHS on dp=2."""
    inp = problems["inputs"]
    meshes = {(2, 2): JParallelCtx.create(dp=2, tp=2),
              (4, 1): JParallelCtx.create(dp=4),
              (2, 1): JParallelCtx.create(dp=2)}
    out = {}
    for label in ("f32", "sym2_int8", "clip", "chunked_span",
                  "chunked_inside", "minsr"):
        _, mshape, precision, cfg, kind = CASES[label]
        ctx = meshes[mshape]
        jprec = jresolve(precision)
        jparams = jax.tree.map(lambda a: a.astype(jprec.compute),
                               problems["jparams"])
        x = inp["x64" if precision == "f64" else "x"]
        if kind == "minsr":
            x = x[:worker.MINSR_N]
        st = JVarState(problems["jflow"], jparams, ctx=ctx, precision=jprec,
                       sampler=JSampler(dim=4, ctx=ctx, dtype=jprec.compute))
        tdvp = JTDVP(st, jevolution.make_equation(EQ[0], 4, **EQ[1]),
                     JTDVPConfig(**dict(cfg, compute_snr=True)),
                     n_samples=x.shape[0], n_samples_obs=x.shape[0],
                     precision=jprec)
        assert not tdvp._stats_shardmap
        theta_c = ravel_pytree(jparams)[0]
        xs = jax.device_put(jnp.asarray(x, jprec.compute),
                            ctx.sharding(ctx.samples_spec))
        if kind == "minsr":
            n = x.shape[0]
            aux = jax.jit(lambda th, xx: tdvp._rhs_minsr(
                th, 0.25, xx, tdvp._unravel(th), jax.random.PRNGKey(1),
                jax.random.PRNGKey(2), None, n, n, with_obs=False))(
                    theta_c, xs)
            out[label] = {k: _np(aux[k]) for k in ("update", "ev")}
            continue
        fn = (tdvp._chunked_stats if "chunk_size" in cfg
              else tdvp._direct_stats)
        res = jax.jit(lambda th, xx: fn(th, 0.25, xx))(theta_c, xs)
        out[label] = {k: _np(res[k]) for k in ("S0", "F0", "A")}
    return out


def _run(label, mesh4, mesh2):
    return mesh2 if CASES[label] in worker.MESH2_CASES else mesh4


# -- against the JAX package ------------------------------------------------

@pytest.mark.parametrize("label", ["f32", "sym2_int8", "chunked_span",
                                   "chunked_inside"])
def test_gspmd_stats_match_jax(label, mesh4, mesh2, jax_ref):
    """The tp-row-sharded direct statistics (f32 and sym2 + int8 Gram) on
    dp=2 x tp=2, and the chunked sym2 + int8 statistics with chunks
    spanning ranks (dp=4, 1024) and inside a rank (dp=2, 512), against the
    JAX package's GSPMD statistics on the same mesh shape, theta and x."""
    got, ref = _run(label, mesh4, mesh2)[0], jax_ref[label]
    for k in ("S0", "A"):
        np.testing.assert_allclose(got[f"{label}/{k}"], ref[k], rtol=0,
                                   atol=5e-5 * np.abs(ref[k]).max(),
                                   err_msg=f"{label} {k}")
    np.testing.assert_allclose(got[f"{label}/F0"], ref["F0"], rtol=1e-4,
                               atol=1e-7, err_msg=f"{label} F0")


def test_gspmd_clip_f64_matches_jax(mesh4, jax_ref):
    """eloc_clip (the global median and MAD) at dp=2 x tp=2 in f64."""
    for k, ref in jax_ref["clip"].items():
        assert rel_err(mesh4[0][f"clip/{k}"], ref) < 1e-10, k


def test_minsr_on_two_ranks_matches_jax(mesh2, jax_ref):
    """minSR direct on 2 ranks (every rank's O rows gathered, the N x N
    kernel solved on each) against the JAX package's on its dp=2 mesh."""
    ref = jax_ref["minsr"]
    for out in mesh2:
        np.testing.assert_allclose(out["minsr/update"], ref["update"],
                                   rtol=1e-7, atol=1e-10)
        np.testing.assert_allclose(out["minsr/ev"][-8:], ref["ev"][-8:],
                                   rtol=1e-9)


# -- against the port's one rank --------------------------------------------

F64_CASES = {"clip": 1e-12, "tp4": 1e-12, "cg": 1e-10, "cg_tp": 1e-10,
             "minsr_stream": 1e-12, "minsr_stream_span": 1e-12,
             "host_eigh": 1e-12, "host_cholesky": 1e-12, "minsr": 1e-12}


@pytest.mark.parametrize("label", sorted(F64_CASES))
def test_f64_mesh_matches_one_rank(label, mesh4, mesh2, one_rank):
    """The f64 cases against one rank on the same draws: the statistics
    of eloc_clip at dp2 x tp2 and of the tp-row Gram at P % tp != 0
    (dp=1 x tp=4, rows 38, 38, 38, 36 of P=150); the updates and
    diagnostics of cg (every matvec one all-reduce), minSR streaming
    (chunks of 64 inside the ranks' rows, and of 192 across them), the
    host solve (the coordinator's, broadcast) and minSR direct."""
    got = _run(label, mesh4, mesh2)[0]
    keys = [k for k in one_rank if k.startswith(f"{label}/")]
    assert keys
    for key in keys:
        if key.endswith("/iters"):
            assert got[key] == one_rank[key]
            assert (got[key] > 0) == label.startswith("cg")
            continue
        if key.endswith("/solver_res"):
            # a residual near the f64 floor: its own scale
            assert abs(got[key] - one_rank[key]) < 1e-12 + 1e-4 * abs(
                one_rank[key]), key
            continue
        assert rel_err(got[key], one_rank[key]) < F64_CASES[label], key


@pytest.mark.parametrize("label", ["f32", "sym2_int8", "chunked_span",
                                   "chunked_mixed", "chunked_inside",
                                   "default_gspmd", "default_shardmap"])
def test_f32_stats_match_one_rank(label, mesh4, mesh2, one_rank):
    """The f32 statistics against one rank on the same x, to F32_BAR (on
    the CPU "default" contracts as the f32 product does)."""
    got = _run(label, mesh4, mesh2)[0]
    for k in ("S0", "F0", "A", "eloc_mean", "eloc_var"):
        key = f"{label}/{k}"
        assert rel_err(got[key], one_rank[key]) < F32_BAR, key


@pytest.mark.parametrize("label", ["f64_gspmd", "f64_shardmap",
                                   "f64acc_gspmd", "f64acc_shardmap"])
def test_f64_sums_match_one_rank(label, mesh4, one_rank):
    """gram_precision f64 (f64 operands) and f64acc (the f32 products of
    the chunks of 512, accumulated in f64) on f32 per-sample rows, on the
    GSPMD route at dp2 x tp2 and on the shard_map route at dp=4: their f64
    moments reduce in f64 beside the f32 E_loc variance (one buffer per
    dtype). f64 lies within F64_SUMS_BAR of one rank's (the f32 rows'
    ulps alone); f64acc within F32_BAR (on the shard_map route a rank's
    chunk is 128 rows, so its f32 products differ from one rank's)."""
    bar = F64_SUMS_BAR if label.startswith("f64_") else F32_BAR
    for k in ("S0", "F0", "A"):
        key = f"{label}/{k}"
        assert mesh4[0][key].dtype == np.float64
        assert rel_err(mesh4[0][key], one_rank[key]) < bar, key


@pytest.mark.parametrize("label", ["rhs_chunked_gspmd", "rhs_default",
                                   "rhs_f64", "rhs_f64acc"])
def test_f32_rhs_runs_on_the_mesh(label, mesh4, one_rank):
    """A whole f32 RHS of the chunked GSPMD statistics (dp2 x tp2) and of
    the default, f64 and f64acc precisions at svd_tol 1e-2: finite, its
    residual within 1% of one rank's and its update within 1e-4 of the
    largest element (f32 statistics to F32_BAR, through an f32 solve at
    condition ~1e2)."""
    got = mesh4[0]
    assert np.isfinite(got[f"{label}/update"]).all()
    assert rel_err(got[f"{label}/solver_res"],
                   one_rank[f"{label}/solver_res"]) < 1e-2
    assert rel_err(got[f"{label}/update"], one_rank[f"{label}/update"]) \
        < 1e-4


@pytest.mark.parametrize("group", ["mesh4", "mesh2"])
def test_every_rank_holds_the_same_bits(group, request):
    """After each reduction and solve every rank holds the same bits: the
    moments, and the updates (theta stays bitwise equal across ranks)."""
    ranks = request.getfixturevalue(group)
    for key, v in ranks[0].items():
        if not key.startswith("layout/"):
            for out in ranks[1:]:
                np.testing.assert_array_equal(out[key], v, err_msg=key)


# -- the layout ------------------------------------------------------------

def test_gram_rows_cross_the_dp_group_no_O_gather(mesh4, problems):
    """The counterpart of tests/test_parallel.py:156-205 at dp2 x tp2
    under GSPMD: in the direct statistics every (P, P) moment (S0, A)
    crosses the dp group as a (ceil(P/2), P) block beside F0 in ONE
    reduction, the blocks are gathered over the tp group, no (P, P)
    matrix crosses the dp group or every rank, and over the statistics
    and a whole RHS no collective carries N P values."""
    P, b = problems["P"], -(-problems["P"] // 2)
    for out in mesh4:
        calls = json.loads(str(out["layout/stats"]))
        blocks = [c for c in calls if c[0] == "all_reduce_sum"
                  and [b, P] in c[2]]
        assert len(blocks) == 1
        name, group, shapes = blocks[0]
        assert group == "dp" and shapes.count([b, P]) == 2 and [P] in shapes
        gathers = [c for c in calls if c[0] == "all_gather_rows"]
        assert gathers == [["all_gather_rows", "tp", [[b, 2, P]]]]
        assert not any([P, P] in c[2] for c in calls)
        raw = json.loads(str(out["layout/raw"]))
        assert len(raw) > int(out["layout/n_stats_raw"]) > 0
        assert max(numel for _, numel in raw) < N * P


def test_mesh_axes_and_row_blocks():
    """Rank r is (r // tp, r % tp); its sample view is the dp-only mesh of
    its dp index; the tp row blocks are ceil(P / tp) rows, the last one
    shorter; one rank's views are itself."""
    ctx = ParallelCtx(dp=2, tp=2, rank=3)
    assert (ctx.dp_index, ctx.tp_index) == (1, 1)
    view = ctx.samples_over_dp()
    assert (view.world, view.rank, view.group) == (2, 1, ("dp", 2, 2, 1))
    assert ctx.over_tp().rank == 1 and ctx.over_tp().world == 2
    assert ctx.row_block(150) == (75, 150)
    assert [ParallelCtx(dp=1, tp=4, rank=r).row_block(150)
            for r in range(4)] == [(0, 38), (38, 76), (76, 114), (114, 150)]
    np.testing.assert_array_equal(view.local_rows(np.arange(8)),
                                  [4, 5, 6, 7])
    one = ParallelCtx.single_device()
    assert one.samples_over_dp() is one and one.row_block(7) == (0, 7)
    # the CUDA kernel's O rows are a transposed view; a broadcast sends the
    # storage as it lies, so it takes contiguous tensors only
    with pytest.raises(ValueError, match="contiguous"):
        mesh.broadcast(view, torch.zeros((3, 4)).T, 0)
