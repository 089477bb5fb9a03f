"""Per-sample statistics of the flow: logp, coordinate score g, Hessian
quadratic trace and the O row, for a batch of samples.

``per_sample_cuda`` launches the hand-written CUDA kernel in
csrc/persample.cu. It replaces the TPU kernel
vmc_pde_tpu/kernels/persample.py::make_per_sample_pallas in plain mode
(f32 O), and computes the same mathematics as its reference functions
``_forward``, ``_backward`` and ``_tile_quad_jet``, for the Gauss and the
Student-t latent and every coupling variant with or without the learned
global affine. Student-t's three theta-only scalars [nu, c0, dg] (the TPU
wrapper's ``student_t_consts``) are computed here on the device, with
``torch.lgamma``/``torch.digamma``, and handed in with the other
constants: no host synchronization, no special functions in the kernel.
``per_sample_plain``
is the torch.func pipeline of ops/score.py with the same signature.
``per_sample`` takes the plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises.

``per_sample_split_cuda`` launches the same kernel in split mode, which
replaces ``make_per_sample_pallas(emit_split=True)``: for a shift vector
it returns the bf16 hi/lo pair of O - shift, its column sums and its
column max |O - shift| instead of the f32 O (the chunked statistics' tri2
and sym2 Gram operands, solver/tdvp.py). ``per_sample_split_plain`` is the
plain pipeline followed by parallel/stats._split_bf16, and
``per_sample_split`` dispatches as ``per_sample`` does. Each CUDA wrapper
counts its launches (``.launches``).

``per_sample_sharded`` replaces the shard_map wrapper
vmc_pde_tpu/kernels/persample.py::make_per_sample_sharded: on a mesh
(parallel/mesh.py) it is the rank's launch of the plain-mode kernel on its
N/W rows, and the plain version for a CPU shard. The TPU wrapper needs N
to divide dp * tile; the CUDA kernel masks ragged tiles, so the world
alone is the rule.

What bounds the kernel on the card: at the fokkerPlanck32 shape (P =
9264, 16 trace directions, N = 16384) the (P, N) f32 O store, 607 MB per
right-hand side (0.18 ms at the H100's 3.35 TB/s), and about 10.4 GFLOP of
f32 work, 90% of it the 16 second-order jets (0.155 ms at the 67 TFLOP/s
FFMA peak): a balanced bound. The design (csrc/persample.cu says more):

- one block per tile of T samples (``tile_plan``: the largest T of 32, 16
  and 8 whose shared memory fits and whose grid still covers the SMs), so
  the pilot's 2048 rows and a rank's 4096 already fill the card. A block's
  regions -- theta, the constants (W^T, the directions, ...), the tile's
  forward saves, W^T y and quad terms, the backward's rows and the jets'
  tangents -- sit in shared memory where they fit (the plan's ``where``,
  ``smem_floats`` counts them), else theta and the constants are read from
  global memory and the rest from the block's slice of a global workspace;
  a launch with a workspace runs WS_BLOCKS_PER_SM blocks per SM, each
  taking every grid-th tile, so any flow has a plan;
- the block plan is one variable-length record per block (``block_plan``,
  with the records' starts after its header), so no dim, half, width or
  depth is bounded by a record size;
- forward and backward over (sample, unit) items, the jets one (sample,
  direction) pair per thread with each layer's activations in registers
  (``register_width``: every layer and half at most 16 wide; wider flows
  take the chunked body: a layer's outputs in chunks of 16 in registers,
  its input tangents in the work rows) and each weight row read as
  16-byte broadcast loads from a repacked theta (``kernel_layout``:
  layers zero-padded to 16 x 16 at that width, rows 16-byte aligned);
  the sum over directions in a fixed order;
- O written FEATURE-MAJOR (P, N) in 16-byte streaming stores along the
  sample axis; the wrapper returns the ``.T`` view, which
  ``torch.matmul`` consumes without a copy;
- W = U^{-1} depends on theta only: the wrapper computes it once per
  launch with ``torch.linalg.solve_triangular``; the flow's constants are
  made on the device once (``_device_plan``), so a launch copies nothing
  from the host;
- the ragged tail is masked (its lanes run the last sample and store
  nothing), so any N runs -- the TPU wrapper needs N % tile == 0;
- split mode: each row's T values reduce in a fixed order into the
  block's (grid, P) partials, its tiles in order, which a second small
  kernel sums in block order (deterministic, no atomics); the grid is cut
  to keep the partials within SPLIT_PART_BYTES. Its bound at the chunked
  path's shape (P = 9264, N = 65536) is the 2.43 GB pair store, ~0.73 ms.

Measured on an H100 (PERF.md, section 6): 1.04-1.05 ms of kernel time at N =
16384 (17% of the bound), 5.1-5.4 ms split at N = 65536 (13-14%), 0.16 ms
for the pilot's 2048 rows; the jets, limited by shared-memory bandwidth
for their broadcast weights, take ~62% of it, and the O stores, which
overlap the arithmetic, under 1% (tools/persample_probe.py).

The TPU layout tricks are not carried over: no bf16 hi/lo split matmuls
(f32 FMAs: the weights broadcast from shared memory, so each FMA needs no
load of its own), no 0/1 selection matrices (direct indexing), no fused
(s, t) conditioner pair, no outer-product relayouts.

Scope (``supports``): the JAX kernel's -- Gauss or Student-t latent, any
coupling variant, the global affine allowed, trace-mode Hessians, any
dim, coupling half, conditioner width and depth, any number of coupling
blocks (SanityFlow's none: the latent behind its learned scale) -- in
f32.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import latent
from ..ops import score
from ..parallel import stats
from ..utils.dtypes import device_constant

# Block-plan format and launch constants shared with csrc/persample.cu
# (same names there; tests/test_torch_persample.py checks them).
HDR = 20
BLOCK_HDR = 12
LAYER_REC = 8
MAX_THREADS = 256
N_SCRATCH = 8
N_PER_SAMPLE = 5
NETS = ("s1", "s2", "t1", "t2")
VARIANT_CODES = {"additive": 0, "affine": 1, "scale": 2, "scale_shift": 3}
LATENT_CODES = {"Gauss": 0, "Student_t": 1}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
TILES = (32, 16, 8)  # samples per block, largest first
REGISTER_WIDTH = 16  # the jets' register arrays (template MW; 0: chunked)
H100_SMS = 132
# A block's regions that may sit in shared or in global memory, by their
# bit in a plan's ``where`` (set: in shared memory): the repacked theta
# and the constants (else read from their inputs), the tile's arrays (its
# saves, W^T y and quad terms) and the work rows (the backward's rows and
# the jets' tangents; else in a per-block slice of a global workspace).
TH, FC, TILE, WORK = 1, 2, 4, 8
ALL = TH | FC | TILE | WORK
WS_BLOCKS_PER_SM = 2  # blocks per SM of a launch with a workspace
SPLIT_PART_BYTES = 1 << 28  # split mode's (grid, P) sum and max partials


class Plan(NamedTuple):
    """The shape of one launch (``tile_plan``)."""
    T: int        # samples per tile
    threads: int  # per block
    J: int        # jet slots: (sample, direction) pairs at a time
    MW: int       # the jets' register width (0: the chunked body)
    where: int    # the regions in shared memory (bits TH, FC, TILE, WORK)
    smem: int     # shared bytes of a block
    ws: int       # floats of a block's slice of the global workspace
    grid: int     # blocks; block b runs tiles b, b + grid, b + 2 grid, ...


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _widest(flow) -> int:
    """The widest conditioner layer or coupling half of the flow (0
    without coupling blocks)."""
    return max((max(spec.hidden + (len(spec.ind_up), len(spec.ind_down)))
                for spec in flow.blocks), default=0)


def jet_buffer(flow) -> int:
    """Floats per jet slot of the chunked body's layer buffers: the
    tangent pair of the widest hidden layer, twice when a conditioner
    has two hidden layers or more (one buffer is read while the other is
    written)."""
    hid = [spec.hidden for spec in flow.blocks if spec.hidden]
    if not hid:
        return 0
    return 2 * max(max(h) for h in hid) * min(2, max(map(len, hid)))


def register_width(flow) -> int:
    """MW, the kernel's template width: REGISTER_WIDTH when every
    conditioner layer and half fits the jets' register arrays, else 0 (the
    chunked jet body: a layer's outputs in chunks of REGISTER_WIDTH, its
    input tangents in the work rows)."""
    return (REGISTER_WIDTH if flow.blocks and _widest(flow) <= REGISTER_WIDTH
            else 0)


def kernel_layout(flow):
    """The theta the kernel reads, repacked: for every block, net and
    layer the bias (padded to 4 floats) and the weights with each row
    padded to a multiple of 4 (16-byte aligned, so the jets read a row as
    float4s) -- for a flow of the register width, every layer padded with
    zeros to MW x MW, so that the jets' body needs no bounds; then every
    global affine's g_scale and g_offset, then the latent's mu and L_diag
    (and SanityFlow's scale). Returns (index (Pk,) int64 into theta, with
    P for the zero padding; {(block, net, layer): (bias, weights, row
    stride)} and {(block, "g"): (g_scale, g_offset)} offsets; offset of
    mu; of L_diag; of the scale, -1 without one)."""
    lay = flow.layout
    MW = register_width(flow)
    pad = lay.size
    idx = []
    table = {}

    def put(flat, rows, cols, stride=None, n_rows=None):
        """rows x cols of theta from ``flat`` on, each row padded to
        ``stride`` (default: cols to 4), ``n_rows`` rows in all."""
        start = len(idx)
        stride = stride or _up(cols, 4)
        for r in range(rows):
            idx.extend(range(flat + r * cols, flat + (r + 1) * cols))
            idx.extend([pad] * (stride - cols))
        idx.extend([pad] * (stride * ((n_rows or rows) - rows)))
        idx.extend([pad] * (_up(len(idx), 4) - len(idx)))
        return start

    for b, spec in enumerate(flow.blocks):
        for net in spec.nets:
            n_in, n_out = spec.net_dims(net)
            dims = [n_in, *spec.hidden, n_out]
            for layer in range(len(dims) - 1):
                stride = MW or _up(dims[layer + 1], 4)
                table[b, net, layer] = (
                    put(lay.offset(("blocks", b, net, "b", layer)), 1,
                        dims[layer + 1]),
                    put(lay.offset(("blocks", b, net, "w", layer)),
                        dims[layer], dims[layer + 1], stride, MW or None),
                    stride)
        if spec.global_affine:
            table[b, "g"] = (
                put(lay.offset(("blocks", b, "g_scale")), 1, 1),
                put(lay.offset(("blocks", b, "g_offset")), 1, flow.dim))
    mu = put(lay.offset(("latent", "mu")), 1, flow.dim)
    ld = put(lay.offset(("latent", "L_diag")), 1, flow.dim)
    scale = (put(lay.offset(("scale",)), 1, 1) if "scale" in lay.shapes
             else -1)
    return np.asarray(idx, dtype=np.int64), table, mu, ld, scale


def _n_fconst(flow, n_dirs: int) -> int:
    """Length of the kernel's f32 constants: W^T with rows padded to 8,
    the offset, the directions, the alphas and Student-t's three."""
    d = flow.dim
    return (d * _up(d, 8) + d + n_dirs * d + len(flow.blocks)
            + 3 * (flow.latent_name == "Student_t"))


def region_floats(Pk, n_fconst, n_meta, n_saves, d, k, T, J, SW, JB):
    """Floats of each region of one block (csrc/persample.cu
    block_layout): theta, the constants and the plan (each padded to 4),
    the N_PER_SAMPLE per-sample scalars; ``tile``: the tile's saves, the
    (d, T) W^T y and the (k, T) quad terms; ``work``: one region that the
    backward's four (d, T) rows and N_SCRATCH (SW, T) rows (SW: the widest
    layer or half) share with the jets' (2 d + JB, J) tangents and layer
    buffers (never live together)."""
    back = 4 * d * T + N_SCRATCH * SW * T
    jet = (2 * d + JB) * J if k else 0
    return {"th": _up(Pk, 4), "fc": _up(n_fconst, 4), "meta": _up(n_meta, 4),
            "ps": N_PER_SAMPLE * T, "tile": (n_saves + d + k) * T,
            "work": _up(max(back, jet), 4)}


def smem_floats(Pk, n_fconst, n_meta, n_saves, d, k, T, J, SW, JB=0,
                where=ALL):
    """(shared floats, workspace floats) of one block: the regions whose
    bit is set in ``where`` in shared memory, the plan and the per-sample
    scalars always; the tile's arrays and the work rows, where not shared,
    in the block's slice of the workspace; theta and the constants, where
    not shared, are read from their inputs."""
    r = region_floats(Pk, n_fconst, n_meta, n_saves, d, k, T, J, SW, JB)
    shared = (r["th"] * bool(where & TH) + r["fc"] * bool(where & FC)
              + r["meta"] + r["ps"] + r["tile"] * bool(where & TILE)
              + r["work"] * bool(where & WORK))
    return shared, (r["tile"] * (not where & TILE)
                    + r["work"] * (not where & WORK))


# The placements a plan may take, best first (tools/persample_plans.py):
# every region in shared memory (the register width needs it); else the
# constants out of it (read through L1, whose share of the SM's memory
# they would shrink), and of the other three the tile's arrays, then
# theta, then the work rows kept in shared memory first.
PLACEMENTS = (ALL, TILE | TH | WORK, TILE | TH, TILE | WORK, TILE,
              TH | WORK, TH, WORK, 0)


def candidates(flow, n_dirs: int) -> list:
    """Every launch shape that fits, as Plans without their grid (0): for
    each placement of PLACEMENTS (the register width MW only at ALL, and
    ALL only with it) and tile T of TILES (256 threads, 128 at T = 8), the
    most jet slots J (at most the threads and the T k pairs) that fit
    SMEM_LIMIT."""
    meta, n_sv = block_plan(flow, n_dirs)
    Pk, SW, JB, d = int(meta[11]), int(meta[14]), int(meta[15]), flow.dim
    nf = _n_fconst(flow, n_dirs)
    MW = register_width(flow)
    fits = []
    for where in PLACEMENTS[0 if MW else 1:]:
        for T in TILES:
            threads = MAX_THREADS if T >= 16 else MAX_THREADS // 2
            full = min(threads, T * n_dirs)
            for J in ((full, full // 2, full // 4, min(full, 32))
                      if n_dirs else (0,)):
                sh, ws = smem_floats(Pk, nf, meta.size, n_sv, d, n_dirs, T,
                                     J, SW, 0 if where == ALL else JB, where)
                if 4 * sh <= SMEM_LIMIT:
                    fits.append(Plan(T, threads, J, MW * (where == ALL),
                                     where, 4 * sh, ws, 0))
                    break
    return fits


def grid_of(plan: Plan, flow, n: int, n_sm: int = H100_SMS,
            split: bool = False) -> Plan:
    """``plan`` with its grid for n samples: one block per tile,
    WS_BLOCKS_PER_SM per SM with a workspace, and in ``split`` mode at most
    what keeps the (grid, P) partials within SPLIT_PART_BYTES (at least
    one block per SM)."""
    grid = -(-n // plan.T)
    if plan.ws:
        grid = min(grid, WS_BLOCKS_PER_SM * n_sm)
    if split:
        grid = min(grid, max(n_sm, SPLIT_PART_BYTES // (8 * flow.layout.size)))
    return plan._replace(grid=grid)


@functools.lru_cache(maxsize=256)
def tile_plan(flow, n_dirs: int, n: int, n_sm: int = H100_SMS,
              split: bool = False) -> Plan:
    """The Plan of a launch on n samples, of the ``candidates``: preferred,
    in order, the register width; a grid that covers the ``n_sm`` SMs, and
    then the most jet slots, the earlier placement, the most threads and
    the largest T at the register width, the smallest in the chunked body
    (whose constants, read from global memory there, keep more of L1;
    tools/persample_plans.py) -- or, where no grid
    covers them, the smallest T, then the slots and the placement. Its
    grid: ``grid_of``."""
    fits = candidates(flow, n_dirs)
    if not fits:  # the plan alone overflows: no flow of a sane size
        raise ValueError("the per-sample kernel's block plan does not fit "
                         "shared memory")

    def rank(f):
        place = -PLACEMENTS.index(f.where)
        if -(-n // f.T) >= n_sm:
            return (f.MW, True, f.J, place, f.threads,
                    f.T if f.MW else -f.T)
        return (f.MW, False, -f.T, f.J, place)

    return grid_of(max(fits, key=rank), flow, n, n_sm, split)


def supports(flow, hess_dirs: Optional[np.ndarray], hess_idx) -> bool:
    """Static capability check for the CUDA kernel: the JAX kernel's
    (vmc_pde_tpu/kernels/persample.py supports) -- a Gauss or Student-t
    latent, trace-mode (or no) Hessians; any dim, coupling half,
    conditioner width and depth, any number of coupling blocks."""
    return (flow.latent_name in LATENT_CODES
            and (hess_idx is None or hess_dirs is not None))


def block_record(meta, b: int) -> int:
    """Where block b's record starts in the plan."""
    return int(meta[HDR + b])


def layer_record(meta, b: int, net: str, layer: int) -> np.ndarray:
    """The LAYER_REC ints of a conditioner layer of block b: in, out,
    bias and weight offsets in the flat theta (the O rows), the save
    offset of its tanh output, its bias and weight offsets and row stride
    in the repacked theta (kernel_layout)."""
    r = block_record(meta, b)
    q = r + BLOCK_HDR + (NETS.index(net) * int(meta[r + 3]) + layer) \
        * LAYER_REC
    return meta[q:q + LAYER_REC]


def halves(meta, b: int):
    """(ind_up, ind_down) of block b, from its record."""
    r = block_record(meta, b)
    n_up, n_down, nl = (int(v) for v in meta[r + 1:r + 4])
    ind = r + BLOCK_HDR + 4 * nl * LAYER_REC
    return (tuple(meta[ind:ind + n_up]),
            tuple(meta[ind + n_up:ind + n_up + n_down]))


@functools.lru_cache(maxsize=64)
def block_plan(flow, n_dirs: int):
    """(meta int32 array, n_saves): the flow's block plan in the format
    csrc/persample.cu reads, and the number of f32 saves per sample.

    meta[:HDR] = d, n_blocks, n_dirs, P, offset of latent L, of L_diag,
    of mu, n_saves, the latent's code (LATENT_CODES), offset of
    dist_params (Student-t's nu row; 0 otherwise), the widest hidden
    layer, the repacked theta's length Pk, mu's and L_diag's offsets in it
    (kernel_layout), the widest layer or half, the jet buffer's floats
    per slot (jet_buffer), SanityFlow's scale offset in theta and in the
    repacked theta (-1 without one), then zeros. meta[HDR:HDR + n_blocks]:
    where each block's record starts. A record, of variable length:
    variant, n_up, n_down, n_layers, save offsets of u1, u2 and v1, a
    global-affine flag, the offsets of g_scale and g_offset in theta and
    in the repacked theta (0 without the global affine); then for each net
    (s1, s2, t1, t2; zeros for a net the variant lacks) and layer a
    LAYER_REC (layer_record); then ind_up and ind_down. Read-only
    (cached)."""
    lay = flow.layout
    extra = set(lay.shapes) - {"latent", "blocks", "scale"}
    if extra:
        raise ValueError(f"the per-sample kernel does not know the flow's "
                         f"parameters {sorted(extra)}")
    nb = len(flow.blocks)
    kidx, ktable, mu_k, ld_k, scale_k = kernel_layout(flow)
    recs, n_sv = [], 0
    for b, spec in enumerate(flow.blocks):
        n_up, n_down = len(spec.ind_up), len(spec.ind_down)
        nl = len(spec.hidden) + 1
        rec = np.zeros(BLOCK_HDR + 4 * nl * LAYER_REC + n_up + n_down,
                       dtype=np.int32)
        rec[:4] = (VARIANT_CODES[spec.variant], n_up, n_down, nl)
        for slot, width in ((4, n_up), (5, n_down), (6, n_up)):
            rec[slot] = n_sv
            n_sv += width
        if spec.global_affine:
            rec[7] = 1
            rec[8:10] = (lay.offset(("blocks", b, "g_scale")),
                         lay.offset(("blocks", b, "g_offset")))
            rec[10:12] = ktable[b, "g"]
        for ni, net in enumerate(NETS):
            if net not in spec.nets:
                continue
            n_in, n_out = spec.net_dims(net)
            dims = [n_in, *spec.hidden, n_out]
            for layer in range(nl):
                q = BLOCK_HDR + (ni * nl + layer) * LAYER_REC
                rec[q:q + LAYER_REC] = (
                    dims[layer], dims[layer + 1],
                    lay.offset(("blocks", b, net, "b", layer)),
                    lay.offset(("blocks", b, net, "w", layer)),
                    n_sv, *ktable[b, net, layer])
                n_sv += dims[layer + 1]
        ind = BLOCK_HDR + 4 * nl * LAYER_REC
        rec[ind:ind + n_up] = spec.ind_up
        rec[ind + n_up:] = spec.ind_down
        recs.append(rec)
    meta = np.concatenate([np.zeros(HDR + nb, dtype=np.int32), *recs])
    meta[HDR:HDR + nb] = HDR + nb + np.cumsum([0] + [r.size
                                                     for r in recs[:-1]])
    student = flow.latent_name == "Student_t"
    hidden = max((max(s.hidden, default=0) for s in flow.blocks), default=0)
    meta[:18] = (flow.dim, nb, n_dirs, lay.size,
                 lay.offset(("latent", "L")),
                 lay.offset(("latent", "L_diag")),
                 lay.offset(("latent", "mu")), n_sv,
                 LATENT_CODES[flow.latent_name],
                 lay.offset(("latent", "dist_params")) if student else 0,
                 hidden, kidx.size, mu_k, ld_k, _widest(flow),
                 jet_buffer(flow),
                 lay.offset(("scale",)) if scale_k >= 0 else -1, scale_k)
    meta.setflags(write=False)
    return meta, n_sv


def per_sample_plain(flow, theta, x, dirs=None):
    """(logp (N,), g (N, d), quad (N,) or None, O (N, P)) through the
    torch.func pipeline (ops/score.py)."""
    f = score.make_flat_log_prob(flow, flow.layout.unravel)
    logp, g, O = score.batched_value_score_and_param_grad(f, theta, x)
    quad = (None if dirs is None
            else score.batched_quad_trace(f, theta, x, dirs))
    return logp, g, quad, O


@functools.lru_cache(maxsize=16)
def _device_plan(flow, n_dirs: int, dev: torch.device):
    """The launch's flow-only inputs, made once per (flow, directions,
    device) so that a launch copies nothing from the host (a copy from
    pageable host memory waits for the stream): meta and the kernel-layout
    index into theta padded with one zero on the device, meta's header on
    the host, the latent's slices of theta (_latent_slices), the offset
    and the alphas on the device, the SM count."""
    meta, _ = block_plan(flow, n_dirs)
    kidx = kernel_layout(flow)[0]
    return (torch.tensor(meta, device=dev), torch.tensor(kidx, device=dev),
            _latent_slices(flow),
            np.ascontiguousarray(meta[:HDR]),
            torch.tensor(flow.offset, dtype=torch.float32, device=dev),
            torch.tensor([s.alpha for s in flow.blocks],
                         dtype=torch.float32, device=dev),
            torch.cuda.get_device_properties(dev).multi_processor_count)


def _launch_inputs(flow, theta, x, dirs, split=False):
    """Checks the arguments of a kernel launch and builds what every
    launch passes: (x, repacked theta, fconst, meta, meta's host header,
    tile plan, the workspace, n_saves, n_dirs). Nothing here waits for
    the card."""
    n_dirs = 0 if dirs is None else int(np.shape(dirs)[0])
    d, P = flow.dim, flow.layout.size
    if flow.latent_name not in LATENT_CODES:
        raise ValueError("per-sample CUDA kernel does not support this flow "
                         "(see kernels.persample.supports)")
    if x.device.type != "cuda" or theta.device != x.device:
        raise ValueError("the per-sample CUDA kernel needs x and theta on "
                         "one CUDA device")
    if x.dtype != torch.float32 or theta.dtype != torch.float32:
        raise ValueError("the per-sample CUDA kernel is f32 only")
    if x.ndim != 2 or x.shape[1] != d or theta.shape != (P,):
        raise ValueError(f"expected x (N, {d}) and theta ({P},), got "
                         f"{tuple(x.shape)} and {tuple(theta.shape)}")
    if n_dirs and tuple(np.shape(dirs)) != (n_dirs, d):
        raise ValueError(f"expected directions (k, {d}), got "
                         f"{tuple(np.shape(dirs))}")
    if x.shape[0] == 0:
        raise ValueError("empty batch")
    dev = x.device
    x = x.contiguous()
    theta = theta.contiguous()

    meta, kidx, lat, hdr, offset, alphas, n_sm = _device_plan(flow, n_dirs,
                                                              dev)
    plan = tile_plan(flow, n_dirs, x.shape[0], n_sm, split)
    ws = theta.new_empty(plan.grid * plan.ws) if plan.ws else None
    theta_k = torch.cat([theta, theta.new_zeros(1)])[kidx]
    lat = {k: theta[a:b] for k, (a, b) in lat.items()}
    U = latent.chol_factor(lat, d)
    # W is upper triangular, its lower part exact zeros (the jets skip it)
    W = torch.linalg.solve_triangular(
        U, torch.eye(d, dtype=theta.dtype, device=dev), upper=True)
    WT = theta.new_zeros((d, _up(d, 8)))
    WT[:, :d] = W.T
    parts = [WT.reshape(-1), offset]
    if n_dirs:
        # a host array is copied once per device (device_constant): a copy
        # per launch would wait for the device and break graph capture
        parts.append((dirs.to(device=dev, dtype=torch.float32)
                      if isinstance(dirs, torch.Tensor)
                      else device_constant(
                          tuple(map(tuple, np.asarray(dirs).tolist())), dev,
                          torch.float32)).reshape(-1))
    parts.append(alphas)
    if flow.latent_name == "Student_t":
        parts.append(student_t_consts(flow, theta, lat))
    fconst = torch.cat(parts)
    if fconst.numel() != _n_fconst(flow, n_dirs):
        raise RuntimeError("fconst does not have the planned length")
    return x, theta_k, fconst, meta, hdr, plan, ws, int(hdr[7]), n_dirs


def _launch_args(x, theta_k, fconst, meta, hdr, plan, ws):
    """The C entry points' leading arguments, through the workspace."""
    return (x.data_ptr(), theta_k.data_ptr(), fconst.data_ptr(),
            meta.data_ptr(), hdr.ctypes.data, x.shape[0], fconst.numel(),
            meta.numel(), *plan, None if ws is None else ws.data_ptr())


def _latent_slices(flow):
    """{name: (start, stop)} of the latent's L, L_diag (and Student-t's
    dist_params) in the flat theta: what a launch reads of the latent,
    without unravelling every parameter."""
    lay = flow.layout
    names = ("L", "L_diag") + (("dist_params",)
                               if flow.latent_name == "Student_t" else ())
    return {k: (lay.offset(("latent", k)),
                lay.offset(("latent", k))
                + int(np.prod(lay.shapes["latent"][k])))
            for k in names}


def student_t_consts(flow, theta, lat=None):
    """[nu, c0, dg] of a Student-t flow, on theta's device and in its
    dtype (the TPU wrapper's student_t_consts): nu = exp(dist_params[0]) +
    1, c0 = lgam((nu+d)/2) - lgam(nu/2) - d/2 log(nu pi) and dg =
    (psi((nu+d)/2) - psi(nu/2))/2 - d/(2 nu), so that the kernel's logp is
    c0 - sum L_diag - (nu+d)/2 log1p(q/nu) + logjac and its nu row
    (nu-1)(dg - log1p(q/nu)/2 + s q/(2 nu)). Device tensor ops only.
    ``lat``: the latent's parameters, if already at hand."""
    d = flow.dim
    nu = latent.nu_value(lat or flow.layout.unravel(theta)["latent"])
    half = 0.5 * (nu + d)
    c0 = (torch.lgamma(half) - torch.lgamma(0.5 * nu)
          - 0.5 * d * torch.log(nu * math.pi))
    dg = 0.5 * (torch.digamma(half) - torch.digamma(0.5 * nu)) - 0.5 * d / nu
    return torch.stack([nu, c0, dg])


def per_sample_cuda(flow, theta, x, dirs=None, saves=None):
    """Same outputs as ``per_sample_plain``, from one launch of the CUDA
    kernel. f32 CUDA tensors only; g and O come back as ``.T`` views of
    the kernel's feature-major (d, N) and (P, N) outputs. ``saves``: an
    optional caller-owned f32 (n_saves, N) buffer that receives the
    forward saves (block_plan's layout; tools/persample_blocks.py reads
    it)."""
    from . import build

    x, theta_k, fconst, meta, hdr, plan, ws, n_sv, n_dirs = _launch_inputs(
        flow, theta, x, dirs)
    n, d, P, dev = x.shape[0], flow.dim, flow.layout.size, x.device
    logp = torch.empty((n,), dtype=torch.float32, device=dev)
    g_t = torch.empty((d, n), dtype=torch.float32, device=dev)
    quad = (torch.empty((n,), dtype=torch.float32, device=dev) if n_dirs
            else None)
    O_t = torch.empty((P, n), dtype=torch.float32, device=dev)
    if saves is not None and (
            saves.shape != (n_sv, n) or saves.device != dev
            or saves.dtype != torch.float32 or not saves.is_contiguous()):
        raise ValueError(f"saves must be a contiguous f32 ({n_sv}, {n}) "
                         f"tensor on {dev}")

    lib = build.library("persample")
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.persample_f32(
        *_launch_args(x, theta_k, fconst, meta, hdr, plan, ws),
        logp.data_ptr(), g_t.data_ptr(),
        None if quad is None else quad.data_ptr(), O_t.data_ptr(),
        None if saves is None else saves.data_ptr(), stream)
    build.check(code, "persample_f32")
    per_sample_cuda.launches += 1
    return logp, g_t.T, quad, O_t.T


per_sample_cuda.launches = 0


def per_sample(flow, theta, x, dirs=None):
    """The plain version for a CPU tensor; the CUDA kernel otherwise (or
    an error: there is no fallback on the card)."""
    if x.device.type == "cpu":
        return per_sample_plain(flow, theta, x, dirs)
    return per_sample_cuda(flow, theta, x, dirs)


def per_sample_split_plain(flow, theta, x, dirs, shift):
    """(logp, g, quad, (O_hi, O_lo), colsum, omax): the plain pipeline
    followed by the bf16 split of o = O - shift (parallel/stats.
    _split_bf16), its column sums and its column max |o|. The pair is
    (N, P) bf16."""
    logp, g, quad, O = per_sample_plain(flow, theta, x, dirs)
    o = O - shift.to(O.dtype)[None, :]
    return (logp, g, quad, stats._split_bf16(o), o.sum(0),
            o.abs().amax(0))


def per_sample_split_cuda(flow, theta, x, dirs, shift):
    """Same outputs as ``per_sample_split_plain``, from one launch of the
    CUDA kernel in split mode (and its small finishing pass). The pair
    comes back as ``.T`` views of the kernel's feature-major (P, N) bf16
    outputs."""
    from . import build

    x, theta_k, fconst, meta, hdr, plan, ws, _, n_dirs = _launch_inputs(
        flow, theta, x, dirs, split=True)
    n, d, P, dev = x.shape[0], flow.dim, flow.layout.size, x.device
    if (shift.device != dev or shift.dtype != torch.float32
            or shift.shape != (P,)):
        raise ValueError(f"expected an f32 shift ({P},) on {dev}")
    shift = shift.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    logp = torch.empty((n,), **f32)
    g_t = torch.empty((d, n), **f32)
    quad = torch.empty((n,), **f32) if n_dirs else None
    hi_t = torch.empty((P, n), dtype=torch.bfloat16, device=dev)
    lo_t = torch.empty((P, n), dtype=torch.bfloat16, device=dev)
    colsum = torch.empty((P,), **f32)
    omax = torch.empty((P,), **f32)
    psum = torch.empty((plan.grid, P), **f32)
    pmax = torch.empty((plan.grid, P), **f32)

    lib = build.library("persample")
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.persample_split_f32(
        *_launch_args(x, theta_k, fconst, meta, hdr, plan, ws),
        shift.data_ptr(), logp.data_ptr(), g_t.data_ptr(),
        None if quad is None else quad.data_ptr(),
        hi_t.data_ptr(), lo_t.data_ptr(), colsum.data_ptr(),
        omax.data_ptr(), psum.data_ptr(), pmax.data_ptr(), stream)
    build.check(code, "persample_split_f32")
    per_sample_split_cuda.launches += 1
    return logp, g_t.T, quad, (hi_t.T, lo_t.T), colsum, omax


per_sample_split_cuda.launches = 0


def per_sample_split(flow, theta, x, dirs, shift):
    """The split variant: the plain version for a CPU tensor, the CUDA
    kernel otherwise (or an error)."""
    if x.device.type == "cpu":
        return per_sample_split_plain(flow, theta, x, dirs, shift)
    return per_sample_split_cuda(flow, theta, x, dirs, shift)


def per_sample_sharded(ctx, flow, theta, x_local, dirs=None,
                       n_global: Optional[int] = None):
    """``per_sample`` on rank ``ctx.rank``'s shard x_local of a global batch
    of ``n_global`` samples (default: the shard times the world): the
    plain-mode kernel on the rank's N/W rows for a CUDA tensor, the plain
    version for a CPU one. Outputs are the shard's rows. ValueError unless
    the global count divides by the world into shards of x_local's size.
    ``.launches`` counts this rank's kernel launches."""
    n_loc = x_local.shape[0]
    n = n_loc * ctx.world if n_global is None else int(n_global)
    if n % ctx.world or n // ctx.world != n_loc:
        raise ValueError(f"a global batch of {n} samples does not shard "
                         f"over {ctx.world} ranks into shards of {n_loc}")
    if x_local.device.type == "cpu":
        return per_sample_plain(flow, theta, x_local, dirs)
    out = per_sample_cuda(flow, theta, x_local, dirs)
    per_sample_sharded.launches += 1
    return out


per_sample_sharded.launches = 0
