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
  and 8 whose shared memory fits and whose grid still covers the SMs; the
  shared memory is theta, W^T, the directions, the plan, the tile's
  forward saves and the jets' tangents, ``smem_floats``), so the pilot's
  2048 rows and a rank's 4096 already fill the card;
- forward and backward over (sample, unit) items, the jets one (sample,
  direction) pair per thread with each layer's activations in registers
  (``register_width``: widths up to 16; wider flows take a generic jet
  body whose arrays sit in local memory) and each weight row read as
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
- split mode: each row's T values reduce in a fixed order into (n_tiles,
  P) partials that a second small kernel sums in tile order
  (deterministic, no atomics). Its bound at the chunked path's shape (P =
  9264, N = 65536) is the 2.43 GB pair store, ~0.73 ms.

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
coupling variant, the global affine allowed, trace-mode Hessians -- within
the port's own limits: f32, dim <= 64, each coupling half <= 32
coordinates, layer widths <= 64, at most
MAX_LAYERS linear layers per conditioner, and a tile of 8 samples (with
theta in global memory if need be) within the card's 227 KB per block.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from ..models import latent
from ..ops import score
from ..parallel import stats

# Block-plan format and launch constants shared with csrc/persample.cu
# (same names there; tests/test_torch_persample.py checks them); MAX_DIM
# is the wrapper's scope alone.
HDR = 16
MAX_DIM = 64
MAX_HALF = 32
MAX_WIDTH = 64
MAX_LAYERS = 4
NET_REC = 5 * MAX_LAYERS
GA_REC = 8 + 4 * NET_REC + 2 * MAX_HALF  # g_scale, g_offset offsets
BLOCK_REC = GA_REC + 2
KL_REC = 3 * 4 * MAX_LAYERS + 2  # kernel-layout table, per block
MAX_THREADS = 256
N_SCRATCH = 8
N_PER_SAMPLE = 5
NETS = ("s1", "s2", "t1", "t2")
VARIANT_CODES = {"additive": 0, "affine": 1, "scale": 2, "scale_shift": 3}
LATENT_CODES = {"Gauss": 0, "Student_t": 1}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
TILES = (32, 16, 8)  # samples per block, largest first
REGISTER_WIDTH = 16  # the jets' register arrays (template MW; 0: generic)
H100_SMS = 132


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _widest(flow) -> int:
    """The widest conditioner layer or coupling half of the flow."""
    return max(max(spec.hidden + (len(spec.ind_up), len(spec.ind_down)))
               for spec in flow.blocks)


def register_width(flow) -> int:
    """MW, the kernel's template width: REGISTER_WIDTH when every
    conditioner layer and half fits the jets' register arrays, else 0 (the
    generic jet body, its arrays in local memory)."""
    return REGISTER_WIDTH if _widest(flow) <= REGISTER_WIDTH else 0


def kernel_layout(flow):
    """The theta the kernel reads, repacked: for every block, net and
    layer the bias (padded to 4 floats) and the weights with each row
    padded to a multiple of 4 (16-byte aligned, so the jets read a row as
    float4s) -- for a flow of the register width, every layer padded with
    zeros to MW x MW, so that the jets' body needs no bounds; then every
    global affine's g_scale and g_offset, then the latent's mu and L_diag.
    Returns (index (Pk,) int64 into theta, with P for the zero padding;
    table (n_blocks, KL_REC) int32 of (bias, weights, row stride) offsets
    per net and layer, then g_scale and g_offset; offset of mu; offset of
    L_diag)."""
    lay = flow.layout
    MW = register_width(flow)
    pad = lay.size
    idx = []
    table = np.zeros((len(flow.blocks), KL_REC), dtype=np.int32)

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
        for ni, net in enumerate(NETS):
            if net not in spec.nets:
                continue
            n_in, n_out = spec.net_dims(net)
            dims = [n_in, *spec.hidden, n_out]
            for layer in range(len(dims) - 1):
                q = 3 * (ni * MAX_LAYERS + layer)
                stride = MW or _up(dims[layer + 1], 4)
                table[b, q] = put(lay.offset(("blocks", b, net, "b", layer)),
                                  1, dims[layer + 1])
                table[b, q + 1] = put(
                    lay.offset(("blocks", b, net, "w", layer)),
                    dims[layer], dims[layer + 1], stride, MW or None)
                table[b, q + 2] = stride
        if spec.global_affine:
            table[b, KL_REC - 2] = put(lay.offset(("blocks", b, "g_scale")),
                                       1, 1)
            table[b, KL_REC - 1] = put(
                lay.offset(("blocks", b, "g_offset")), 1, flow.dim)
    mu = put(lay.offset(("latent", "mu")), 1, flow.dim)
    ld = put(lay.offset(("latent", "L_diag")), 1, flow.dim)
    return np.asarray(idx, dtype=np.int64), table, mu, ld


def _n_fconst(flow, n_dirs: int) -> int:
    """Length of the kernel's f32 constants: W^T with rows padded to 8,
    the offset, the directions, the alphas and Student-t's three."""
    d = flow.dim
    return (d * _up(d, 8) + d + n_dirs * d + len(flow.blocks)
            + 3 * (flow.latent_name == "Student_t"))


def smem_floats(Pk, n_fconst, n_meta, n_saves, d, k, T, J, SW,
                resident=True) -> int:
    """Floats of one block's shared memory (csrc/persample.cu smem_layout,
    region by region): theta when ``resident``, constants and plan (each
    padded to 4), the tile's saves, the (d, T) W^T y, N_PER_SAMPLE
    per-sample scalars and the (k, T) quad terms; then one region that the
    backward's four (d, T) rows and N_SCRATCH (SW, T) rows (SW: the widest
    layer or half) share with the jets' (2 d, J) tangents (never live
    together)."""
    back = 4 * d * T + N_SCRATCH * SW * T
    jet = 2 * d * J if k else 0
    return (_up(Pk, 4) * resident + _up(n_fconst, 4) + _up(n_meta, 4)
            + n_saves * T + d * T + N_PER_SAMPLE * T + k * T
            + max(back, jet))


@functools.lru_cache(maxsize=256)
def tile_plan(flow, n_dirs: int, n: int, n_sm: int = H100_SMS):
    """(T, threads, J, MW, resident, shared bytes) of a launch on n samples,
    or None if no block fits SMEM_LIMIT. For each tile T of TILES (256
    threads, 128 at T = 8), theta in shared memory (with the register
    width MW) or not (the generic jet body, MW = 0), the most jet
    slots J (at most the threads and the T k pairs) that fit. Preferred, in
    order: every thread with a pair in the jets; theta resident; then the
    largest T whose grid covers the ``n_sm`` SMs, else the smallest T."""
    meta, n_sv = block_plan(flow, n_dirs)
    Pk, SW, d = int(meta[11]), int(meta[14]), flow.dim
    fits = []
    for resident in (True, False):
        # the register-width body reads theta from shared memory only
        MW = register_width(flow) if resident else 0
        for T in TILES:
            threads = MAX_THREADS if T >= 16 else MAX_THREADS // 2
            full = min(threads, T * n_dirs)
            for J in ((full, full // 2, full // 4, min(full, 32))
                      if n_dirs else (0,)):
                smem = 4 * smem_floats(Pk, _n_fconst(flow, n_dirs),
                                       meta.size, n_sv, d, n_dirs, T, J, SW,
                                       resident)
                if smem <= SMEM_LIMIT and (J or not n_dirs):
                    fits.append((T, threads, J, MW, resident, smem,
                                 J == full))
                    break
    if not fits:
        return None

    def rank(f):
        covers = -(-n // f[0]) >= n_sm
        return (f[6], f[4], covers, f[0] if covers else -f[0])

    return max(fits, key=rank)[:6]


def supports(flow, hess_dirs: Optional[np.ndarray], hess_idx) -> bool:
    """Static capability check for the CUDA kernel."""
    n_dirs = 0 if hess_dirs is None else int(np.shape(hess_dirs)[0])
    return ((hess_idx is None or hess_dirs is not None)  # trace mode only
            and _supports(flow, n_dirs))


@functools.lru_cache(maxsize=64)
def _supports(flow, n_dirs: int) -> bool:
    return (
        flow.latent_name in LATENT_CODES
        and flow.dim <= MAX_DIM
        and all(len(s.hidden) + 1 <= MAX_LAYERS
                and max((*s.hidden, len(s.ind_up), len(s.ind_down)))
                <= MAX_WIDTH
                and max(len(s.ind_up), len(s.ind_down)) <= MAX_HALF
                for s in flow.blocks)
        and tile_plan(flow, n_dirs, 1) is not None
    )


@functools.lru_cache(maxsize=64)
def block_plan(flow, n_dirs: int):
    """(meta int32 array, n_saves): the flow's block plan in the format
    csrc/persample.cu reads, and the number of f32 saves per sample.

    meta[:HDR] = d, n_blocks, n_dirs, P, offset of latent L, of L_diag,
    of mu, n_saves, the latent's code (LATENT_CODES), offset of
    dist_params (Student-t's nu row; 0 otherwise), the start of the
    kernel-layout table, its theta's length Pk, mu's and L_diag's
    offsets in it (kernel_layout), and the widest layer or half. Then one BLOCK_REC record per block:
    variant, n_up, n_down, n_layers, save offsets of u1, u2 and v1, a
    global-affine flag; for each net (s1, s2, t1, t2) and layer: in, out,
    bias offset, weight offset and save offset of the layer's tanh output;
    then ind_up and ind_down, each padded to MAX_HALF; then, at GA_REC,
    the offsets of g_scale and g_offset (0 without the global affine).
    The offsets are the flat layout's (the O rows). Last the
    kernel-layout table, KL_REC per block. Read-only (cached)."""
    lay = flow.layout
    nb = len(flow.blocks)
    kidx, ktable, mu_k, ld_k = kernel_layout(flow)
    ktab = HDR + nb * BLOCK_REC
    meta = np.zeros(ktab + nb * KL_REC, dtype=np.int32)
    n_sv = 0
    for b, spec in enumerate(flow.blocks):
        r = HDR + b * BLOCK_REC
        n_up, n_down = len(spec.ind_up), len(spec.ind_down)
        n_layers = len(spec.hidden) + 1
        meta[r:r + 4] = (VARIANT_CODES[spec.variant], n_up, n_down,
                         n_layers)
        for slot, width in ((4, n_up), (5, n_down), (6, n_up)):
            meta[r + slot] = n_sv
            n_sv += width
        for ni, net in enumerate(NETS):
            if net not in spec.nets:
                continue
            n_in, n_out = spec.net_dims(net)
            dims = [n_in, *spec.hidden, n_out]
            for layer in range(n_layers):
                q = r + 8 + ni * NET_REC + 5 * layer
                meta[q:q + 5] = (
                    dims[layer], dims[layer + 1],
                    lay.offset(("blocks", b, net, "b", layer)),
                    lay.offset(("blocks", b, net, "w", layer)),
                    n_sv)
                n_sv += dims[layer + 1]
        ind = r + 8 + 4 * NET_REC
        meta[ind:ind + n_up] = spec.ind_up
        meta[ind + MAX_HALF:ind + MAX_HALF + n_down] = spec.ind_down
        if spec.global_affine:
            meta[r + 7] = 1
            meta[r + GA_REC:r + GA_REC + 2] = (
                lay.offset(("blocks", b, "g_scale")),
                lay.offset(("blocks", b, "g_offset")))
    student = flow.latent_name == "Student_t"
    meta[:15] = (flow.dim, nb, n_dirs, lay.size,
                 lay.offset(("latent", "L")),
                 lay.offset(("latent", "L_diag")),
                 lay.offset(("latent", "mu")), n_sv,
                 LATENT_CODES[flow.latent_name],
                 lay.offset(("latent", "dist_params")) if student else 0,
                 ktab, kidx.size, mu_k, ld_k, _widest(flow))
    meta[ktab:] = ktable.reshape(-1)
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


def _launch_inputs(flow, theta, x, dirs):
    """Checks the arguments of a kernel launch and builds what every
    launch passes: (x, repacked theta, fconst, meta, meta's host header,
    tile plan, n_saves, n_dirs). Nothing here waits for the card."""
    n_dirs = 0 if dirs is None else int(np.shape(dirs)[0])
    d, P = flow.dim, flow.layout.size
    if not _supports(flow, n_dirs):
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
    plan = tile_plan(flow, n_dirs, x.shape[0], n_sm)
    theta_k = torch.cat([theta, theta.new_zeros(1)])[kidx]
    lat = {k: theta[a:b] for k, (a, b) in lat.items()}
    U = latent.chol_factor(lat, d)
    W = torch.linalg.solve_triangular(
        U, torch.eye(d, dtype=theta.dtype, device=dev), upper=True)
    WT = theta.new_zeros((d, _up(d, 8)))
    WT[:, :d] = W.T
    parts = [WT.reshape(-1), offset]
    if n_dirs:
        parts.append(torch.as_tensor(dirs, dtype=torch.float32,
                                     device=dev).reshape(-1))
    parts.append(alphas)
    if flow.latent_name == "Student_t":
        parts.append(student_t_consts(flow, theta, lat))
    fconst = torch.cat(parts)
    if fconst.numel() != _n_fconst(flow, n_dirs):
        raise RuntimeError("fconst does not have the planned length")
    return x, theta_k, fconst, meta, hdr, plan, int(hdr[7]), n_dirs


def _launch_args(x, theta_k, fconst, meta, hdr, plan):
    """The C entry points' leading arguments, through the shared bytes."""
    T, threads, J, MW, resident, smem = plan
    return (x.data_ptr(), theta_k.data_ptr(), fconst.data_ptr(),
            meta.data_ptr(), hdr.ctypes.data, x.shape[0], fconst.numel(),
            meta.numel(), T, threads, J, MW, int(resident), smem)


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

    x, theta_k, fconst, meta, hdr, plan, n_sv, n_dirs = _launch_inputs(
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
        *_launch_args(x, theta_k, fconst, meta, hdr, plan),
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

    x, theta_k, fconst, meta, hdr, plan, _, n_dirs = _launch_inputs(
        flow, theta, x, dirs)
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
    n_tiles = -(-n // plan[0])
    psum = torch.empty((n_tiles, P), **f32)
    pmax = torch.empty((n_tiles, P), **f32)

    lib = build.library("persample")
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.persample_split_f32(
        *_launch_args(x, theta_k, fconst, meta, hdr, plan),
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
