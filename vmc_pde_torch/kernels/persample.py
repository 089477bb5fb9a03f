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

What bounds the kernel on the card: the (P, N) f32 O store. At the
fokkerPlanck32 shape (P = 9264, N = 16384) that is 607 MB per right-hand
side, about 0.2 ms at the H100's 3.35 TB/s, against roughly 5 GFLOP of
scalar f32 work (the 16 second-order jets dominate). The design:

- one thread per sample; the parameters, the latent inverse factor W, the
  trace directions and the block plan sit in shared memory (about 46 KB at
  that shape), read as warp-wide broadcasts;
- O is written FEATURE-MAJOR (P, N), so the 32 samples of a warp store to
  32 neighbouring addresses; the wrapper returns the ``.T`` view, which
  ``torch.matmul`` consumes without a copy;
- the forward activations the backward and the jets reuse go to a
  feature-major (n_saves, N) scratch buffer, coalesced the same way;
- W = U^{-1} depends on theta only: the wrapper computes it once per
  launch with ``torch.linalg.solve_triangular``;
- the ragged tail is masked (threads past N exit after the shared-memory
  load), so any N runs -- the TPU wrapper needs N % tile == 0;
- split mode: the column sums and max reduce across each warp by
  shuffles into (n_warps, P) partials that a second small kernel sums in
  a fixed order (deterministic, no atomics); its tail threads stay alive
  on a clamped sample and contribute zeros. Its bound at the chunked
  path's shape (P = 9264, N = 65536) is the 2.43 GB pair store, ~0.72 ms.

The TPU layout tricks are not carried over: no bf16 hi/lo split matmuls
(plain f32 FMAs), no 0/1 selection matrices (direct indexing), no fused
(s, t) conditioner pair, no outer-product relayouts.

Scope (``supports``): the JAX kernel's -- Gauss or Student-t latent, any
coupling variant, the global affine allowed, trace-mode Hessians -- within
the port's own limits: f32, dim <= 64, each coupling half <= 32
coordinates, layer widths <= 64, at most
MAX_LAYERS linear layers per conditioner, and shared memory within the
card's 227 KB per block.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..models import latent
from ..ops import score
from ..parallel import stats

# Block-plan format shared with csrc/persample.cu (same constants there).
HDR = 16
MAX_DIM = 64
MAX_HALF = 32
MAX_WIDTH = 64
MAX_LAYERS = 4
NET_REC = 5 * MAX_LAYERS
GA_REC = 8 + 4 * NET_REC + 2 * MAX_HALF  # g_scale, g_offset offsets
BLOCK_REC = GA_REC + 2
NETS = ("s1", "s2", "t1", "t2")
VARIANT_CODES = {"additive": 0, "affine": 1, "scale": 2, "scale_shift": 3}
LATENT_CODES = {"Gauss": 0, "Student_t": 1}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
THREADS = 64  # threads per block of the kernel (csrc/persample.cu)


def _smem_bytes(flow, n_dirs: int) -> int:
    d = flow.dim
    n_fconst = d * d + d + n_dirs * d + len(flow.blocks) + 3
    n_meta = HDR + len(flow.blocks) * BLOCK_REC
    return 4 * (flow.layout.size + n_fconst + n_meta)


def supports(flow, hess_dirs: Optional[np.ndarray], hess_idx) -> bool:
    """Static capability check for the CUDA kernel."""
    n_dirs = 0 if hess_dirs is None else int(np.shape(hess_dirs)[0])
    return (
        flow.latent_name in LATENT_CODES
        and (hess_idx is None or hess_dirs is not None)  # trace mode only
        and flow.dim <= MAX_DIM
        and all(len(s.hidden) + 1 <= MAX_LAYERS
                and max((*s.hidden, len(s.ind_up), len(s.ind_down)))
                <= MAX_WIDTH
                and max(len(s.ind_up), len(s.ind_down)) <= MAX_HALF
                for s in flow.blocks)
        and _smem_bytes(flow, n_dirs) <= SMEM_LIMIT
    )


def block_plan(flow, n_dirs: int):
    """(meta int32 array, n_saves): the flow's block plan in the format
    csrc/persample.cu reads, and the number of f32 saves per sample.

    meta[:HDR] = d, n_blocks, n_dirs, P, offset of latent L, of L_diag,
    of mu, n_saves, the latent's code (LATENT_CODES), offset of
    dist_params (Student-t's nu row; 0 otherwise). Then one BLOCK_REC
    record per block: variant, n_up, n_down, n_layers, save offsets of u1,
    u2 and v1, a global-affine flag; for each net (s1, s2, t1, t2) and
    layer: in, out, bias offset, weight offset and save offset of the
    layer's tanh output; then ind_up and ind_down, each padded to
    MAX_HALF; then, at GA_REC, the offsets of g_scale and g_offset (0
    without the global affine)."""
    lay = flow.layout
    nb = len(flow.blocks)
    meta = np.zeros(HDR + nb * BLOCK_REC, dtype=np.int32)
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
    meta[:10] = (flow.dim, nb, n_dirs, lay.size,
                 lay.offset(("latent", "L")),
                 lay.offset(("latent", "L_diag")),
                 lay.offset(("latent", "mu")), n_sv,
                 LATENT_CODES[flow.latent_name],
                 lay.offset(("latent", "dist_params")) if student else 0)
    return meta, n_sv


def per_sample_plain(flow, theta, x, dirs=None):
    """(logp (N,), g (N, d), quad (N,) or None, O (N, P)) through the
    torch.func pipeline (ops/score.py)."""
    f = score.make_flat_log_prob(flow, flow.layout.unravel)
    logp, g, O = score.batched_value_score_and_param_grad(f, theta, x)
    quad = (None if dirs is None
            else score.batched_quad_trace(f, theta, x, dirs))
    return logp, g, quad, O


def _launch_inputs(flow, theta, x, dirs):
    """Checks the arguments of a kernel launch and builds what every
    launch passes: (x, theta, fconst, meta, n_saves, n_dirs)."""
    n_dirs = 0 if dirs is None else int(np.shape(dirs)[0])
    d, P = flow.dim, flow.layout.size
    if not supports(flow, dirs, None):
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

    meta_np, n_sv = block_plan(flow, n_dirs)
    meta = torch.as_tensor(meta_np, device=dev)
    U = latent.chol_factor(flow.layout.unravel(theta)["latent"], d)
    W = torch.linalg.solve_triangular(
        U, torch.eye(d, dtype=theta.dtype, device=dev), upper=True)
    parts = [W.reshape(-1),
             torch.as_tensor(flow.offset, dtype=torch.float32, device=dev)]
    if n_dirs:
        parts.append(torch.as_tensor(dirs, dtype=torch.float32,
                                     device=dev).reshape(-1))
    parts.append(torch.as_tensor([s.alpha for s in flow.blocks],
                                 dtype=torch.float32, device=dev))
    if flow.latent_name == "Student_t":
        parts.append(student_t_consts(flow, theta))
    fconst = torch.cat(parts).contiguous()
    return x, theta, fconst, meta, n_sv, n_dirs


def student_t_consts(flow, theta):
    """[nu, c0, dg] of a Student-t flow, on theta's device and in its
    dtype (the TPU wrapper's student_t_consts): nu = exp(dist_params[0]) +
    1, c0 = lgam((nu+d)/2) - lgam(nu/2) - d/2 log(nu pi) and dg =
    (psi((nu+d)/2) - psi(nu/2))/2 - d/(2 nu), so that the kernel's logp is
    c0 - sum L_diag - (nu+d)/2 log1p(q/nu) + logjac and its nu row
    (nu-1)(dg - log1p(q/nu)/2 + s q/(2 nu)). Device tensor ops only."""
    d = flow.dim
    nu = latent.nu_value(flow.layout.unravel(theta)["latent"])
    half = 0.5 * (nu + d)
    c0 = (torch.lgamma(half) - torch.lgamma(0.5 * nu)
          - 0.5 * d * torch.log(nu * math.pi))
    dg = 0.5 * (torch.digamma(half) - torch.digamma(0.5 * nu)) - 0.5 * d / nu
    return torch.stack([nu, c0, dg])


def _padded(n: int) -> int:
    """Threads a launch runs for n samples (whole blocks of THREADS)."""
    return -(-n // THREADS) * THREADS


def per_sample_cuda(flow, theta, x, dirs=None, saves=None):
    """Same outputs as ``per_sample_plain``, from one launch of the CUDA
    kernel. f32 CUDA tensors only; g and O come back as ``.T`` views of
    the kernel's feature-major (d, N) and (P, N) outputs. ``saves``: an
    optional caller-owned f32 (n_saves, padded N) buffer that receives
    the forward saves (block_plan's layout; tools/persample_blocks.py
    reads it)."""
    from . import build

    x, theta, fconst, meta, n_sv, n_dirs = _launch_inputs(flow, theta, x,
                                                          dirs)
    n, d, P, dev = x.shape[0], flow.dim, flow.layout.size, x.device
    logp = torch.empty((n,), dtype=torch.float32, device=dev)
    g_t = torch.empty((d, n), dtype=torch.float32, device=dev)
    quad = (torch.empty((n,), dtype=torch.float32, device=dev) if n_dirs
            else None)
    O_t = torch.empty((P, n), dtype=torch.float32, device=dev)
    scratch = saves
    if scratch is None:
        scratch = torch.empty((n_sv, _padded(n)), dtype=torch.float32,
                              device=dev)
    elif (scratch.shape != (n_sv, _padded(n)) or scratch.device != dev
          or scratch.dtype != torch.float32 or not scratch.is_contiguous()):
        raise ValueError(f"saves must be a contiguous f32 ({n_sv}, "
                         f"{_padded(n)}) tensor on {dev}")

    lib = build.library("persample")
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.persample_f32(
        x.data_ptr(), theta.data_ptr(), fconst.data_ptr(), meta.data_ptr(),
        n, P, fconst.numel(), meta.numel(),
        logp.data_ptr(), g_t.data_ptr(),
        None if quad is None else quad.data_ptr(),
        O_t.data_ptr(), scratch.data_ptr(), stream)
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

    x, theta, fconst, meta, n_sv, n_dirs = _launch_inputs(flow, theta, x,
                                                          dirs)
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
    n_warps = _padded(n) // 32
    psum = torch.empty((n_warps, P), **f32)
    pmax = torch.empty((n_warps, P), **f32)
    scratch = torch.empty((n_sv, _padded(n)), **f32)

    lib = build.library("persample")
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.persample_split_f32(
        x.data_ptr(), theta.data_ptr(), fconst.data_ptr(), meta.data_ptr(),
        n, P, fconst.numel(), meta.numel(), shift.data_ptr(),
        logp.data_ptr(), g_t.data_ptr(),
        None if quad is None else quad.data_ptr(),
        hi_t.data_ptr(), lo_t.data_ptr(), colsum.data_ptr(),
        omax.data_ptr(), psum.data_ptr(), pmax.data_ptr(),
        scratch.data_ptr(), stream)
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
