"""Triangle Gram S = O^T diag(w) O (unnormalized, w optional and of any
sign) at f32 grade from bf16 products, the counterpart of
vmc_pde_tpu/kernels/syrk.py::syrk and the port's ``gram_backend="syrk"``
(solver/tdvp.py).

The operand splits as x = hi + lo in bf16 and the product keeps three of
the four terms, hi*hi + hi*lo + lo*hi, accumulated in f32; with weights
the left operand is O * w (rounded in f32) and the right one O, so the
result is symmetric for any real w.

``syrk_cuda`` launches the two hand-written kernels of csrc/syrk.cu: a
split pass that reads O feature-major -- the per-sample kernel's (P, N)
storage, handed over as the (N, P) ``.T`` view; any other layout is copied
once -- and writes the bf16 halves as (P, Np) arrays (``split_plain`` is
its plain version), then the product, which computes the lower-triangle
128 x 128 output tiles on the tensor cores (TMA into an mbarrier ring,
wgmma, at most 512 samples per tensor-core accumulation: the card
truncates as it accumulates) in the order of ``tile_list`` and writes each
off-diagonal tile and its mirror, so S comes out whole. The tensor maps
come from the driver (cuTensorMapEncodeTiled). ``syrk_plain`` is the same
split and the three products over the full matrix through
parallel/stats._mm_bf16. ``syrk`` takes the plain version only for a
tensor on the CPU, and for a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..parallel import stats

TILE = 128   # output tile edge of csrc/syrk.cu
KBOX = 64    # samples per pipeline stage (one swizzled 128-byte row)
STAGES = 3   # depth of the kernel's ring of stages
FLUSH = 8    # stages per tensor-core accumulation: 512 samples
PAD = 8      # the split arrays' rows are padded to a multiple of PAD
GROUP = 16   # tile rows per square group of the tile list


def syrk_plain(O, w=None):
    """(P, P) f32: the split and hi*hi + hi*lo + lo*hi in bf16 products
    with f32 accumulation (K-blocked on the card)."""
    O = O.float()
    ahi, alo = stats._split_bf16(O if w is None else O * w.float()[:, None])
    bhi, blo = (ahi, alo) if w is None else stats._split_bf16(O)
    return (stats._mm_bf16(ahi.T, bhi) + stats._mm_bf16(ahi.T, blo)
            + stats._mm_bf16(alo.T, bhi))


def padded(N):
    """Np: N rounded up to a multiple of PAD (16-byte bf16 rows)."""
    return -(-N // PAD) * PAD


def split_plain(X, w=None):
    """The split pass's output from X (P, N) and w (N,): (2, P, Np) bf16
    [A_hi, A_lo] with A = X, or (4, P, Np) [A_hi, A_lo, B_hi, B_lo] with
    A = X * w (rounded in f32) and B = X; samples N .. Np - 1 are zero."""
    P, N = X.shape
    X = X.float()
    halves = stats._split_bf16(X if w is None else X * w.float()[None, :])
    if w is not None:
        halves += stats._split_bf16(X)
    ops = torch.zeros((len(halves), P, padded(N)), dtype=torch.bfloat16,
                      device=X.device)
    for k, h in enumerate(halves):
        ops[k, :, :N] = h
    return ops


def tile_list(nb):
    """The (nb (nb + 1) / 2, 2) int32 lower tiles (I, J), I >= J, in the
    product's order: square groups of GROUP tile rows and columns,
    the groups row by row, each group's tiles row by row. The card's
    blocks take consecutive tiles, so the blocks in flight share their
    operand rows: at P = 9264 a call's waves read 599 row tiles against
    1063 row by row (tests/test_torch_syrk.py), ~5.0 GB from device memory
    at N = 16384 against ~8.9 GB."""
    out = []
    g = GROUP
    for a in range(-(-nb // g)):
        for b in range(a + 1):
            for i in range(a * g, min(nb, (a + 1) * g)):
                for j in range(b * g, min(i + 1, (b + 1) * g)):
                    out.append((i, j))
    return np.asarray(out, dtype=np.int32).reshape(-1, 2)


@functools.lru_cache(maxsize=None)
def _tiles_on(nb, dev):
    return torch.from_numpy(tile_list(nb)).to(dev)


def _feature_major(O):
    """X (P, N) with unit sample stride for the split pass: the storage
    behind a feature-major O (any row stride or alignment), a contiguous
    copy otherwise."""
    X = O.T
    return X if X.stride(1) == 1 else X.contiguous()


def _check(O, w):
    if O.ndim != 2:
        raise ValueError("expected O (N, P)")
    N, P = O.shape
    dev = O.device
    if dev.type != "cuda" or O.dtype != torch.float32:
        raise ValueError("syrk_cuda takes an f32 O on a CUDA device")
    if N == 0 or P == 0:
        raise ValueError("empty operand")
    if w is not None and (w.device != dev or w.dtype != torch.float32
                          or w.shape != (N,)):
        raise ValueError(f"expected f32 weights ({N},) on {dev}")


def split_cuda(O, w=None):
    """``split_plain(O.T, w)`` from csrc/syrk.cu's split pass: O (N, P)
    and w (N,) f32 on one CUDA device."""
    from . import build

    _check(O, w)
    N, P = O.shape
    X = _feature_major(O)
    ldx = X.stride(0) if P > 1 else N
    if w is not None and not w.is_contiguous():
        w = w.contiguous()
    ops = torch.empty((2 if w is None else 4, P, padded(N)),
                      dtype=torch.bfloat16, device=O.device)
    code = build.library("syrk").syrk_split_bf16(
        X.data_ptr(), None if w is None else w.data_ptr(), P, N, ldx,
        padded(N), ops.data_ptr(),
        torch.cuda.current_stream(O.device).cuda_stream)
    build.check(code, "syrk_split_bf16")
    return ops


def syrk_cuda(O, w=None):
    """Same result as ``syrk_plain``, from the split pass and the triangle
    product (a launch per 16384 samples): O (N, P) and w (N,) f32 on one
    CUDA device."""
    from . import build

    ops = split_cuda(O, w)
    P, dev = O.shape[1], O.device
    nb = -(-P // TILE)
    tiles = _tiles_on(nb, dev)
    S = torch.empty((P, P), dtype=torch.float32, device=dev)
    code = build.library("syrk").syrk_tiles_bf16(
        ops.data_ptr(), ops.shape[0], P, ops.shape[2], tiles.data_ptr(),
        tiles.shape[0], S.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "syrk_tiles_bf16")
    syrk_cuda.launches += 1
    return S


syrk_cuda.launches = 0


def syrk(O, w=None):
    """The plain version for a CPU tensor; the CUDA kernel otherwise (or
    an error: there is no fallback on the card)."""
    if O.device.type == "cpu":
        return syrk_plain(O, w)
    return syrk_cuda(O, w)
