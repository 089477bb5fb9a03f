"""Triangle Gram S = O^T diag(w) O (unnormalized, w optional and of any
sign) at f32 grade from bf16 products, the counterpart of
vmc_pde_tpu/kernels/syrk.py::syrk and the port's ``gram_backend="syrk"``
(solver/tdvp.py).

The operand splits as x = hi + lo in bf16 and the product keeps three of
the four terms, hi*hi + hi*lo + lo*hi, accumulated in f32; with weights
the left operand is O * w (rounded in f32) and the right one O, so the
result is symmetric for any real w.

``syrk_cuda`` launches the hand-written kernel in csrc/syrk.cu, which
computes only the lower-triangle 128 x 128 output tiles on the tensor
cores (mma.sync, at most 512 samples per tensor-core accumulation: the
card truncates as it accumulates) and mirrors them over the upper tiles
with a select on tile indices. It reads O feature-major -- the
per-sample kernel's (P, N) storage, handed over as the (N, P) ``.T``
view -- and copies any other layout once. ``syrk_plain`` is the same
split and the three products over the full matrix through
parallel/stats._mm_bf16. ``syrk`` takes the plain version only for a
tensor on the CPU, and for a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..parallel import stats

TILE = 128  # output tile edge of csrc/syrk.cu


def syrk_plain(O, w=None):
    """(P, P) f32: the split and hi*hi + hi*lo + lo*hi in bf16 products
    with f32 accumulation (K-blocked on the card)."""
    O = O.float()
    ahi, alo = stats._split_bf16(O if w is None else O * w.float()[:, None])
    bhi, blo = (ahi, alo) if w is None else stats._split_bf16(O)
    return (stats._mm_bf16(ahi.T, bhi) + stats._mm_bf16(ahi.T, blo)
            + stats._mm_bf16(alo.T, bhi))


def _feature_major(O):
    """(X (P, Np) f32 with 16-byte aligned rows, Np = N rounded up to 4) for
    the kernel: the storage behind a feature-major O when it qualifies, a
    zero-padded copy otherwise."""
    N, P = O.shape
    X = O.T
    if (X.stride(1) == 1 and N % 4 == 0 and X.stride(0) % 4 == 0
            and X.data_ptr() % 16 == 0):
        return X, N
    Np = -(-N // 4) * 4
    Xp = torch.zeros((P, Np), dtype=torch.float32, device=O.device)
    Xp[:, :N] = X
    return Xp, Np


def syrk_cuda(O, w=None):
    """Same result as ``syrk_plain``, from one launch of the CUDA kernel and
    the mirror: O (N, P) and w (N,) f32 on one CUDA device."""
    from . import build

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
    X, Np = _feature_major(O)
    if w is not None:
        if Np != N:
            w = torch.cat([w, w.new_zeros(Np - N)])
        elif not w.is_contiguous() or w.data_ptr() % 16:
            # the kernel reads w as float4: a fresh, aligned copy
            w = w.clone(memory_format=torch.contiguous_format)
    W = torch.empty((P, P), dtype=torch.float32, device=dev)
    lib = build.library("syrk")
    code = lib.syrk_f32(X.data_ptr(), None if w is None else w.data_ptr(),
                        P, Np, X.stride(0), W.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "syrk_f32")
    syrk_cuda.launches += 1
    # the upper tiles were never written: select, never add
    tile = torch.arange(P, device=dev) // TILE
    return torch.where(tile[:, None] >= tile[None, :], W, W.T)


syrk_cuda.launches = 0


def syrk(O, w=None):
    """The plain version for a CPU tensor; the CUDA kernel otherwise (or
    an error: there is no fallback on the card)."""
    if O.device.type == "cpu":
        return syrk_plain(O, w)
    return syrk_cuda(O, w)
