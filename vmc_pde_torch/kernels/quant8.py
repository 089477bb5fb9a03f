"""Fused int8 quantization and force partial of one bf16 operand, the
counterpart of vmc_pde_tpu/kernels/quant8.py::quant_force.

On the chunked int8 path (solver/tdvp.py) each half of the split
per-sample kernel's (hi, lo) pair is read once to give both its int8
cross-product operand and its terms of the force:

    q8 = clamp(round(x * inv[:, None]), -127, 127)   (P, n) int8
    f  = x @ V                                       (P, kv) f32

with V = [es_hi, es_lo] (kv = 2) for hi and V = [es_hi] (kv = 1) for lo,
so f_hi[:, 0] + f_hi[:, 1] + f_lo[:, 0] is parallel/stats.pair_vecmat's
three hi/lo terms.

``quant_force_cuda`` launches the hand-written kernel in csrc/quant8.cu
(bound: one read of x and one int8 write, 1.82 GB per call at P = 9264,
n = 65536, ~0.54 ms at 3.35 TB/s; the ROWS rows of a block share each
16-byte load of V); ``quant_force_plain`` makes the
separate passes (the quantization of parallel/stats._quant_cols_int8 with
the given inverse scales, then the bf16 product); ``quant_force`` takes
the plain version only for a tensor on the CPU, and for a CUDA tensor
launches the kernel or raises. Rounding is half to even in both, so q8
is bit-identical.
"""

from __future__ import annotations

import torch

from ..parallel import stats

ROWS = 2  # rows of x per block of csrc/quant8.cu


def quant_force_plain(x_pn, inv, V):
    """(q8 (P, n) int8, f (P, kv) f32) by separate passes."""
    q8 = stats._quantize_int8(x_pn.float(), inv[:, None])
    return q8, stats._mm_bf16(x_pn.to(torch.bfloat16), V.to(torch.bfloat16))


def quant_force_cuda(x_pn, inv, V):
    """Same outputs as ``quant_force_plain``, from one launch of the CUDA
    kernel: x_pn (P, n) bf16 with n a multiple of 8, inv (P,) f32 and V
    (n, kv) bf16 with kv in {1, 2}, all on one CUDA device."""
    from . import build

    if x_pn.ndim != 2 or V.ndim != 2:
        raise ValueError("expected x (P, n) and V (n, kv)")
    P, n = x_pn.shape
    kv = V.shape[1]
    dev = x_pn.device
    if dev.type != "cuda" or inv.device != dev or V.device != dev:
        raise ValueError("quant_force_cuda needs x, inv and V on one CUDA "
                         "device")
    if x_pn.dtype != torch.bfloat16 or V.dtype != torch.bfloat16:
        raise ValueError("quant_force_cuda takes bf16 x and V")
    if inv.dtype != torch.float32 or inv.shape != (P,):
        raise ValueError(f"expected f32 inverse scales ({P},)")
    if V.shape[0] != n or kv not in (1, 2) or n % 8 or P == 0:
        raise ValueError(f"quant_force_cuda takes V (n, 1 or 2) and n a "
                         f"multiple of 8; got x {tuple(x_pn.shape)}, V "
                         f"{tuple(V.shape)}")
    # the kernel loads x and V as 16-byte vectors: contiguous and aligned
    x_pn, inv, V = (t.contiguous() for t in (x_pn, inv, V))
    x_pn, V = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x_pn, V))
    q8 = torch.empty((P, n), dtype=torch.int8, device=dev)
    f = torch.empty((P, kv), dtype=torch.float32, device=dev)
    lib = build.library("quant8")
    code = lib.quant_force_bf16(
        x_pn.data_ptr(), inv.data_ptr(), V.data_ptr(), P, n, kv,
        q8.data_ptr(), f.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "quant_force_bf16")
    quant_force_cuda.launches += 1
    return q8, f


quant_force_cuda.launches = 0


def quant_force(x_pn, inv, V):
    """The plain version for a CPU tensor; the CUDA kernel otherwise (or
    an error: there is no fallback on the card)."""
    if x_pn.device.type == "cpu":
        return quant_force_plain(x_pn, inv, V)
    return quant_force_cuda(x_pn, inv, V)
