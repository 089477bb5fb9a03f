"""Symmetric eigendecomposition of one small matrix on the device, without
a host wait: the TDVP step's small eigensolves (the top-k Ritz matrix of
the Cholesky path, the spectral solve of a small P) inside a captured
CUDA graph.

``eigh_cuda`` launches the hand-written one-block Jacobi kernel of
csrc/jacobi.cu (A and V in shared memory, the m/2 rotations of a
round-robin round applied together; bound: the chain of block barriers,
~3 per round, m - 1 rounds a sweep). ``eigh_plain`` is torch.linalg.eigh;
``eigh`` takes the plain version only for a tensor on the CPU and for a
CUDA tensor launches the kernel or raises. Both return (w ascending, V
with the eigenvectors as columns) from the lower triangle; the vectors'
signs may differ between the two, and every use in the port is
sign-invariant (V diag(f(w)) V^T, or squared projections).

The TDVP decides once, when it is built, which of its eigensolves go
through ``eigh`` (solver/tdvp.py): a top-k Ritz matrix the kernel cannot
take is refused there on a CUDA device, and the P-space spectral solve
of a P above ``fits`` calls torch.linalg.eigh at its own site.
"""

from __future__ import annotations

import torch

THREADS = 512  # csrc/jacobi.cu
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper


def smem_bytes(n: int, dtype: torch.dtype) -> int:
    """Shared memory of a launch at order n: A and V with row stride
    m + 1 (m = n rounded up to even), the (c, s) pairs and the reduction
    scratch, as csrc/jacobi.cu lays them out."""
    m = n + (n & 1)
    item = torch.empty((), dtype=dtype).element_size()
    return item * (2 * m * (m + 1) + m + THREADS // 32 + 1)


def fits(n: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes an (n, n) matrix of ``dtype``."""
    return (dtype in (torch.float32, torch.float64) and n >= 1
            and smem_bytes(n, dtype) <= SMEM_LIMIT)


def eigh_plain(A):
    return torch.linalg.eigh(A)


def eigh_cuda(A, sweeps=None):
    """(w, V) of the symmetric (n, n) f32 or f64 CUDA tensor A from one
    launch of the Jacobi kernel. ``sweeps``: an optional int32 CUDA tensor
    of one element that receives the sweeps the solve took."""
    from . import build

    if A.device.type != "cuda":
        raise ValueError("eigh_cuda needs a CUDA tensor")
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"expected a square matrix, got {tuple(A.shape)}")
    n = A.shape[0]
    if not fits(n, A.dtype):
        raise ValueError(f"the Jacobi kernel takes f32/f64 matrices up to "
                         f"{SMEM_LIMIT} B of shared memory; got n={n}, "
                         f"{A.dtype}")
    A = A.contiguous()
    w = torch.empty(n, dtype=A.dtype, device=A.device)
    V = torch.empty((n, n), dtype=A.dtype, device=A.device)
    lib = build.library("jacobi")
    fn = (lib.jacobi_eigh_f32 if A.dtype == torch.float32
          else lib.jacobi_eigh_f64)
    if sweeps is not None and (sweeps.dtype != torch.int32
                               or sweeps.device != A.device):
        raise ValueError("sweeps must be an int32 tensor on A's device")
    code = fn(A.data_ptr(), n, w.data_ptr(), V.data_ptr(),
              0 if sweeps is None else sweeps.data_ptr(),
              torch.cuda.current_stream(A.device).cuda_stream)
    build.check(code, "jacobi_eigh")
    eigh_cuda.launches += 1
    return w, V


eigh_cuda.launches = 0


def eigh(A):
    """The plain version for a CPU tensor; the CUDA kernel otherwise (or
    an error: there is no fallback on the card)."""
    if A.device.type == "cpu":
        return eigh_plain(A)
    return eigh_cuda(A)
