"""Symmetric eigendecomposition of one small matrix on the device, without
a host wait: the TDVP step's small eigensolves (the top-k Ritz matrix of
the Cholesky path, the spectral solve of a small P) inside a captured
CUDA graph.

``eigh_cuda`` launches the hand-written Jacobi kernel of csrc/jacobi.cu:
one block up to order 168 (f32) or 118 (f64), a thread block cluster of
8 blocks above that up to ``REACH`` (464 in f32, 320 in f64),
each holding its share of A's and V's columns in shared memory, every
round's m/2 rotations applied in one fused two-sided pass (the source
lays out the launch). ``eigh_plain`` is torch.linalg.eigh; ``eigh`` takes
the plain version only for a tensor on the CPU and for a CUDA tensor
launches the kernel or raises. Both return (w ascending, V with the
eigenvectors as columns) from the lower triangle; the vectors' signs may
differ between the two, and every use in the port is sign-invariant
(V diag(f(w)) V^T, or squared projections).

``eigh_for`` routes an eigensolve by its size, once, where the TDVP is
built (solver/tdvp.py): ``eigh`` where the kernel takes the order,
torch.linalg.eigh above its reach on a CUDA device (a host wait, which
the TDVP reports in ``graphs_refusal``).
"""

from __future__ import annotations

import torch

# the largest order each variant of csrc/jacobi.cu takes, by its shared
# memory: one block, and a thread block cluster of 8 (the library's
# jacobi_reach computes the same from its layout; the card tests hold
# these against it)
ONE_BLOCK_REACH = {torch.float32: 168, torch.float64: 118}
REACH = {torch.float32: 464, torch.float64: 320}


def fits(n: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes an (n, n) matrix of ``dtype``."""
    return 1 <= n <= REACH.get(dtype, 0)


def in_cluster(n: int, dtype: torch.dtype) -> bool:
    """Whether the kernel solves order n in its cluster variant."""
    return n > ONE_BLOCK_REACH[dtype]


def eigh_for(n: int, dtype: torch.dtype, device: torch.device):
    """The eigensolve for (n, n) matrices of ``dtype`` on ``device``:
    ``eigh`` (the kernel on a CUDA device, the plain version on the CPU)
    where the kernel takes the order, torch.linalg.eigh above its reach
    on a CUDA device."""
    if torch.device(device).type != "cuda" or fits(n, dtype):
        return eigh
    return torch.linalg.eigh


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
        raise ValueError(
            f"the Jacobi kernel takes f32/f64 matrices up to order "
            f"{REACH[torch.float32]} (f32) or {REACH[torch.float64]} (f64); "
            f"got n={n}, {A.dtype}")
    if sweeps is not None and (sweeps.dtype != torch.int32
                               or sweeps.device != A.device):
        raise ValueError("sweeps must be an int32 tensor on A's device")
    A = A.contiguous()
    w = torch.empty(n, dtype=A.dtype, device=A.device)
    V = torch.empty((n, n), dtype=A.dtype, device=A.device)
    lib = build.library("jacobi")
    fn = (lib.jacobi_eigh_f32 if A.dtype == torch.float32
          else lib.jacobi_eigh_f64)
    cluster = in_cluster(n, A.dtype)
    code = fn(A.data_ptr(), n, int(cluster), w.data_ptr(), V.data_ptr(),
              0 if sweeps is None else sweeps.data_ptr(),
              torch.cuda.current_stream(A.device).cuda_stream)
    build.check(code, "jacobi_eigh")
    if cluster:
        eigh_cuda.cluster_launches += 1
    else:
        eigh_cuda.launches += 1
    return w, V


# launches of the one-block kernel and of the cluster's
eigh_cuda.launches = 0
eigh_cuda.cluster_launches = 0


def eigh(A):
    """The plain version for a CPU tensor; the CUDA kernel otherwise (or
    an error: there is no fallback on the card)."""
    if A.device.type == "cpu":
        return eigh_plain(A)
    return eigh_cuda(A)


def flops(n: int) -> int:
    """Floating-point operations a symmetric eigendecomposition with
    vectors needs at order n, whatever the algorithm: ~9 n^3, the
    tridiagonalisation and the implicit QR with the vectors accumulated
    (Golub and Van Loan, Matrix Computations, 4th ed., section 8.3)."""
    return 9 * n ** 3
