"""Symmetric eigendecomposition of one small matrix on the device, without
a host wait: the TDVP step's small eigensolves (the top-k Ritz matrix of
the Cholesky path, the spectral solve of P <= eigh_max_params = 2048)
inside a captured CUDA graph.

``eigh_cuda`` launches the hand-written Jacobi kernel of csrc/jacobi.cu:
one block up to order 168 (f32) or 118 (f64), its columns in shared
memory, every round's m/2 rotations applied in one fused two-sided pass;
above that, up to ``REACH`` (2048 in both), a block Jacobi spread over
the card in one cooperative launch: 16-column blocks paired by the circle
method, each pair's 32 x 32 subproblem rotated in shared memory and its
rotations applied to A and V as small products, A and V in a scratch of
device memory that the wrapper allocates (the source lays out both
launches). ``eigh_plain`` is torch.linalg.eigh; ``eigh`` takes the plain
version only for a tensor on the CPU and for a CUDA tensor launches the
kernel or raises. Both return (w ascending, V with the eigenvectors as
columns) from the lower triangle; the vectors' signs may differ between
the two, and every use in the port is sign-invariant (V diag(f(w)) V^T,
or squared projections).

``eigh_for`` routes an eigensolve by its size, once, where the TDVP is
built (solver/tdvp.py): ``eigh`` where the kernel takes the order,
torch.linalg.eigh above its reach on a CUDA device (a host wait, which
the TDVP reports in ``graphs_refusal``).
"""

from __future__ import annotations

import torch

# the largest order each variant of csrc/jacobi.cu takes: one block, by
# its shared memory, and the block variant, by its constant BLOCK_REACH
# (the library's jacobi_reach computes the same from its plans; the card
# tests hold these against it)
ONE_BLOCK_REACH = {torch.float32: 168, torch.float64: 118}
REACH = {torch.float32: 2048, torch.float64: 2048}


def fits(n: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes an (n, n) matrix of ``dtype``."""
    return 1 <= n <= REACH.get(dtype, 0)


def in_blocks(n: int, dtype: torch.dtype) -> bool:
    """Whether the kernel solves order n in its block variant."""
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
    launch of the Jacobi kernel (the block variant's also zeroes its
    barrier word first). ``sweeps``: an optional int32 CUDA tensor
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
    f64 = A.dtype == torch.float64
    fn = lib.jacobi_eigh_f64 if f64 else lib.jacobi_eigh_f32
    blocks = in_blocks(n, A.dtype)
    # the block variant's A, V, rotations and barrier word (from the
    # caller's stream's pool: a captured solve's lands in the graph's)
    scratch = torch.empty(lib.jacobi_scratch_bytes(n, int(f64), int(blocks)),
                          dtype=torch.uint8, device=A.device)
    code = fn(A.data_ptr(), n, int(blocks), w.data_ptr(), V.data_ptr(),
              0 if sweeps is None else sweeps.data_ptr(), scratch.data_ptr(),
              torch.cuda.current_stream(A.device).cuda_stream)
    build.check(code, "jacobi_eigh")
    if blocks:
        eigh_cuda.block_launches += 1
    else:
        eigh_cuda.launches += 1
    return w, V


# solves (one launch each) of the one-block kernel and of the block
# variant's
eigh_cuda.launches = 0
eigh_cuda.block_launches = 0


def block_solves_on_device() -> int:
    """The block variant's solves on the current CUDA device so far, as the
    kernel counts them (a captured solve's replays included; waits for
    the device): what a trace of the device's activity should show."""
    from . import build

    torch.cuda.synchronize()
    count = build.library("jacobi").jacobi_block_solves()
    if count < 0:
        raise RuntimeError("jacobi_block_solves: CUDA error")
    return count


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
