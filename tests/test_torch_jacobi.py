"""The Jacobi eigensolve (vmc_pde_torch/kernels/jacobi.py,
csrc/jacobi.cu) on the CPU, where the kernel cannot run: its algorithm
emulated in numpy (the slot layout, the round robin inside a block, the
circle of halves between a cluster's blocks, the fused two-sided 2 x 2
update in Rutishauser's form, the convergence test and the ranking), its
C interface against the wrapper's, the TDVP's routing by order, and the
top-k Ritz solve against the JAX package's.

Tolerances: the emulation against torch.linalg.eigh in f64, eigenvalues
to 1e-12 of the matrix's norm and V diag(w) V^T to 1e-12 (rounding of a
few hundred rotations); the Ritz top-k against the true spectrum to rtol
1e-8 (two subspace iterations on a gap of 100x), the JAX package's to
1e-8 (different random starts).
"""

import ctypes
import re

import jax
import numpy as np
import pytest
import torch

from vmc_pde_torch.kernels import build, jacobi
from vmc_pde_torch.solver import tdvp as ttdvp
from vmc_pde_tpu.solver import tdvp as jtdvp

SRC = (build.CSRC / "jacobi.cu").read_text()


def _round_pairs(sr, r, w):
    """The slots of each local pair l of round r of super-round sr."""
    l = np.arange(w)
    if sr == 0:  # round robin over the 2w slots
        M = 2 * w - 1
        return (np.where(l == 0, r, (r + l) % M),
                np.where(l == 0, M, (r - l) % M))
    return l, w + (l + r) % w  # the halves X and Y against each other


def _move_halves(arr, blocks):
    """The move between super-rounds: half (b, h) to its next place on the
    circle X_1 -> ... -> X_{B-1} -> Y_{B-1} -> ... -> Y_0 -> X_1, X_0
    staying (arr[b, h] is block b's half h)."""
    new = arr.copy()
    for b in range(blocks):
        to_x = (b + 1, 0) if b < blocks - 1 else (b, 1)
        to_y = (1, 0) if b == 0 else (b - 1, 1)
        if b > 0:
            new[to_x] = arr[b, 0]
        new[to_y] = arr[b, 1]
    return new


def _rotate(s, tau, x, y):
    """(c x - s y, s x + c y) in Rutishauser's form, tau = s / (1 + c)."""
    return x - s * (y + tau * x), y + s * (x - tau * y)


def _jacobi_emulated(A, blocks=1, on_round=None):
    """csrc/jacobi.cu's algorithm in numpy (f64). Returns (w, V, sweeps)."""
    n = A.shape[0]
    m = -(-n // (2 * blocks)) * 2 * blocks
    w = m // (2 * blocks)
    S = 2 * w
    full = np.zeros((m, m))
    full[:n, :n] = np.tril(A) + np.tril(A, -1).T
    # block b's slot s holds column idx[b, s]: its A entries by row and its
    # V entries for rows < n
    idx = np.arange(m).reshape(blocks, S)
    col_a = full.T.reshape(blocks, S, m).copy()
    col_v = np.eye(m).reshape(blocks, S, m)[:, :, :n].copy()
    bs = np.arange(blocks)[:, None]
    prev, sweep = -1.0, 0
    while sweep < 30:
        sweep += 1
        for sr in range(2 * blocks - 1):
            for r in range(S - 1 if sr == 0 else w):
                sp, sq = _round_pairs(sr, r, w)
                p, q = idx[:, sp], idx[:, sq]  # (blocks, w)
                apq = col_a[bs, sq, p]
                app, aqq = col_a[bs, sp, p], col_a[bs, sq, q]
                live = (p < n) & (q < n) & (apq != 0)
                d = aqq - app
                with np.errstate(invalid="ignore", divide="ignore"):
                    t = np.where(live, np.where(d >= 0, 2 * apq, -2 * apq)
                                 / (np.abs(d) + np.sqrt(d * d
                                                        + 4 * apq * apq)),
                                 0.0)
                c = 1.0 / np.sqrt(1.0 + t * t)
                s, tau = t * c, t * c / (1.0 + c)
                if on_round is not None:
                    on_round(p.ravel(), q.ravel())
                pk, qk = p.ravel(), q.ravel()  # the round's table
                sk, tk = s.ravel(), tau.ravel()
                for b in range(blocks):
                    sl, tl = s[b][:, None], tau[b][:, None]
                    cp, cq = col_a[b, sp], col_a[b, sq]
                    x00, x01 = cp[:, pk], cq[:, pk]
                    x10, x11 = cp[:, qk], cq[:, qk]
                    x00, x10 = _rotate(sk, tk, x00, x10)
                    x01, x11 = _rotate(sk, tk, x01, x11)
                    y00, y01 = _rotate(sl, tl, x00, x01)
                    y10, y11 = _rotate(sl, tl, x10, x11)
                    diag = (np.arange(w), b * w + np.arange(w))
                    y00[diag] = app[b] - t[b] * apq[b]
                    y11[diag] = aqq[b] + t[b] * apq[b]
                    y01[diag] = y10[diag] = 0.0
                    rs, rq = sp[:, None], sq[:, None]
                    col_a[b, rs, pk], col_a[b, rq, pk] = y00, y01
                    col_a[b, rs, qk], col_a[b, rq, qk] = y10, y11
                    col_v[b, sp], col_v[b, sq] = _rotate(
                        sl, tl, col_v[b, sp], col_v[b, sq])
            if sr < 2 * blocks - 2:
                for arr in (col_a, col_v, idx):
                    arr[:] = _move_halves(
                        arr.reshape(blocks, 2, w, *arr.shape[2:]),
                        blocks).reshape(arr.shape)
        real = idx < n
        sq_a = col_a[:, :, :n] ** 2
        tot = sq_a[real].sum()
        on_diag = np.zeros_like(sq_a, dtype=bool)
        on_diag[np.nonzero(real) + (idx[real],)] = True
        off = tot - sq_a[on_diag].sum()
        if off <= (n * np.finfo(float).eps) ** 2 * tot or (
                prev >= 0 and off >= prev):
            break
        prev = off
    lam = col_a[np.nonzero(real) + (idx[real],)]
    j = idx[real]
    order = np.lexsort((j, lam))
    return lam[order], col_v[real][order].T, sweep


def _check(A, blocks):
    w, V, _ = _jacobi_emulated(A, blocks)
    w0, _ = torch.linalg.eigh(torch.as_tensor(A))
    nrm = np.linalg.norm(A)
    np.testing.assert_allclose(w, w0.numpy(), atol=1e-12 * nrm)
    np.testing.assert_allclose(V @ np.diag(w) @ V.T, A, atol=1e-12 * nrm)
    np.testing.assert_allclose(V.T @ V, np.eye(len(w)), atol=1e-12)
    return w0


def _matrix(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, n))
    A = X @ X.T
    A[0, 0] = A[-1, -1]  # a near-degenerate pair
    return A


@pytest.mark.parametrize("n", [1, 2, 9, 10])
def test_jacobi_schedule_matches_eigh(n):
    """The one-block kernel's algorithm (emulated) against
    torch.linalg.eigh, which is also the plain version jacobi.eigh takes
    for a CPU tensor."""
    A = _matrix(n, n)
    w0 = _check(A, 1)
    wp, _ = jacobi.eigh(torch.as_tensor(A))
    assert torch.equal(wp, w0)


@pytest.mark.parametrize("blocks,n", [(2, 4), (2, 7), (2, 16), (4, 8),
                                      (4, 21), (4, 24)])
def test_jacobi_cluster_matches_eigh(blocks, n):
    """The cluster variant's algorithm (emulated: the columns spread over
    the blocks' slots, the halves moving between super-rounds) against
    torch.linalg.eigh, padding included (n not a multiple of 2 blocks)."""
    _check(_matrix(n, 100 + n), blocks)


@pytest.mark.parametrize("blocks", [1, 2, 4, 8])
def test_jacobi_rounds_meet_every_pair_once(blocks):
    """Each sweep is m - 1 rounds of m/2 disjoint pairs in which every
    pair of columns meets exactly once, the halves' moves included (the
    second sweep starts where the first left them)."""
    for w in (1, 2, 3):
        m = 2 * blocks * w
        A = np.random.default_rng(m).standard_normal((m, m))
        seen = []
        sweeps = _jacobi_emulated(A @ A.T, blocks, on_round=lambda p, q:
                                  seen.append((p, q)))[2]
        assert len(seen) == sweeps * (m - 1) and (sweeps >= 2 or m == 2)
        for first in range(0, min(sweeps, 2) * (m - 1), m - 1):
            met = np.eye(m, dtype=int)
            for p, q in seen[first:first + m - 1]:
                assert np.sort(np.concatenate([p, q])).tolist() \
                    == list(range(m))
                np.add.at(met, (p, q), 1)
                np.add.at(met, (q, p), 1)
            assert (met == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_jacobi_routing_brackets_each_reach(dtype):
    """eigh_for at the orders around the one-block reach (168 in f32, 118
    in f64) and the cluster's (464, 320): the kernel up to the cluster's
    reach, torch.linalg.eigh above it on a CUDA device, the plain version
    of jacobi.eigh on the CPU at any order; the reach covers the Ritz
    matrix up to k = 376 (f32) / 248 (f64) and the diffusion preset's
    P=365 in f32."""
    one, top = jacobi.ONE_BLOCK_REACH[dtype], jacobi.REACH[dtype]
    assert (one, top) == ((168, 464) if dtype == torch.float32
                          else (118, 320))
    assert top >= (384 if dtype == torch.float32 else 256)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for n, cluster in ((1, False), (72, False), (one, False), (one + 1, True),
                       (top, True)):
        assert jacobi.fits(n, dtype) and jacobi.in_cluster(n, dtype) \
            == cluster
        assert jacobi.eigh_for(n, dtype, cuda) is jacobi.eigh
    assert not jacobi.fits(top + 1, dtype) and not jacobi.fits(0, dtype)
    assert jacobi.eigh_for(top + 1, dtype, cuda) is torch.linalg.eigh
    assert jacobi.eigh_for(top + 1, dtype, "cpu") is jacobi.eigh
    assert jacobi.eigh_for(top + 1, dtype, cpu) is jacobi.eigh
    assert not jacobi.fits(72, torch.float16)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        jacobi.eigh_cuda(torch.eye(3, dtype=dtype))


def test_jacobi_launch_constants_and_ritz_topk():
    """The C entry points' parameters against the wrapper's argument
    types, the cluster's size in the source against the reach's comment
    (the layout and the launch live in the source alone: the card tests
    hold the reach against the library's); the top-k Ritz solve (plain
    version on the CPU) against the top of a full eigendecomposition and
    against the JAX package's."""
    assert "constexpr int CLUSTER_BLOCKS = 8;" in SRC
    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int}
    assert set(build.SIGNATURES["jacobi"]) == set(
        re.findall(r'extern "C" int (\w+)\(', SRC))
    for fn, argtypes in build.SIGNATURES["jacobi"].items():
        params = re.search(rf'extern "C" int {fn}\((.*?)\)', SRC, re.S)[1]
        want = [ctype[re.sub(r"^const |\s*\w+$", "", a.strip())]
                for a in params.split(",")]
        assert argtypes == want
    rng = np.random.default_rng(0)
    U, _ = np.linalg.qr(rng.standard_normal((200, 200)))
    ev = np.concatenate([np.geomspace(1e-6, 1e-2, 180), np.geomspace(1, 1e3,
                                                                    20)])
    S = (U * ev) @ U.T
    gen = torch.Generator().manual_seed(1)
    ev_k, V_k = ttdvp._randomized_topk_eigh(torch.as_tensor(S), 10, gen)
    np.testing.assert_allclose(ev_k.numpy(), ev[-10:], rtol=1e-8)
    assert V_k.shape == (200, 10)
    ev_j, _ = jtdvp._randomized_topk_eigh(jax.numpy.asarray(S), 10,
                                          jax.random.PRNGKey(1))
    np.testing.assert_allclose(ev_k.numpy(), np.asarray(ev_j), rtol=1e-8)
