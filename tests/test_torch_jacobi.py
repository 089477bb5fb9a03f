"""The Jacobi eigensolve (vmc_pde_torch/kernels/jacobi.py,
csrc/jacobi.cu) on the CPU, where the kernel cannot run: both of its
variants' algorithms emulated in numpy -- one block (the round robin over
the columns, the fused two-sided 2 x 2 update in Rutishauser's form, the
convergence test and the ranking) and the block variant (column blocks of
width b paired by the circle method, each pair's 2b x 2b subproblem
rotated by one inner sweep whose rotations accumulate into an orthogonal
Q, the off-diagonal pair tiles updated as Q_i^T A_ij Q_j, V as V Q_j) --
its C interface against the wrapper's, the TDVP's routing by order, and
the top-k Ritz solve against the JAX package's.

Tolerances: the emulations against torch.linalg.eigh in f64, eigenvalues
to 1e-12 of the matrix's norm and V diag(w) V^T to 1e-12 (rounding of a
few thousand rotations); a pair's Q orthogonal, and Q^T S Q equal to the
rotated subproblem, to 1e-13 of the subproblem's norm (one inner sweep of
at most 15 rounds); the Ritz top-k against the true spectrum to rtol 1e-8
(two subspace iterations on a gap of 100x), the JAX package's to 1e-8
(different random starts).
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
EPS = np.finfo(float).eps


def _rotate(s, tau, x, y):
    """(c x - s y, s x + c y) in Rutishauser's form, tau = s / (1 + c)."""
    return x - s * (y + tau * x), y + s * (x - tau * y)


def _rotations(app, aqq, apq, live):
    """The kernel's rotations zeroing A_pq: (t, s, tau), identity where
    not ``live``."""
    d = aqq - app
    with np.errstate(invalid="ignore", divide="ignore"):
        t = np.where(live, np.where(d >= 0, 2 * apq, -2 * apq)
                     / (np.abs(d) + np.sqrt(d * d + 4 * apq * apq)), 0.0)
    c = 1.0 / np.sqrt(1.0 + t * t)
    return t, t * c, t * c / (1.0 + c)


def _circle(n_players, r):
    """Round r of the circle method over ``n_players`` (even): the pairs
    (p, q) as two arrays, pair 0 holding the last player."""
    last = n_players - 1
    i = np.arange(n_players // 2)
    return (np.where(i == 0, r, (r + i) % last),
            np.where(i == 0, last, (r - i) % last))


def _rotate_pairs(S, p, q, live):
    """One round of disjoint rotations (p_l, q_l) on the symmetric S,
    two-sided as the kernels apply it: each 2 x 2 block X =
    S[{p_k, q_k}, {p_l, q_l}] <- J_k^T X J_l, rows first, the diagonal
    blocks k = l by A_pp - t A_pq, A_qq + t A_pq and zeros. Returns the
    new S and the rotations (s, tau)."""
    t, s, tau = _rotations(S[p, p], S[q, q], S[q, p], live & (S[q, p] != 0))
    x00, x01 = S[np.ix_(p, p)], S[np.ix_(p, q)]
    x10, x11 = S[np.ix_(q, p)], S[np.ix_(q, q)]
    sk, tk = s[:, None], tau[:, None]
    x00, x10 = _rotate(sk, tk, x00, x10)
    x01, x11 = _rotate(sk, tk, x01, x11)
    x00, x01 = _rotate(s, tau, x00, x01)
    x10, x11 = _rotate(s, tau, x10, x11)
    diag = np.arange(len(p)), np.arange(len(p))
    apq = S[q, p]
    x00[diag] = S[p, p] - t * apq
    x11[diag] = S[q, q] + t * apq
    x01[diag] = x10[diag] = 0.0
    new = S.copy()
    new[np.ix_(p, p)], new[np.ix_(p, q)] = x00, x01
    new[np.ix_(q, p)], new[np.ix_(q, q)] = x10, x11
    return new, s, tau


def _converged(A, n, prev):
    """The kernels' stopping test on the off-diagonal mass of A[:n, :n]:
    (stop, off)."""
    tot = (A[:n, :n] ** 2).sum()
    off = tot - (np.diag(A)[:n] ** 2).sum()
    return off <= (n * EPS) ** 2 * tot or (prev >= 0 and off >= prev), off


def _ranked(A, V, n):
    """The eigenvalues ranked (ties by index) and V's columns with them."""
    lam = np.diag(A)[:n]
    order = np.lexsort((np.arange(n), lam))
    return lam[order], V[:n][:, order]


def _sym(A, m):
    """A's lower triangle, mirrored, zero-padded to order m."""
    n = A.shape[0]
    full = np.zeros((m, m))
    full[:n, :n] = np.tril(A) + np.tril(A, -1).T
    return full


def _jacobi_emulated(A, on_round=None):
    """csrc/jacobi.cu's one-block algorithm in numpy (f64): the columns in
    m = n padded to even slots, a sweep the m - 1 rounds of the circle.
    Returns (w, V, sweeps)."""
    n = A.shape[0]
    m = n + n % 2
    full, V = _sym(A, m), np.eye(m)
    prev, sweep = -1.0, 0
    while sweep < 30:
        sweep += 1
        for r in range(m - 1):
            p, q = _circle(m, r)
            if on_round is not None:
                on_round(p, q)
            full, s, tau = _rotate_pairs(full, p, q, (p < n) & (q < n))
            V[:, p], V[:, q] = _rotate(s, tau, V[:, p], V[:, q])
        stop, prev = _converged(full, n, prev)
        if stop:
            break
    return (*_ranked(full, V, n), sweep)


def _inner_pairs(bw, r, full):
    """Inner round r of a pair's 2b x 2b subproblem: the circle over its
    2b columns (a sweep's first round), or the first block's columns
    against the second's shifted by r."""
    if full:
        return _circle(2 * bw, r)
    l = np.arange(bw)
    return l, bw + (l + r) % bw


def _solve_pair(S, cols, n, bw, full, on_inner=None):
    """One inner sweep of a pair's subproblem S (its global columns
    ``cols``): the rotated S, written back symmetric from its lower
    triangle, and the accumulated Q."""
    Q = np.eye(2 * bw)
    for r in range(2 * bw - 1 if full else bw):
        p, q = _inner_pairs(bw, r, full)
        if on_inner is not None:
            on_inner(cols[p], cols[q])
        S, s, tau = _rotate_pairs(S, p, q, (cols[p] < n) & (cols[q] < n))
        Q[:, p], Q[:, q] = _rotate(s, tau, Q[:, p], Q[:, q])
    return np.tril(S) + np.tril(S, -1).T, Q


def _block_jacobi_emulated(A, bw, on_round=None, on_inner=None,
                           on_pair=None):
    """csrc/jacobi.cu's block variant in numpy (f64), its block width
    ``bw`` a parameter (the kernel's is 16): m = n padded to a multiple of
    2 bw, 2K blocks; a sweep is the 2K - 1 rounds of the circle over the
    blocks; in a round each pair's subproblem is rotated by one inner
    sweep (_solve_pair), then every off-diagonal pair tile becomes Q_i^T
    A_ij Q_j (with its mirror) and V's pair columns V Q_j, each Q applied
    as I + E. Returns (w, V, sweeps)."""
    n = A.shape[0]
    m = -(-n // (2 * bw)) * 2 * bw
    nb = m // bw
    full, V = _sym(A, m), np.eye(m)
    prev, sweep = -1.0, 0
    while sweep < 30:
        sweep += 1
        for r in range(nb - 1):
            P, Qb = _circle(nb, r)
            if on_round is not None:
                on_round(P, Qb)
            cols = [np.concatenate([np.arange(a * bw, (a + 1) * bw),
                                    np.arange(b * bw, (b + 1) * bw)])
                    for a, b in zip(P, Qb)]
            qs = []
            for c in cols:
                S0 = full[np.ix_(c, c)]
                S, Q = _solve_pair(S0, c, n, bw, r == 0, on_inner)
                if on_pair is not None:
                    on_pair(S0, S, Q)
                full[np.ix_(c, c)] = S
                qs.append(Q)
            # each Q applied as I + E: the products with E first, then
            # the matrix added
            es = [Q - np.eye(2 * bw) for Q in qs]
            for i in range(len(cols)):
                for j in range(i):
                    X = full[np.ix_(cols[i], cols[j])]
                    U = es[i].T @ X + X
                    Y = U @ es[j] + U
                    full[np.ix_(cols[i], cols[j])] = Y
                    full[np.ix_(cols[j], cols[i])] = Y.T
            for c, E in zip(cols, es):
                V[:, c] = V[:, c] @ E + V[:, c]
        stop, prev = _converged(full, n, prev)
        if stop:
            break
    return (*_ranked(full, V, n), sweep)


def _check(A, w, V):
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
    w, V, _ = _jacobi_emulated(A)
    w0 = _check(A, w, V)
    wp, _ = jacobi.eigh(torch.as_tensor(A))
    assert torch.equal(wp, w0)


@pytest.mark.parametrize("bw,n", [(4, 1), (4, 7), (4, 8), (4, 21), (4, 48),
                                  (8, 9), (8, 16), (8, 33), (8, 48)])
def test_jacobi_blocks_match_eigh(bw, n):
    """The block variant's algorithm (emulated, blocks of width 4 and 8)
    against torch.linalg.eigh, padding included (n not a multiple of 2b),
    within the kernel's sweep limit."""
    A = _matrix(n, 100 + n)
    w, V, sweeps = _block_jacobi_emulated(A, bw)
    _check(A, w, V)
    assert sweeps < 30


@pytest.mark.parametrize("bw,nb", [(4, 2), (4, 4), (4, 6), (8, 2), (8, 6)])
def test_jacobi_block_rounds_meet_every_pair_once(bw, nb):
    """Each sweep of the block variant is nb - 1 rounds of nb/2 disjoint
    block pairs in which every pair of blocks meets exactly once, and its
    inner rounds meet every pair of columns exactly once (the pairs inside
    a block in the sweep's first round); every pair's accumulated Q is
    orthogonal and takes its subproblem to the rotated one."""
    m = nb * bw
    A = np.random.default_rng(m + bw).standard_normal((m, m))
    rounds, inner, pairs = [], [], []
    _, _, sweeps = _block_jacobi_emulated(
        A @ A.T, bw, on_round=lambda p, q: rounds.append((p, q)),
        on_inner=lambda p, q: inner.append((p, q)),
        on_pair=lambda *x: pairs.append(x))
    assert sweeps >= 2 and len(rounds) == sweeps * (nb - 1)
    per_sweep = len(inner) // sweeps
    for first in range(2):
        met = np.eye(nb, dtype=int)
        for p, q in rounds[first * (nb - 1):(first + 1) * (nb - 1)]:
            assert np.sort(np.concatenate([p, q])).tolist() == list(range(nb))
            np.add.at(met, (p, q), 1)
            np.add.at(met, (q, p), 1)
        assert (met == 1).all()
        met = np.eye(m, dtype=int)
        for p, q in inner[first * per_sweep:(first + 1) * per_sweep]:
            np.add.at(met, (p, q), 1)
            np.add.at(met, (q, p), 1)
        assert (met == 1).all()
    for S0, S, Q in pairs[:3 * (nb // 2)]:
        nrm = np.linalg.norm(S0)
        np.testing.assert_allclose(Q.T @ Q, np.eye(2 * bw), atol=1e-13)
        np.testing.assert_allclose(Q.T @ S0 @ Q, S, atol=1e-13 * nrm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_jacobi_routing_brackets_each_reach(dtype):
    """eigh_for at every order up to the block variant's reach (2048 in
    both dtypes; the one block's 168 in f32, 118 in f64): the kernel on a
    CUDA device, in one block up to that reach and in blocks above it;
    torch.linalg.eigh above 2048 on a CUDA device; the plain version of
    jacobi.eigh on the CPU at any order. The reach covers the TDVP's
    eigh_max_params (2048) and every Ritz matrix it takes."""
    one, top = jacobi.ONE_BLOCK_REACH[dtype], jacobi.REACH[dtype]
    assert (one, top) == ((168, 2048) if dtype == torch.float32
                          else (118, 2048))
    assert top >= ttdvp.TDVPConfig().eigh_max_params
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for n in range(1, top + 1):
        assert jacobi.fits(n, dtype)
        assert jacobi.in_blocks(n, dtype) == (n > one)
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
    types; the block variant's reach and block width in the source against
    the wrapper's REACH and the emulation's pair width (a pair is one warp:
    its 32 columns one a lane); the top-k Ritz solve (plain version on the
    CPU) against the top of a full eigendecomposition and against the JAX
    package's."""
    const = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", SRC))
    assert int(const["BLOCK_REACH"]) == jacobi.REACH[torch.float32] \
        == jacobi.REACH[torch.float64]
    assert int(const["BW"]) == 16 and const["PW"] == "2 * BW" \
        and const["BT"] == "BW * BW"
    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int}
    assert set(build.SIGNATURES["jacobi"]) == set(
        re.findall(r'extern "C" int (\w+)\(', SRC))
    for fn, argtypes in build.SIGNATURES["jacobi"].items():
        params = re.search(rf'extern "C" int {fn}\((.*?)\)', SRC, re.S)[1]
        want = [ctype[re.sub(r"^const |\s*\w+$", "", a.strip())]
                for a in params.split(",") if a.strip() != "void"]
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
