"""Sample statistics, the counterpart of vmc_pde_tpu/parallel/stats.py.

Every statistic is a plain torch reduction over the leading sample axis.
On a mesh (parallel/mesh.py) a rank holds its shard of the rows: its sums
cross ranks through ``mesh.all_reduce_sum`` and divide by the GLOBAL
count (``global_means``; ``second_moment_matrix`` takes the count), never
by the shard's. The f32 Gram is one ``torch.matmul``; on the card it
runs in full f32 because utils/dtypes.full_f32_matmuls turns TF32 off,
which is what the JAX package's ``gram_backend="auto"`` resolves to off
the TPU.

The split backends emulate that f32 Gram with bf16 operands, as the JAX
package does on the TPU's matrix unit: x = hi + lo in bf16 (exact up to a
~2^-16 relative residual), and X^T X ~= H^T H + H^T L + (H^T L)^T with the
lo^T lo term dropped. ``sym2`` computes the two products in full;
``tri2`` computes only the lower block-triangle of the symmetric H^T H,
accumulates the raw parts across chunks and mirrors once
(``tri2_gram_finalize``). The cross term H^T L may run on int8 with
per-column scales (``gram_cross="int8"``).

Every product here is a library GEMM, as in the JAX package, where they
are XLA contractions outside any Pallas kernel:

- bf16 x bf16 -> f32 (``_mm_bf16``): ``torch.mm``/``torch.bmm`` with
  ``out_dtype=float32`` on the card (cuBLAS with f32 accumulation,
  blocked along the contraction, see _BF16_K_BLOCK; reduced-precision
  reductions are off, utils/dtypes.full_f32_matmuls); on the CPU, which
  has no such kernel, the operands are upcast to f32 -- a bf16 product is
  exact in f32, so only the summation order differs;
- int8 x int8 -> int32 (``_mm_int8``): ``torch._int_mm``, exact. cuBLASLt
  wants more than 16 rows and inner and column sizes that are multiples
  of 8 (operands are zero-padded to them); both operands are passed as
  (rows, contraction) row-major.

A bf16 output is never taken from a plain bf16 matmul.

``gram_precision`` (the JAX package's PRECISIONS, stats.py:31-64) says how
the statistics contract; ``contract`` applies it to one product:

- ``highest``, ``high``: the product in the operands' dtype, full f32 on
  the card (TF32 off);
- ``default``: the JAX package's one-pass reduced product. On a CUDA
  device f32 operands contract in one bf16 pass with f32 accumulation
  (``_mm_bf16``, whose K blocks bound the tensor cores' truncation); on
  the CPU it is the f32 product, as the JAX package's DEFAULT is on its
  CPU backend;
- ``f64``: the f32 operands cast to f64 and contracted in f64
  (GRAM_OPERAND_DTYPE), with f64 accumulators across chunks;
- ``f64acc``: the f32 product per chunk, accumulated across chunks in f64
  (GRAM_ACC_DTYPE; the chunked statistics only).
"""

from __future__ import annotations

import torch

from . import mesh

PRECISIONS = ("highest", "high", "default", "f64", "f64acc")
# the operand dtype of a mode's contractions (absent: the compute dtype)
GRAM_OPERAND_DTYPE = {"f64": torch.float64}
# the chunked statistics' accumulator dtype (absent: the compute dtype)
GRAM_ACC_DTYPE = {"f64": torch.float64, "f64acc": torch.float64}

# Exact int32 accumulation bound of the int8 cross term: |q| <= 127, so a
# sum over N samples stays below 2^31 - 1 for N <= 133152; rounded down to
# 131072 (131072 * 127^2 = 2.114e9). Longer contractions take the bf16
# cross pass (stats.py:117-123 of the JAX package).
_INT8_CROSS_N_MAX = 131072


def global_means(ctx, tensors, n: int):
    """E over the global sample axis of each rank-local (N/W, ...) tensor:
    the local sums cross ranks in one all-reduce and divide by the global
    count ``n`` (the JAX package's psum(sum) / n_global). On one rank, the
    plain means."""
    if ctx.world == 1:
        return [t.mean(dim=0) for t in tensors]
    sums = mesh.all_reduce_sum(ctx, [t.sum(dim=0) for t in tensors])
    return [s / n for s in sums]


def mean(data, axis=0):
    """E[X] over the sample axis (the JAX package's stats.mean)."""
    return data.mean(dim=axis)


def variance(data, axis=0):
    """E[|X - E X|^2] over the sample axis, biased like the reference's
    (the JAX package's stats.variance)."""
    d = data - data.mean(dim=axis, keepdim=True)
    return (d.conj() * d).real.mean(dim=axis)


def weighted_second_moment_matrix(data, w):
    """E[w_i X_i^T X_i] with per-sample weights w of shape (N,)."""
    return second_moment_matrix(data, w)


def covariance_matrix(data):
    """E[(X - m)^T (X - m)] of data (N, P), m the sample mean."""
    return second_moment_matrix(data - data.mean(dim=0, keepdim=True))


def second_moment_matrix(data, w=None, n=None):
    """E[w_i X_i^T X_i] for data of shape (N, P), with optional per-sample
    weights w (N,): the Gram contraction of the TDVP step. ``n``: the
    count to normalize by (default the rows given; a shard's caller passes
    the global count and sums the ranks' results)."""
    n = data.shape[0] if n is None else n
    rhs = data if w is None else data * w[:, None]
    return torch.matmul(data.T, rhs) / n


# The card's tensor cores add each bf16 product step into their f32
# accumulator with truncation, not rounding, so a long contraction shrinks
# every partial sum a little: a sum of squares of 65536 terms comes out
# 5.6e-5 low (cuBLAS's f32 product: 6.4e-6), and the chunked tri2 + int8
# S0 at chunk 65536 had an eigenvalue of -2.6e-5 lambda_max, below the
# Cholesky solve's Tikhonov shift of 64 eps_f32 = 7.6e-6 lambda_max, which
# then failed (H100 80GB HBM3, 700 W, tools/split_gram_accuracy.py). So a
# bf16 product contracts at most _BF16_K_BLOCK terms per tensor-core
# accumulation, as a batched GEMM over K blocks (_BF16_BATCH blocks per
# call, which bounds its output), and sums the blocks in f32. At 2048 the
# shrink is 5.2e-6, the f32 product's grade, for ~6% more statistics time
# than one product.
_BF16_K_BLOCK = 2048
_BF16_BATCH = 16


def _mm_bf16(a, b):
    """a @ b for bf16 operands with an f32 result (f32 accumulation), in
    blocks of at most _BF16_K_BLOCK contraction terms."""
    cuda = a.device.type == "cuda"

    def mm(x, y):  # one product, (x @ y) or a batch of them
        if cuda:
            return (torch.mm if x.ndim == 2 else torch.bmm)(
                x, y, out_dtype=torch.float32)
        return torch.matmul(x.float(), y.float())

    kb = _BF16_K_BLOCK
    nb, rem = divmod(a.shape[1], kb)
    if nb <= 1:
        return mm(a, b)
    out = mm(a[:, nb * kb:], b[nb * kb:]) if rem else None
    for g0 in range(0, nb, _BF16_BATCH):
        g1 = min(nb, g0 + _BF16_BATCH)
        a3 = a[:, g0 * kb:g1 * kb].unflatten(1, (g1 - g0, kb)).transpose(0, 1)
        b3 = b[g0 * kb:g1 * kb].unflatten(0, (g1 - g0, kb))
        part = mm(a3, b3).sum(0)
        out = part if out is None else out.add_(part)
    return out


def contract(a, b, mode="high"):
    """a @ b (1-D or 2-D operands, as torch.matmul takes them) as
    gram_precision ``mode`` contracts (module docstring)."""
    if mode == "f64":
        return torch.matmul(a.double(), b.double())
    if (mode == "default" and a.device.type == "cuda"
            and a.dtype == b.dtype == torch.float32):
        a2 = a if a.ndim == 2 else a[None, :]
        b2 = b if b.ndim == 2 else b[:, None]
        out = _mm_bf16(a2.bfloat16(), b2.bfloat16())
        if b.ndim == 1:
            out = out[:, 0]
        return out if a.ndim == 2 else out[0]
    return torch.matmul(a, b)


def _mm_int8(a_rk, b_ck):
    """a_rk @ b_ck^T for int8 operands (rows, k) and (cols, k): the exact
    int32 product contracting k. Operands whose sizes cuBLASLt refuses
    (P = 9397 with a Student-t latent and the global affine, for one) are
    zero-padded, which adds nothing to the sums, and the product is cut
    back."""
    (r, k), c = a_rk.shape, b_ck.shape[0]
    pad_r, pad_k, pad_c = max(17 - r, 0), -k % 8, -c % 8
    if pad_r or pad_k:
        a_rk = torch.nn.functional.pad(a_rk, (0, pad_k, 0, pad_r))
    if pad_c or pad_k:
        b_ck = torch.nn.functional.pad(b_ck, (0, pad_k, 0, pad_c))
    return torch._int_mm(a_rk.contiguous(), b_ck.contiguous().T)[:r, :c]


def _split_bf16(x):
    """Exact f32 = hi + lo bf16 operand decomposition, round to nearest
    even at both steps (eager torch folds nothing away, so no barrier is
    needed)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def _quant_cols_int8(x, amax=None):
    """Per-column symmetric int8 quantization of (N, P) x: x == scale * q
    + err with scale = colmax|x| / 127 (1 for zero columns). Rounds half
    to even after a multiply by the reciprocal scale, as the JAX package
    does, so q is bit-identical to its. ``amax``: the column max |x|,
    precomputed. Returns (q (N, P) int8, scale (P,) f32)."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim=0)
    scale, inv = _int8_scales(amax)
    return _quantize_int8(xf, inv[None, :]), scale


def _quantize_int8(xf, inv):
    """clamp(round(xf * inv), -127, 127) as int8, rounding half to even;
    ``inv`` broadcasts against f32 ``xf``."""
    return torch.clamp(torch.round(xf * inv), -127, 127).to(torch.int8)


def _int8_scales(amax):
    """(scale, inverse scale) of per-column int8 quantization from the
    column max |x|: (amax / 127, 127 / amax), or (1, 0) for a zero
    column. Both are true f32 divisions by tensors: torch evaluates
    ``127.0 / amax`` as ``amax.reciprocal() * 127`` and, on the card,
    ``amax / 127.0`` as ``amax * (1 / 127)``, each a rounding off the
    JAX package's quotient."""
    pos = amax > 0
    c127 = torch.full_like(amax, 127.0)
    scale = torch.where(pos, amax / c127, torch.ones_like(amax))
    inv = torch.where(pos, c127 / amax, torch.zeros_like(amax))
    return scale, inv


def _cross_sum(a, b, int8=False, amax=None, n_rows=None):
    """The hi/lo cross term a^T @ b -> f32 (P, P) of two (N, P) operands.

    Default: one bf16 product. ``int8=True``: per-column scales factor out
    of the contraction exactly, a^T b = diag(s) (a8^T b8) diag(t), with
    the int8 product exact in int32 -- up to N = _INT8_CROSS_N_MAX; longer
    contractions take the bf16 product. ``amax``: optional (colmax|a|,
    colmax|b|) pair. ``n_rows``: the whole contraction's length where a
    and b hold one rank's rows of it (default a's)."""
    n = a.shape[0] if n_rows is None else n_rows
    if int8 and n <= _INT8_CROSS_N_MAX:
        a8, sa = _quant_cols_int8(a, None if amax is None else amax[0])
        b8, sb = _quant_cols_int8(b, None if amax is None else amax[1])
        return cross_from_q8(a8.T, b8.T, sa, sb)
    return _mm_bf16(a.T, b)


def _weighted_split(data, w=None):
    """(hs, hi, lo): the bf16 split of sqrt(|w|) data, and hi with w's sign
    (exact in bf16)."""
    x = data.float()
    sign = None
    if w is not None:
        wf = w.float()
        x = x * wf.abs().sqrt()[:, None]
        sign = wf.sign()[:, None]
    hi, lo = _split_bf16(x)
    hs = hi if sign is None else hi * sign.to(hi.dtype)
    return hs, hi, lo


def _cross_amax(hs, lo, cross_int8, amax_fn):
    """The int8 cross term's column max pair (colmax|hs|, colmax|lo|) made
    global by ``amax_fn`` (an all-reduce MAX over the ranks that hold the
    rows), or None: the quantization then takes the operands' own."""
    if not (cross_int8 and amax_fn):
        return None
    return amax_fn(torch.stack([hs.float().abs().amax(0),
                                lo.float().abs().amax(0)]))


def _cross_rows(a, b, rows, int8=False, amax=None, n_rows=None):
    """Rows ``rows`` (a slice) of the symmetric cross term a^T b + (a^T b)^T
    of two (N, P) operands, (|rows|, P) in f32: a[:, rows]^T b + b[:, rows]^T
    a, by _cross_sum's rule (int8 with per-column scales over the whole
    columns, which factor out row by row, up to N = _INT8_CROSS_N_MAX)."""
    n = a.shape[0] if n_rows is None else n_rows
    if int8 and n <= _INT8_CROSS_N_MAX:
        a8, sa = _quant_cols_int8(a, None if amax is None else amax[0])
        b8, sb = _quant_cols_int8(b, None if amax is None else amax[1])
        return (cross_from_q8(a8[:, rows].T, b8.T, sa[rows], sb)
                + cross_from_q8(b8[:, rows].T, a8.T, sb[rows], sa))
    return _mm_bf16(a[:, rows].T, b) + _mm_bf16(b[:, rows].T, a)


def sym2_gram_sum(data, w=None, cross_int8=False, amax_fn=None,
                  n_rows=None, rows=None):
    """Unnormalized symmetric Gram X^T diag(w) X of (N, P) data in two
    bf16 products: H^T H + H^T L + (H^T L)^T. Weights of any sign fold in
    as X <- sqrt(|w|) X with the sign applied to one side's hi split
    (exact in bf16), so the operand symmetry survives. Where data holds
    one rank's rows of a sharded operand, ``amax_fn`` makes the int8 cross
    term's column scales global and ``n_rows`` is the whole length
    (_cross_sum), as the JAX package's GSPMD statistics quantize the
    global operand. ``rows``: (r0, r1), only those rows of the Gram
    (the tp-sharded layout), (r1 - r0, P)."""
    hs, hi, lo = _weighted_split(data, w)
    amax = _cross_amax(hs, lo, cross_int8, amax_fn)
    if rows is not None:
        r = slice(*rows)
        return _mm_bf16(hs[:, r].T, hi) + _cross_rows(
            hs, lo, r, int8=cross_int8, amax=amax, n_rows=n_rows)
    m1 = _mm_bf16(hs.T, hi)
    m2 = _cross_sum(hs, lo, int8=cross_int8, amax=amax, n_rows=n_rows)
    return m1 + m2 + m2.T


# -- consumers of a pre-split (hi, lo) pair: the split-emitting per-sample
# kernel writes the bf16 split of (O - shift) directly. Pair arrays are
# (N, P) bf16 with hi + lo == O - shift up to the dropped sub-lo residual.

def pair_to_f32(pair):
    """The f32 operand hi + lo (for the weighted moments, whose sqrt(w)
    scaling must precede the split)."""
    hi, lo = pair
    return hi.float() + lo.float()


def pair_colsum(pair):
    """Sum over the sample axis in f32."""
    hi, lo = pair
    return hi.float().sum(0) + lo.float().sum(0)


def pair_vecmat(v, pair):
    """v @ (hi + lo) with the f32 matvec's three hi/lo terms
    v_hi @ hi + v_lo @ hi + v_hi @ lo, the first two in one product of
    the stacked (2, N) [v_hi; v_lo]."""
    v_hi, v_lo = _split_bf16(v.float())
    hi, lo = pair
    r = _mm_bf16(torch.stack([v_hi, v_lo]), hi)
    r2 = _mm_bf16(v_hi[None, :], lo)
    return r[0] + r[1] + r2[0]


def cross_from_q8(q8_a_pn, q8_b_pn, sa, sb):
    """The cross term from pre-quantized (P, n) int8 operands: the exact
    int32 product contracting the sample axis, de-scaled in f32."""
    m = _mm_int8(q8_a_pn, q8_b_pn)
    return m.float() * sa[:, None] * sb[None, :]


def sym2_gram_sum_pair(pair, cross_int8=False, amax=None, m2=None):
    """Unweighted sym2_gram_sum from the pre-split pair. ``amax``:
    optional (colmax|hi| bound, colmax|lo| bound) for the int8 cross
    quantization; ``m2``: optional precomputed cross term
    (cross_from_q8)."""
    hi, lo = pair
    m1 = _mm_bf16(hi.T, hi)
    if m2 is None:
        m2 = _cross_sum(hi, lo, int8=cross_int8, amax=amax)
    return m1 + m2 + m2.T


def tri2_gram_sum_raw_pair(pair, bounds, cross_int8=False, amax=None,
                           m2=None):
    """Unweighted tri2_gram_sum_raw from the pre-split pair (the same raw
    {"t", "m2"} parts)."""
    hi, lo = pair
    return _tri2_from_split(hi, hi, lo, bounds, cross_int8=cross_int8,
                            amax=amax, m2=m2)


def sym2_outer_sum(data):
    """Unnormalized symmetric outer Gram X X^T of (N, P) data, (N, N), in
    two bf16 products: H H^T + H L^T + (H L^T)^T, sym2_gram_sum's split in
    the kernel-space orientation of minSR's T. The contraction runs over
    P, in _mm_bf16's bounded K blocks."""
    hi, lo = _split_bf16(data.float())
    m1 = _mm_bf16(hi, hi.T)
    m2 = _mm_bf16(hi, lo.T)
    return m1 + m2 + m2.T


def tri2_bounds(P, target_block=512):
    """Panel boundaries (0, b_1, ..., P) of the triangle-blocked Gram:
    panels of exactly ``target_block`` columns, the remainder merged into
    the last panel (K = max(1, P // target_block))."""
    K = max(1, P // target_block)
    return tuple([i * target_block for i in range(K)] + [P])


def tri2_gram_sum_raw(data, w=None, bounds=None, cross_int8=False,
                      amax_fn=None, n_rows=None):
    """Triangle-blocked two-product Gram of (N, P) data: the unnormalized
    X^T diag(w) X as raw parts {"t": strips, "m2": cross term} that a
    chunk loop sums and ``tri2_gram_finalize`` mirrors once. Row panel i
    of H^T H costs one (p_i, N) x (N, b_{i+1}) product, so the triangle
    is (1 + 1/K)/2 of a full product; the cross term stays a full one.
    Signed weights, ``amax_fn`` and ``n_rows`` as in sym2_gram_sum."""
    hs, hi, lo = _weighted_split(data, w)
    if bounds is None:
        bounds = tri2_bounds(data.shape[1])
    return _tri2_from_split(hs, hi, lo, bounds, cross_int8=cross_int8,
                            amax=_cross_amax(hs, lo, cross_int8, amax_fn),
                            n_rows=n_rows)


def _tri2_from_split(hs, hi, lo, bounds, cross_int8=False, amax=None,
                     m2=None, n_rows=None):
    """tri2 raw parts from a split (hs, hi, lo) triple; the strips stay
    unpadded (a tuple of (p_i, b_{i+1}) blocks)."""
    if m2 is None:
        m2 = _cross_sum(hs, lo, int8=cross_int8, amax=amax, n_rows=n_rows)
    strips = tuple(_mm_bf16(hs[:, lo_b:hi_b].T, hi[:, :hi_b])
                   for lo_b, hi_b in zip(bounds[:-1], bounds[1:]))
    return {"t": strips, "m2": m2}


def tri2_gram_finalize(raw, bounds):
    """The full symmetric Gram from accumulated raw parts:
    S = M1 + m2 + m2^T with M1 = T + T^T - sym(block-diagonal of T). The
    diagonal panels appear in both T and T^T; they are symmetric up to
    summation order, so their symmetrized copy is subtracted once."""
    m2 = raw["m2"]
    P = m2.shape[0]
    T = torch.zeros((P, P), dtype=m2.dtype, device=m2.device)
    D = torch.zeros_like(T)
    for strip, lo_b, hi_b in zip(raw["t"], bounds[:-1], bounds[1:]):
        T[lo_b:hi_b, :hi_b] = strip
        D[lo_b:hi_b, lo_b:hi_b] = strip[:, lo_b:hi_b]
    M1 = T + T.T - 0.5 * (D + D.T)
    return M1 + m2 + m2.T
