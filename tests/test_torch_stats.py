"""The port's split-Gram statistics (vmc_pde_torch/parallel/stats.py) and
the plain version of its fused quantize+force kernel (kernels/quant8.py)
against the JAX package, on the same numpy f32 inputs of 256 samples x 130
columns, on the CPU.

Tolerances:
- the bf16 split, the int8 quantization and quant8's q8 are
  bit-identical: both round to nearest even at the same f32 values;
- results built from exact int32 products (the int8 cross term) agree to
  1e-6 of their largest value: the int32 products are identical and only
  the de-scaling's f32 rounding may differ;
- results of bf16 products agree to 1e-6 of their largest value: each
  product is exact in f32 in both packages (the port upcasts on the CPU,
  XLA contracts bf16 in f32), so only the f32 summation order differs
  (~256 terms, a few ulp of the largest partial sum);
- quant8's f to 1e-6 relative, for the same reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmc_pde_torch.kernels import quant8
from vmc_pde_torch.parallel import stats
from vmc_pde_tpu.kernels import quant8 as jquant8
from vmc_pde_tpu.parallel import stats as jstats

torch.set_num_threads(1)

N, P = 256, 130
BOUNDS = (0, 40, 80, 130)  # three panels, the last one merged


def _data(seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, P)).astype(np.float32)
    X[:, 7] = 0.0                         # an empty column
    X[5, 11] = 50.0                       # an outlier sets a column's scale
    w = rng.standard_normal(N).astype(np.float32)
    return X, w


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol=1e-6):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _pair(X):
    return (stats._split_bf16(torch.from_numpy(X)),
            jstats._split_bf16(jnp.asarray(X)))


def test_split_and_quantization_bit_identical():
    X, _ = _data()
    (hi, lo), (jhi, jlo) = _pair(X)
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(hi), _np(jhi))
    np.testing.assert_array_equal(_np(lo), _np(jlo))
    # the split halves hold exact ties of x * 127 / amax, where a
    # reciprocal-multiply quotient rounds the other way
    for x, jx in ((torch.from_numpy(X), jnp.asarray(X)), (hi, jhi),
                  (lo, jlo)):
        q, scale = stats._quant_cols_int8(x)
        jq, jscale = jstats._quant_cols_int8(jx)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
        assert (q[:, 7] == 0).all() and q.abs().max() == 127
    assert stats._INT8_CROSS_N_MAX == jstats._INT8_CROSS_N_MAX


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_split_grams_match_jax(weighted, int8):
    """sym2 and the tri2 raw parts with their finalize, unweighted and
    with signed weights (the chunked path's E_loc-weighted moment), with
    the bf16 or the int8 cross term."""
    X, w = _data()
    tw = torch.from_numpy(w) if weighted else None
    jw = jnp.asarray(w) if weighted else None
    tX, jX = torch.from_numpy(X), jnp.asarray(X)
    _close(stats.sym2_gram_sum(tX, tw, cross_int8=int8),
           jstats.sym2_gram_sum(jX, jw, cross_int8=int8))
    raw = stats.tri2_gram_sum_raw(tX, tw, BOUNDS, cross_int8=int8)
    jraw = jstats.tri2_gram_sum_raw(jX, jw, BOUNDS, cross_int8=int8)
    for s, js in zip(raw["t"], jraw["t"]):
        _close(s, js)
    _close(raw["m2"], jraw["m2"])
    _close(stats.tri2_gram_finalize(raw, BOUNDS),
           jstats.tri2_gram_finalize(jraw, BOUNDS))
    assert stats.tri2_bounds(9264) == jstats.tri2_bounds(9264)
    assert stats.tri2_bounds(130, 40) == jstats.tri2_bounds(130, 40)


@pytest.mark.parametrize("int8", [False, True])
def test_pair_helpers_match_jax(int8):
    """The pre-split pair's consumers: reconstruction, column sums, the
    three-term matvec, the cross term and both pair Grams, with the int8
    scale bounds the chunked path derives from the column max."""
    X, w = _data()
    pair, jpair = _pair(X)
    np.testing.assert_array_equal(_np(stats.pair_to_f32(pair)),
                                  _np(jstats.pair_to_f32(jpair)))
    _close(stats.pair_colsum(pair), jstats.pair_colsum(jpair))
    _close(stats.pair_vecmat(torch.from_numpy(w), pair),
           jstats.pair_vecmat(jnp.asarray(w), jpair))
    _close(stats._cross_sum(*pair, int8=int8),
           jstats._cross_sum(*jpair, int8=int8))
    omax = np.abs(X).max(0)
    amax = ((torch.from_numpy(omax) * (1 + 2**-8),
             torch.from_numpy(omax) * 2**-8) if int8 else None)
    jamax = ((jnp.asarray(omax) * np.float32(1 + 2**-8),
              jnp.asarray(omax) * np.float32(2**-8)) if int8 else None)
    _close(stats.sym2_gram_sum_pair(pair, int8, amax),
           jstats.sym2_gram_sum_pair(jpair, int8, jamax))
    raw = stats.tri2_gram_sum_raw_pair(pair, BOUNDS, int8, amax)
    jraw = jstats.tri2_gram_sum_raw_pair(jpair, BOUNDS, int8, jamax)
    _close(stats.tri2_gram_finalize(raw, BOUNDS),
           jstats.tri2_gram_finalize(jraw, BOUNDS))


def test_cross_from_q8_matches_jax():
    X, _ = _data()
    (hi, lo), (jhi, jlo) = _pair(X)
    qa, sa = stats._quant_cols_int8(hi)
    qb, sb = stats._quant_cols_int8(lo)
    jqa, jsa = jstats._quant_cols_int8(jhi)
    jqb, jsb = jstats._quant_cols_int8(jlo)
    got = stats.cross_from_q8(qa.T, qb.T, sa, sb)
    want = jstats.cross_from_q8(jqa.T, jqb.T, jsa, jsb)
    _close(got, want)


@pytest.mark.parametrize("kv", [1, 2])
def test_quant_force_plain_matches_pallas_interpret(kv):
    """quant8's plain version against the TPU kernel in interpret mode at
    P=130, n=256, on a real split half with a zero column: q8
    bit-identical, f to 1e-6 relative."""
    X, w = _data()
    (hi, _), (jhi, _) = _pair(X)
    amax = np.abs(_np(hi)).max(0)
    inv = np.where(amax > 0, np.float32(127.0) / np.maximum(amax, 1e-30),
                   0.0).astype(np.float32)
    V = np.stack([w, w[::-1]], axis=1)[:, :kv]
    tV = torch.from_numpy(np.ascontiguousarray(V)).to(torch.bfloat16)
    q8, f = quant8.quant_force(hi.T, torch.from_numpy(inv), tV)
    jq8, jf = jquant8.quant_force(jhi.T, jnp.asarray(inv),
                                  jnp.asarray(V, jnp.bfloat16),
                                  interpret=True)
    assert q8.dtype == torch.int8 and f.shape == (P, kv)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    _close(f, jf)
    assert (q8[7] == 0).all()


def test_quant8_constants_match_the_kernel_source():
    """quant8's rows per block here equal csrc/quant8.cu's (parsed from
    the source)."""
    from test_torch_syrk import kernel_constants

    assert kernel_constants("quant8.cu")["ROWS"] == quant8.ROWS


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers launch or raise: given CPU tensors they do
    not fall back to the plain versions, and count no launch."""
    X, w = _data()
    hi = torch.from_numpy(X).to(torch.bfloat16)
    before = quant8.quant_force_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        quant8.quant_force_cuda(hi.T, torch.ones(P),
                                hi[:, :1].contiguous())
    assert quant8.quant_force_cuda.launches == before


@pytest.mark.parametrize("K", [2048, 2 * 2048, 37 * 2048 + 5])
def test_bf16_product_blocks_the_contraction(K):
    """_mm_bf16 contracts in blocks of _BF16_K_BLOCK terms (a batched
    product over the blocks plus the remainder, summed in f32): against
    the f64 product of the same bf16 values to 1e-6 of the largest value,
    as one f32 product would be."""
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.standard_normal((9, K)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((K, 7)).astype(np.float32))
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    got = stats._mm_bf16(a16, b16)
    assert got.dtype == torch.float32 and got.shape == (9, 7)
    _close(got, a16.double() @ b16.double())
    # a transposed operand, as the Gram strips pass it
    _close(stats._mm_bf16(b16.T, b16), b16.double().T @ b16.double())
