"""The JAX package's f64 standard-normal draw, in numpy.

``normal_f64(seed, shape)`` gives, bit for bit, what
``jax.random.normal(jax.random.PRNGKey(seed), shape, float64)`` gives on
the CPU with ``jax_threefry_partitionable`` on (the default of JAX 0.9):

- the key of ``PRNGKey(seed)`` is (seed >> 32, seed & 0xffffffff);
- element i of the flattened shape takes the Threefry-2x32 (20 rounds)
  hash of the counter pair (i >> 32, i & 0xffffffff); the two output words
  make the 64-bit draw (hi << 32) | lo;
- the top 52 bits become a mantissa in [1, 2); minus 1, scaled onto
  [nextafter(-1, 0), 1) by one fused multiply-add, clamped below;
- the result is sqrt(2) erfinv(u), with erfinv the XLA expansion of Giles'
  f64 approximation: w = -log1p(-u^2), then one of three Horner
  polynomials in w - 3.125, sqrt(w) - 3.25 or sqrt(w) - 5, evaluated with
  fused multiply-adds. XLA's f64 log1p is itself a Cephes rational
  approximation below |x| < sqrt(2) - 1 (Horner with fused multiply-adds,
  the rest without) and the C library's log above.

XLA compiles the polynomials to fused multiply-adds, and one rounding
there moves the last bit, so ``_fma`` computes a * b + c with one rounding
on numpy arrays: Boldo and Melquiond's emulation (the exact product as a
pair of doubles by Dekker's split, an exact sum with c, the two low parts
added with rounding to odd, one final rounding to nearest). The port needs
JAX's numbers for the random SPD matrix of ops/evolution.py and for the
synthetic data of pretrain/train.py (``gen_data``), whose draws run to
millions of elements, so every step works on whole arrays.
"""

from __future__ import annotations

import math

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def threefry2x32(k1: int, k2: int, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32 with 20 rounds on uint32 arrays (JAX's
    ``threefry2x32_p``)."""
    ks = [np.uint32(k1), np.uint32(k2), np.uint32(k1 ^ k2 ^ _PARITY)]
    x = [(x1.astype(np.uint32) + ks[0]).astype(np.uint32),
         (x2.astype(np.uint32) + ks[1]).astype(np.uint32)]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = (x[0] + x[1]).astype(np.uint32)
                rot = ((x[1] << np.uint32(r))
                       | (x[1] >> np.uint32(32 - r))).astype(np.uint32)
                x[1] = rot ^ x[0]
            x[0] = (x[0] + ks[(i + 1) % 3]).astype(np.uint32)
            x[1] = (x[1] + ks[(i + 2) % 3]
                    + np.uint32(i + 1)).astype(np.uint32)
    return x


def random_bits64(seed: int, n: int) -> np.ndarray:
    """n 64-bit draws of the key PRNGKey(seed), in flattened order."""
    i = np.arange(n, dtype=np.uint64)
    hi, lo = threefry2x32((seed >> 32) & _M32, seed & _M32,
                          (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(_M32)).astype(np.uint32))
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _two_sum(a, b):
    """(s, e) with s = fl(a + b) and s + e = a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    """Veltkamp's split of a into two 26-bit halves, a = hi + lo."""
    c = 134217729.0 * a  # 2^27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """(p, e) with p = fl(a b) and p + e = a b exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _add_round_odd(a, b):
    """a + b rounded to odd: the sum rounded to nearest, moved one ulp
    toward the exact sum when inexact and its last bit is even."""
    s, e = _two_sum(a, b)
    even = (s.view(np.int64) & 1) == 0
    toward = np.where(e > 0, np.inf, -np.inf)
    return np.where((e != 0) & even, np.nextafter(s, toward), s)


def _fma(a, b, c):
    """a * b + c with one rounding, on float64 arrays (the magnitudes here
    are far from overflow and underflow, where Dekker's split holds)."""
    a, b, c = (np.asarray(v, dtype=np.float64) for v in (a, b, c))
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _add_round_odd(tl, ul)


def _horner_fma(x, coeffs):
    p = np.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972e-1,
              6.5787325942061044846e0, 2.9911919328553073277e1,
              6.0949667980987787057e1, 5.7112963590585538103e1,
              2.0039553499201281259e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469e1,
              2.2176239823732856465e2, 3.0909872225312059774e2,
              2.1642788614495947685e2, 6.0118660497603843919e1)


def _log1p(x: np.ndarray) -> np.ndarray:
    big = np.abs(x) >= 0.41421356237309504880
    # the C library's log where XLA calls it (numpy's own log may differ
    # in the last bit)
    out = np.array([math.log(v + 1.0) for v in x[big].tolist()],
                   dtype=np.float64)
    xs = x[~big]
    r = _horner_fma(xs, _LOG1P_NUM) / _horner_fma(xs, _LOG1P_DEN)
    t = xs * (xs * xs) * r
    t = (-0.5 * xs) * xs + t
    res = np.empty_like(x)
    res[big] = out
    res[~big] = xs + t
    return res


_ERFINV_W6 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV_W16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV_WBIG = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


def erfinv(x) -> np.ndarray:
    """XLA's f64 erf_inv, elementwise."""
    x = np.asarray(x, dtype=np.float64)
    w = -_log1p(x * -x)
    # each polynomial on its own elements only (w < 6.25 holds for all but
    # ~0.1% of uniform draws): the emulated fused multiply-adds dominate
    p = np.empty_like(w)
    lo = w < 6.25
    mid = ~lo & (w < 16.0)
    hi = ~(lo | mid)
    p[lo] = _horner_fma(w[lo] - 3.125, _ERFINV_W6)
    p[mid] = _horner_fma(np.sqrt(w[mid]) - 3.25, _ERFINV_W16)
    p[hi] = _horner_fma(np.sqrt(w[hi]) - 5.0, _ERFINV_WBIG)
    return np.where(np.abs(x) == 1.0, x * np.inf, p * x)


def normal_f64(seed: int, shape) -> np.ndarray:
    """jax.random.normal(PRNGKey(seed), shape, float64), bit for bit."""
    n = math.prod(shape)
    bits = random_bits64(seed, n)
    mant = (bits >> np.uint64(12)) | np.array(1.0).view(np.uint64)
    f = mant.view(np.float64) - 1.0
    lo = float(np.nextafter(-1.0, 0.0))
    u = np.maximum(lo, _fma(f, 1.0 - lo, lo))
    with np.errstate(divide="ignore", invalid="ignore"):
        return (math.sqrt(2.0) * erfinv(u)).reshape(shape)
