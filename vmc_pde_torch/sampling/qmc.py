"""Randomized quasi-Monte Carlo (scrambled Sobol) latent draws, the
counterpart of vmc_pde_tpu/sampling/qmc.py.

Every statistics batch of the TDVP step is an integral over the latent
base distribution estimated from N draws; a low-discrepancy point set in
place of iid draws cuts the estimator error from O(N^-1/2) toward
O(N^-1 log^d N) for the smooth integrands of the exact-latent presets.

- Sobol points come from the (30, dim) direction-number table: point i
  is the XOR of the direction numbers selected by the bits of the Gray
  code i ^ (i >> 1), masked XOR passes over an (n, dim) int32 array
  (every value is below 2^30, so int32 shifts, ANDs and XORs are exact;
  torch supports few operators on uint32). The table comes from scipy's
  Joe-Kuo tables (scipy.stats.qmc.Sobol), cached on each device once.
- Each call randomizes the net by a Matousek linear-matrix scramble of
  the direction table plus a random digital shift, so each call draws an
  independent, unbiased random net. ``scrambled_bits_from_words`` takes
  the raw 30-bit words (the (30, dim) LMS words and the (dim,) shift);
  ``scrambled_bits`` draws them from a ``torch.Generator``.
- Uniforms map to Gaussians through the inverse CDF with the mirror done
  on the integer grid (2^30 - 1 - bits), so that both tails keep the
  small-u accuracy of ndtri.
- chi^2 draws invert the regularized incomplete gamma function by Newton
  iterations in log space, always in f64 (the JAX package runs with x64
  enabled, so its inversion is f64 too), then cast. The iterations run on
  ``torch.special.gammainc``, which errs up to 1.8e-9 relative at shape
  25; two more steps on the module's own P(k, x) (``gammainc_f64``, within
  a few f64 ulps of scipy's) land on the root of the exact function.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..utils.dtypes import device_constant

_BITS = 30  # scipy's Sobol tables carry 30-bit direction numbers
_MASK = (1 << _BITS) - 1


@lru_cache(maxsize=None)
def direction_numbers(dim: int) -> np.ndarray:
    """(30, dim) uint32 Sobol direction-number table (host constant),
    scipy's Joe-Kuo numbers; no other source is used."""
    if dim < 1:
        raise ValueError("dim must be >= 1")
    try:
        from scipy.stats import qmc as _scipy_qmc

        sv = np.asarray(_scipy_qmc.Sobol(d=dim, scramble=False)._sv)
    except (ImportError, AttributeError) as e:  # pragma: no cover
        raise RuntimeError(
            "QMC sampling needs scipy's Sobol direction numbers "
            "(scipy.stats.qmc.Sobol._sv); scipy is missing or its internal "
            "layout changed -- use the default pseudo-random sampling"
        ) from e
    if sv.shape != (dim, _BITS):  # pragma: no cover
        raise RuntimeError(
            f"unexpected scipy Sobol table shape {sv.shape}; expected "
            f"({dim}, {_BITS})")
    return np.ascontiguousarray(sv.T.astype(np.uint32))


@lru_cache(maxsize=None)
def _table_values(dim: int):
    return tuple(map(tuple, direction_numbers(dim).tolist()))


def _directions(dim: int, device) -> torch.Tensor:
    """The (30, dim) int32 direction table on ``device``, made once."""
    return device_constant(_table_values(dim), torch.device(device),
                           torch.int32)


def _net(V: torch.Tensor, n: int) -> torch.Tensor:
    """(n, dim) int32 points of the digital net with direction numbers V:
    point i XORs V[k] over the set bits k of gray(i) = i ^ (i >> 1). The
    passes above the highest bit of n - 1 select nothing and are
    skipped."""
    if n > 1 << _BITS:
        raise ValueError(f"n={n} exceeds the Sobol table's 2^{_BITS} points")
    i = torch.arange(n, dtype=torch.int32, device=V.device)
    gray = i ^ (i >> 1)
    acc = torch.zeros((n, V.shape[1]), dtype=torch.int32, device=V.device)
    for k in range(max(n - 1, 0).bit_length()):
        acc ^= (-((gray >> k) & 1))[:, None] & V[k]
    return acc


def sobol_bits(dim: int, n: int, device="cpu") -> torch.Tensor:
    """The first n Sobol points as (n, dim) int32 in [0, 2^30)."""
    return _net(_directions(dim, device), n)


def _lms_directions(V: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Matousek linear-matrix-scrambled direction numbers: per dimension a
    random unit-diagonal lower-triangular GF(2) matrix M maps digit vectors
    a -> M a, which commutes with the XOR construction, so it is applied
    once to the (30, dim) table. Digit b (most significant first) lives at
    bit 29 - b; column c of M is the word with bit 29 - c set and the
    random bits of ``words[c]`` strictly below it."""
    out = torch.zeros_like(V)
    for c in range(_BITS):
        top = 1 << (_BITS - 1 - c)
        mcol = (words[c] & (top - 1)) | top
        out ^= (-((V >> (_BITS - 1 - c)) & 1)) & mcol
    return out


def scrambled_bits_from_words(n: int, lms_words: torch.Tensor,
                              shift: torch.Tensor) -> torch.Tensor:
    """(n, dim) int32 points of the Sobol net scrambled by the (30, dim)
    LMS words and digitally shifted by the (dim,) shift, each a 30-bit
    word (higher bits are masked off), on the words' device."""
    dim = shift.shape[0]
    lms_words = (lms_words.to(torch.int64) & _MASK).to(torch.int32)
    shift = (shift.to(torch.int64) & _MASK).to(torch.int32)
    V = _lms_directions(_directions(dim, shift.device), lms_words)
    return _net(V, n) ^ shift


def draw_words(gen: torch.Generator, dim: int, device=None):
    """The (30, dim) LMS words and the (dim,) shift of one randomization,
    30-bit words drawn from ``gen`` on ``device`` (default the
    generator's)."""
    device = gen.device if device is None else device
    kw = dict(generator=gen, dtype=torch.int32, device=device)
    lms = torch.randint(0, 1 << _BITS, (_BITS, dim), **kw)
    return lms, torch.randint(0, 1 << _BITS, (dim,), **kw)


def scrambled_bits(gen: torch.Generator, dim: int, n: int, device=None):
    """(n, dim) scrambled Sobol points of one randomization drawn from
    ``gen``: a fresh generator state gives an independent random net."""
    return scrambled_bits_from_words(n, *draw_words(gen, dim, device))


def _mirrored_ndtri(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Standard normals from 30-bit uniforms by the inverse CDF: z =
    ndtri(u) for u <= 1/2 and -ndtri(1 - u) otherwise, with 1 - u taken on
    the integer grid before the conversion. The rounding follows the JAX
    package's: the conversion, + 0.5, then x 2^-30."""
    upper = (bits >> (_BITS - 1)) == 1  # u >= 1/2
    small = torch.where(upper, _MASK - bits, bits)
    u = (small.to(dtype) + 0.5) * 2.0**-_BITS
    z = torch.special.ndtri(u)  # <= 0
    return torch.where(upper, -z, z)


def normal(gen: torch.Generator, n: int, dim: int, dtype=torch.float32,
           device=None):
    """(n, dim) standard-normal RQMC draws."""
    return _mirrored_ndtri(scrambled_bits(gen, dim, n, device), dtype)


def uniform(gen: torch.Generator, n: int, dim: int, dtype=torch.float32,
            device=None):
    """(n, dim) RQMC uniforms on (0, 1), centred on the 2^-30 grid."""
    bits = scrambled_bits(gen, dim, n, device)
    return (bits.to(dtype) + 0.5) * 2.0**-_BITS


def chi2(gen: torch.Generator, nu, n: int, dtype=torch.float32,
         newton_iters: int = 25, device=None):
    """(n,) RQMC chi-square(nu) draws from a fresh 1-D net."""
    return chi2_from_bits(scrambled_bits(gen, 1, n, device)[:, 0], nu,
                          dtype=dtype, newton_iters=newton_iters)


# P(k, x) in f64 (gammainc_f64): both truncations converge to ~1e-16 for
# shape k up to _K_MAX (the series needs ~sqrt(78 (k + 1)) terms at
# x = k + 1, the continued fraction 64 at k = 1/2, fewer above)
_SERIES_TERMS = 96
_CF_TERMS = 64
_K_MAX = 100.0
_POLISH_STEPS = 2
# Boost's lanczos13m53, as scipy's cephes takes it: Gamma(k) =
# ((k + g - 1/2) / e)^(k - 1/2) times the ratio of these polynomials,
# coefficients of the descending powers k^12 .. k^0
_LANCZOS_G = 6.024680040776729583740234375
_LANCZOS_NUM = (
    0.006061842346248906525783753964555936883222,
    0.5098416655656676188125178644804694509993,
    19.51992788247617482847860966235652136208,
    449.9445569063168119446858607650988409623,
    6955.999602515376140356310115515198987526,
    75999.29304014542649875303443598909137092,
    601859.6171681098786670226533699352302507,
    3481712.15498064590882071018964774556468,
    14605578.08768506808414169982791359218571,
    43338889.32467613834773723740590533316085,
    86363131.28813859145546927288977868422342,
    103794043.1163445451906271053616070238554,
    56906521.91347156388090791033559122686859)
_LANCZOS_DEN = (1.0, 66.0, 1925.0, 32670.0, 357423.0, 2637558.0,
                13339535.0, 45995730.0, 105258076.0, 150917976.0,
                120543840.0, 39916800.0, 0.0)


def _lanczos_sum(k: torch.Tensor) -> torch.Tensor:
    """Gamma(k) / ((k + g - 1/2) / e)^(k - 1/2) for f64 k > 0: the two
    polynomials in k for k <= 1 and in 1/k above (cephes' ratevl), each a
    sum of powers (positive terms) rather than 13 Horner steps, so that a
    0-dim k on the card costs a few launches."""
    f64 = torch.float64
    dev = k.device
    num = device_constant(_LANCZOS_NUM, dev, f64)
    den = device_constant(_LANCZOS_DEN, dev, f64)
    big = (k > 1.0).unsqueeze(-1)
    y = torch.where(k > 1.0, 1.0 / k, k).unsqueeze(-1)
    q = y ** device_constant(tuple(range(13)), dev, f64)
    # ascending powers of 1/k take the coefficients as listed, ascending
    # powers of k reversed
    n = (q * torch.where(big, num, num.flip(0))).sum(-1)
    d = (q * torch.where(big, den, den.flip(0))).sum(-1)
    return n / d


def _density(k, x, lgk, lsum):
    """x^k e^-x / Gamma(k) (= dP/d log x) as cephes' igam_fac takes it:
    exp(k log x - x - lgamma k) where |k - x| > 0.4 k, the Lanczos form
    exp(k - x) (x / f)^k sqrt(f / e) / lsum, f = k + g - 1/2, nearer k,
    where the plain form's terms cancel."""
    plain = torch.exp(k * torch.log(x) - x - lgk)
    f = k + (_LANCZOS_G - 0.5)
    near = torch.exp(k - x) * torch.pow(x / f, k) * (torch.sqrt(f / math.e)
                                                     / lsum)
    return torch.where((k - x).abs() > 0.4 * k, plain, near)


def _gammainc_and_density(k, x, lgk, lsum):
    """(P(k, x), x^k e^-x / Gamma(k)) for f64 x > 0 and a 0-dim (or
    x-shaped) shape k: the power series P = dens / k (1 + sum_n prod_{j<=n}
    x / (k + j)) where x < k + 1, the continued fraction of Q = 1 - P
    (Numerical Recipes 6.2.7) otherwise. Both run over every element with
    a fixed number of terms and nothing waits for the device: the series
    as one cumulative product over a leading terms axis; the fraction
    truncated after _CF_TERMS terms and evaluated from its tail, one
    fused ``addcdiv`` per term (the truncation Lentz's forward recurrence
    would reach after as many steps, at a quarter of its launches)."""
    f64 = torch.float64
    dev = x.device
    dens = _density(k, x, lgk, lsum)
    lead = (-1,) + (1,) * x.dim()
    j = device_constant(tuple(range(1, _SERIES_TERMS + 1)), dev,
                        f64).reshape(lead)
    series = 1.0 + torch.cumprod(x / (k + j), dim=0).sum(0)
    p_series = dens / k * series
    # g_i = b_i + a_{i+1} / g_{i+1} from g_T = b_T, with b_i = x + 2 i + 1
    # - k and a_i = -i (i - k); Q = dens / g_0
    i = device_constant(tuple(range(_CF_TERMS + 1)), dev, f64)
    a = -i * (i - k.unsqueeze(-1)) if k.dim() else -i * (i - k)
    b = (x + 1.0 - k) + 2.0 * i.reshape(lead)
    g = b[_CF_TERMS]
    for t in range(_CF_TERMS - 1, -1, -1):
        g = torch.addcdiv(b[t], a[..., t + 1], g)
    return torch.where(x < k + 1.0, p_series, 1.0 - dens / g), dens


def gammainc_f64(k, x) -> torch.Tensor:
    """The regularized lower incomplete gamma P(k, x) in f64 for x > 0
    and a shape k > 0 (a number or a 0-dim tensor), within a few ulps of
    scipy.special.gammainc for k up to 100 (tests/test_torch_qmc.py)."""
    x = torch.as_tensor(x, dtype=torch.float64)
    k = torch.as_tensor(k, dtype=torch.float64, device=x.device)
    return _gammainc_and_density(k, x, torch.lgamma(k), _lanczos_sum(k))[0]


def chi2_from_bits(bits: torch.Tensor, nu, dtype=torch.float32,
                   newton_iters: int = 25) -> torch.Tensor:
    """chi-square(nu) draws from 30-bit uniforms: P(nu/2, x) = u solved by
    ``newton_iters`` Newton steps in y = log x (each clipped to +-3) from a
    Wilson-Hilferty guess, or from the inverted left-tail asymptote
    P(k, x) ~ x^k / (k Gamma(k)) where that guess fails, on
    ``torch.special.gammainc``; then _POLISH_STEPS steps on
    ``gammainc_f64`` up to nu = 2 _K_MAX (above it the first root stays);
    chi2 = 2x. In f64 whatever ``dtype``, then cast. ``nu`` may be a
    device tensor (the Student-t degrees of freedom are learnable);
    nothing waits for the device. Taking bits lets the Student-t sampler
    use one joint (dim + 1)-column net for directions and radius."""
    f64 = torch.float64
    u = (bits.to(f64) + 0.5) * 2.0**-_BITS
    k = torch.as_tensor(nu, dtype=f64, device=bits.device) / 2.0
    nu_i = 2.0 * k
    lgk = torch.lgamma(k)
    z = torch.special.ndtri(u)
    wh = 0.5 * nu_i * (1.0 - 2.0 / (9.0 * nu_i)
                       + z * torch.sqrt(2.0 / (9.0 * nu_i))) ** 3
    log_x_tail = (torch.log(u) + torch.log(k) + lgk) / k
    y = torch.where(wh > 0.05 * k, torch.log(torch.clamp_min(wh, 1e-30)),
                    log_x_tail)
    for _ in range(newton_iters):
        # dF/dy = pdf(x) x = exp(k y - x - lgamma(k))
        x = torch.exp(y)
        f = torch.special.gammainc(k, x) - u
        step = f * torch.exp(-(k * y - x - lgk))
        y = y - torch.clamp(step, -3.0, 3.0)
    lsum = _lanczos_sum(k)
    y_torch = y
    for _ in range(_POLISH_STEPS):
        p, dens = _gammainc_and_density(k, torch.exp(y), lgk, lsum)
        y = y - torch.clamp((p - u) / dens, -3.0, 3.0)
    y = torch.where(k <= _K_MAX, y, y_torch)
    return (2.0 * torch.exp(y)).to(dtype)
