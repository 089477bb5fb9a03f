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
  enabled, so its inversion is f64 too), then cast.
"""

from __future__ import annotations

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


def chi2_from_bits(bits: torch.Tensor, nu, dtype=torch.float32,
                   newton_iters: int = 25) -> torch.Tensor:
    """chi-square(nu) draws from 30-bit uniforms: P(nu/2, x) = u solved by
    ``newton_iters`` Newton steps in y = log x (each clipped to +-3) from a
    Wilson-Hilferty guess, or from the inverted left-tail asymptote
    P(k, x) ~ x^k / (k Gamma(k)) where that guess fails; chi2 = 2x. In f64
    whatever ``dtype``, then cast. ``nu`` may be a device tensor (the
    Student-t degrees of freedom are learnable); nothing waits for the
    device. Taking bits lets the Student-t sampler use one joint
    (dim + 1)-column net for directions and radius."""
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
    return (2.0 * torch.exp(y)).to(dtype)
