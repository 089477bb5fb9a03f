"""Latent base distribution, the counterpart of
vmc_pde_tpu/models/latent.py:

- ``Gauss``: a multivariate Gaussian with covariance S = U U^T, U
  upper-triangular with its strictly-upper entries from the packed vector
  ``L`` and diag(U) = exp(L_diag), and mean ``mu``;
- ``Student_t``: the multivariate Student-t with the same location and
  scale and learnable degrees of freedom nu = exp(dist_params[0]) + 1
  (nu = 2 at the zero init), normalized with the -1/2 log det S term;
- ``cos_dist``: the normalized 2-D cosine bump of the ML-fluids paper;
- ``double_well``: the normalized double-well Boltzmann density in the 2-D
  phase space [x, p].

The last two are fixed (their parameters are unused: the flow learns all
deformation) and have no closed-form sampler; the Metropolis sampler
draws them (sampling/sampler.py). Gauss and Student-t draw exactly; the
Student-t chi^2 mixing variable comes from the caller's generator, and
``student_t_tempered_sample`` draws the heavier-tailed importance proposal
of the TDVP's ``is_gamma``. With ``qmc`` both draw from a scrambled Sobol
net instead (sampling/qmc.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..sampling import qmc as _qmc

NAMES = ("Gauss", "Student_t", "cos_dist", "double_well")
EXACT_NAMES = ("Gauss", "Student_t")  # closed-form samplers exist

# Normalization of the 2-D cosine bump f(x) = (1 + cos(pi min(1, 4|x|))) / 2:
# Z = pi/32 - 1/(8 pi) (compact support |x| <= 1/4)
_COS_BUMP_LOG_Z_2D = math.log(math.pi / 32.0 - 1.0 / (8.0 * math.pi))

# Double-well Boltzmann latent at the quench temperature T0:
#     p(z) ~ exp(-(DW_V2/2 x^2 + DW_LAM x^4 + p^2/2) / DW_T0)
# with the doubleWell preset's potential (wells at x = +-1, barrier 1) and
# T0 = 3 x its bath T = 0.5. The x-marginal's normalization has no closed
# form; it comes from an f64 quadrature, once.
DW_V2, DW_LAM, DW_T0 = -4.0, 1.0, 1.5


def dw_x_quadrature():
    """(xs, unnormalized pdf) of the latent's x-marginal on the dense
    quadrature grid behind its normalization."""
    xs = np.linspace(-8.0, 8.0, 400001)
    v = 0.5 * DW_V2 * xs**2 + DW_LAM * xs**4
    return xs, np.exp(-v / DW_T0)


def _dw_log_zx() -> float:
    xs, pdf = dw_x_quadrature()
    return float(np.log(np.trapezoid(pdf, xs)))


_DW_LOG_Z = _dw_log_zx() + 0.5 * math.log(2.0 * math.pi * DW_T0)


def check_name(name: str) -> None:
    if name not in NAMES:
        raise ValueError(f"unknown latent distribution {name!r}")


def init_params(dim: int, name: str):
    """Zero-initialized numpy latent parameters: S = I, mu = 0 and, for
    Student-t, the one raw degrees-of-freedom parameter 0 (nu = 2)."""
    check_name(name)
    return {
        "L": np.zeros(((dim * dim - dim) // 2,)),
        "L_diag": np.zeros((dim,)),
        "mu": np.zeros((dim,)),
        "dist_params": np.zeros((1 if name == "Student_t" else 0,)),
    }


def shapes(dim: int, name: str):
    return {k: v.shape for k, v in init_params(dim, name).items()}


def chol_factor(latent_params, dim: int):
    """Upper-triangular factor U with S = U U^T."""
    L = latent_params["L"]
    iu = torch.triu_indices(dim, dim, 1, device=L.device)
    U = torch.zeros((dim, dim), dtype=L.dtype, device=L.device)
    U = U.index_put((iu[0], iu[1]), L)
    return U + torch.diag(latent_params["L_diag"].exp())


def _mahalanobis_sq(latent_params, dim: int, x):
    """(x - mu)^T S^{-1} (x - mu) for x of shape (..., dim), via a
    triangular solve against U."""
    xc = x - latent_params["mu"]
    U = chol_factor(latent_params, dim)
    y = torch.linalg.solve_triangular(U, xc.unsqueeze(-1), upper=True)
    return (y.squeeze(-1) ** 2).sum(-1)


def gauss_log_prob(latent_params, dim: int, x):
    """log N(x; mu, S) for x of shape (..., dim)."""
    quad = _mahalanobis_sq(latent_params, dim, x)
    return -0.5 * (dim * math.log(2.0 * math.pi)
                   + 2.0 * latent_params["L_diag"].sum() + quad)


def nu_value(latent_params):
    """Student-t degrees of freedom nu = exp(dist_params[0]) + 1."""
    return latent_params["dist_params"][0].exp() + 1.0


def student_t_log_prob(latent_params, dim: int, x):
    """log t_nu(x; mu, S) for x of shape (..., dim)."""
    nu = nu_value(latent_params)
    quad = _mahalanobis_sq(latent_params, dim, x)
    return (torch.lgamma(0.5 * (nu + dim)) - torch.lgamma(0.5 * nu)
            - 0.5 * dim * torch.log(nu * math.pi)
            - latent_params["L_diag"].sum()
            - 0.5 * (nu + dim) * torch.log1p(quad / nu))


def cos_bump_log_prob(latent_params, dim: int, x):
    """Normalized cosine bump for x of shape (..., 2)."""
    if dim != 2:
        raise ValueError("cos_dist latent is defined for dim=2")
    r = torch.clamp(4.0 * (x * x).sum(-1).sqrt(), max=1.0)
    return torch.log(0.5 * (1.0 + torch.cos(math.pi * r))) \
        - _COS_BUMP_LOG_Z_2D


def double_well_log_prob(latent_params, dim: int, x):
    """Normalized double-well Boltzmann density for z = [x, p] of shape
    (..., 2)."""
    if dim != 2:
        raise ValueError("double_well latent is defined for dim=2 ([x, p])")
    q, p = x[..., 0], x[..., 1]
    h = 0.5 * DW_V2 * q**2 + DW_LAM * q**4 + 0.5 * p**2
    return -h / DW_T0 - _DW_LOG_Z


def log_prob(name: str, latent_params, dim: int, x):
    check_name(name)
    if name == "cos_dist":
        return cos_bump_log_prob(latent_params, dim, x)
    if name == "double_well":
        return double_well_log_prob(latent_params, dim, x)
    if name == "Student_t":
        return student_t_log_prob(latent_params, dim, x)
    return gauss_log_prob(latent_params, dim, x)


def sample(name: str, gen: torch.Generator, latent_params, dim: int, n: int,
           dtype: torch.dtype, qmc: bool = False):
    """n exact draws, shape (n, dim): z = mu + U eps (Gauss) or
    z = mu + U eps sqrt(nu / chi^2_nu) (Student-t, chi^2_nu = 2 Gamma(nu/2)
    from the same generator). ``qmc``: eps (and chi^2) from one scrambled
    Sobol net of the generator's randomization; for Student-t one joint
    (dim + 1)-column net, its last column the chi^2, so that radius and
    directions equidistribute jointly."""
    check_name(name)
    if name not in EXACT_NAMES:
        raise ValueError(f"no closed-form sampler for latent {name!r}")
    mu = latent_params["mu"]
    student = name == "Student_t"
    if qmc:
        bits = _qmc.scrambled_bits(gen, dim + 1 if student else dim, n,
                                   mu.device)
        eps = _qmc._mirrored_ndtri(bits[:, :dim], dtype)
    else:
        eps = torch.randn((n, dim), generator=gen, dtype=dtype,
                          device=mu.device)
    U = chol_factor(latent_params, dim).to(dtype)
    z = eps @ U.T
    if student:
        nu = nu_value(latent_params).to(dtype)
        if qmc:
            chi2 = _qmc.chi2_from_bits(bits[:, dim], nu, dtype=dtype)
        else:
            chi2 = 2.0 * torch._standard_gamma(
                (0.5 * nu).expand(n).contiguous(), generator=gen)
        z = z * (nu / chi2).sqrt()[:, None]
    return z + mu.to(dtype)


def student_t_tempered_sample(gen: torch.Generator, latent_params, dim: int,
                              n: int, gamma: float, dtype: torch.dtype,
                              qmc: bool = False):
    """Tail-tempered importance proposal of the Student-t TDVP statistics:
    z drawn from the heavier-tailed t_{nu_q}(mu, S), nu_q = max(gamma nu,
    1.05), and log_w = log t_nu(z) - log t_{nu_q}(z). The proposal
    dominates the target's tails, so the weights are bounded above."""
    nu = nu_value(latent_params)
    nu_q = torch.clamp_min(gamma * nu, 1.05)
    q_params = dict(latent_params)
    q_params["dist_params"] = (nu_q - 1.0).log().reshape(1).to(
        latent_params["dist_params"].dtype)
    z = sample("Student_t", gen, q_params, dim, n, dtype, qmc=qmc)
    log_w = (student_t_log_prob(latent_params, dim, z)
             - student_t_log_prob(q_params, dim, z))
    return z, log_w
