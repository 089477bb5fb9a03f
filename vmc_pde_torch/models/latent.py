"""Latent base distribution, the counterpart of
vmc_pde_tpu/models/latent.py for the Gauss family: a multivariate Gaussian
with covariance S = U U^T, U upper-triangular with its strictly-upper
entries from the packed vector ``L`` and diag(U) = exp(L_diag), and mean
``mu``. Student-t, the cosine bump and the double well are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import math

import numpy as np
import torch

NAMES = ("Gauss", "Student_t", "cos_dist", "double_well")
EXACT_NAMES = ("Gauss", "Student_t")  # closed-form samplers exist
PORTED = ("Gauss",)


def check_ported(name: str) -> None:
    if name not in NAMES:
        raise ValueError(f"unknown latent distribution {name!r}")
    if name not in PORTED:
        raise NotImplementedError(
            f"latent {name!r} is not ported yet (ROADMAP.md)")


def init_params(dim: int, name: str):
    """Zero-initialized numpy latent parameters: S = I, mu = 0."""
    check_ported(name)
    return {
        "L": np.zeros(((dim * dim - dim) // 2,)),
        "L_diag": np.zeros((dim,)),
        "mu": np.zeros((dim,)),
        "dist_params": np.zeros((0,)),
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


def gauss_log_prob(latent_params, dim: int, x):
    """log N(x; mu, S) for x of shape (..., dim), via a triangular solve
    against U."""
    xc = x - latent_params["mu"]
    U = chol_factor(latent_params, dim)
    y = torch.linalg.solve_triangular(U, xc.unsqueeze(-1), upper=True)
    quad = (y.squeeze(-1) ** 2).sum(-1)
    return -0.5 * (dim * math.log(2.0 * math.pi)
                   + 2.0 * latent_params["L_diag"].sum() + quad)


def log_prob(name: str, latent_params, dim: int, x):
    check_ported(name)
    return gauss_log_prob(latent_params, dim, x)


def sample(name: str, gen: torch.Generator, latent_params, dim: int, n: int,
           dtype: torch.dtype):
    """n exact draws z = mu + U eps, shape (n, dim)."""
    check_ported(name)
    mu = latent_params["mu"]
    eps = torch.randn((n, dim), generator=gen, dtype=dtype, device=mu.device)
    U = chol_factor(latent_params, dim).to(dtype)
    return eps @ U.T + mu.to(dtype)
