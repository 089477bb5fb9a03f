"""Evolution equations, the counterpart of vmc_pde_tpu/ops/evolution.py.

Each equation computes the per-sample local "energy"

    Eloc_i = (d/dt) log p(x_i)   prescribed by the PDE at sample x_i,

from the coordinate score g = grad_x log p and ``hess``: the Hessian
quadratic trace along ``hessian_trace_dirs`` (ndim 1), or the (N, k, k)
Hessian block in the coordinates ``hessian_coords`` (ndim 3, the TDVP's
block mode). All six equations of the JAX package:

- ``diffusion``: dp/dt = D lap p, Eloc = D (|g|^2 + tr H);
- ``diffusion_drift``: adds the drift mu sum_i g_i;
- ``diffusion_anisotropic``: dp/dt = div(D grad p) with the JAX package's
  random SPD D, Eloc = g^T D g + tr(H D), the trace along the columns of
  D's Cholesky factor;
- ``advection_paper``: Liouville transport by the ML-fluids paper's
  time-periodic 2-D swirl, Eloc = -g . v (no Hessian);
- ``advection_hamiltonian``: Liouville transport by the symplectic flow of
  the (coupled) harmonic Hamiltonian, Eloc = -g . v (no Hessian);
- ``advection_hamiltonian_wDiss``: phase-space Fokker-Planck, that
  transport plus momentum diffusion m gamma sum_i T_i (g_{p_i}^2 +
  H_{p_i p_i}) and damping gamma sum_i p_i g_{p_i}. T may be one bath
  temperature per (x, p) pair.

Coordinate layout for phase space: [x1, p1, x2, p2, ...].
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import threefry
from ..utils.dtypes import device_constant


def velocity_field_mlpaper(coord, t, T=5.0):
    """Time-periodic 2-D swirl of the ML-fluids paper for coord of shape
    (..., 2)."""
    x, y = coord[..., 0], coord[..., 1]
    # t is a float, or inside a captured step a 0-dim f64 device tensor
    c = (torch.cos(math.pi * t / T) if isinstance(t, torch.Tensor)
         else math.cos(math.pi * t / T))
    return torch.stack([
        -torch.sin(math.pi * x) ** 2 * torch.sin(2 * math.pi * y) * c,
        torch.sin(math.pi * y) ** 2 * torch.sin(2 * math.pi * x) * c,
    ], dim=-1)


def hamiltonian(coord, m=1.0, omega=1.0, lam=0.0, coupled=False, v2=1.0,
                onsite=0.0):
    """Harmonic(+quartic) Hamiltonian on the [x1, p1, x2, p2, ...] layout,
    for coord of shape (..., d). ``coupled``: nearest-neighbour ring
    potential sum_i (x_i - x_{i-1})^2 plus the on-site pinning term."""
    xs, ps = coord[..., 0::2], coord[..., 1::2]
    if coupled:
        pot = m * omega**2 / 2.0 * (
            ((xs - xs.roll(1, -1)) ** 2).sum(-1) + onsite * (xs**2).sum(-1))
    else:
        pot = m * omega**2 / 2.0 * (xs**2).sum(-1)
    return v2 * pot + (ps**2).sum(-1) / (2.0 * m) + lam * (xs**4).sum(-1)


def velocity_field_hamiltonian(coord, t, m=1.0, omega=1.0, lam=0.0,
                               coupled=False, v2=1.0, onsite=0.0):
    """Symplectic flow v = J grad H: dx/dt = dH/dp, dp/dt = -dH/dx, with the
    gradient of ``hamiltonian`` written out."""
    xs, ps = coord[..., 0::2], coord[..., 1::2]
    if coupled:
        dpot = m * omega**2 * (2.0 * xs - xs.roll(1, -1) - xs.roll(-1, -1)
                               + onsite * xs)
    else:
        dpot = m * omega**2 * xs
    dH_dx = v2 * dpot + 4.0 * lam * xs**3
    return torch.stack([ps / m, -dH_dx], dim=-1).reshape(coord.shape)


class Equation:
    """Base: subclasses define the Hessian trace directions and Eloc."""

    name: str = "base"

    def hessian_coords(self, dim: int) -> Optional[Tuple[int, ...]]:
        return None

    def hessian_trace_dirs(self, dim: int) -> Optional[np.ndarray]:
        """(k, d) directions V when Eloc consumes the Hessian only through
        sum_j V_j^T H V_j; ``eloc`` then receives that scalar per sample
        as a 1-D ``hess`` (or, in block mode, the block)."""
        return None

    def eloc(self, x, g, hess, t):
        raise NotImplementedError


def _trace(hess):
    """The trace-mode scalar, or the trace of each (k, k) block."""
    return hess if hess.ndim == 1 else hess.diagonal(dim1=-2,
                                                     dim2=-1).sum(-1)


@dataclasses.dataclass(frozen=True)
class Diffusion(Equation):
    """dp/dt = D lap p  =>  dlogp/dt = D (|grad logp|^2 + lap logp)."""

    D: float = 1.0
    name: str = "diffusion"

    def hessian_coords(self, dim):
        return tuple(range(dim))

    def hessian_trace_dirs(self, dim):
        return np.eye(dim)

    def eloc(self, x, g, hess, t):
        return self.D * ((g**2).sum(-1) + _trace(hess))


@dataclasses.dataclass(frozen=True)
class DiffusionDrift(Equation):
    """Diffusion plus the constant drift mu along every coordinate:
    Eloc = D (|g|^2 + tr H) + mu sum_i g_i."""

    D: float = 1.0
    mu: float = 4.0
    name: str = "diffusion_drift"

    def hessian_coords(self, dim):
        return tuple(range(dim))

    def hessian_trace_dirs(self, dim):
        return np.eye(dim)

    def eloc(self, x, g, hess, t):
        return self.D * ((g**2).sum(-1) + _trace(hess)) + self.mu * g.sum(-1)


@functools.lru_cache(maxsize=None)
def random_spd_matrix(dim: int, seed: int = 0) -> np.ndarray:
    """The JAX package's random SPD diffusion matrix D = A^T A, A the f64
    normal draw of PRNGKey(seed) (utils/threefry.py gives it bit for
    bit). The product sums over the rows of A in order."""
    A = threefry.normal_f64(seed, (dim, dim))
    D = np.zeros((dim, dim))
    for row in A:
        D = D + row[:, None] * row[None, :]
    return D


@dataclasses.dataclass(frozen=True)
class DiffusionAnisotropic(Equation):
    """dp/dt = div(D grad p) with a constant SPD matrix D:
    Eloc = g^T D g + tr(H D). ``seed`` picks the JAX package's random D."""

    dim: int = 2
    seed: int = 0
    name: str = "diffusion_anisotropic"

    @property
    def D_matrix(self) -> np.ndarray:
        return random_spd_matrix(self.dim, self.seed)

    def hessian_coords(self, dim):
        return tuple(range(dim))

    def hessian_trace_dirs(self, dim):
        # tr(H D) = sum_j (L e_j)^T H (L e_j) with D = L L^T: the columns
        # of the Cholesky factor are exact trace directions
        return np.linalg.cholesky(self.D_matrix).T

    def eloc(self, x, g, hess, t):
        D = device_constant(tuple(map(tuple, self.D_matrix.tolist())),
                            g.device, g.dtype)
        tr = hess if hess.ndim == 1 else torch.einsum("nij,ji->n", hess, D)
        return ((g @ D) * g).sum(-1) + tr


@dataclasses.dataclass(frozen=True)
class AdvectionPaper(Equation):
    """Liouville transport by the ML-paper 2-D field: dlogp/dt = -g . v."""

    T: float = 5.0
    name: str = "advection_paper"

    def eloc(self, x, g, hess, t):
        return -(g * velocity_field_mlpaper(x, t, self.T)).sum(-1)


@dataclasses.dataclass(frozen=True)
class AdvectionHamiltonian(Equation):
    """Liouville transport by the symplectic flow."""

    m: float = 1.0
    omega: float = 1.0
    lam: float = 0.0
    coupled: bool = False
    v2: float = 1.0
    onsite: float = 0.0
    name: str = "advection_hamiltonian"

    def velocity(self, x, t):
        return velocity_field_hamiltonian(x, t, self.m, self.omega, self.lam,
                                          self.coupled, self.v2, self.onsite)

    def eloc(self, x, g, hess, t):
        return -(g * self.velocity(x, t)).sum(-1)


@dataclasses.dataclass(frozen=True)
class FokkerPlanck(AdvectionHamiltonian):
    """Phase-space Fokker-Planck with momentum diffusion and damping. The
    per-site T weights ride the Hessian trace directions as
    sqrt(T_i) e_{p_i}, so a 1-D ``hess`` is already sum_i T_i H_{p_i p_i};
    the block is the momentum block."""

    T: object = 10.0  # float or per-site tuple, length dim // 2
    gamma: float = 1.0
    name: str = "advection_hamiltonian_wDiss"

    def __post_init__(self):
        if isinstance(self.T, (list, np.ndarray)):
            object.__setattr__(self, "T", tuple(float(t) for t in self.T))

    def _t_vec(self, n_pairs: int) -> np.ndarray:
        T = np.asarray(self.T, dtype=np.float64)
        if T.ndim == 0:
            return np.full(n_pairs, float(T))
        if T.shape != (n_pairs,):
            raise ValueError(
                f"per-site T has {T.shape[0]} entries; dim "
                f"{2 * n_pairs} has {n_pairs} (x, p) pairs")
        return T

    def hessian_coords(self, dim):
        return tuple(range(1, dim, 2))

    def hessian_trace_dirs(self, dim):
        T = self._t_vec(dim // 2)
        return np.eye(dim)[1::2] * np.sqrt(T)[:, None]

    def eloc(self, x, g, hess, t):
        adv = -(g * self.velocity(x, t)).sum(-1)
        g_p, x_p = g[..., 1::2], x[..., 1::2]
        Tv = device_constant(tuple(self._t_vec(x.shape[-1] // 2).tolist()),
                             g.device, g.dtype)
        lap_T = (hess if hess.ndim == 1
                 else (hess.diagonal(dim1=-2, dim2=-1) * Tv).sum(-1))
        diff = self.m * self.gamma * ((g_p**2 * Tv).sum(-1) + lap_T)
        damp = self.gamma * (x_p * g_p).sum(-1)
        return adv + diff + damp


def make_equation(name: str, dim: int, **overrides) -> Equation:
    if name == "diffusion":
        return Diffusion(**overrides)
    if name == "diffusion_drift":
        return DiffusionDrift(**overrides)
    if name == "diffusion_anisotropic":
        return DiffusionAnisotropic(dim=dim, **overrides)
    if name == "advection_paper":
        return AdvectionPaper(**overrides)
    if name == "advection_hamiltonian":
        return AdvectionHamiltonian(**overrides)
    if name == "advection_hamiltonian_wDiss":
        return FokkerPlanck(**overrides)
    raise ValueError(f"unknown evolution equation {name!r}")
