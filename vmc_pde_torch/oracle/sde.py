"""Exact-dynamics oracle: particle/SDE integration of the same PDEs, used as
ground truth for validating the variational solver; the counterpart of
vmc_pde_tpu/oracle/sde.py.

Parity with vmc_fluids/exact_dyn.py: RK4-discretized update with per-stage
noise whose variance is scaled by the stage weight (exact_dyn.py:55-82) for

- pure diffusion            dx = D * sqrt(2/dt) N(0,1)     (exact_dyn.py:65-67)
- phase-space Fokker-Planck dx = v_H + noise+damping on momenta
                                                           (exact_dyn.py:55-62)
- deterministic advection

The whole (N, d) cloud advances at once on the device of its coordinates.
Each step draws the standard normals of its four stages in one
``torch.randn`` from an explicit ``torch.Generator`` on that device (the
JAX package splits a key per particle and per stage instead), so the two
packages' noisy trajectories agree in distribution, not in value; the
noise-free parts (the drifts at zero noise, ``rk4_sde_step`` and
``evolve`` under ``advection_paper``) agree to rounding. The observables
(means, covariance, ball-counting integrals) stay on the device until the
run ends, and are then read in one transfer.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.evolution import velocity_field_hamiltonian, velocity_field_mlpaper
from ..utils.dtypes import device_constant


def drift_diffusion(coord, t, dt, noise, D=1.0, **_):
    """Pure-diffusion 'velocity' with discretized noise (exact_dyn.py:65-67):
    ``noise`` is coord-shaped standard normals."""
    return D * math.sqrt(2.0 / dt) * noise


def drift_phase_space(coord, t, dt, noise, m=1.0, omega=1.0, lam=0.0,
                      gamma=1.0, T=10.0, v2=1.0, coupled=False,
                      onsite=0.0, **_):
    """Hamiltonian advection + momentum noise + damping (exact_dyn.py:55-62)
    on coord of shape (..., d), [x1, p1, x2, p2, ...].
    ``v2`` < 0 with ``lam`` > 0: the double-well potential (config 3);
    ``coupled``: the interacting chain potential sum (x_i - x_{i-1})^2
    (config 4); ``T`` may be a per-site tuple (length dim // 2) for the
    heat-transport setting (ops.evolution.FokkerPlanck per-site baths).
    The noise and the damping act on the momentum columns only."""
    d = coord.shape[-1]
    mask = device_constant((0.0, 1.0) * (d // 2) + (0.0,) * (d % 2),
                           coord.device, coord.dtype)
    v_adv = velocity_field_hamiltonian(coord, t, m=m, omega=omega, lam=lam,
                                       v2=v2, coupled=coupled,
                                       onsite=onsite)
    Tv = np.asarray(T, dtype=np.float64)
    if Tv.ndim > 0:
        Tv = np.repeat(Tv, 2)  # per-site -> per-coordinate (x_i, p_i)
        scale = device_constant(
            tuple(np.sqrt(2.0 * m * gamma * Tv / dt).tolist()),
            coord.device, coord.dtype)
    else:
        scale = math.sqrt(2.0 * m * gamma * float(Tv) / dt)
    v_diff = scale * noise
    v_damp = -gamma * coord
    return v_adv + (v_diff + v_damp) * mask


def drift_advection_paper(coord, t, dt, noise, T=5.0, **_):
    return velocity_field_mlpaper(coord, t, T)


DRIFTS = {
    "diffusion": drift_diffusion,
    "phase_space": drift_phase_space,
    "advection_paper": drift_advection_paper,
}
# the drifts that read their noise (evolve draws none for the others)
NOISY = frozenset({"diffusion", "phase_space"})


def mcmc_init_cloud(gen: torch.Generator, n: int, offset,
                    bound: float = 0.25, n_chains: int = 256,
                    burn_in: int = 200, dtype=torch.float64):
    """MCMC-initialized particle cloud from the paper's cosine-bump density
    -- the fluidpaper oracle's initial condition (exact_dyn.py:89-96) --
    on ``gen``'s device. Metropolis with uniform-in-ball independence
    proposals; ``burn_in`` sweeps are discarded before collecting
    ceil(n / n_chains) sweeps.

    The chains run in the port's Metropolis kernel
    (kernels/metropolis.metropolis_chain: csrc/metropolis.cu on a CUDA
    device, its plain version on the CPU), started from one ball proposal
    each and driven by the kernel's Philox stream under a seed drawn from
    ``gen``. Its contract applies: a 2-D bump, ``n_chains`` a multiple of
    128, sweeps rounded up to multiples of 8 (the extra ones fall at the
    end and are dropped). The kernel is f32 where the JAX oracle's chain
    is f64: the cloud is cast to ``dtype`` after; f32's rounding (~1e-7)
    lies far under the cloud's Monte Carlo noise (~1e-2 at 10^4
    particles)."""
    from ..kernels.metropolis import metropolis_chain
    from ..sampling.sampler import radial_proposal

    off = tuple(float(o) for o in offset)
    info = {"offset": np.asarray(off), "bound": bound}
    init = radial_proposal(gen, n_chains, len(off), info,
                           dtype=torch.float32)
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                             device=gen.device))
    n_steps = -(-n // n_chains) + burn_in
    samples, _, _ = metropolis_chain(seed, init, n_steps, bound, off)
    return samples[burn_in * n_chains:][:n].to(dtype)


def double_well_init_cloud(gen: torch.Generator, n: int,
                           dtype=torch.float64):
    """Exact particle cloud from the double-well Boltzmann latent
    (models/latent.py double_well_log_prob, quench temperature DW_T0), on
    ``gen``'s device: x by inverse-CDF on a dense quadrature grid (the
    marginal has no closed form; the interpolation runs on the host),
    p ~ N(0, DW_T0). Independent of the model's Metropolis chains, so
    oracle-vs-model comparisons share no sampling machinery."""
    from ..models.latent import DW_T0, dw_x_quadrature

    xs, pdf = dw_x_quadrature()
    cdf = np.cumsum(pdf)
    cdf /= cdf[-1]
    dev = gen.device
    u = torch.rand((n,), generator=gen, dtype=torch.float64, device=dev)
    x = torch.as_tensor(np.interp(u.cpu().numpy(), cdf, xs), device=dev)
    p = math.sqrt(DW_T0) * torch.randn((n,), generator=gen,
                                       dtype=torch.float64, device=dev)
    return torch.stack([x, p], dim=1).to(dtype)


def rk4_sde_step(coord, t, dt, noise, drift: Callable, params: dict):
    """One RK4 step with stage-weighted noise (exact_dyn.py:70-76): stage k_i
    with Butcher weight w_i draws noise with dt_eff = w_i * dt, while the
    position update takes dt. ``noise``: (4, *coord.shape) standard
    normals, one slice per stage (None for a drift that reads none)."""
    f = partial(drift, **params)
    n = noise if noise is not None else (None,) * 4
    k1 = f(coord, t, dt / 6.0, n[0])
    k2 = f(coord + dt * 0.5 * k1, t + 0.5 * dt, dt / 3.0, n[1])
    k3 = f(coord + dt * 0.5 * k2, t + 0.5 * dt, dt / 3.0, n[2])
    k4 = f(coord + dt * k3, t + dt, dt / 6.0, n[3])
    return coord + dt * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0


def evolve(
    coords,
    t0: float,
    dt: float,
    n_steps: int,
    drift_name: str = "diffusion",
    params: Optional[dict] = None,
    gen: Optional[torch.Generator] = None,
    integral_T: float = 10.0,
):
    """Integrate the (N, d) particle cloud ``coords`` on its device and
    record observables before each step: record i is the state at
    t0 + i dt, so the final coords are not in the record. ``gen``: the
    noise's generator on the coords' device (default seeded 0). The ball
    integrals count the particles within sqrt(integral_T) x (1, 0.5, 0.1)
    of the origin. Returns (final coords, infos dict of numpy arrays)."""
    params = dict(params or {})
    drift = DRIFTS[drift_name]
    c = torch.as_tensor(coords)
    if gen is None:
        gen = torch.Generator(device=c.device)
        gen.manual_seed(0)
    lims = [math.sqrt(integral_T) * f for f in (1.0, 0.5, 0.1)]
    rows = {"x1": [], "covar": [], "ints": []}
    for i in range(n_steps):
        t = t0 + i * dt
        mean = c.mean(dim=0)
        cc = c - mean
        rows["x1"].append(mean)
        rows["covar"].append((cc.T @ cc) / c.shape[0])
        r = torch.linalg.vector_norm(c, dim=-1)
        rows["ints"].append(torch.stack(
            [(r < lim).to(c.dtype).mean() for lim in lims]))
        noise = (torch.randn((4,) + tuple(c.shape), generator=gen,
                             dtype=c.dtype, device=c.device)
                 if drift_name in NOISY else None)
        c = rk4_sde_step(c, t, dt, noise, drift, params)
    host = {k: torch.stack(v).cpu().numpy() for k, v in rows.items()}
    ints = host["ints"]
    infos = {
        "times": t0 + np.arange(n_steps) * dt,
        "x1": host["x1"],
        "covar": host["covar"],
        "integral_1sigma": ints[:, 0],
        "integral_0.5sigma": ints[:, 1],
        "integral_0.1sigma": ints[:, 2],
    }
    return c, infos
