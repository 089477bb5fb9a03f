"""Ground-truth SDE oracle driver: ``python -m vmc_pde_torch.oracle``, the
counterpart of ``python -m vmc_pde_tpu.oracle``.

Parity with the reference's exact_dyn.py __main__ (exact_dyn.py:85-158):
integrate a particle cloud under the chosen dynamics, record the same
observables (means, covariance, MC ball integrals), and write the
Wiener-baseline-compatible infos HDF5.

    python -m vmc_pde_torch.oracle fluidpaper
    python -m vmc_pde_torch.oracle hamiltonian --workdir run
    python -m vmc_pde_torch.oracle diffusion2d --device cpu

``--device`` defaults to cuda and raises when no CUDA device is present.
The cloud and its noise come from one ``torch.Generator`` on the device
(seeded ``--seed`` for the initial cloud, ``--seed`` + 1 for the noise),
so a run replays on the same device, not across devices or packages.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..utils.infos import store_infos
from . import sde

CASES = {
    # exact_dyn.py:96-104 "hamiltonian": damped phase-space FP, 6-D
    "hamiltonian": dict(
        dim=6,
        offset=(1.0, 0.0, 1.0, 0.0, 1.0, 0.0),
        drift="phase_space",
        params={"m": 1.0, "omega": 1.0, "gamma": 1.0, "T": 10.0, "lam": 0.0},
    ),
    # exact_dyn.py:105-111 "diffusion"
    "diffusion": dict(
        dim=6,
        offset=(0.0,) * 6,
        drift="diffusion",
        params={"D": 1.0},
    ),
    "diffusion2d": dict(
        dim=2,
        offset=(0.0, 0.0),
        drift="diffusion",
        params={"D": 1.0},
    ),
    # exact_dyn.py:89-96 "fluidpaper": MCMC-initialized cloud from the
    # cosine-bump density, deterministic advection under the paper's
    # time-periodic velocity field
    "fluidpaper": dict(
        dim=2,
        offset=(0.25, 0.25),
        drift="advection_paper",
        params={"T": 5.0},
        init="cos_dist",
        mcmc_bound=0.25,
    ),
}


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def main(argv=None):
    """Run the oracle CLI; returns (final coords, infos)."""
    from ..driver import resolve_device

    p = argparse.ArgumentParser(description="SDE/particle ground-truth "
                                            "oracle (PyTorch port)")
    p.add_argument("case", choices=sorted(CASES), nargs="?",
                   default="hamiltonian")
    p.add_argument("--particles", type=int, default=10000)
    p.add_argument("--dt", type=float, default=1e-2)       # exact_dyn.py:114
    p.add_argument("--t-end", type=float, default=12.0)    # exact_dyn.py:113
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workdir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; raises without one)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    case = CASES[args.case]
    dim = case["dim"]
    gen = _generator(device, args.seed)
    if case.get("init") == "cos_dist":
        coords = sde.mcmc_init_cloud(gen, args.particles, case["offset"],
                                     bound=case["mcmc_bound"])
    else:
        offset = torch.tensor(case["offset"], dtype=torch.float64,
                              device=device)
        coords = args.sigma * torch.randn(
            (args.particles, dim), generator=gen, dtype=torch.float64,
            device=device) + offset

    n_steps = int(round(args.t_end / args.dt))
    coords, infos = sde.evolve(
        coords, 0.0, args.dt, n_steps,
        drift_name=case["drift"], params=case["params"],
        gen=_generator(device, args.seed + 1),
        integral_T=case["params"].get("T", 10.0),
    )

    print(f"{args.case}: {n_steps} steps to t={args.t_end}")
    print("final mean:", infos["x1"][-1])
    print("final covar diag:", np.diag(infos["covar"][-1]))
    for k in ("integral_1sigma", "integral_0.5sigma", "integral_0.1sigma"):
        print(f"final {k}:", float(infos[k][-1]))

    if args.workdir:
        import os

        os.makedirs(args.workdir, exist_ok=True)
        path = store_infos(args.workdir, infos)
        print("wrote", path)
    return coords, infos


if __name__ == "__main__":
    main()
