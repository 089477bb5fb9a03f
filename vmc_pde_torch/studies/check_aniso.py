"""Validate a diffusion_anisotropic run against the closed form, the
counterpart of scripts/check_aniso.py.

For p0 = N(0, I) under dp/dt = div(D grad p) with constant SPD D, the
exact solution stays Gaussian with Sigma(t) = I + 2 D t (matrix form).
Reads the run's infos.hdf5 and reports the worst relative error of the
recorded covariance against I + 2 D t over the trajectory. D is the
equation's own (ops.evolution.DiffusionAnisotropic), which is the JAX
package's D of the same dim and seed.

    python -m vmc_pde_torch.studies.check_aniso RUN_DIR [--dim 12]
        [--seed 0] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def d_matrix(dim: int, seed: int) -> np.ndarray:
    from ..ops.evolution import DiffusionAnisotropic

    return np.asarray(DiffusionAnisotropic(dim=dim, seed=seed).D_matrix)


def covariance_error(infos, D, device="cpu") -> float:
    """max over the records of max |cov - (I + 2 D t)| / max |I + 2 D t|,
    in f64 on ``device``."""
    t = torch.as_tensor(np.asarray(infos["times"]), dtype=torch.float64,
                        device=device)
    cov = torch.as_tensor(np.asarray(infos["covar"]), dtype=torch.float64,
                          device=device)
    Dt = torch.as_tensor(D, dtype=torch.float64, device=device)
    exact = torch.eye(Dt.shape[0], dtype=torch.float64, device=device) \
        + 2.0 * Dt * t[:, None, None]
    err = (cov - exact).abs().amax(dim=(1, 2)) / exact.abs().amax(dim=(1, 2))
    return float(err.max())


def report(infos, dim: int = 12, seed: int = 0, device="cpu") -> dict:
    """Print the script's lines for a run's infos dict; returns the
    numbers."""
    D = d_matrix(dim, seed)
    t = np.asarray(infos["times"])
    cov = np.asarray(infos["covar"])
    worst = covariance_error(infos, D, device)
    final = np.eye(dim) + 2.0 * D * t[-1]
    med_res = float(np.median(np.asarray(infos["solver_res"])))
    print(f"steps: {len(t)}, t_final: {t[-1]:.4f}")
    print(f"D eigenvalues: {np.linalg.eigvalsh(D).round(3)}")
    print(f"worst max-rel covar error over trajectory: {worst:.4f}")
    print(f"final covar diag (model):  {np.diag(cov[-1]).round(3)}")
    print(f"final covar diag (exact):  {np.diag(final).round(3)}")
    print(f"solver residual median: {med_res:.3e}")
    return dict(steps=len(t), t_final=float(t[-1]), worst=worst,
                residual_median=med_res)


def main(argv=None):
    from ..driver import resolve_device
    from ..utils.infos import load_infos

    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--dim", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    infos = load_infos(f"{args.workdir}/infos.hdf5")
    return report(infos, args.dim, args.seed, device)


if __name__ == "__main__":
    main()
