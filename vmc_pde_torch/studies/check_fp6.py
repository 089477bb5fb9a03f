"""Compare a harmonicOsc_diff (6-D phase-space Fokker-Planck) run against
the independent SDE particle oracle, the reference's 'Wiener' validation
methodology (exact_dyn.py); the counterpart of scripts/check_fp6.py.
Model record i is the state at t_i, and so is oracle record i.

The oracle's initial cloud is the preset's offset plus the f64 normals of
the JAX package's PRNGKey(11) (utils/threefry.py replays them bit for
bit); its noise comes from a torch generator seeded 12, so the two
packages' oracles agree in distribution, not in value.

    python -m vmc_pde_torch.studies.check_fp6 RUN_DIR [--particles 60000]
        [--heat-chain] [--device cpu]

``--heat-chain``: the run is the heat-transport chain of
make_paper_figures (HEAT_CHAIN: per-site T = (10, 5, 2.5), coupled), not
the preset's uncoupled oscillators at T = 10.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

OFFSET = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
# the JAX package's keys of the oracle's cloud and noise
CLOUD_SEED, NOISE_SEED = 11, 12
DT = 1e-2
PRESET_PARAMS = {"m": 1.0, "omega": 1.0, "gamma": 1.0, "T": 10.0,
                 "lam": 0.0}
# the per-site heat-transport chain of the paper's phase-space figure
HEAT_CHAIN = dict(m=1.0, omega=1.0, gamma=1.0, lam=0.0,
                  T=(10.0, 5.0, 2.5), coupled=True, onsite=1.0)


def oracle_cloud(particles: int, device="cpu") -> torch.Tensor:
    """offset + jax.random.normal(PRNGKey(11), (particles, 6), float64)."""
    from ..utils.threefry import normal_f64

    cloud = np.asarray(OFFSET) + normal_f64(CLOUD_SEED, (particles, 6))
    return torch.as_tensor(cloud, dtype=torch.float64, device=device)


def oracle(t_end: float, particles: int, params=None, device="cpu",
           dt: float = DT, integral_T: float = 10.0) -> dict:
    """The SDE oracle's infos from the study's cloud, records every ``dt``
    up to the one at t_end."""
    from ..oracle import sde

    gen = torch.Generator(device=device)
    gen.manual_seed(NOISE_SEED)
    n_steps = int(round(t_end / dt)) + 1
    _, infos = sde.evolve(oracle_cloud(particles, device), 0.0, dt, n_steps,
                          drift_name="phase_space",
                          params=dict(params or PRESET_PARAMS), gen=gen,
                          integral_T=integral_T)
    return infos


def compare(infos, oracle_infos) -> dict:
    """Print the script's lines for the model's last record against the
    oracle's nearest; returns the two maxima."""
    t = np.asarray(infos["times"])
    m_x1 = np.asarray(infos["x1"])
    m_cov = np.asarray(infos["covar"])
    ot, ox1, ocov = (np.asarray(oracle_infos[k])
                     for k in ("times", "x1", "covar"))
    j = np.argmin(np.abs(ot - t[-1]))
    print(f"model t_final {t[-1]:.3f} vs oracle t {ot[j]:.3f}")
    print("means  (model): ", m_x1[-1].round(3))
    print("means  (oracle):", ox1[j].round(3))
    print("covdiag (model): ", np.diag(m_cov[-1]).round(3))
    print("covdiag (oracle):", np.diag(ocov[j]).round(3))
    dm = np.abs(m_x1[-1] - ox1[j]).max()
    dc = np.abs(np.diag(m_cov[-1]) / np.diag(ocov[j]) - 1).max()
    print(f"max |mean diff| {dm:.4f};  max rel covdiag diff {dc:.4f}")
    return dict(t_final=float(t[-1]), t_oracle=float(ot[j]),
                max_mean_diff=float(dm), max_rel_covdiag_diff=float(dc))


def check(infos, particles=60000, heat_chain=False, device="cpu") -> dict:
    t_end = float(np.asarray(infos["times"])[-1])
    o = oracle(t_end, particles, HEAT_CHAIN if heat_chain else None, device)
    return compare(infos, o)


def main(argv=None):
    from ..driver import resolve_device
    from ..utils.infos import load_infos

    ap = argparse.ArgumentParser()
    ap.add_argument("workdir")
    ap.add_argument("--particles", type=int, default=60000)
    ap.add_argument("--heat-chain", action="store_true",
                    help="the oracle under HEAT_CHAIN's drift")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    infos = load_infos(f"{args.workdir}/infos.hdf5")
    return check(infos, args.particles, args.heat_chain, device)


if __name__ == "__main__":
    main()
