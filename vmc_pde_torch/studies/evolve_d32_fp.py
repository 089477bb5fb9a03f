"""Time-evolution study of the d=32 Fokker-Planck main path (the shape of
the throughput benchmarks), the counterpart of scripts/evolve_d32_fp.py:
it evolves the density and validates it against the SDE particle oracle
(oracle/sde.py) and the exact Lyapunov covariance.

The d=32 phase space is 16 (q, p) pairs under harmonic advection and
momentum damping and diffusion toward temperature T; the flow's
covariance diagonal must track the oracle cloud's within Monte Carlo
tolerance while both relax toward the T-thermal state. The oracle's cloud
is the JAX package's f64 normals of PRNGKey(5) (utils/threefry.py), its
noise a torch generator seeded 6.

    python -m vmc_pde_torch.studies.evolve_d32_fp [--n 16384] [--steps 48]
        [--k 8]
    python -m vmc_pde_torch.studies.evolve_d32_fp --quick --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

DIM = 32
# the JAX package's key of the oracle's cloud; the noise generator's seed
CLOUD_SEED, NOISE_SEED = 5, 6
ORACLE_MIN = 20000


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--k", type=int, default=8,
                    help="steps per dispatch")
    ap.add_argument("--dt", type=float, default=2e-3)
    ap.add_argument("--chunk", type=int, default=0,
                    help="streaming Gram chunk size (0 = direct; the "
                         "production operating point is --n 524288 "
                         "--chunk 65536, the tri2 + split-kernel path)")
    ap.add_argument("--temperature", type=float, default=10.0)
    ap.add_argument("--precision", type=str, default="tpu",
                    choices=["tpu", "tpu_f64stats", "f32", "f64"])
    ap.add_argument("--qmc", action="store_true",
                    help="randomized-QMC latent sampling")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; raises without one)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    if args.quick:
        args.n, args.steps, args.k = 1024, 8, 4
        args.precision = "f64"
    return args


def make_config(args):
    from ..config import RunConfig

    return RunConfig(
        name="d32_fp", dim=DIM, offset=(0.0,) * DIM,
        equation="advection_hamiltonian_wDiss",
        equation_params={"T": args.temperature},
        variant="affine", latent_name="Gauss",
        dt0=args.dt, max_step=args.dt, t_end=args.dt * (args.steps + 1),
        n_samples_tdvp=args.n, n_samples_obs=args.n,
        chunk_size=args.chunk,
        precision=args.precision, verbose=False, qmc=args.qmc,
        steps_per_dispatch=args.k, device=str(args.device),
    )


def oracle_params(T: float) -> dict:
    return {"m": 1.0, "omega": 1.0, "gamma": 1.0, "T": T, "lam": 0.0}


def oracle_cloud(n: int, device="cpu") -> torch.Tensor:
    """The oracle's N(0, I) cloud of max(n, 20000) particles in f64."""
    from ..utils.threefry import normal_f64

    return torch.as_tensor(normal_f64(CLOUD_SEED, (max(n, ORACLE_MIN), DIM)),
                           device=device)


def oracle(cloud, dt: float, steps: int, T: float) -> dict:
    """The SDE oracle from ``cloud`` under the model's operator, ``steps +
    1`` records."""
    from ..oracle import sde

    device = cloud.device
    gen = torch.Generator(device=device)
    gen.manual_seed(NOISE_SEED)
    _, infos = sde.evolve(cloud, 0.0, dt, steps + 1,
                          drift_name="phase_space", params=oracle_params(T),
                          gen=gen)
    return infos


def lyapunov_diag(times, T, gamma=1.0, n_sub=4000):
    """(len(times), 2) diagonal of the exact covariance of one (q, p) pair
    from C(0) = I: the system is a linear (OU) SDE, per pair
    A = [[0, 1], [-1, -gamma]], B = diag(0, 2 gamma T), so
    dC/dt = A C + C A^T + B with no sampling noise; RK4 at h = t / n_sub
    for every record at once (exact to ~1e-13)."""
    A = np.array([[0.0, 1.0], [-1.0, -gamma]])
    B = np.diag([0.0, 2.0 * gamma * T])
    h = (np.asarray(times, dtype=np.float64) / n_sub)[:, None, None]
    C = np.tile(np.eye(2), (len(times), 1, 1))

    def f(C):
        return A @ C + C @ A.T + B

    for _ in range(n_sub):
        k1 = f(C)
        k2 = f(C + h / 2 * k1)
        k3 = f(C + h / 2 * k2)
        k4 = f(C + h * k3)
        C = C + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return np.diagonal(C, axis1=1, axis2=2)


def summarize(infos, oracle_infos, T, wall) -> dict:
    """The script's summary: the model's covariance diagonal against the
    oracle's and the Lyapunov solution's at matching record indices (both
    record the state at t_i)."""
    m_cov = np.asarray(infos["covar"])
    m_t = np.asarray(infos["times"])
    o_cov = np.asarray(oracle_infos["covar"])
    n_rec = min(len(m_t), len(o_cov))
    md = np.diagonal(m_cov[:n_rec], axis1=1, axis2=2)
    od = np.diagonal(o_cov[:n_rec], axis1=1, axis2=2)
    rel = np.abs(md - od) / np.maximum(np.abs(od), 1e-9)
    # momentum coordinates (odd indices) heat toward T
    p_growth = md[-1, 1::2].mean() / md[0, 1::2].mean()
    ed = np.tile(lyapunov_diag(m_t[:n_rec], T), (1, md.shape[1] // 2))
    rel_exact = np.abs(md - ed) / np.maximum(np.abs(ed), 1e-9)
    return dict(
        steps=int(len(m_t)), wall_s=round(wall, 1),
        residual_median=float(np.median(infos["solver_res"])),
        cov_diag_rel_err_max=float(rel.max()),
        cov_diag_rel_err_mean=float(rel.mean()),
        cov_diag_exact_rel_err_max=float(rel_exact.max()),
        cov_diag_exact_rel_err_mean=float(rel_exact.mean()),
        momentum_var_growth=float(p_growth),
        entropy_finite=bool(np.isfinite(infos["entropy"]).all()),
    )


def main(argv=None):
    """Run the study; returns (summary, the model's infos, the oracle's)."""
    from ..driver import resolve_device, run

    args = parse_args(argv)
    args.device = resolve_device(args.device)
    t0 = time.time()
    _, rec = run(make_config(args), max_steps=args.steps)
    wall = time.time() - t0
    infos = rec.as_arrays()
    o = oracle(oracle_cloud(args.n, args.device), args.dt, args.steps,
               args.temperature)
    summary = summarize(infos, o, args.temperature, wall)
    print(json.dumps(summary))
    if args.out:
        np.savez(args.out, times=infos["times"], covar=infos["covar"],
                 oracle_covar=o["covar"], entropy=infos["entropy"],
                 residual=infos["solver_res"])
    return summary, infos, o


if __name__ == "__main__":
    main()
