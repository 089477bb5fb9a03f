"""Double-well Fokker-Planck quench study, the counterpart of
scripts/evolve_doublewell.py.

Evolves the ``doubleWell`` preset -- the bimodal double-well Boltzmann
latent at quench temperature T0=1.5, Metropolis-sampled (random-walk
proposals) -- under V(x) = -2 x^2 + x^4 coupled to a colder bath T=0.5,
and validates the whole trajectory against the independent SDE oracle
started from the same density by exact inverse-CDF sampling
(oracle/sde.py double_well_init_cloud; the cloud's generator is seeded 3,
the noise's 4).

Over the window the momentum variance cools along the OU relaxation
T0 e^{-2 gamma t} + T (1 - e^{-2 gamma t}); the position marginal
sharpens toward the bimodal exp(-V/T).

    python -m vmc_pde_torch.studies.evolve_doublewell [--t-end 2.0]
        [--dt 2e-3] [--samples 3200] [--chains 400] [--out FILE.npz]
        [--precision tpu] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

CLOUD_SEED, NOISE_SEED = 3, 4
BATH_T = 0.5
ORACLE_PARAMS = {"m": 1.0, "omega": 1.0, "gamma": 1.0, "T": BATH_T,
                 "lam": 1.0, "v2": -4.0}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--t-end", type=float, default=2.0)
    ap.add_argument("--dt", type=float, default=2e-3)
    ap.add_argument("--samples", type=int, default=3200)
    ap.add_argument("--chains", type=int, default=400)
    ap.add_argument("--oracle-n", type=int, default=100000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None,
                    help="write the trajectories to this .npz")
    ap.add_argument("--precision", type=str, default="f64",
                    choices=["tpu", "tpu_f64stats", "f32", "f64"])
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; raises without one)")
    return ap.parse_args(argv)


def make_config(args):
    from ..config import preset

    return preset(
        "doubleWell",
        n_samples_tdvp=args.samples,
        n_samples_obs=args.samples,
        n_chains=args.chains,
        dt0=args.dt,
        max_step=args.dt,
        t_end=args.t_end,
        exact_t_end=True,
        seed=args.seed,
        precision=args.precision,
        verbose=False,
        grid_points=60,
        device=str(args.device),
    )


def _gen(device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def oracle_cloud(n: int, device="cpu") -> torch.Tensor:
    from ..oracle import sde

    return sde.double_well_init_cloud(_gen(device, CLOUD_SEED), n)


def oracle(cloud, dt: float, n_records: int):
    """(final cloud, infos) of the SDE oracle at the bath's parameters."""
    from ..oracle import sde

    return sde.evolve(cloud, 0.0, dt, n_records, drift_name="phase_space",
                      params=ORACLE_PARAMS,
                      gen=_gen(cloud.device, NOISE_SEED))


def stationary_marginal(g1):
    """The bath's Boltzmann x-marginal exp(-V/T), normalized on ``g1``."""
    v = -2.0 * g1**2 + g1**4
    p_stat = np.exp(-v / BATH_T)
    return p_stat / np.trapezoid(p_stat, g1)


def x_marginal(state, g1, ps):
    """The model's x-marginal on ``g1``: p(x, p) integrated over ``ps``."""
    X, P = np.meshgrid(g1, ps, indexing="ij")
    coords = np.stack([X.ravel(), P.ravel()], axis=1)
    logp = state.log_prob(coords).cpu().numpy().reshape(len(g1), len(ps))
    return np.trapezoid(np.exp(logp), ps, axis=1)


def summarize(args, infos, oracle_infos, p_x, p_stat, g1, mass):
    m_cov = np.asarray(infos["covar"])
    o_cov = np.asarray(oracle_infos["covar"])[: len(m_cov)]
    m_x1 = np.asarray(infos["x1"])
    o_x1 = np.asarray(oracle_infos["x1"])[: len(m_x1)]
    skip = max(10, len(m_cov) // 20)
    cov_rel = np.abs(np.diagonal(m_cov, axis1=1, axis2=2)
                     - np.diagonal(o_cov, axis1=1, axis2=2)) / np.abs(
        np.diagonal(o_cov, axis1=1, axis2=2))
    mean_bias = np.abs((m_x1[skip:] - o_x1[skip:]).mean(axis=0))
    return {
        "t_end": args.t_end,
        "dt": args.dt,
        "samples": args.samples,
        "chains": args.chains,
        "steps": len(m_cov),
        "cov_rel_err_mean": float(cov_rel[skip:].mean()),
        "cov_rel_err_max": float(cov_rel[skip:].max()),
        "mean_bias_max": float(mean_bias.max()),
        "varp_start": float(o_cov[0][1, 1]),
        "varp_end_oracle": float(o_cov[-1][1, 1]),
        "varp_end_model": float(m_cov[-1][1, 1]),
        "x_marginal_l1_vs_stationary": float(
            np.trapezoid(np.abs(p_x - p_stat), g1)),
        "mass": mass,
    }


def main(argv=None):
    """Run the study; returns its JSON record."""
    from ..driver import resolve_device, run
    from ..utils.grid import Grid

    args = parse_args(argv)
    args.device = resolve_device(args.device)
    n_steps = int(round(args.t_end / args.dt))
    state, rec = run(make_config(args))
    infos = rec.as_arrays()
    _, oinfos = oracle(oracle_cloud(args.oracle_n, args.device), args.dt,
                       n_steps + 1)

    g1 = np.linspace(-3.0, 3.0, 601)
    p_stat = stationary_marginal(g1)
    p_x = x_marginal(state, g1, np.linspace(-4.0, 4.0, 201))
    grid = Grid(np.ones(2) * 4.0, 200, sym=True)
    out = summarize(args, infos, oinfos, p_x, p_stat, g1,
                    float(state.integrate(grid)))
    print(json.dumps(out))
    if args.out:
        m_cov = np.asarray(infos["covar"])
        m_x1 = np.asarray(infos["x1"])
        np.savez(
            args.out,
            times=np.asarray(infos["times"]),
            m_cov=m_cov, o_cov=np.asarray(oinfos["covar"])[: len(m_cov)],
            m_x1=m_x1, o_x1=np.asarray(oinfos["x1"])[: len(m_x1)],
            x_grid=g1, p_x=p_x, p_stationary=p_stat,
            meta=json.dumps(out),
        )
    return out


if __name__ == "__main__":
    main()
