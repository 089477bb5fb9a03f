"""North-star metric #1: L2 density error against the exact dynamics of
2-D diffusion, the counterpart of scripts/northstar_l2.py.

The mwe workload (2-D isotropic diffusion, D=1, ~N(0, I) initial density)
has the closed-form solution p(x, t) = N(0, (1+2t) I). This study evolves
the mwe preset at the reference conditions (f64 statistics, 10^4 TDVP
samples, fixed Heun with the preset's dt ramp, landing on t_end) and
reports the density-space error on a dense quadrature grid:

    L2     = sqrt( sum_g (p_model(x_g) - p_exact(x_g))^2 * bin_area )
    L2_rel = L2 / ||p_exact||_2

Target: L2 <= 1e-5.

    python -m vmc_pde_torch.studies.northstar_l2 [--device cpu]
        [--t-end 1.0] [--samples 10000] [--grid-n 501] [--bound 10.0]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

TARGET = 1e-5


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--t-end", type=float, default=1.0)
    ap.add_argument("--samples", type=int, default=10000)
    ap.add_argument("--grid-n", type=int, default=501)
    ap.add_argument("--bound", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-step", type=float, default=None,
                    help="override the preset max dt")
    ap.add_argument("--dt0", type=float, default=None,
                    help="override the ramp start (set equal to --max-step "
                         "to disable the geometric ramp)")
    ap.add_argument("--init-scale", type=float, default=None,
                    help="flow output-layer init scale; 0 = exactly the "
                         "identity flow at t=0")
    ap.add_argument("--gram-f64", action="store_true",
                    help="f64-grade statistics (gram_precision='f64' + "
                         "host solve)")
    ap.add_argument("--steps-per-dispatch", type=int, default=10)
    ap.add_argument("--precision", type=str, default="f64",
                    choices=["tpu", "tpu_f64stats", "f32", "f64"])
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; raises without one)")
    return ap.parse_args(argv)


def make_config(args):
    from ..config import preset

    over = {}
    if args.max_step is not None:
        over["max_step"] = args.max_step
    if args.dt0 is not None:
        over["dt0"] = args.dt0
    if args.init_scale is not None:
        over["init_scale"] = args.init_scale
    precision = args.precision
    if args.gram_f64:
        precision = "tpu_f64stats" if precision == "tpu" else "f64"
        over.update(gram_precision="f64", solve_on_device=False)
    return preset(
        "mwe",
        t_end=args.t_end,
        # land on t_end: the reference's loop overshoots by up to dt, an
        # O(dt) error against p_exact(t_end) that dominates Heun's O(dt^2)
        exact_t_end=True,
        n_samples_tdvp=args.samples,
        n_samples_obs=args.samples,
        precision=precision,
        seed=args.seed,
        steps_per_dispatch=args.steps_per_dispatch,
        plot_every=10**9,
        verbose=False,
        device=args.device,
        **over,
    )


def grid_error(p_model, coords, bin_area, t_end) -> dict:
    """L2, L2_rel, Linf and mass of the model density ``p_model`` at the
    grid's ``coords`` against N(0, (1 + 2 t_end) I)."""
    s2 = 1.0 + 2.0 * t_end  # dSigma/dt = 2 D I, D = 1
    q = np.sum(coords**2, axis=1) / s2
    p_exact = np.exp(-0.5 * q) / (2.0 * np.pi * s2)
    dl2 = float(np.sqrt(np.sum((p_model - p_exact) ** 2) * bin_area))
    nl2 = float(np.sqrt(np.sum(p_exact**2) * bin_area))
    return {
        "L2": dl2,
        "L2_rel": dl2 / nl2,
        "Linf": float(np.max(np.abs(p_model - p_exact))),
        "mass": float(np.sum(p_model) * bin_area),
    }


def evaluate(state, args) -> dict:
    """The study's JSON record of an evolved 2-D ``state``."""
    from ..utils.grid import Grid

    grid = Grid((args.bound,) * 2, args.grid_n, sym=True)
    p_model = np.exp(state.log_prob(grid.coords).cpu().numpy())
    err = grid_error(p_model, grid.coords, grid.bin_area, args.t_end)
    return {
        "t_end": args.t_end,
        "samples": args.samples,
        "grid_n": args.grid_n,
        "bound": args.bound,
        **err,
        "target": TARGET,
        "pass": err["L2"] <= TARGET,
    }


def main(argv=None):
    from .. import driver

    args = parse_args(argv)
    driver.resolve_device(args.device)
    state, _ = driver.run(make_config(args))
    out = evaluate(state, args)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
