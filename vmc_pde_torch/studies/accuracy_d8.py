"""Dim-8 diffusion accuracy study: the entropy error against the closed
form, per seed and per solver configuration; the counterpart of
scripts/accuracy_d8.py.

The reference's headline accuracy artifact is the dim-8 Gaussian
diffusion run: entropy S(t) = d/2 log(2 pi e (1 + 2 D t)), max transient
error 0.057 over t in [0, 5]. The Student-t latent reproduces the
reference's dim8_StudentT_nu2 run, which has no closed form
(compare_student_grid holds its curve against the radial grid).

    python -m vmc_pde_torch.studies.accuracy_d8 --seed 1 [--device cpu]
        [--latent Student_t] [--qmc] [--steps-per-dispatch 8]
        [--precision tpu] [--samples 10000] [--t-end 5.0]
        [--json-out FILE] [--dump-curve FILE.npz]

Prints one JSON line with {seed, steps, t_final, entropy_err_max/mean/
final, t_at_max_err, residual_median, wall_s, wall_s_warm,
steps_per_dispatch, config}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np


def analytic_entropy(d, t, D=1.0):
    return d / 2.0 * math.log(2.0 * math.pi * math.e) \
        + d / 2.0 * np.log1p(2.0 * D * np.asarray(t))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1,
                    help="sets both the init seed and the sampling stream")
    ap.add_argument("--latent", type=str, default="Gauss",
                    choices=["Gauss", "Student_t"])
    ap.add_argument("--samples", type=int, default=10000)
    ap.add_argument("--depth", type=int, default=4,
                    help="coupling-block depth (reference checklist: 4)")
    ap.add_argument("--samples-obs", type=int, default=None,
                    help="observable budget (default = --samples)")
    ap.add_argument("--t-end", type=float, default=5.0)
    ap.add_argument("--precision", type=str, default="tpu",
                    choices=["tpu", "tpu_f64stats", "f32", "f64"])
    ap.add_argument("--gram-precision", type=str, default="high")
    ap.add_argument("--gram-backend", type=str, default="auto")
    ap.add_argument("--use-snr", action="store_true")
    ap.add_argument("--eloc-clip", type=float, default=0.0,
                    help=">0: winsorize Eloc at this many robust sigmas")
    ap.add_argument("--is-gamma", type=float, default=1.0,
                    help="<1: tail-tempered importance sampling of the "
                         "TDVP statistics (Student_t only)")
    ap.add_argument("--qmc", action="store_true",
                    help="randomized-QMC (scrambled Sobol) latent sampling")
    ap.add_argument("--snr-tol", type=float, default=2.0)
    ap.add_argument("--svd-tol", type=float, default=1e-11)
    ap.add_argument("--no-tol-floor", action="store_true")
    ap.add_argument("--solver", type=str, default="auto")
    ap.add_argument("--increase-fac", type=float, default=1.3,
                    help="dt ramp factor")
    ap.add_argument("--dt0", type=float, default=1e-7)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; raises without one)")
    ap.add_argument("--json-out", type=str, default=None)
    ap.add_argument("--dump-curve", type=str, default=None,
                    help="write times/entropy/err arrays to this .npz")
    ap.add_argument("--solve-on-host", action="store_true",
                    help="host numpy f64 solve (reference default)")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help=">1: batch fixed-Heun steps (TDVP.heun_multi; "
                         "CUDA graphs on one card)")
    ap.add_argument("--twice", action="store_true",
                    help="run the evolution a second time with "
                         "sample_seed + 1000 and report both walls: the "
                         "second is the steady state, without the "
                         "kernels' first loads")
    return ap.parse_args(argv)


def make_config(args):
    from ..config import RunConfig

    return RunConfig(
        name=f"d8{args.latent.lower()}_seed{args.seed}",
        dim=8, offset=(0.0,) * 8, latent_name=args.latent,
        equation="diffusion", variant="scale", depth=args.depth,
        dt0=args.dt0, max_step=1e-2, t_end=args.t_end,
        increase_fac=args.increase_fac,
        n_samples_tdvp=args.samples,
        n_samples_obs=args.samples_obs or args.samples,
        seed=args.seed, sample_seed=args.seed, precision=args.precision,
        gram_precision=args.gram_precision,
        gram_backend=args.gram_backend,
        use_snr=args.use_snr, snr_tol=args.snr_tol, svd_tol=args.svd_tol,
        eloc_clip=args.eloc_clip, is_gamma=args.is_gamma, qmc=args.qmc,
        auto_tol_floor=not args.no_tol_floor,
        solver_method=args.solver,
        solve_on_device=not args.solve_on_host,
        steps_per_dispatch=args.steps_per_dispatch,
        device=args.device,
        workdir=None, verbose=False,
    )


def entropy_error(infos, latent):
    """|S(t) - S_exact(t)| of the recorded entropy (NaN for Student-t,
    which has no closed form)."""
    t = np.asarray(infos["times"])
    S = np.asarray(infos["entropy"])
    if latent == "Gauss":
        return np.abs(S - analytic_entropy(8, t))
    return np.full_like(S, np.nan)


def summarize(infos, args, t_wall, t_wall2=None) -> dict:
    """The study's JSON record of a run's infos dict."""
    t = np.asarray(infos["times"])
    err = entropy_error(infos, args.latent)
    res = np.asarray(infos["solver_res"])
    return {
        "seed": args.seed,
        "steps": int(t.size),
        "t_final": float(t[-1]),
        "entropy_err_max": round(float(err.max()), 5),
        "entropy_err_mean": round(float(err.mean()), 5),
        "entropy_err_final": round(float(err[-1]), 5),
        "t_at_max_err": round(float(t[np.argmax(err)]), 4),
        "residual_median": float(np.median(res)),
        "wall_s": round(t_wall, 1),
        "wall_s_warm": None if t_wall2 is None else round(t_wall2, 1),
        "steps_per_dispatch": args.steps_per_dispatch,
        "config": {
            "precision": args.precision,
            "gram_precision": args.gram_precision,
            "use_snr": args.use_snr,
            "svd_tol": args.svd_tol,
            "auto_tol_floor": not args.no_tol_floor,
            "samples": args.samples,
            "samples_obs": args.samples_obs or args.samples,
            "increase_fac": args.increase_fac,
            "dt0": args.dt0,
            "latent": args.latent,
            "depth": args.depth,
            "eloc_clip": args.eloc_clip,
            "is_gamma": args.is_gamma,
            "qmc": args.qmc,
            "solver": args.solver,
            "solve_on_host": args.solve_on_host,
        },
    }


def dump_curve(path, infos, latent):
    """The --dump-curve npz: times, entropy, err, res, and dist_params
    where the run recorded them."""
    extra = {}
    if "dist_params" in infos:
        extra["dist_params"] = np.asarray(infos["dist_params"])
    np.savez(path, times=np.asarray(infos["times"]),
             entropy=np.asarray(infos["entropy"]),
             err=entropy_error(infos, latent),
             res=np.asarray(infos["solver_res"]), **extra)


def main(argv=None):
    """Run the study; returns (the JSON record, the infos dict)."""
    from .. import driver

    args = parse_args(argv)
    driver.resolve_device(args.device)
    cfg = make_config(args)
    t_wall = -time.perf_counter()
    _, rec = driver.run(cfg)
    t_wall += time.perf_counter()
    t_wall2 = None
    if args.twice:
        cfg2 = dataclasses.replace(cfg, sample_seed=args.seed + 1000)
        t_wall2 = -time.perf_counter()
        _, rec = driver.run(cfg2)
        t_wall2 += time.perf_counter()
    infos = rec.as_arrays()
    out = summarize(infos, args, t_wall, t_wall2)
    if args.dump_curve:
        dump_curve(args.dump_curve, infos, args.latent)
    line = json.dumps(out)
    print(line, flush=True)
    if args.json_out:
        with open(args.json_out, "a") as f:
            f.write(line + "\n")
    return out, infos


if __name__ == "__main__":
    main()
