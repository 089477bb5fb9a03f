"""Minimal end-to-end demo: 2D Gaussian diffusion ("mwe" workload), the
port's counterpart of examples/minimal_demo.py.

Run the variational solver on the simplest workload, compare the entropy
trajectory against the analytic closed form S(t) = log(2 pi e (1 + 2t))
per dimension, and the covariance growth against Cov(t) = (1 + 2t) I; then
draw the diagnostic figures (matplotlib) and write infos.hdf5 (h5py).

    python -m vmc_pde_torch.examples.minimal_demo [--t-end 0.3] \\
        [--samples 4096] [--device cpu]
"""

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--t-end", type=float, default=0.3)
    p.add_argument("--samples", type=int, default=4096)
    p.add_argument("--outdir", type=str, default="output/minimal_demo")
    p.add_argument("--precision", type=str, default=None,
                   help="tpu|f32|f64 (default: f64 on the CPU, tpu on "
                        "the card)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; raises without one)")
    args = p.parse_args(argv)

    import numpy as np

    from vmc_pde_torch.config import preset
    from vmc_pde_torch.driver import run
    from vmc_pde_torch.viz.paper import entropy_error_stats
    from vmc_pde_torch.viz.plots import make_final_plots

    cfg = preset(
        "mwe",
        n_samples_tdvp=args.samples,
        n_samples_obs=args.samples,
        dt0=1e-3,
        t_end=args.t_end,
        precision=args.precision or (
            "f64" if args.device == "cpu" else "tpu"),
        device=args.device,
        workdir=args.outdir,
        verbose=True,
    )
    state, rec = run(cfg)
    infos = rec.as_arrays()

    stats = entropy_error_stats(infos, dim=2)
    t_final = infos["times"][-1]
    cov = infos["covar"][-1]
    print("\n=== results ===")
    print(f"steps: {len(infos['times'])}, final t: {t_final:.3f}")
    print(f"entropy error vs analytic: max {stats['max']:.3e}, "
          f"final {stats['final']:.3e}")
    print(f"covariance diagonal at t={t_final:.2f}: {np.diag(cov)} "
          f"(exact: {1 + 2 * t_final:.3f})")
    print(f"median solver residual: "
          f"{float(np.median(infos['solver_res'])):.2e}")

    os.makedirs(args.outdir, exist_ok=True)
    figs = make_final_plots(args.outdir, infos, dim=2)
    print(f"wrote {len(figs)} figures + infos.hdf5 to {args.outdir}/")
    return infos


if __name__ == "__main__":
    main()
