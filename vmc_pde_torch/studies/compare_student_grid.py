"""Compare dim-8 Student-t flow runs against the exact grid solution, the
counterpart of scripts/compare_student_grid.py.

Recomputes the radial-grid reference (oracle/radial.py, on the card as
CUDA graphs) and prints the entropy lag of every curve given on the
command line (npz files holding ``times`` and ``entropy``, such as
accuracy_d8's --dump-curve), plus the reference paper's own data when
its HDF5 is given with --reference.

    python -m vmc_pde_torch.studies.compare_student_grid CURVE.npz ...
        [--reference INFOS.hdf5] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from functools import partial

import numpy as np

NU, DIM = 2.0, 8


def grid_faces():
    """The graded radial grid: 0.02 cells to r = 12, growing 2% a cell out
    to r = 1500."""
    from ..oracle import radial

    return radial.radial_faces(1500.0, dr0=0.02, r_core=12.0, growth=1.02)


def grid_reference(t_end: float = 5.0, n_record: int = 250, device="cpu",
                   **kw) -> dict:
    """The radial grid's Student-t (nu=2, d=8) diffusion to ``t_end``."""
    from ..oracle import radial

    return radial.evolve_radial(partial(radial.student_t_radial, nu=NU,
                                        d=DIM), d=DIM, t_end=t_end,
                                n_record=n_record, faces=grid_faces(),
                                device=device, **kw)


def report(name, t, S, grid) -> dict:
    """Print the entropy lag of the curve (t, S) against the grid at
    t = 1, 2, 5 and its largest past t = 0.5; returns them."""
    t, S = np.asarray(t), np.asarray(S)
    Sg = np.interp(t, grid["times"], grid["entropy"])
    lag = S - Sg
    idx = {tt: np.argmin(np.abs(t - tt)) for tt in (1.0, 2.0, 5.0)}
    late = np.abs(lag[t > 0.5])
    out = {f"lag_t{tt:g}": float(lag[i]) for tt, i in idx.items()}
    out["max_abs_lag_after_0.5"] = float(late.max()) if late.size else None
    late_s = f"{late.max():.4f}" if late.size else "n/a"
    print(f"{name}: lag t=1 {lag[idx[1.0]]:+.4f}  t=2 {lag[idx[2.0]]:+.4f}  "
          f"t=5 {lag[idx[5.0]]:+.4f}  max|lag| (t>0.5) {late_s}")
    return out


def main(argv=None):
    """Returns {curve path: its lags}."""
    from ..driver import resolve_device
    from ..utils.infos import load_infos

    ap = argparse.ArgumentParser()
    ap.add_argument("curves", nargs="*")
    ap.add_argument("--reference", type=str, default=None,
                    help="the reference paper's dim8_StudentT_nu2 "
                         "infos.hdf5, reported beside the curves")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    grid = grid_reference(5.0, device=device)
    print(f"grid: entropy {grid['entropy'][0]:.4f} -> "
          f"{grid['entropy'][-1]:.4f}, mass drift "
          f"{np.abs(grid['mass'] - grid['mass'][0]).max():.2e}")
    out = {}
    for path in args.curves:
        with np.load(path) as d:
            out[path] = report(path, d["times"], d["entropy"], grid)
    if args.reference and os.path.exists(args.reference):
        ref = load_infos(args.reference)
        out["reference paper INN"] = report(
            "reference paper INN", ref["times"], ref["entropy"], grid)
    return out


if __name__ == "__main__":
    main()
