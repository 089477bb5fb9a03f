"""One-command reproduction of the reference's two paper figures, the
counterpart of scripts/make_paper_figures.py.

1. ``paper_fig_diffusion.pdf``, the diffusion entropy panel: dim-8 Gauss
   and Student-t (nu0=2) diffusion entropy S(t) with the Gauss closed
   form S = d/2 log(2 pi e (1 + 2Dt)), the radial grid oracle's
   Student-t solution (oracle/radial.py) and the learnable-nu inset.
   Overlays, when present: the reference's shipped INN and grid-based
   HDF5 curves (``--reference``), and this framework's runs (npz curves
   of accuracy_d8 --dump-curve in ``--run-dir``).

2. ``paper_fig_phasespace.pdf``, the 6-D phase-space temperature-
   difference panel: (a) means, (b) covariance diagonals, (c) MC sphere
   integrals with the analytic Gauss ball-mass lines, (d) entropy with the
   steady-state line. Overlays: the reference's INN and Wiener HDF5, this
   framework's run (``<run-dir>/fp6/infos.hdf5``), a fresh SDE particle
   oracle (the 'Wiener' methodology) and the exact nonequilibrium steady
   state from the continuous Lyapunov equation. The run is the per-site
   heat-transport chain at T = (10, 5, 2.5), coupled (HEAT_CHAIN).

    python -m vmc_pde_torch.studies.make_paper_figures       # stored data
    python -m vmc_pde_torch.studies.make_paper_figures --run # runs first
        [--outdir paper_figures] [--run-dir paper_figures/runs]
        [--reference REFERENCE/paper_plot] [--device cpu]

Missing inputs are skipped with a note, never fatal. Reading or writing
an HDF5 needs h5py and drawing needs matplotlib (both imported lazily);
the collection of the curves needs neither, unless an HDF5 is there to
read.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .check_fp6 import HEAT_CHAIN


def _load_h5(path):
    """{key: np.ndarray} from an infos HDF5, or None when absent (or
    when no reference directory was given: ``path`` None)."""
    if path is None:
        return None
    if not os.path.exists(path):
        print(f"  [skip] {path} not found")
        return None
    from ..utils.infos import load_infos

    return load_infos(path)


def _load_npz(path):
    if path is None or not os.path.exists(path):
        if path is not None:
            print(f"  [skip] {path} not found")
        return None
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in z.files}


def _ref(ref_dir, *parts):
    return None if ref_dir is None else os.path.join(ref_dir, *parts)


# ---------------------------------------------------------------------------
# Figure 1: diffusion entropy (+ nu inset).
# ---------------------------------------------------------------------------

def build_diffusion_figure(curves, dim=8, D=1.0):
    """``curves``: list of (label, style-kwargs, {"times", "entropy",
    optional "nu"}). Returns the matplotlib figure (entropy panel with the
    analytic Gauss curve and a nu(t) inset for every curve carrying nu)."""
    from ..viz.paper import _plt, gauss_diffusion_entropy

    plt = _plt()
    fig, ax = plt.subplots(figsize=(5.2, 3.6))

    t_max = 5.0
    for label, style, data in curves:
        ax.plot(data["times"], data["entropy"], label=label, **style)
        t_max = max(t_max, float(np.max(data["times"])))

    ts = np.linspace(0, t_max, 200)
    ax.plot(ts, gauss_diffusion_entropy(ts, dim, D=D), color="black",
            linestyle="--", alpha=0.8, label="Gauss - Analytical")
    ax.legend(loc="upper left", fontsize=7)
    ax.grid(alpha=0.4)
    ax.set_xlabel(r"$Dt$")
    ax.set_ylabel("Entropy")

    nu_curves = [(lb, st, d) for lb, st, d in curves if "nu" in d]
    if nu_curves:
        axins = ax.inset_axes([0.57, 0.12, 0.40, 0.45])
        for label, style, data in nu_curves:
            axins.plot(data["times"], data["nu"], **style)
        axins.set_ylabel(r"$\nu$", fontsize=8)
        axins.grid(alpha=0.4)
        axins.tick_params(labelsize=7)
    fig.tight_layout()
    return fig


def collect_diffusion_curves(ref_dir, run_dir, grid_oracle=True,
                             grid_t_end=5.0, device="cpu"):
    curves = []

    # the reference's shipped INN curves
    ref_st = _load_h5(_ref(
        ref_dir, "data_diffusion",
        "dim8_StudentT_nu2_NsamplesTDVP10000_NsamplesObs10000",
        "infos.hdf5"))
    if ref_st is not None:
        curves.append((r"Student-$t$ - ref INN",
                       dict(color="tab:blue", alpha=0.5),
                       dict(times=ref_st["times"],
                            entropy=ref_st["entropy"],
                            nu=np.exp(ref_st["dist_params"][:, 0]) + 1)))
    ref_g = _load_h5(_ref(
        ref_dir, "data_diffusion",
        "dim8_Gauss_NsamplesTDVP10000_NsamplesObs10000", "infos.hdf5"))
    if ref_g is not None:
        curves.append(("Gauss - ref INN", dict(color="tab:red", alpha=0.5),
                       dict(times=ref_g["times"],
                            entropy=ref_g["entropy"])))

    # the reference's shipped grid-based Student-t solution
    ref_grid = _load_h5(_ref(
        ref_dir, "data_diffusion", "StudentT_gridbased",
        "infos_step4e-3_dt1e-6_centergrid_slimmed.hdf5"))
    if ref_grid is not None:
        curves.append((r"Student-$t$ - ref grid",
                       dict(color="gray", linestyle=":", alpha=0.9),
                       dict(times=ref_grid["t"],
                            entropy=ref_grid["entropy"])))

    # this framework's curves (accuracy_d8 --dump-curve npz)
    own_st = _load_npz(os.path.join(run_dir, "d8_student_curve.npz"))
    if own_st is not None:
        curves.append((r"Student-$t$ - this work",
                       dict(color="tab:blue", linewidth=1.8),
                       dict(times=own_st["times"],
                            entropy=own_st["entropy"],
                            nu=np.exp(own_st["dist_params"][:, 0]) + 1)))
    own_g = _load_npz(os.path.join(run_dir, "d8_gauss_curve.npz"))
    if own_g is not None:
        curves.append(("Gauss - this work",
                       dict(color="tab:red", linewidth=1.8),
                       dict(times=own_g["times"],
                            entropy=own_g["entropy"])))

    # this framework's own finite-volume grid oracle (recomputed)
    if grid_oracle:
        from .compare_student_grid import grid_reference

        print("  computing radial grid oracle (Student-t, d=8) ...")
        grid = grid_reference(grid_t_end, n_record=120, device=device)
        curves.append((r"Student-$t$ - grid oracle (this work)",
                       dict(color="black", linestyle="-.", alpha=0.8),
                       dict(times=grid["times"],
                            entropy=grid["entropy"])))
    return curves


# ---------------------------------------------------------------------------
# Figure 2: phase-space temperature difference (4 panels).
# ---------------------------------------------------------------------------

def ness_state(params=None):
    """Exact nonequilibrium steady state of the linear heat-transport
    chain: solve the continuous Lyapunov equation A S + S A^T + D = 0
    for the drift of dx_i = p_i dt, dp_i = (-dH/dx_i - gamma p_i) dt +
    sqrt(2 m gamma T_i) dW_i. Returns (S (6, 6), entropy)."""
    import scipy.linalg

    p = dict(HEAT_CHAIN, **(params or {}))
    gamma, Ts, m, w2 = p["gamma"], p["T"], p["m"], p["omega"] ** 2
    n = len(Ts)
    K = np.zeros((n, n))
    if p["coupled"]:
        # H = m w^2/2 (sum_i (x_i - x_{i-1})^2 + onsite sum_i x_i^2): the
        # on-site pinning removes the ring's zero mode, so a stationary
        # state exists
        for i in range(n):
            K[i, i] = 2.0 + p.get("onsite", 0.0)
            K[i, (i - 1) % n] -= 1.0
            K[i, (i + 1) % n] -= 1.0
        K *= m * w2
    else:
        K = np.eye(n) * m * w2
    A = np.zeros((2 * n, 2 * n))
    D = np.zeros((2 * n, 2 * n))
    for i in range(n):
        A[2 * i, 2 * i + 1] = 1.0 / m
        for j in range(n):
            A[2 * i + 1, 2 * j] = -K[i, j]
        A[2 * i + 1, 2 * i + 1] = -gamma
        D[2 * i + 1, 2 * i + 1] = 2.0 * m * gamma * Ts[i]
    S = scipy.linalg.solve_continuous_lyapunov(A, -D)
    ent = 0.5 * np.linalg.slogdet(2 * np.pi * np.e * S)[1]
    return S, ent


def build_phasespace_figure(inn_runs, wiener_runs, dim=6, T=10.0,
                            ness=None):
    """4-panel figure (means / covar diagonals / sphere integrals /
    entropy). ``inn_runs``/``wiener_runs``: lists of (label, style,
    infos-dict); INN runs may carry "entropy" and "integral_*".
    ``ness``: optional (S, entropy) exact steady state to draw as
    reference lines in panels (b) and (d)."""
    from ..viz.paper import _plt, gauss_ball_mass, steady_state_entropy

    plt = _plt()
    fig, axes = plt.subplots(figsize=(13, 3.2), ncols=4)

    for runs, lw in ((wiener_runs, 1.0), (inn_runs, 1.6)):
        for label, style, d in runs:
            t = d["times"]
            means = np.asarray(d["x1"])
            cov = np.asarray(d["covar"])
            for i in range(means.shape[1]):
                axes[0].plot(t, means[:, i], linewidth=lw, **style,
                             label=label if i == 0 else None)
                axes[1].plot(t, cov[:, i, i], linewidth=lw, **style,
                             label=label if i == 0 else None)

    for label, style, d in inn_runs + wiener_runs:
        if "integral_1sigma" not in d:
            continue
        for key in ("integral_1sigma", "integral_0.5sigma",
                    "integral_0.1sigma"):
            axes[2].plot(d["times"], np.maximum(np.asarray(d[key]), 1e-12),
                         **style,
                         label=label if key == "integral_1sigma" else None)
    # the analytic steady-state ball masses
    for r in (1.0, 0.5, 0.1):
        axes[2].axhline(gauss_ball_mass(dim, r), color="black",
                        linestyle="--", alpha=0.7, zorder=0)
    axes[2].set_yscale("log")
    axes[2].set_ylim(1e-9, 1.0)

    for label, style, d in inn_runs:
        if "entropy" in d:
            axes[3].plot(d["times"], d["entropy"], **style, label=label)
    if ness is not None:
        S_ness, ent_ness = ness
        for i in range(S_ness.shape[0]):
            axes[1].axhline(S_ness[i, i], color="black", linestyle=":",
                            alpha=0.5, zorder=0)
        axes[3].axhline(ent_ness, color="black", linestyle=":",
                        alpha=0.8, label="exact NESS (Lyapunov)")
    axes[3].axhline(steady_state_entropy(dim // 2, T), color="black",
                    linestyle="--", alpha=0.7,
                    label=f"equilibrium (T={T:g})")

    titles = [r"$\langle O \rangle$",
              r"$\langle O^2 \rangle - \langle O \rangle^2$",
              "Sphere integrals", "Entropy"]
    for ax, title, letter in zip(axes, titles, "abcd"):
        ax.grid(alpha=0.4)
        ax.set_xlabel(r"$\omega t$")
        ax.set_title(title, fontsize=10)
        ax.text(0.02, 1.04, f"({letter})", transform=ax.transAxes,
                fontweight="bold")
        ax.legend(fontsize=6)
    fig.tight_layout()
    return fig


def fresh_wiener_oracle(n_particles=10000, t_end=5.0, dt=1e-2,
                        params=None, device="cpu"):
    """The reference's 'Wiener' baseline recomputed: the SDE particle
    cloud of check_fp6 under the heat-transport chain's drift (per-site
    T)."""
    from .check_fp6 import oracle

    return oracle(t_end, n_particles, dict(HEAT_CHAIN, **(params or {})),
                  device, dt=dt, integral_T=10.0)


def collect_phasespace_runs(ref_dir, run_dir, oracle_particles=10000,
                            device="cpu", own=None):
    """The phase-space figure's runs: the reference's (when ``ref_dir``
    holds them), this framework's fp6 run (``own``, its infos, or else
    ``<run_dir>/fp6/infos.hdf5``) and a fresh Wiener oracle."""
    inn_runs, wiener_runs = [], []

    ref_inn = _load_h5(_ref(
        ref_dir, "data_phaseSpace", "INN",
        "NsamplesTDVP10000_NsamplesObs10000_Tdifferent", "infos.hdf5"))
    if ref_inn is not None:
        inn_runs.append(("ref INN", dict(color="tab:orange", alpha=0.55),
                         ref_inn))
    ref_w = _load_h5(_ref(
        ref_dir, "data_phaseSpace", "Wiener", "Nsamples10000_Tdifferent",
        "infos.hdf5"))
    if ref_w is not None:
        wiener_runs.append(("ref Wiener",
                            dict(color="tab:green", alpha=0.5,
                                 linestyle="--"), ref_w))

    if own is None:
        own = _load_h5(os.path.join(run_dir, "fp6", "infos.hdf5"))
    if own is not None:
        inn_runs.append(("this work, NESS T=(10,5,2.5)",
                         dict(color="tab:blue", alpha=0.9), own))

    print("  computing SDE (Wiener) oracle, heat chain T=(10,5,2.5) ...")
    wiener_runs.append(("Wiener oracle (this work)",
                        dict(color="tab:red", alpha=0.6, linestyle="--"),
                        fresh_wiener_oracle(n_particles=oracle_particles,
                                            device=device)))
    return inn_runs, wiener_runs


# ---------------------------------------------------------------------------
# --run: regenerate this framework's runs.
# ---------------------------------------------------------------------------

def fp6_config(run_dir, samples=10000, t_end=5.0, device="cuda"):
    """The heat-transport chain's run: harmonicOsc_diff at per-site
    T = HEAT_CHAIN's, coupled, with the sphere integrals recorded."""
    from ..config import preset

    return preset(
        "harmonicOsc_diff", n_samples_tdvp=samples, n_samples_obs=samples,
        t_end=t_end, workdir=os.path.join(run_dir, "fp6"), verbose=False,
        integrals=True,
        equation_params={"T": HEAT_CHAIN["T"],
                         "coupled": HEAT_CHAIN["coupled"],
                         "onsite": HEAT_CHAIN["onsite"]},
        steps_per_dispatch=8, dt0=1e-4, max_step=1e-2, device=str(device),
    )


def regenerate_runs(run_dir, samples=10000, t_end=5.0, device="cuda"):
    """Produce this framework's three overlay inputs on ``device``: the d8
    Gauss and Student-t curves (accuracy_d8 --qmc --steps-per-dispatch 8
    --dump-curve) and the fp6 heat-chain run with its sphere integrals
    (its infos.hdf5 needs h5py). Returns {"d8_gauss", "d8_student": the
    accuracy_d8 (JSON record, infos)}, and {"fp6": its infos}."""
    from ..driver import run
    from . import accuracy_d8

    os.makedirs(run_dir, exist_ok=True)
    out = {}
    for latent, name in (("Gauss", "d8_gauss"), ("Student_t", "d8_student")):
        path = os.path.join(run_dir, f"{name}_curve.npz")
        print(f"  running d8 {latent} diffusion -> {path}")
        out[name] = accuracy_d8.main([
            "--latent", latent, "--samples", str(samples),
            "--t-end", str(t_end), "--steps-per-dispatch", "8",
            "--qmc", "--dump-curve", path, "--device", str(device),
        ])
    cfg = fp6_config(run_dir, samples, t_end, device)
    print(f"  running fp6 heat-transport chain -> {cfg.workdir}")
    out["fp6"] = run(cfg)[1].as_arrays()
    return out


def main(argv=None):
    from ..driver import resolve_device

    ap = argparse.ArgumentParser(
        description="Regenerate the reference's two paper figures with "
                    "this framework's overlays")
    ap.add_argument("--outdir", default="paper_figures")
    ap.add_argument("--reference", default=None,
                    help="the reference's paper_plot directory (shipped "
                         "HDF5); its overlays are skipped without it")
    ap.add_argument("--run-dir", default=os.path.join("paper_figures",
                                                      "runs"),
                    help="directory with this framework's runs")
    ap.add_argument("--run", action="store_true",
                    help="regenerate this framework's runs first")
    ap.add_argument("--samples", type=int, default=10000)
    ap.add_argument("--t-end", type=float, default=5.0)
    ap.add_argument("--no-grid-oracle", action="store_true",
                    help="skip recomputing the radial grid oracle")
    ap.add_argument("--oracle-particles", type=int, default=10000)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.reference is None:
        print("  [skip] no --reference: the reference's overlays are left "
              "out")
    if args.run:
        regenerate_runs(args.run_dir, samples=args.samples,
                        t_end=args.t_end, device=device)

    os.makedirs(args.outdir, exist_ok=True)

    print("figure 1: diffusion entropy panel")
    curves = collect_diffusion_curves(
        args.reference, args.run_dir, grid_oracle=not args.no_grid_oracle,
        device=device)
    fig = build_diffusion_figure(curves)
    p1 = os.path.join(args.outdir, "paper_fig_diffusion.pdf")
    fig.savefig(p1)
    fig.savefig(p1.replace(".pdf", ".png"), dpi=150)
    print(f"  wrote {p1}")

    print("figure 2: phase-space temperature-difference panel")
    inn_runs, wiener_runs = collect_phasespace_runs(
        args.reference, args.run_dir,
        oracle_particles=args.oracle_particles, device=device)
    fig = build_phasespace_figure(inn_runs, wiener_runs,
                                  ness=ness_state())
    p2 = os.path.join(args.outdir, "paper_fig_phasespace.pdf")
    fig.savefig(p2)
    fig.savefig(p2.replace(".pdf", ".png"), dpi=150)
    print(f"  wrote {p2}")
    return p1, p2


if __name__ == "__main__":
    main()
