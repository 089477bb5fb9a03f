"""Paper-figure reproduction utilities, the counterpart of
vmc_pde_tpu/viz/paper.py (numpy and matplotlib only).

Parity with the reference's paper_plot scripts:
- entropy-vs-analytic / multi-run comparison for the diffusion workloads
  (paper_plot/paper_plot_diffusion.py),
- observable trajectories vs the SDE ("Wiener") oracle for the phase-space
  workloads, with analytic steady-state entropy and sphere-integral targets
  (paper_plot/paper_plot_phaseSpaceTempDifference.py:87,129-133),
- data thinning (paper_plot/slim_data.py).

All functions take infos dicts as produced by the driver / oracle (or loaded
with utils.infos.load_infos -- the HDF5 schema is reference-compatible, so
these functions also read the reference's shipped paper data).
"""

from __future__ import annotations

import math

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def slim_infos(infos: dict, stride: int = 10) -> dict:
    """Keep every stride-th step (slim_data.py:4-5)."""
    return {k: np.asarray(v)[::stride] for k, v in infos.items()}


def gauss_diffusion_entropy(times, dim, D=1.0, sigma0_sq=1.0):
    """S(t) = d/2 log(2 pi e (sigma0^2 + 2 D t)) (visualization.py:188)."""
    times = np.asarray(times)
    return dim / 2.0 * np.log(2 * np.pi * np.e * (sigma0_sq + 2 * D * times))


def steady_state_entropy(dim_pairs: int, T: float) -> float:
    """Thermal steady state of the damped phase-space FP: each of the
    ``dim_pairs`` (x, p) pairs contributes log(2 pi e T)
    (paper_plot_phaseSpaceTempDifference.py:87)."""
    return dim_pairs * math.log(2 * math.pi * math.e * T)


def gauss_ball_mass(dim: int, radius_sigmas: float) -> float:
    """P(|x| < r) for x ~ N(0, I_dim), r in units of sigma: the analytic
    sphere-integral targets (paper_plot_phaseSpaceTempDifference.py:129-133
    hard-codes the d=2 values 1.44e-2 / 2.96e-4 / 2.08e-8 for r=sigma/0.5/0.1
    around a variance-T state -- this is the closed form)."""
    from scipy.stats import chi2

    return float(chi2.cdf(radius_sigmas**2, dim))


def entropy_error_stats(infos: dict, dim: int, D: float = 1.0) -> dict:
    """Entropy error vs the analytic Gaussian-diffusion curve -- the
    BASELINE.md accuracy metric (max 5.7e-2 / final 1.47e-2 for the
    reference's dim-8 paper run)."""
    t = np.asarray(infos["times"])
    s = np.asarray(infos["entropy"])
    exact = gauss_diffusion_entropy(t, dim, D)
    err = np.abs(s - exact)
    return {
        "max": float(err.max()),
        "mean": float(err.mean()),
        "final": float(err[-1]),
        "final_rel": float(err[-1] / abs(exact[-1])),
    }


def plot_entropy_comparison(runs: dict, dim: int, D: float = 1.0,
                            analytic: bool = True, save: str = None):
    """Entropy trajectories of several runs vs the analytic curve
    (paper_plot_diffusion.py figure)."""
    plt = _plt()
    fig = plt.figure(figsize=(6, 4))
    tmax = 0.0
    for label, infos in runs.items():
        t = np.asarray(infos["times"])
        plt.plot(t, np.asarray(infos["entropy"]), label=label)
        tmax = max(tmax, t.max())
    if analytic:
        t = np.linspace(0, tmax, 200)
        plt.plot(t, gauss_diffusion_entropy(t, dim, D), "k--",
                 label="analytic")
    plt.xlabel("t")
    plt.ylabel("entropy")
    plt.legend()
    plt.grid()
    fig.tight_layout()
    if save:
        fig.savefig(save)
    return fig


def plot_vs_oracle(model_infos: dict, oracle_infos: dict,
                   keys=("x1", "covar", "integral_1sigma",
                         "integral_0.5sigma", "integral_0.1sigma"),
                   entropy_target: float = None, save_prefix: str = None):
    """Observable trajectories: variational model vs SDE oracle
    (paper_plot_phaseSpaceTempDifference.py figures). Returns the figures."""
    plt = _plt()
    figs = []
    tm = np.asarray(model_infos["times"])
    t_o = np.asarray(oracle_infos["times"])
    for key in keys:
        if key not in model_infos or key not in oracle_infos:
            continue
        fig = plt.figure(figsize=(6, 4))
        m = np.asarray(model_infos[key]).reshape(len(tm), -1)
        o = np.asarray(oracle_infos[key]).reshape(len(t_o), -1)
        for i in range(m.shape[1]):
            plt.plot(tm, m[:, i], f"C{i % 10}-")
        for i in range(o.shape[1]):
            plt.plot(t_o, o[:, i], f"C{i % 10}--")
        plt.xlabel("t")
        plt.ylabel(key)
        plt.title(f"{key}: model (solid) vs oracle (dashed)")
        plt.grid()
        fig.tight_layout()
        if save_prefix:
            fig.savefig(f"{save_prefix}_{key.replace('.', '_')}.pdf")
        figs.append(fig)

    if "entropy" in model_infos:
        fig = plt.figure(figsize=(6, 4))
        plt.plot(tm, np.asarray(model_infos["entropy"]), label="model")
        if entropy_target is not None:
            plt.axhline(entropy_target, color="k", linestyle="--",
                        label="steady state")
        plt.xlabel("t")
        plt.ylabel("entropy")
        plt.legend()
        plt.grid()
        fig.tight_layout()
        if save_prefix:
            fig.savefig(f"{save_prefix}_entropy.pdf")
        figs.append(fig)
    return figs
