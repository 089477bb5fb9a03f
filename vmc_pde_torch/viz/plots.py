"""Matplotlib diagnostics plots, the counterpart of
vmc_pde_tpu/viz/plots.py.

Parity with vmc_fluids/visualization.py: model-density surface/heatmap on a
2D grid (:16-39), 1D slice with Gaussian fit (:42-62), model-target and
model-histogram differences (:65-109), sample histograms (:112-128),
velocity-field quiver (:131-138), and the make_final_plots battery of
time-series figures from the infos record (:141-280).

The only device work is the model's log-density at the plotted points
(``_log_density``): evaluated where the state lives, then moved to numpy;
everything after it is numpy and matplotlib on the host. matplotlib is
imported lazily so headless/production runs never pay for it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_figure(fig, path: str) -> None:
    """Save ``fig`` to ``path`` and close it (the driver's and pretrain's
    periodic snapshots)."""
    fig.savefig(path)
    _plt().close(fig)


def _numpy(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def _log_density(state, points) -> np.ndarray:
    """log p of the state's flow at ``points`` (numpy (M, dim)), computed
    on the state's device and returned as a numpy array."""
    with torch.no_grad():
        return _numpy(state.log_prob(points))


def plot_density(state, grid, proj: bool = False, z_lim=None, fun=None):
    """2D model-density surface or heatmap (visualization.py:16-39)."""
    plt = _plt()
    if fun is not None:
        probs = np.asarray([fun(c) for c in grid.coords])
    else:
        probs = np.exp(_log_density(state, grid.coords))
    probs = probs.reshape((grid.n_gridpoints, grid.n_gridpoints))
    fig = plt.figure(figsize=(6, 6))
    if proj:
        ax = plt.axes()
        ax.pcolormesh(grid.meshgrid[0], grid.meshgrid[1], probs, cmap="coolwarm")
    else:
        ax = plt.axes(projection="3d")
        ax.plot_surface(grid.meshgrid[0], grid.meshgrid[1], probs, cmap="coolwarm")
        ax.set_zlim(0, z_lim if z_lim is not None else 0.15)
    ax.set_title("Model")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.tight_layout()
    return fig


def plot_line(state, scale=1.0, n_gridpoints=100, fit=False, offset=None):
    """1D density slice with optional Gaussian fit (visualization.py:42-62)."""
    plt = _plt()
    offset = np.zeros(state.dim) if offset is None else np.asarray(offset)
    pts = np.zeros((n_gridpoints, state.dim))
    pts[:, 0] = np.arange(-scale, scale, 2 * scale / n_gridpoints)
    probs = np.exp(_log_density(state, pts + offset))
    fig = plt.figure()
    plt.plot(pts[:, 0], probs)
    plt.grid()
    plt.yscale("log")
    plt.xlabel(r"Interpolation $\lambda$")
    plt.ylabel("Probability")
    if fit:
        from scipy.optimize import curve_fit

        def gauss(x, a, x0, sigma):
            return a / np.sqrt(2 * np.pi * sigma**2) * np.exp(
                -((x - x0) ** 2) / (2 * sigma**2)
            )

        popt, _ = curve_fit(gauss, pts[:, 0], probs, p0=[1, 0, 1])
        plt.plot(pts[:, 0], gauss(pts[:, 0], *popt))
    return fig


def plot_diff(state, grid, target_fun):
    """Model minus target surface (visualization.py:65-79). ``target_fun``
    maps an (M, 2) tensor on the state's device to the M target density
    values (pretrain.train.gen_data's)."""
    plt = _plt()
    probs = np.exp(_log_density(state, grid.coords)).reshape(
        (grid.n_gridpoints, grid.n_gridpoints)
    )
    coords = torch.as_tensor(grid.coords, dtype=state.precision.compute,
                             device=state.device)
    target = _numpy(target_fun(coords)).reshape(probs.shape)
    fig = plt.figure()
    ax = plt.axes(projection="3d")
    ax.plot_surface(grid.meshgrid[0], grid.meshgrid[1], probs - target,
                    cmap="coolwarm")
    ax.set_title("Model - Target Function")
    return fig


def plot_data_diff(state, grid, data, fun=None):
    """Model density minus a normalized 2D sample histogram
    (visualization.py:80-109). The histogram is renormalized to the model's
    grid mass so out-of-range samples don't bias the comparison. Returns
    (figure, integrated |diff|)."""
    plt = _plt()
    if fun is not None:
        probs = np.asarray([fun(c) for c in grid.coords])
    else:
        probs = np.exp(_log_density(state, grid.coords))
    probs = probs.reshape((grid.n_gridpoints, grid.n_gridpoints))

    data = np.asarray(data).reshape(-1, 2)
    rng = np.asarray(grid.range) - np.asarray(grid.widths)[:, None] / 2
    hist, _, _ = np.histogram2d(
        data[:, 0], data[:, 1], bins=grid.n_gridpoints, range=rng,
        density=True,
    )
    # density=True normalizes over in-range samples only; rescale to the
    # model's in-range mass so the two surfaces are comparable.
    # histogram2d returns H indexed [x, y] while the meshgrid-flattened
    # probs are [y, x]: transpose before differencing (the reference
    # subtracts untransposed, visualization.py:80-109 -- a mirrored diff
    # for any x/y-asymmetric density; fixed here since the integrated
    # |diff| is returned as a quantitative metric)
    hist = hist.T * probs.sum() / max(hist.sum(), 1e-300)
    diff = probs - hist

    fig = plt.figure()
    ax = plt.axes(projection="3d")
    ax.plot_surface(grid.meshgrid[0], grid.meshgrid[1], diff, cmap="coolwarm")
    ax.set_title("Model - Sample Histogram")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    return fig, float(grid.bin_area * np.abs(diff).sum())


def plot_data(data, grid, title="Data"):
    """3D histogram surface of samples (visualization.py:112-128)."""
    plt = _plt()
    data = np.asarray(data).reshape(-1, 2)
    rng = np.asarray(grid.range) - np.asarray(grid.widths)[:, None] / 2
    hist, _, _ = np.histogram2d(
        data[:, 0], data[:, 1], bins=grid.n_gridpoints, range=rng, density=True
    )
    fig = plt.figure()
    ax = plt.axes(projection="3d")
    # H is indexed [x, y]; the 'xy' meshgrid wants [y, x] (see
    # plot_data_diff -- the reference plots untransposed)
    ax.plot_surface(grid.meshgrid[0], grid.meshgrid[1], hist.T,
                    cmap="coolwarm")
    ax.set_title(title)
    return fig


def plot_vectorfield(grid, velocity_fn, t=0.0, stride=10):
    """Quiver plot of an advection field (visualization.py:131-138).
    ``velocity_fn(points, t)`` takes the (M, 2) points as one tensor, as
    the port's ops.evolution velocity fields do."""
    plt = _plt()
    pts = grid.coords[::stride]
    vel = _numpy(velocity_fn(torch.as_tensor(pts), t))
    fig = plt.figure()
    plt.quiver(pts[:, 0], pts[:, 1], vel[:, 0], vel[:, 1])
    return fig


def gauss_diffusion_entropy(times, dim, D=1.0, sigma0_sq=1.0):
    """Analytic entropy of an isotropically diffusing Gaussian
    S(t) = d/2 log(2 pi e (sigma0^2 + 2 D t)) (visualization.py:188)."""
    times = np.asarray(times)
    return dim / 2.0 * np.log(2 * np.pi * np.e * (sigma0_sq + 2 * D * times))


def make_final_plots(wdir: str, infos, dim=None, analytic_entropy=True):
    """Time-series diagnostic battery (visualization.py:141-280): entropy vs
    analytic, means, covariance diagonal, residual, tdvp error, dt, latent
    params, eigenvalue spectrum, SNR, moments, integrals. Saves PDFs to wdir."""
    plt = _plt()
    if hasattr(infos, "as_arrays"):
        infos = infos.as_arrays()
    infos = {k: np.asarray(v) for k, v in infos.items()}
    times = infos["times"]
    figs = []

    def save(fig, name):
        save_figure(fig, f"{wdir}/{name}.pdf")
        figs.append(name)

    if "entropy" in infos:
        fig = plt.figure()
        plt.plot(times, infos["entropy"], label="model")
        if analytic_entropy and dim is not None:
            plt.plot(times, gauss_diffusion_entropy(times, dim), "--",
                     label="analytic (Gauss diffusion)")
        plt.xlabel("t"); plt.ylabel("entropy"); plt.legend(); plt.grid()
        save(fig, "entropy")

    if "x1" in infos:
        fig = plt.figure()
        plt.plot(times, infos["x1"].reshape(len(times), -1))
        plt.xlabel("t"); plt.ylabel("mean"); plt.grid()
        save(fig, "means")

    if "covar" in infos:
        cv = infos["covar"].reshape(len(times), -1)
        d = int(math.isqrt(cv.shape[1]))
        diag = cv.reshape(len(times), d, d).diagonal(axis1=1, axis2=2)
        fig = plt.figure()
        plt.plot(times, diag)
        plt.xlabel("t"); plt.ylabel("covariance diagonal"); plt.grid()
        save(fig, "covariance")

    for key, log in (("solver_res", True), ("tdvp_error", True),
                     ("max_grad", False), ("dist_params", False)):
        if key in infos and infos[key].size:
            fig = plt.figure()
            data = infos[key].reshape(len(times), -1)
            plt.plot(times, np.abs(data) if log else data)
            if log:
                plt.yscale("log")
            plt.xlabel("t"); plt.ylabel(key); plt.grid()
            save(fig, key)

    if len(times) > 1:
        fig = plt.figure()
        plt.plot(times[1:], np.diff(times))
        plt.yscale("log"); plt.xlabel("t"); plt.ylabel("dt"); plt.grid()
        save(fig, "dt")

    if "ev" in infos:
        fig = plt.figure()
        plt.plot(times, np.abs(infos["ev"]))
        plt.yscale("log"); plt.xlabel("t"); plt.ylabel("|eigenvalues|")
        save(fig, "spectrum")

    if "snr" in infos:
        fig = plt.figure()
        plt.plot(times, infos["snr"])
        plt.yscale("log"); plt.xlabel("t"); plt.ylabel("SNR")
        save(fig, "snr")

    for m in (3, 4, 5, 6):
        k = f"x{m}"
        if k in infos:
            fig = plt.figure()
            plt.plot(times, infos[k].reshape(len(times), -1))
            plt.xlabel("t"); plt.ylabel(f"central moment {m}"); plt.grid()
            save(fig, k)

    for k in ("integral_1.0sigma", "integral_0.5sigma", "integral_0.1sigma",
              "integral_1sigma"):
        if k in infos:
            fig = plt.figure()
            plt.plot(times, infos[k])
            plt.xlabel("t"); plt.ylabel(k); plt.grid()
            save(fig, k.replace(".", "_"))

    return figs
