"""Grid-based radial diffusion oracle: deterministic PDE reference for
ISOTROPIC initial conditions (the Student-t workloads); the counterpart of
vmc_pde_tpu/oracle/radial.py.

The reference validates its dim-8 Student-t INN run against a grid-based
solution (paper_plot_diffusion.py:13-29, 'StudentT_gridbased' -- the data
file is not shipped and neither is the solver). For an isotropic density
p(x, t) = f(r, t) in d dimensions, the diffusion equation reduces to the
1-D radial problem

    df/dt = D r^(1-d) d/dr ( r^(d-1) df/dr ),

which this module integrates with a conservative finite-volume scheme on
shells: flux F_{i+1/2} = -D A_{i+1/2} (f_{i+1} - f_i)/dr with shell surface
A = S_{d-1} r^(d-1), so total mass sum_i f_i V_i is conserved to rounding
and r = 0 needs no special casing (the innermost face has A(0) = 0). Time
stepping is explicit RK2 in float64, in recording chunks: on a CUDA device
a block of at most 256 steps, and the chunk's last steps with its
diagnostics (which stay on the device), are captured once as CUDA graphs
and replayed, since the explicit step is a few tiny elementwise kernels on
~10^3 cells and a run takes ~10^6 steps; on the CPU the chunk runs
eagerly.

This gives an INDEPENDENT, sampling-free entropy/moment reference for the
dim-8 Student-t run: unlike the SDE particle oracle (oracle/sde.py) there
is no MC noise, so the comparison resolves the INN's dynamics error
directly (BENCHMARKS.md).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def sphere_area(d: int) -> float:
    """Surface of the unit (d-1)-sphere: S_{d-1} = 2 pi^{d/2} / Gamma(d/2)."""
    return 2.0 * math.pi ** (d / 2.0) / math.gamma(d / 2.0)


def student_t_radial(r, nu: float, d: int):
    """Isotropic multivariate Student-t density value at radius r
    (net.py:23-36 normalization, Q8-corrected)."""
    c = (math.gamma((nu + d) / 2.0)
         / (math.gamma(nu / 2.0) * (nu * math.pi) ** (d / 2.0)))
    return c * (1.0 + r**2 / nu) ** (-(nu + d) / 2.0)


def gauss_radial(r, d: int, sigma2: float = 1.0):
    return np.exp(-(r**2) / (2 * sigma2)) / (2 * math.pi * sigma2) ** (d / 2)


def student_t_entropy(nu: float, d: int) -> float:
    """Closed-form differential entropy of the d-dim Student-t (Sigma = I):
    -log c + (nu+d)/2 [psi((nu+d)/2) - psi(nu/2)] with c the normalization."""
    from scipy.special import digamma

    log_c = (math.lgamma((nu + d) / 2.0) - math.lgamma(nu / 2.0)
             - (d / 2.0) * math.log(nu * math.pi))
    return float(-log_c + (nu + d) / 2.0
                 * (digamma((nu + d) / 2.0) - digamma(nu / 2.0)))


def radial_faces(r_max: float, dr0: float, r_core: float = 10.0,
                 growth: float = 1.02):
    """Graded face radii: uniform spacing dr0 through the core (where the
    density varies on O(1) scales), then geometric growth out to r_max --
    heavy-tailed densities (Student-t: -f log f ~ r^{-3} log r in d=8)
    need domains of hundreds of units, which a uniform grid can't afford."""
    faces = list(np.arange(0.0, r_core + dr0, dr0))
    dr = dr0
    while faces[-1] < r_max:
        dr *= growth
        faces.append(faces[-1] + dr)
    return np.asarray(faces)


# steps per captured CUDA graph: a recording chunk replays this graph
# every // _GRAPH_STEPS times, then one graph of the remaining steps and the
# diagnostics, so the capture's size and cost do not grow with the chunk
_GRAPH_STEPS = 256


def _step_fns(vol, area, drc, rc2, d: int, D: float, dt: float):
    """(steps, diagnostics): ``steps(f, n)`` is f after n RK2 steps and
    ``diagnostics(f)`` its (entropy, mass, var) as a (3,) tensor; the JAX
    oracle's scan body and recording, operation for operation."""
    neg_d_area = -D * area[1:-1]  # inner faces

    def rhs(f):
        flux = neg_d_area * (f[1:] - f[:-1]) / drc
        # -(outflow of cell i - inflow from cell i-1), the walls flux-free
        padded = torch.nn.functional.pad(flux, (1, 1))
        return (padded[:-1] - padded[1:]) / vol

    def steps(f, n):
        for _ in range(n):
            k1 = rhs(f)
            k2 = rhs(f + dt * k1)
            f = f + 0.5 * dt * (k1 + k2)
        return f

    def diagnostics(f):
        fs = torch.clamp(f, min=1e-300)
        ent = -torch.sum(torch.where(f > 0, f * torch.log(fs), 0.0) * vol)
        mass = torch.sum(f * vol)
        var = torch.sum(f * vol * rc2) / d
        return torch.stack([ent, mass, var])

    return steps, diagnostics


def _capture(fn, device):
    """``fn`` (in place on static tensors) captured once as a CUDA graph,
    after a warm-up on a side stream; returns the graph's replay."""
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def _graphed_chunk(steps, diagnostics, f, every: int):
    """One recording chunk of ``every`` steps as CUDA graphs on a static
    copy of f: a graph of min(every, _GRAPH_STEPS) steps replayed
    every // that many times, then a graph of the remaining steps and the
    diagnostics. Returns (run, f_static, diag): ``run()`` advances f_static
    in place by one chunk and leaves its diagnostics in ``diag``."""
    k = min(every, _GRAPH_STEPS)
    q, r = divmod(every, k)
    f_static = f.clone()
    diag = torch.empty(3, dtype=f.dtype, device=f.device)
    start = f.clone()
    body = _capture(lambda: f_static.copy_(steps(f_static, k)), f.device)

    def tail_fn():
        if r:
            f_static.copy_(steps(f_static, r))
        diag.copy_(diagnostics(f_static))

    tail = _capture(tail_fn, f.device)
    f_static.copy_(start)  # the warm-ups and captures advanced it

    def run():
        for _ in range(q):
            body()
        tail()

    return run, f_static, diag


def evolve_radial(
    f0,
    d: int,
    D: float = 1.0,
    r_max: float = 60.0,
    n_r: int = 6000,
    t_end: float = 5.0,
    cfl: float = 0.2,
    n_record: int = 200,
    faces=None,
    device="cuda",
    cuda_graph: Optional[bool] = None,
):
    """Integrate the radial diffusion of an isotropic density.

    ``f0``: callable r -> density value on numpy radii (e.g.
    partial(student_t_radial, nu=2, d=8)). ``faces``: optional graded face
    radii (radial_faces); default is a uniform grid of n_r cells to r_max.
    ``device``: where the cells live (float64); ``cuda_graph``: replay the
    recording chunk as captured graphs (default: on a CUDA device) or run it
    eagerly.
    Returns a dict of numpy arrays with times, entropy, mass, var (E[r^2]/d,
    the per-coordinate variance -- grows as sigma0^2 + 2 D t), f_final and
    r, t = 0 first.
    """
    dev = torch.device(device)
    rf = np.asarray(faces) if faces is not None \
        else np.linspace(0.0, r_max, n_r + 1)
    rc = 0.5 * (rf[1:] + rf[:-1])
    drc = np.diff(rc)                                # center-to-center
    dr_min = float(np.diff(rf).min())
    Sd = sphere_area(d)
    vol = Sd * (rf[1:] ** d - rf[:-1] ** d) / d      # exact shell volumes
    area = Sd * rf ** (d - 1)                        # S_{d-1} r^{d-1}
    area[-1] = 0.0                                   # zero-flux outer wall
    # (area[0] = 0 already: no flux through r = 0)

    # explicit stability: dt < dr^2 / (2 d D) (the d-dim Laplacian CFL)
    dt = cfl * dr_min * dr_min / (2.0 * d * D)
    n_steps = int(math.ceil(t_end / dt))
    every = max(n_steps // n_record, 1)
    # round the step count UP to whole recording chunks so the trajectory
    # reaches exactly t_end (a truncating n_steps // every would silently
    # stop short when n_record does not divide n_steps)
    n_steps = -(-n_steps // every) * every
    dt = t_end / max(n_steps, 1)
    n_chunks = n_steps // every

    # the grid's constants, copied to the device once
    f0v = np.asarray(f0(rc), dtype=np.float64)
    on_dev = (lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                        device=dev))
    f = on_dev(f0v)
    steps, diagnostics = _step_fns(on_dev(vol), on_dev(area), on_dev(drc),
                                   on_dev(rc**2), d, D, dt)
    diags = torch.empty((n_chunks, 3), dtype=torch.float64, device=dev)
    if cuda_graph if cuda_graph is not None else dev.type == "cuda":
        run, f, diag = _graphed_chunk(steps, diagnostics, f, every)
        for i in range(n_chunks):
            run()
            diags[i].copy_(diag)
    else:
        for i in range(n_chunks):
            f = steps(f, every)
            diags[i] = diagnostics(f)
    ents, masses, variances = diags.cpu().numpy().T
    times = (np.arange(n_chunks) + 1) * every * dt
    # prepend t = 0 diagnostics
    ent0 = -np.sum(np.where(f0v > 0, f0v * np.log(np.maximum(f0v, 1e-300)),
                            0.0) * vol)
    return {
        "times": np.concatenate([[0.0], times]),
        "entropy": np.concatenate([[ent0], ents]),
        "mass": np.concatenate([[float(np.sum(f0v * vol))], masses]),
        "var": np.concatenate([[float(np.sum(f0v * vol * rc**2) / d)],
                               variances]),
        "f_final": f.cpu().numpy(),
        "r": rc,
    }
