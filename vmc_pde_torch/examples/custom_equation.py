"""Custom PDE in ~30 lines: plug a user-defined evolution equation into
the full driver (steppers, diagnostics, checkpointing) without touching
the framework; the port's counterpart of examples/custom_equation.py.

The reference hard-wires its physics into a name registry
(vmc_fluids/evolutionEq.py:54-77); here any `ops.evolution.Equation`
subclass can be passed directly as `RunConfig.equation`. The subclass
declares (a) which coordinate-Hessian information it needs -- this one
consumes it only through the Laplacian, so `hessian_trace_dirs` lets the
solver compute the scalar quadratic form instead of materializing the
(d, d) block -- and (b) the batched local estimator Eloc = d log p / dt at
the samples, written in torch.

Physics: a "moving optical trap" -- an Ornstein-Uhlenbeck density whose
trap center slides along coordinate 0 at speed ``a``:

    dp/dt = div( p * gamma * (x - mu(t) e0) ) + D lap p,   mu(t) = a t

so  Eloc = gamma*d + gamma*(x - mu(t) e0) . grad log p
         + D (|grad log p|^2 + lap log p).

Everything is analytically solvable from p0 = N(0, I):

    mean_0(t) = a t - (a / gamma) (1 - e^{-gamma t})   (lags the trap)
    var_i(t)  = D/gamma + (1 - D/gamma) e^{-2 gamma t}  (every coordinate)

Run (the card by default; f64 on the CPU, the tpu precision on the card):

    python -m vmc_pde_torch.examples.custom_equation
    python -m vmc_pde_torch.examples.custom_equation --device cpu
"""

import argparse
import dataclasses
import sys

import numpy as np


def make_moving_trap(gamma=1.0, D=0.5, a=2.0):
    import torch

    from vmc_pde_torch.ops.evolution import Equation

    @dataclasses.dataclass(frozen=True)
    class MovingTrap(Equation):
        name: str = "moving_trap"

        def hessian_trace_dirs(self, dim):
            return np.eye(dim)  # Laplacian only: d trace directions

        def eloc(self, x, g, hess, t):
            lap = hess  # 1-D because hessian_trace_dirs is set
            d = x.shape[-1]
            # x - mu(t) e0, the trap center on coordinate 0
            shifted = torch.cat([x[..., :1] - a * t, x[..., 1:]], dim=-1)
            drift = gamma * shifted
            return (gamma * d + torch.sum(drift * g, dim=-1)
                    + D * (torch.sum(g**2, dim=-1) + lap))

    return MovingTrap()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; raises without one)")
    p.add_argument("--precision", type=str, default=None,
                   help="tpu|f32|f64 (default: f64 on the CPU, tpu on "
                        "the card)")
    p.add_argument("--workdir", type=str, default="output/custom_equation",
                   help="infos.hdf5 and the density snapshots go here "
                        "(needs h5py and matplotlib); '' writes nothing")
    args = p.parse_args(argv)

    from vmc_pde_torch.config import preset
    from vmc_pde_torch.driver import run

    gamma, D, a = 1.0, 0.5, 2.0
    t_end = 0.4
    n = 4096
    cfg = preset(
        "mwe",  # reuse the tuned 2-D knobs; swap in the custom physics
        equation=make_moving_trap(gamma, D, a),
        variant="affine",
        qmc=True,  # scrambled-Sobol latent draws: lower-variance forces
        dt0=2e-3, max_step=2e-3, t_end=t_end, exact_t_end=True,
        n_samples_tdvp=n, n_samples_obs=n,
        precision=args.precision or (
            "f64" if args.device == "cpu" else "tpu"),
        device=args.device, workdir=args.workdir or None, verbose=False,
    )
    state, rec = run(cfg)
    infos = rec.as_arrays()

    # --- noise-free judge: model density on a grid vs the exact Gaussian
    # solution at the final recorded time (the density family is closed
    # under this PDE, so any gap is solver + representation error)
    t = np.asarray(infos["times"])
    tf = float(t[-1])
    m_exact = np.array([a * tf - (a / gamma) * (1 - np.exp(-gamma * tf)), 0.0])
    v_exact = D / gamma + (1.0 - D / gamma) * np.exp(-2.0 * gamma * tf)
    g1 = np.linspace(-4.0, 4.0, 161)
    X, Y = np.meshgrid(g1 + m_exact[0], g1, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], 1)
    p_model = np.exp(state.log_prob(coords).detach().cpu().numpy()
                     .astype(np.float64))
    r2 = (X - m_exact[0]) ** 2 + Y**2
    p_exact = np.exp(-r2 / (2 * v_exact)).ravel() / (2 * np.pi * v_exact)
    da = (g1[1] - g1[0]) ** 2
    l2 = np.sqrt(np.sum((p_model - p_exact) ** 2) * da)

    # --- MC moment trajectories vs closed forms, judged against their own
    # sampling noise (var estimator SE ~ sqrt(2/n), mean SE ~ sqrt(v/n))
    mean0 = np.asarray(infos["x1"])[:, 0]
    var = np.diagonal(np.asarray(infos["covar"]), axis1=1, axis2=2)
    mean0_exact = a * t - (a / gamma) * (1.0 - np.exp(-gamma * t))
    var_exact = D / gamma + (1.0 - D / gamma) * np.exp(-2.0 * gamma * t)
    err_mean = np.abs(mean0 - mean0_exact).max()
    err_var = np.abs(var - var_exact[:, None]).max()

    print(f"steps: {len(t)}, t_end reached: {tf:.3f}")
    print(f"density L2 vs exact solution at t_end: {l2:.2e}")
    print(f"trap-lag mean_0(t): max abs err {err_mean:.2e} "
          f"(signal {np.abs(mean0_exact).max():.3f}, "
          f"5 SE = {5 * np.sqrt(1.0 / n):.3f})")
    print(f"covariance diag:    max abs err {err_var:.2e} "
          f"(contracts 1.00 -> {var_exact[-1]:.3f}, "
          f"5 SE = {5 * np.sqrt(2.0 / n):.3f})")
    ok = (l2 < 1e-3
          and err_mean < 5 * np.sqrt(1.0 / n)
          and err_var < 5 * np.sqrt(2.0 / n))
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
