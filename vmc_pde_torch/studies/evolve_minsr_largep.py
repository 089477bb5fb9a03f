"""Time-evolution accuracy at large parameter count on the minSR path,
the counterpart of scripts/evolve_minsr_largep.py.

Workload: d-dimensional Gaussian diffusion with a deep scale flow (d=8,
depth 16, hidden (64,): P = 18,604, far beyond the dense-Gram regime at
N = 4096) integrated with the fixed-Heun ramp to t_end under
solver_method='minsr'. Accuracy metric: the analytic entropy
S(t) = d/2 log(2 pi e (1 + 2 D t)) of the exact solution, plus the
covariance diagonal 1 + 2t. In f32 on a card that P lies in ``auto``'s
window of the per-sample kernel (2048 <= P <= 32768), so the kernel runs
in plain mode; the first line says which route the RHS takes.

Optionally replays the first steps with the streaming (chunk_size) minSR
assembly against a fresh direct problem on the same keys, to confirm
chunked == direct along an actual trajectory.

    python -m vmc_pde_torch.studies.evolve_minsr_largep [--chunk 1024]
    python -m vmc_pde_torch.studies.evolve_minsr_largep --quick \
        --device cpu                                   # smoke shapes
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np

SEED = 7


def build(args, chunk=0):
    """(state, tdvp, stepper) of the study's problem on ``args.device``."""
    from ..models.flow import build_flow
    from ..models.state import VarState
    from ..ops import evolution
    from ..parallel.mesh import ParallelCtx
    from ..sampling.sampler import Sampler
    from ..solver.steppers import FixedStepper
    from ..solver.tdvp import TDVP, TDVPConfig
    from ..utils.dtypes import resolve

    prec = resolve(args.precision)
    ctx = ParallelCtx.single_device(args.device)
    fl, theta = build_flow(
        1, dim=args.dim, depth=args.depth, hidden=(args.hidden,),
        variant="scale", latent_name="Gauss", dtype=prec.compute,
        device=ctx.device)
    s = Sampler(dim=args.dim, ctx=ctx, name="Gauss", dtype=prec.compute)
    st = VarState(fl, theta, sampler=s, ctx=ctx, precision=prec)
    cfg = TDVPConfig(solver_method="minsr", chunk_size=chunk,
                     compute_snr=False)
    tdvp = TDVP(st, evolution.Diffusion(D=1.0), cfg, n_samples=args.n,
                precision=prec)
    stepper = FixedStepper(timeStep=args.dt0, maxStep=args.max_step,
                           pair_fn=tdvp.heun_pair)
    return st, tdvp, stepper


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--t-end", type=float, default=1.0)
    ap.add_argument("--dt0", type=float, default=1e-6)
    ap.add_argument("--max-step", type=float, default=1e-2)
    ap.add_argument("--precision", type=str, default="tpu",
                    choices=["tpu", "tpu_f64stats", "f32", "f64"])
    ap.add_argument("--chunk", type=int, default=0,
                    help="also verify the streaming assembly for this many "
                         "leading steps at this chunk size (0 = skip)")
    ap.add_argument("--chunk-steps", type=int, default=3)
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help=">1: batch the main evolution into K-step "
                         "dispatches (TDVP.heun_multi)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; raises without one)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    if args.quick:
        args.depth, args.hidden, args.n = 4, 16, 1024
        args.t_end = 0.02
        args.precision = "f64"
    return args


def evolve(args, st, tdvp, stepper):
    """The fixed-Heun evolution to t_end; returns the recorded (times,
    entropy, mean covariance diagonal, residual) and the step count."""
    from ..solver.tdvp import fold_in

    theta = st.get_parameters()
    t, n_step = 0.0, 0
    ts, ents, covd, res = [], [], [], []
    K = max(args.steps_per_dispatch, 1)
    while t < args.t_end:
        if K > 1:
            # the deterministic dt ramp simulated K steps ahead, one batch
            ts_l, dts_l = [], []
            t_sim, dt_sim = t, stepper.dt
            for _ in range(K):
                if not (t_sim < args.t_end):
                    break
                dt_sim = min(dt_sim * stepper.increase_fac, stepper.maxStep)
                ts_l.append(t_sim)
                dts_l.append(dt_sim)
                t_sim += dt_sim
            if len(ts_l) == K:
                keys = [fold_in(SEED, n_step + i) for i in range(K)]
                theta, auxs = tdvp.heun_multi(theta, ts_l, dts_l, keys)
                ts.extend(ts_l)
                ents.extend(auxs["entropy"].tolist())
                covd.extend(auxs["covar"].diagonal(dim1=1, dim2=2)
                            .mean(dim=1).tolist())
                res.extend(auxs["solver_res"].tolist())
                t = t_sim
                stepper.dt = dts_l[-1]
                n_step += K
                continue
        r = stepper.step(t, None, theta, fold_in(SEED, n_step))
        theta, dt, info = r.y, r.dt_used, r.info
        ts.append(t)
        ents.append(float(info["entropy"]))
        covd.append(float(info["covar"].diagonal().mean()))
        res.append(float(info["solver_res"]))
        t += dt
        n_step += 1
    return (np.asarray(ts), np.asarray(ents), np.asarray(covd),
            np.asarray(res)), n_step


def summarize(args, P, N, n_step, ts, ents, covd, res, wall) -> dict:
    d = args.dim
    S_exact = d / 2 * np.log(2 * math.pi * math.e * (1 + 2 * ts))
    err = np.abs(ents - S_exact)
    cov_err = np.abs(covd - (1 + 2 * ts))
    return dict(
        P=P, N=N, steps=n_step,
        t_end=float(ts[-1]), wall_s=round(wall, 2),
        entropy_err_final=float(err[-1]), entropy_err_max=float(err.max()),
        entropy_err_mean=float(err.mean()),
        cov_diag_err_max=float(cov_err.max()),
        residual_median=float(np.median(res)),
    )


def chunked_vs_direct(args):
    """(max |theta_chunked - theta_direct|, max |theta_direct - theta_0|)
    after each of the first ``chunk_steps`` steps on the same keys, from
    fresh problems: identical samples, so a near-identical trajectory
    (the regularized kernel inverse amplifies the streaming sums'
    rounding only)."""
    from ..solver.tdvp import fold_in

    st2, _, stepper2 = build(args, chunk=args.chunk)
    st3, _, stepper3 = build(args, chunk=0)
    theta2, theta3 = st2.get_parameters(), st3.get_parameters()
    t2 = 0.0
    theta0 = theta3
    diffs, moves = [], []
    for i in range(args.chunk_steps):
        key = fold_in(SEED, i)
        r2 = stepper2.step(t2, None, theta2, key)
        r3 = stepper3.step(t2, None, theta3, key)
        theta2, theta3 = r2.y, r3.y
        t2 += r2.dt_used
        diffs.append(float((theta2 - theta3).abs().max()))
        moves.append(float((theta3 - theta0).abs().max()))
    return diffs, moves


def order_control(args):
    """The yardstick of chunked_vs_direct in the compute precision: (max
    |theta_b - theta_a|, max |theta_a - theta_0|) after each of the first
    ``chunk_steps`` steps of two direct problems fed the same latent
    draws, b each stage's samples in another order (one fixed
    permutation). Only the order of the sums differs, so the gap is what
    rounding alone moves theta by on this flow."""
    import torch

    from ..solver.tdvp import fold_in

    (st_a, tdvp_a, step_a), (_, tdvp_b, step_b) = build(args), build(args)
    n, dtype = tdvp_a.n_samples, tdvp_a.precision.compute
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(SEED))
    perm = perm.to(args.device)
    z = {}
    # the study's latent is N(0, I) with no offset: z_ext is a plain draw
    step_a.pair_fn = lambda y, t, dt, key: tdvp_a.heun_pair(
        y, t, dt, key, z_ext=z["z"])
    step_b.pair_fn = lambda y, t, dt, key: tdvp_b.heun_pair(
        y, t, dt, key, z_ext=z["z"][:, perm])
    theta_a = theta_b = theta0 = st_a.get_parameters()
    t = 0.0
    diffs, moves = [], []
    for i in range(args.chunk_steps):
        key = fold_in(SEED, i)
        gen = torch.Generator(device=args.device)
        gen.manual_seed(key)
        z["z"] = torch.randn((2, n, args.dim), generator=gen, dtype=dtype,
                             device=args.device)
        ra = step_a.step(t, None, theta_a, key)
        rb = step_b.step(t, None, theta_b, key)
        theta_a, theta_b = ra.y, rb.y
        t += ra.dt_used
        diffs.append(float((theta_b - theta_a).abs().max()))
        moves.append(float((theta_a - theta0).abs().max()))
    return diffs, moves


def main(argv=None):
    """Run the study; returns its summary, with the per-sample route and
    the chunked replay's differences when asked."""
    from ..driver import resolve_device

    args = parse_args(argv)
    args.device = resolve_device(args.device)
    st, tdvp, stepper = build(args)
    route = "cuda" if tdvp.uses_kernel else "torch"
    print(f"P = {tdvp.n_params}, N = {tdvp.n_samples}, "
          f"solver = {tdvp.solver_method}, backend = {args.device.type}, "
          f"per_sample = {route}")

    t_wall = time.perf_counter()
    (ts, ents, covd, res), n_step = evolve(args, st, tdvp, stepper)
    wall = time.perf_counter() - t_wall
    summary = summarize(args, tdvp.n_params, tdvp.n_samples, n_step, ts,
                        ents, covd, res, wall)
    print(json.dumps(summary))
    out = dict(summary, per_sample=route)

    if args.chunk:
        diffs, moves = chunked_vs_direct(args)
        print(json.dumps(dict(chunk=args.chunk,
                              chunked_vs_direct_max_dtheta=diffs)))
        out.update(chunk=args.chunk, chunked_vs_direct_max_dtheta=diffs,
                   direct_max_dtheta=moves)

    if args.out:
        np.savez(args.out, times=ts, entropy=ents, covdiag=covd,
                 residual=res, **summary)
    return out


if __name__ == "__main__":
    main()
