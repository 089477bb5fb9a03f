"""Experiment driver, the counterpart of vmc_pde_tpu/driver.py: wires
sampler -> state -> TDVP -> stepper and runs the time evolution, recording
the reference-compatible infos schema.

    python -m vmc_pde_torch.driver fokkerPlanck32 --max-steps 5
    python -m vmc_pde_torch.driver fokkerPlanck32 --samples 524288 \
        --chunk-size 65536 --gram-backend tri2 --gram-cross int8
    python -m vmc_pde_torch.driver fokkerPlanck32 --gram-backend syrk
    python -m vmc_pde_torch.driver fluidpaper --max-steps 20
    python -m vmc_pde_torch.driver diffusion --is-gamma 0.5
    python -m vmc_pde_torch.driver mwe --precision f64 --device cpu
    python -m vmc_pde_torch.driver mwe --precision f64 --device cpu \
        --stepper adaptive_heun --t-end 0.1 --exact-t-end
    python -m vmc_pde_torch.driver fokkerPlanck32 --stepper fixed_rk3 \
        --steps-per-dispatch 4 --max-steps 8
    python -m vmc_pde_torch.driver fokkerPlanck32 --solver cg
    python -m vmc_pde_torch.driver fokkerPlanck32 --solver minsr \
        --samples 2048 --chunk-size 512
    python -m vmc_pde_torch.driver fokkerPlanck32 --precision tpu_f64stats \
        --gram-precision f64
    python -m vmc_pde_torch.driver mwe --precision f64 --host-solve
    python -m vmc_pde_torch.driver fokkerPlanck32 --qmc
    python -m vmc_pde_torch.driver fokkerPlanck32 --hessian-mode block
    python -m vmc_pde_torch.driver fokkerPlanck32 --seed 3 \
        --workdir run --checkpoint-every 10 --async-recorder
    python -m vmc_pde_torch.driver fokkerPlanck32 --workdir run --resume
    python -m vmc_pde_torch.driver fokkerPlanck32 --profile-dir prof
    python -m vmc_pde_torch.driver mwe --init-params pre/pretrain_ckpt.npz

One process per rank on a mesh (parallel/mesh.py), each started with
its --process-id, e.g. two ranks on the CPU:

    python -m vmc_pde_torch.driver mwe --precision f64 --device cpu \
        --distributed --coordinator localhost:29500 --num-processes 2 \
        --process-id 0 --mesh-dp 2

Only the coordinator (rank 0) prints and writes: infos.hdf5, the
checkpoints, metrics.bin, and on a 2-D preset the density snapshot
``t_<t>.pdf`` at every ``plot_every`` of simulated time (viz/plots.py;
matplotlib); every rank reads the checkpoint it resumes from.

Run state (utils/checkpoint.py, utils/recorder.py, utils/timings.py):
``--checkpoint-every K`` writes theta, t, the step counter and the
stepper's dt after every K-th step into the workdir; ``--resume`` starts
from the workdir's latest checkpoint and, since the step keys are
``fold_in(sample_seed + 7, n_step)``, draws the samples the uninterrupted
run would have drawn (the Metropolis chains' state is not saved: exact
for the exact-latent presets). ``--resume`` wins over ``--init-params``
when a checkpoint exists. ``--profile-dir`` traces the steps in
``[profile_steps[0], profile_steps[1])`` with torch.profiler into
``trace_rank<r>.json``.

The latent family and the learned global affine have no flags, as in the
JAX package: ``run(preset("fokkerPlanck32", latent_name="Student_t",
global_affine=True))``.

``--device`` defaults to cuda and raises when no CUDA device is present;
pass ``--device cpu`` to run on the CPU.

``--steps-per-dispatch K`` (K > 1) checks the NaN flags once every K
steps instead of every ``nan_check_every``; the steps are issued as with
K=1 (no host wait between them unless verbose output reads each step's
residual) and the trajectory and the recorded rows are those of K=1.
Eager torch has no device-side loop: an adaptive step waits for each
attempt's error on the host (one synchronization per attempt), where the
JAX package keeps its retry loop on the device.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .config import RunConfig
from .models.flow import build_flow
from .models.latent import EXACT_NAMES
from .models.state import VarState
from .ops.evolution import Equation, make_equation
from .parallel import mesh
from .sampling.sampler import Sampler
from .solver.steppers import AdaptiveHeun, AdaptiveRK23, FixedStepper
from .solver.tdvp import TDVP, TDVPConfig, fold_in
from .utils import dtypes
from .utils.checkpoint import latest_checkpoint, save_checkpoint
from .utils.grid import Grid
from .utils.infos import InfoRecorder, store_infos
from .utils.timings import Timings, profiler_trace


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but no CUDA device is "
                           "available (pass --device cpu to run on the CPU)")
    return device


def build_problem(cfg: RunConfig, ctx=None):
    """Construct (state, tdvp, stepper, equation, grid) from a RunConfig,
    on ``ctx`` (default: the mesh of the process group when one is
    initialized, ``cfg.mesh_dp`` x ``cfg.mesh_tp`` ranks; one device
    otherwise)."""
    if ctx is None:
        ctx = mesh.ParallelCtx.create(dp=cfg.mesh_dp, tp=cfg.mesh_tp,
                                      device=resolve_device(cfg.device))
    device = ctx.device
    precision = dtypes.resolve(cfg.precision)
    sampler = Sampler(dim=cfg.dim, name=cfg.latent_name,
                      dtype=precision.compute, n_chains=cfg.n_chains,
                      mcmc_info={"offset": np.asarray(cfg.offset),
                                 "bound": cfg.mcmc_bound},
                      proposal_mode=cfg.proposal_mode, rw_scale=cfg.rw_scale,
                      ctx=ctx)
    flow, theta = build_flow(
        cfg.seed, cfg.dim, depth=cfg.depth, hidden=cfg.hidden_resolved(),
        variant=cfg.variant, global_affine=cfg.global_affine,
        latent_name=cfg.latent_name, offset=cfg.offset, alpha=cfg.alpha,
        out_scale=cfg.init_scale, dtype=precision.compute, device=device,
        qmc=cfg.qmc and cfg.latent_name in EXACT_NAMES)
    state = VarState(flow, theta, sampler=sampler, precision=precision,
                     ctx=ctx)
    # a registry name, or a user's Equation instance: custom physics plugs
    # into the whole driver (examples/custom_equation.py)
    if isinstance(cfg.equation, Equation):
        if cfg.equation_params:
            raise ValueError(
                "RunConfig.equation is an Equation INSTANCE, so "
                f"equation_params {sorted(cfg.equation_params)} would be "
                "silently ignored -- construct the instance with those "
                "parameters instead (equation_params applies to registry "
                "names only)")
        equation = cfg.equation
    else:
        equation = make_equation(cfg.equation, cfg.dim,
                                 **cfg.equation_params)
    tdvp_cfg = TDVPConfig(
        use_snr=cfg.use_snr, snr_tol=cfg.snr_tol, svd_tol=cfg.svd_tol,
        eloc_clip=cfg.eloc_clip, is_gamma=cfg.is_gamma,
        diagonal_shift=cfg.diagonal_shift, solver_method=cfg.solver_method,
        eigh_max_params=cfg.eigh_max_params,
        cg_maxiter=cfg.cg_maxiter, cg_tol=cfg.cg_tol,
        solve_on_device=cfg.solve_on_device,
        gram_precision=cfg.gram_precision,
        gram_backend=cfg.gram_backend, gram_cross=cfg.gram_cross,
        chunk_size=cfg.chunk_size, integrals=cfg.integrals,
        stats_partitioning=cfg.stats_partitioning,
        per_sample_backend=cfg.per_sample_backend,
        hessian_mode=cfg.hessian_mode, auto_tol_floor=cfg.auto_tol_floor,
        # adaptive steppers need an S metric: the dense SExp on the eigh
        # solve, the matrix-free quadratic on cholesky, cg and minsr
        # (TDVPConfig)
        sexp_mode="auto" if cfg.stepper.startswith("adaptive") else "none")
    tdvp = TDVP(state, equation, tdvp_cfg, n_samples=cfg.n_samples_tdvp,
                n_samples_obs=cfg.n_samples_obs, precision=precision)
    ramp = dict(timeStep=cfg.dt0, maxStep=cfg.max_step,
                increase_fac=cfg.increase_fac)
    adaptive = dict(timeStep=cfg.dt0, tol=cfg.tol, maxStep=cfg.max_step)
    # the fused steps solve on the device; the host solve steps through
    # tdvp.rhs, one stage at a time
    fused = tdvp.fused_steps_available
    if cfg.stepper == "adaptive_heun":
        stepper = AdaptiveHeun(attempt_fn=tdvp.heun_attempt if fused
                               else None, **adaptive)
    elif cfg.stepper == "adaptive_rk23":
        stepper = AdaptiveRK23(attempt_fn=tdvp.rk23_attempt if fused
                               else None, **adaptive)
    elif cfg.stepper == "fixed_euler":
        stepper = FixedStepper(mode="Euler", **ramp)
    elif cfg.stepper == "fixed_rk3":
        stepper = FixedStepper(mode="RK3", pair_fn=tdvp.rk3_triple if fused
                               else None, **ramp)
    elif cfg.stepper == "fixed_heun":
        stepper = FixedStepper(mode="Heun", pair_fn=tdvp.heun_pair if fused
                               else None, **ramp)
    else:
        raise ValueError(f"unknown stepper {cfg.stepper!r}")
    grid = None
    if cfg.dim == 2:
        grid = Grid(np.ones(2) * cfg.grid_bound, cfg.grid_points,
                    sym=cfg.sym_grid)
    return state, tdvp, stepper, equation, grid


def load_init_params(path: str, state) -> torch.Tensor:
    """The flat master-dtype theta stored in ``path``: an npz holding
    ``theta`` (an evolution checkpoint, utils/checkpoint.py, of either
    package, or the port's pretrain checkpoint, pretrain/train.py), on the
    state's device. The flow must be the one that wrote it: a theta from
    the JAX package means the same density only in a flow built from the
    JAX partitions (models/convert.py), not in the port's build_flow."""
    if os.path.isdir(path):
        raise ValueError(
            f"init_params {path!r} is a directory: the JAX package's orbax "
            "pytree checkpoint (its pretrain/train.py), which needs orbax "
            "and JAX to read; the port reads npz files holding 'theta' "
            "(its own pretrain/train.py writes <workdir>/pretrain_ckpt.npz)")
    with np.load(path) as z:
        if "theta" not in z:
            raise ValueError(
                f"init_params npz {path!r} has no 'theta' array (found "
                f"{sorted(z.files)}); expected an evolution checkpoint "
                "(utils/checkpoint.py) or a pretrain checkpoint "
                "(pretrain/train.py)")
        theta = np.asarray(z["theta"])
    if theta.shape != (state.numParameters,):
        raise ValueError(
            f"init_params {path!r} holds {theta.shape} parameters; this "
            f"flow has ({state.numParameters},) -- the architectures must "
            "match")
    return torch.as_tensor(theta, dtype=state.precision.master,
                           device=state.device)


def _initial_state(cfg: RunConfig, state, stepper):
    """(theta, t, n_step) to start from: the workdir's latest checkpoint
    under ``resume`` (every rank reads it, after a barrier, so that a
    coordinator still writing its last one is waited for), else
    ``init_params``, else the flow's init; the stepper's dt is restored
    with a checkpoint."""
    if cfg.resume and cfg.workdir:
        mesh.sync_global_devices()
        ck = latest_checkpoint(cfg.workdir)
        if ck is not None:
            theta = torch.as_tensor(ck["theta"], dtype=state.precision.master,
                                    device=state.device)
            stepper.dt = ck["dt"]
            if cfg.verbose and mesh.is_coordinator():
                print(f"resumed from step {ck['step']}, t={ck['t']:.4f}")
            return theta, ck["t"], ck["step"]
    if cfg.init_params:
        theta = load_init_params(cfg.init_params, state)
        if cfg.verbose and mesh.is_coordinator():
            print(f"initialized parameters from {cfg.init_params}")
        return theta, 0.0, 0
    return state.get_parameters(), 0.0, 0


def _open_recorder(cfg: RunConfig):
    """The async recorder of <workdir>/metrics.bin on the coordinator
    (None elsewhere, and without ``async_recorder``)."""
    if not cfg.async_recorder:
        return None
    if not cfg.workdir:
        raise ValueError("async_recorder needs a workdir")
    if not mesh.is_coordinator():
        return None
    from .utils.recorder import AsyncRecorder

    os.makedirs(cfg.workdir, exist_ok=True)
    return AsyncRecorder(os.path.join(cfg.workdir, "metrics.bin"))


def run(cfg: RunConfig, max_steps: int = 10**9, callbacks=()):
    """Run the time evolution; returns (state, InfoRecorder). Each
    callback is called as cb(n_step, t, state, info) after every step.
    On a mesh every rank runs this loop; only the coordinator prints and
    writes."""
    if cfg.steps_per_dispatch < 1:
        raise ValueError("steps_per_dispatch must be >= 1")
    state, tdvp, stepper, _, grid = build_problem(cfg)
    rec = InfoRecorder()
    timings = Timings()
    talk = cfg.verbose and mesh.is_coordinator()
    wdir = cfg.workdir if mesh.is_coordinator() else None
    if wdir:
        os.makedirs(wdir, exist_ok=True)

    # NaN aborts are checked every nan_check_every steps, or once per batch
    # of steps_per_dispatch steps (each check waits for the device), on
    # flags agreed across the ranks, so that all of them abort together and
    # none waits alone in a collective
    nan_every = (cfg.steps_per_dispatch if cfg.steps_per_dispatch > 1
                 else max(cfg.nan_check_every, 1))
    pending_nan = []

    def check_nan():
        if not pending_nan:
            return
        flags = mesh.all_reduce_max(state.ctx, torch.stack(
            [f for f, _ in pending_nan]).to(torch.int32))
        for flag, (_, t_at) in zip(flags.tolist(), pending_nan):
            if flag:
                raise FloatingPointError(
                    f"NaN encountered in TDVP update at t={t_at}")
        pending_nan.clear()

    def f(theta, t, key, intStep=0):
        timings.start_timing("tdvp_rhs")
        out = tdvp.rhs(theta, t, key, intStep=intStep)
        # verbose output waits for the device anyway: time the RHS's work
        timings.stop_timing("tdvp_rhs", waitFor=out[0] if cfg.verbose
                            else None)
        f.SExp = tdvp.SExp  # read by a per-stage adaptive stepper
        return out

    # exact_t_end: stop at t_end, clamping the last dt, instead of the
    # reference's `while t < t_end + dt` overshoot
    t_eps = 1e-12 * max(1.0, abs(cfg.t_end))

    def more_steps(t, dt):
        if cfg.exact_t_end:
            return t < cfg.t_end - t_eps
        return t < cfg.t_end + dt

    theta, t, n_step = _initial_state(cfg, state, stepper)
    state.set_parameters(theta)
    dt = stepper.dt
    key = cfg.sample_seed + 7
    plotted = set()
    if grid is not None and talk:
        print("Initial grid integral:", float(state.integrate(grid)))

    arec = _open_recorder(cfg)
    # the profiler window [profile_steps[0], profile_steps[1]) counts the
    # steps of this run (a resumed run's too); it closes at loop exit, or
    # when the loop raises
    window = contextlib.ExitStack()
    steps_done = 0
    try:
        while more_steps(t, dt) and steps_done < max_steps:
            if cfg.profile_dir:
                if steps_done == cfg.profile_steps[0]:
                    window.enter_context(profiler_trace(
                        cfg.profile_dir, cuda=state.device.type == "cuda",
                        name=f"trace_rank{state.ctx.rank}"))
                elif steps_done == cfg.profile_steps[1]:
                    window.close()
            timings.start_timing("step")
            res = stepper.step(t, f, theta, fold_in(key, n_step),
                               normFunction=tdvp.stepper_norm,
                               dt_cap=(cfg.t_end - t if cfg.exact_t_end
                                       else None))
            theta, dt, info = res.y, res.dt_used, res.info
            # verbose output reads the residual below: the step's time
            # is then its device work's
            timings.stop_timing("step", waitFor=theta if talk else None)
            pending_nan.append((info["nan"], t))
            state.set_parameters(theta)

            rec.append("times", t)
            rec.append("dt", dt)
            rec.append_dict(info)
            dist_params = state.params["latent"]["dist_params"]
            rec.append("dist_params", dist_params)
            if arec is not None:
                # one host read of the step's tensors (record_dict)
                arec.record_dict(n_step, {
                    "times": t, "dt": dt,
                    **{k: v for k, v in info.items()
                       if k not in rec.SKIP_KEYS},
                    "dist_params": dist_params})

            if cfg.verbose or n_step % nan_every == 0:
                check_nan()
            if talk:
                res_f = float(info["solver_res"])
                print(f"t = {t:.4f}, dt = {dt:e}  "
                      f"[{timings.last('step'):.3f}s]")
                if "attempts" in info:
                    print(f"\t > Attempts = {info['attempts']}, "
                          f"Error = {info['step_error']:.3e}")
                print(f"\t > Solver Residual = {res_f:.3e}")
                print(f"\t > TDVP Error = {float(info['tdvp_error']):.3e}")
                print(f"\t > Entropy = {float(info['entropy']):.6f}")

            n = round(t / cfg.plot_every)
            if (grid is not None and abs(t - n * cfg.plot_every) < dt
                    and n not in plotted):
                plotted.add(n)
                integral = float(state.integrate(grid))
                rec.append("grid_integral_t", t)
                rec.append("grid_integral", integral)
                if talk:
                    print("Grid integral:", integral)
                if wdir:
                    # the periodic 2-D density snapshot, on the coordinator
                    from .viz.plots import plot_density, save_figure

                    save_figure(plot_density(state, grid, proj=False),
                                os.path.join(wdir, f"t_{t:.3f}.pdf"))

            if (wdir and cfg.checkpoint_every
                    and n_step % cfg.checkpoint_every == 0):
                # theta is the solution at t + dt, the step just taken
                save_checkpoint(wdir, n_step + 1, t + dt, theta, stepper.dt)

            for cb in callbacks:
                cb(n_step, t, state, info)
            t += dt
            n_step += 1
            steps_done += 1
    finally:
        window.close()
        if arec is not None:
            arec.close()

    check_nan()
    rec.flush()
    if wdir:
        store_infos(wdir, rec)
    return state, rec


def main(argv=None, callbacks=()):
    import argparse

    from .config import PRESETS, preset

    p = argparse.ArgumentParser(description="VMC-PDE solver (PyTorch port)")
    p.add_argument("mode", choices=sorted(PRESETS), nargs="?", default="mwe")
    p.add_argument("--samples", type=int, default=None)
    p.add_argument("--t-end", type=float, default=None)
    p.add_argument("--max-steps", type=int, default=10**9)
    p.add_argument("--precision", type=str, default=None,
                   choices=["tpu", "tpu_f64stats", "f32", "f64"])
    p.add_argument("--workdir", type=str, default=None,
                   help="write infos.hdf5 here (needs h5py), the "
                        "density snapshots t_<t>.pdf of a 2-D preset "
                        "(needs matplotlib), and the checkpoints and "
                        "metrics.bin when asked")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the flow's init and of the samples "
                        "(sets seed and sample_seed)")
    p.add_argument("--init-params", type=str, default=None,
                   help="start from the theta stored in this npz (an "
                        "evolution checkpoint, or pretrain/train.py's "
                        "pretrain_ckpt.npz); the flow must match")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help=">0: checkpoint theta, t, step and dt into the "
                        "workdir after every that many steps")
    p.add_argument("--resume", action="store_true",
                   help="resume from the workdir's latest checkpoint "
                        "(wins over --init-params)")
    p.add_argument("--async-recorder", action="store_true",
                   help="also stream each step's infos through the native "
                        "recorder into <workdir>/metrics.bin")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of steps "
                        "[5, 8) here")
    p.add_argument("--per-sample-backend", type=str, default=None,
                   choices=["auto", "torch", "cuda", "xla", "pallas"],
                   help="per-sample pipeline: cuda = the hand-written "
                        "kernel (kernels/persample.py), torch = the "
                        "torch.func pipeline; the JAX package's xla and "
                        "pallas name them too")
    p.add_argument("--gram-backend", type=str, default=None,
                   choices=["auto", "xla", "syrk", "sym2", "tri2"],
                   help="Gram contraction: xla = the f32 product (what auto "
                        "resolves to), syrk = the triangle kernel's 3-pass "
                        "bf16 split (kernels/syrk.py), sym2 = 2-product "
                        "symmetric bf16 hi/lo split, tri2 = its "
                        "triangle-blocked form")
    p.add_argument("--gram-cross", type=str, default=None,
                   choices=["auto", "bf16", "int8"],
                   help="product of the sym2/tri2 cross term (int8 = "
                        "per-column-quantized int8 product)")
    p.add_argument("--chunk-size", type=int, default=None,
                   help=">0: stream samples through the stats in chunks")
    p.add_argument("--solver", type=str, default=None,
                   choices=["auto", "eigh", "cholesky", "cg", "minsr"],
                   help="linear-solver strategy (TDVPConfig.solver_method): "
                        "cg = matrix-free conjugate gradients, minsr = the "
                        "N x N kernel solve for P >> N (streamed with "
                        "--chunk-size)")
    p.add_argument("--gram-precision", type=str, default=None,
                   choices=["highest", "high", "default", "f64", "f64acc"],
                   help="statistics contractions: highest/high = full f32 "
                        "products, default = one bf16 pass on the card, "
                        "f64 = the f32 gradients contracted in float64 "
                        "(pair with --precision tpu_f64stats), f64acc = "
                        "f32 chunks accumulated in float64 (chunked)")
    p.add_argument("--host-solve", action="store_true",
                   help="solve the regularized system on the host in numpy "
                        "f64 (the reference's default path)")
    p.add_argument("--is-gamma", type=float, default=None,
                   help="<1: tail-tempered importance sampling of the TDVP "
                        "statistics (Student_t latent; TDVPConfig.is_gamma)")
    p.add_argument("--hessian-mode", type=str, default=None,
                   choices=["auto", "trace", "block"],
                   help="per-sample Hessian: the quadratic trace along the "
                        "equation's directions (the kernel's) or the (k, k) "
                        "block (torch.func)")
    p.add_argument("--qmc", action="store_true",
                   help="randomized-QMC (scrambled Sobol) exact-latent "
                        "draws: lower estimator noise at the same sample "
                        "budget (sampling/qmc.py)")
    p.add_argument("--stepper", type=str, default=None,
                   choices=["fixed_heun", "fixed_euler", "fixed_rk3",
                            "adaptive_heun", "adaptive_rk23"],
                   help="time integrator (solver/steppers.py); the "
                        "adaptive ones take their error in the S metric")
    p.add_argument("--exact-t-end", action="store_true",
                   help="clamp the final dt to land exactly on t_end (the "
                        "reference's loop overshoots by up to one dt)")
    p.add_argument("--steps-per-dispatch", type=int, default=None,
                   help=">1: check the NaN flags once every that many "
                        "steps (the trajectory is K=1's); an adaptive step "
                        "still waits for each attempt's error on the host")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; raises without one); "
                        "on a mesh each rank takes card rank %% count")
    p.add_argument("--stats-partitioning", type=str, default=None,
                   choices=["auto", "gspmd", "shard_map"],
                   help="statistics on a mesh ('auto' = shard_map where it "
                        "may run: per-rank statistics and kernels, one "
                        "all-reduce of the assembled moments per RHS)")
    p.add_argument("--mesh-dp", type=int, default=None,
                   help="sample-parallel mesh size (-1 = all ranks)")
    p.add_argument("--mesh-tp", type=int, default=None,
                   help="second mesh axis: more sample shards on the "
                        "shard_map statistics; on the GSPMD ones the "
                        "samples shard over dp only and each of a dp "
                        "index's tp ranks contracts ceil(P/tp) of the "
                        "Gram's rows")
    p.add_argument("--distributed", action="store_true",
                   help="one process per rank: initialize torch."
                        "distributed before building the mesh (NCCL with "
                        "a card per rank, gloo otherwise)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="coordinator address host:port, or a torch init "
                        "URL such as file:///path (with --distributed)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)

    if args.distributed:
        mesh.distributed_init(
            coordinator=args.coordinator,
            num_processes=args.num_processes or 1,
            process_id=args.process_id or 0, device=args.device)

    overrides = {"device": args.device}
    if args.samples is not None:
        overrides["n_samples_tdvp"] = args.samples
        overrides["n_samples_obs"] = args.samples
    if args.t_end is not None:
        overrides["t_end"] = args.t_end
    if args.precision is not None:
        overrides["precision"] = args.precision
    if args.workdir is not None:
        overrides["workdir"] = args.workdir
    if args.per_sample_backend is not None:
        overrides["per_sample_backend"] = args.per_sample_backend
    if args.exact_t_end:
        overrides["exact_t_end"] = True
    if args.host_solve:
        overrides["solve_on_device"] = False
    if args.solver is not None:
        overrides["solver_method"] = args.solver
    if args.qmc:
        overrides["qmc"] = True
    if args.seed is not None:
        overrides["seed"] = args.seed
        overrides["sample_seed"] = args.seed
    if args.resume:
        overrides["resume"] = True
    if args.async_recorder:
        overrides["async_recorder"] = True
    for name in ("init_params", "profile_dir"):
        if getattr(args, name) is not None:
            overrides[name] = getattr(args, name)
    if args.checkpoint_every:
        overrides["checkpoint_every"] = args.checkpoint_every
    for name in ("gram_backend", "gram_cross", "gram_precision",
                 "chunk_size", "is_gamma", "hessian_mode",
                 "stats_partitioning", "mesh_dp", "mesh_tp", "stepper",
                 "steps_per_dispatch"):
        if getattr(args, name) is not None:
            overrides[name] = getattr(args, name)
    return run(preset(args.mode, **overrides), max_steps=args.max_steps,
               callbacks=callbacks)


if __name__ == "__main__":
    main()
