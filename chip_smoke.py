"""Smoke test of the PyTorch port on one CUDA card:

    python3 chip_smoke.py

1. the device, and its name and power limit as nvidia-smi reports them;
   then every CUDA kernel is built from vmc_pde_torch/kernels/csrc, one
   nvcc per source, all at once;
2. the per-sample kernel against its plain torch.func version at the
   fokkerPlanck32 shape (d=32, P=9264): N=1024, a ragged N=1000 and the
   main path's N=16384 on a perturbed theta (there within twice plain
   f32's own error), then the preset's initial theta at N=16384, where
   both are also timed with CUDA events, and the kernel on the chunked
   path's pilot shape (its first 2048 rows); each time's share of its
   bound is printed;
3. the same kernel in split mode (bf16 hi/lo of O - shift, column sums,
   column max) against the plain pipeline and split: N=1024 and a ragged
   N=1000 on the perturbed theta, the chunked path's N=65536 on the
   initial theta, where both are timed (and the share of the bound);
4. the fused quantize+force kernel against its plain passes at P=9264,
   n=65536 on the split pair of phase 3: q8 bit-identical, f against f64;
   both calls timed (the hi half with kv=2, the lo half with kv=1), each
   with its share of the bound;
5. the port's main path, ``vmc_pde_torch.driver.main`` on fokkerPlanck32
   at the preset's N=16384 for 5 fixed-Heun steps: the per-sample kernel's
   launch counter must rise, nothing may be NaN, the solver residual must
   be finite and below 1e-3;
6. the chunked statistics on one batch of 131072 in chunks of 65536 at
   the theta phase 5 ends on, tri2 + int8 and syrk each against the f32
   Gram on the same draws: S0, F0 and A within 1e-4 of each one's largest
   value;
7. the chunked path at the production operating point, N=524288 in
   chunks of 65536 with the tri2 Gram and the int8 cross term, for 3
   steps: 3 steps x 2 RHS x 8 chunks split launches, twice that many
   quant8 launches, the plain-mode kernel for the pilot, no NaN, residual
   below 1e-3;
8. the 2-D Gaussian diffusion ``mwe`` in f64 against its closed forms;
9. the Metropolis kernel against its plain version on the same external
   uniforms and on the same Philox stream at the launch shapes (128
   chains x 24 sweeps; 8192 x 128, the VarState.sample launch; 8192 x
   136, a last chunk of 8 sweeps; 2048 x 128 from chain 2048, also
   against those chains' rows of the plain version over 4096), every
   fourth chain started outside the bump's support: the same accept
   count, samples and final states within 2e-6, the rim proposals of
   the chains outside rejected; a Philox run at 8192 x 128 against the
   torch chain on statistics (acceptance within 0.03, mean radius within
   5% of the analytic value, radial-histogram L1 below 0.15); timed, with
   the shares of the bound and of the bound without Philox's multiplies;
10. ``VarState.sample`` on fluidpaper's flow with 8192 chains, 2^20
   samples: the kernel's launch counter must rise;
11. ``fluidpaper`` through the driver at the preset (30 chains, N=10020)
   for 20 steps: no NaN, residual below 1e-3, acceptance in (0.05, 0.95),
   the grid integral on [0, 1]^2 within 0.05 of 1, the entropy drift;
12. ``doubleWell`` through the driver for 20 steps: no NaN, acceptance in
   (0.05, 0.95), the adapted random-walk scale;
13. the syrk kernel against its plain version at P=9264 on the operands
   the syrk paths give it, at the theta phase 5 ends on: one chunk of the
   chunked path, N=65536, unweighted (within 2e-5 of the largest entry)
   and with the weights es and es^2 (3e-5), after the plain-mode
   per-sample kernel that makes the chunk is held against its plain
   version at N=65536; then the direct path's centered O at N=16384,
   unweighted and with the signed weight E_loc - mean, where it is timed
   against the plain version and against torch.mm(O^T, O) in f32; the
   weighted call and the chunk (N=65536) are timed too, each with its
   share of the bound;
14. ``fokkerPlanck32 --gram-backend syrk``: 5 steps at N=16384 with
   exactly 20 syrk launches, S0 and A within 1e-4 of the f32 Gram's on one
   batch, then the chunked statistics at N=131072 in chunks of 65536 for
   2 steps with exactly 24 syrk and 8 per-sample launches. The chunked
   syrk run is cut to 2 steps and N=131072, the direct one to 5 steps,
   to keep the whole script well inside its time limit;
15. (A) the per-sample kernel's Student-t and global-affine branches at
   full width: fokkerPlanck32's flow with the Student-t latent and the
   global affine in every block (d=32, P=9397), on the preset's initial
   theta and a perturbed one (nu = 2.5, g_scale off 1): plain mode at
   N=1024, a ragged 1000 and 16384, split mode at 1024, 1000 and 65536,
   to TOL (on the perturbed theta's heavy-tailed draws, to plain f32's own
   error sample by sample: GRADE_Q and GRADE_MAX below), the nu and
   g_scale rows reported on their own; both modes timed, plain mode also
   at the pilot's 2048 rows, with the shares of the bounds; then
   diffusion_anisotropic's flow (d=12, P=762) with its dense Cholesky
   trace directions at N=16384;
16. (B) ``driver.run(preset("fokkerPlanck32", latent_name="Student_t",
   global_affine=True))`` at N=16384 for 4 steps: exactly 8 plain-mode
   launches, no NaN, residual below 1e-3; then the chunked statistics at
   N=131072 in chunks of 65536 with tri2 + int8 (2 split launches)
   against the f32 Gram on the same draws, S0, F0 and A within 1e-4;
17. (C) ``diffusion`` (d=8, Student-t, P=365) through the CLI with
   ``--per-sample-backend cuda`` for 20 steps: exactly 40 plain-mode
   launches, no NaN, residual below 1e-3, the f64 entropy on common
   random numbers rising every step; then ``--is-gamma 0.5`` for 10 steps
   (20 launches) with the IS weights' effective sample share;
18. (D) ``diffusion_anisotropic`` in f64 (the torch pipeline) for 50
   steps against Sigma(t) = I + 2 t D and 1/2 log det(2 pi e Sigma(t)),
   within 5 Monte Carlo standard errors; ``harmonicOsc`` for 20 steps
   (entropy within 5 standard errors of the initial log(2 pi e), grid
   integral within 0.05 of 1) and ``harmonicOsc_diff`` for 20 steps;
19. (E) the sharded statistics at full width, in 4 rank processes on the
   one card (spawned after every kernel is built; they exchange over gloo,
   through the host): fokkerPlanck32 through ``driver.run`` with
   ``stats_partitioning="shard_map"`` and ``mesh_dp=4``, (a) direct at
   N=16384 for 3 steps (exactly 2 plain-mode launches per step per rank),
   (b) chunked tri2 + int8 at N=262144 in global chunks of 65536 for 2
   steps (each rank 4 local chunks of 16384: exactly 16 split, 32 quant8
   and 4 pilot launches per rank); in both no NaN, residual below 1e-3,
   theta bitwise equal across ranks after every step, and S0, F0 and A on
   one batch within 1e-4 of the one-rank f32 statistics on the same global
   draws; step times and the all-reduce's share and bytes printed; (c)
   ``per_sample_sharded`` against its plain version on a rank's 4096 rows
   (timed, with its share of the bound), then the GSPMD counterpart (``eloc_clip=2``) for 2 steps with
   exactly 4 of its launches per rank;
20. (F) ``metropolis_chain_sharded`` on the 4 ranks, 8192 chains x 128
   and x 136 sweeps (every fourth chain outside the support): each
   rank's launch against the plain version with its chain_base, and the
   gathered shards against the single launch, bit for bit, accept counts
   equal, with external uniforms and with Philox (the per-rank launch
   timed, with both shares); then ``VarState.sample`` of fluidpaper's
   flow on the mesh with 8192 chains: 2 launches on every rank.
21. (G) the steppers at full width, before phases 19-20:
   ``fokkerPlanck32`` at N=16384 with ``--stepper`` fixed_euler,
   fixed_rk3, adaptive_heun and adaptive_rk23 for 3 steps each (cholesky,
   so the adaptive error is the matrix-free S metric on the last stage's
   kept O): exactly stages x attempts plain-mode launches, each step's t,
   dt, attempts, error and residual; adaptive_heun for 2 steps at tol
   2e-5, below its first attempt's error, so that the first step retries
   at a smaller dt (5 launches per attempt, the accepted errors within
   tol); the matrix-free pass timed with CUDA events beside one
   per-sample launch;
22. (G) ``--exact-t-end`` landing on t_end = 5e-3 (dt 2e-3, 2e-3, 1e-3),
   and ``steps_per_dispatch`` 3 against 1 for fixed_heun and
   adaptive_heun (3 steps, verbose output off, so the NaN flags are read
   once per 3 steps): theta and the recorded rows bit for bit; then the host waits (torch's sync debug
   mode) inside one fused Heun pair, one adaptive-Heun attempt and one
   chunked Heun pair, printed with where each comes from;
23. (G) one batch with the dense SExp at the theta phase 5 ends on: the
   direct statistics at N=16384 through syrk (3 launches: S0, A and SExp
   weighted with logp^2) and the chunked ones at N=131072 through tri2 +
   int8, each SExp within 1e-4 of the f32 Gram's; the matrix-free
   v^T SExp v on the direct f32 path within 1e-4 relative of the dense;
   the syrk SExp again on phase 16's Student-t + global-affine flow
   (heavy tails, large logp^2);
24. (G) one adaptive_heun step at the production point (N=524288 in
   chunks of 65536, tri2 + int8): per attempt 40 split, 80 quant8 and 13
   plain-mode launches (5 pilots, 8 for the matrix-free metric, which
   re-makes O per chunk); that metric timed;
25. (G) ``fluidpaper`` with adaptive_heun (the dense SExp, the torch
   chain) for 3 steps: the recorded proposals are the budget x 5 x
   attempts;
26. (H1) ``--solver cg`` at fokkerPlanck32's N=16384 for 3 fixed-Heun
   steps (2 plain-mode launches a step, lambda_max and no spectrum); one
   RHS at phase 5's theta against the Cholesky solve on the same draws
   (svd_tol 1e-5, 600 iterations): cosine, lambda_max, residual, and the
   update against the f64 Cholesky solve; the CG solve timed with its
   iterations and the host waits of one RHS; one adaptive-Heun step;
27. (H2) ``--solver minsr`` in its regime, P > N: fokkerPlanck32 at
   N=2048 and scripts/bench_minsr.py's flow (d=32, depth 8, hidden 32,
   P=34,864, N=1024, kernel forced), 3 steps each (1 launch a RHS); one
   batch's kernel-space residual and spectrum against P-space ones on
   the same O rows; the N x N eigh, a minSR RHS and a Cholesky RHS timed;
28. (H3) streaming minSR at chunk_size N/4 on both flows, 3 steps (18
   launches a RHS), one RHS against the direct one on the same draws;
29. (H4) the Gram precisions: direct N=16384 under tpu_f64stats, f64 and
   default against high on the same draws, the f64 solve's residuals;
   then f64acc at the production point (3 steps: 16 split, 32 quant8, 2
   pilots a step) and one batch's statistics under f64acc, high and
   chunked f64, f64acc nearer to f64 than high (Frobenius norm);
30. (H5) the host f64 solve: ``mwe --precision f64 --host-solve`` for 10
   steps (residual below 1e-10), one fokkerPlanck32 RHS solved on the
   host (numpy f64) against the device's f64 Cholesky, timed;
31. (I1) the randomized QMC draws on the card against the CPU at
   fokkerPlanck32's production batch (d=33, n=524288): the scrambled bits
   from the same words bit for bit, the f32 normals within 8 f32 ulps of
   the CPU's f64 ones, chi^2 for nu in {1.05, 2.5, 50} within the
   inversion's bound; the net, the normals and the Newton solve timed;
32. (I2) ``fokkerPlanck32 --qmc`` at N=16384 for 5 steps (exactly 10
   plain-mode launches) and at the production point for 3 steps (48
   split, 96 quant8, 6 pilots), each step time beside phase 5's and 7's;
   the spread of F0 over 8 randomizations, QMC against pseudo-random
   draws (printed, no gate);
33. (I3) the Student-t + global affine ``fokkerPlanck32`` with ``qmc`` for
   4 steps (8 launches), and the kernel on QMC draws of the joint
   (d+1)-column net held to plain f32 with phase 15's grading;
34. (I4) ``fokkerPlanck32 --hessian-mode block`` for 2 steps (the
   torch.func pipeline: no launch), its f32 E_loc against the f64
   pipeline's beside the kernel's trace-mode E_loc, and mwe and
   diffusion_anisotropic in f64, block against trace within 1e-10;
35. (I5) the MC sphere integrals: mwe in f64 for 10 steps within 5
   standard errors of its closed form, fokkerPlanck32 at N=16384 for 3
   steps (6 launches) in [0, 1 + 5 SE], with the step time.

Any failure raises and exits nonzero. On success the second-to-last line
is the per-kernel JSON record and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import dataclasses
import json
import math
import multiprocessing
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.kernels import (bounds, build, metropolis, persample,
                                   quant8, syrk)
from vmc_pde_torch.models.flow import build_flow, perturb_theta
from vmc_pde_torch.models.state import VarState
from vmc_pde_torch.ops.evolution import make_equation
from vmc_pde_torch.parallel import mesh, stats
from vmc_pde_torch.parallel.mesh import ParallelCtx
from vmc_pde_torch.sampling import sampler as sampling
from vmc_pde_torch.solver import tdvp as tdvp_mod
from vmc_pde_torch.solver.tdvp import TDVP
from vmc_pde_torch.utils.dtypes import full_f32_matmuls
from vmc_pde_torch.utils.grid import Grid

# Kernel (f32) vs plain version in f64 on the same f32-rounded inputs,
# relative to the largest reference value: f32 rounding amplified by four
# coupling blocks of exp/tanh (the plain pipeline in f32 shows 1e-5 to
# 7e-5 on the perturbed flow at N=1024), and a second derivative with
# cancellations for quad. The plain pipeline's own f32 error is printed
# beside the kernel's. The split pair adds 2^-16 (its dropped residual).
TOL = {"logp": 1e-4, "g": 2e-4, "quad": 1e-3, "O": 2e-4}
KERNELS = {
    "persample": ("vmc_pde_torch/kernels/csrc/persample.cu",
                  "vmc_pde_tpu/kernels/persample.py:899"),
    "persample_split": ("vmc_pde_torch/kernels/csrc/persample.cu",
                        "vmc_pde_tpu/kernels/persample.py:916"),
    "quant8": ("vmc_pde_torch/kernels/csrc/quant8.cu",
               "vmc_pde_tpu/kernels/quant8.py:103"),
    "metropolis": ("vmc_pde_torch/kernels/csrc/metropolis.cu",
                   "vmc_pde_tpu/kernels/metropolis.py:140"),
    "syrk": ("vmc_pde_torch/kernels/csrc/syrk.cu",
             "vmc_pde_tpu/kernels/syrk.py:161"),
    "persample_sharded": ("vmc_pde_torch/kernels/csrc/persample.cu",
                          "vmc_pde_tpu/kernels/persample.py:1104"),
    "metropolis_sharded": ("vmc_pde_torch/kernels/csrc/metropolis.cu",
                           "vmc_pde_tpu/kernels/metropolis.py:191"),
}
WRAPPERS = {"persample": persample.per_sample_cuda,
            "persample_split": persample.per_sample_split_cuda,
            "quant8": quant8.quant_force_cuda,
            "metropolis": metropolis.metropolis_chain_cuda,
            "syrk": syrk.syrk_cuda,
            "persample_sharded": persample.per_sample_sharded,
            "metropolis_sharded": metropolis.metropolis_chain_sharded}
# rank processes of phases 19 and 20, all on the one card
MESH_WORLD = 4
# the chunked path's pilot batch (solver/tdvp.py): its per-sample shape
PILOT_N = 2048
# wall seconds of each step of each _drive run, by its label
STEP_TIMES = {}
MAIN_LABEL = "fokkerPlanck32 N=16384"
CHUNKED_LABEL = "fokkerPlanck32 N=524288 chunked tri2+int8"


def fail(msg):
    raise RuntimeError(msg)


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0])


def phase_build():
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name in build.SIGNATURES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "stack frame" in line:
                print(f"ptxas {name}:", line.strip())


def _time_ms(fn, reps):
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _fp32_problem(dev):
    cfg = preset("fokkerPlanck32")
    flow, theta0 = build_flow(cfg.seed, cfg.dim, depth=cfg.depth,
                              hidden=cfg.hidden_resolved(),
                              variant=cfg.variant, out_scale=cfg.init_scale,
                              dtype=torch.float32, device=dev)
    if flow.layout.size != 9264:
        fail(f"fokkerPlanck32 has P={flow.layout.size}, expected 9264")
    perturbed = perturb_theta(flow, theta0, np.random.default_rng(0),
                              out_scale=0.03)
    eq = make_equation(cfg.equation, cfg.dim, **cfg.equation_params)
    dirs = torch.as_tensor(eq.hessian_trace_dirs(cfg.dim),
                           dtype=torch.float32, device=dev)
    return flow, theta0, perturbed, eq, dirs


def _rel(a, ref, scale=None):
    ref = ref.double()
    if scale is None:
        scale = ref.abs().max().clamp_min(1.0)
    return float((a.double() - ref).abs().max() / scale)


def _row_groups(flow):
    """The O rows of the Student-t and global-affine branches, by name:
    the nu row and every block's g_scale row (and g_offset rows)."""
    lay, groups = flow.layout, {}
    if flow.latent_name == "Student_t":
        groups["nu row"] = [lay.offset(("latent", "dist_params"))]
    ga = [b for b, spec in enumerate(flow.blocks) if spec.global_affine]
    if ga:
        groups["g_scale rows"] = [lay.offset(("blocks", b, "g_scale"))
                                  for b in ga]
        groups["g_offset rows"] = [
            lay.offset(("blocks", b, "g_offset")) + i
            for b in ga for i in range(flow.dim)]
    return groups


def _print_rows(label, n, O, O_ref, O_32, groups):
    """Max abs error of each row group of O, relative to the group's
    largest reference value, beside plain f32's."""
    for name, rows in groups.items():
        r = O_ref[:, rows]
        scale = r.abs().max().clamp_min(1e-30)
        err = float((O[:, rows].double() - r).abs().max())
        err32 = float((O_32[:, rows].double() - r).abs().max())
        print(f"  {label}, N={n}, {name}: max abs err {err:.3e}, relative "
              f"to the rows' largest value {err / float(scale):.3e} (plain "
              f"f32 {err32 / float(scale):.3e})")


# Heavy-tailed draws of a perturbed flow (phase 15): a few samples are so
# ill-conditioned that f32 itself loses three digits there, and which of
# two f32 evaluations errs more at the worst one is a coin toss
# (over seven draws of 16384 on the card, six of them through
# tools/persample_blocks.py, the kernel's largest g error was 0.46-4.2
# times plain f32's, while their per-sample error quantiles up to 0.999
# agreed within 25%). There each
# per-sample output is held to plain f32's own error sample by sample:
# the quantiles GRADE_Q of the per-sample error within twice plain f32's,
# the largest within GRADE_MAX times plain f32's largest (or TOL).
GRADE_Q = (0.5, 0.99, 0.999)
GRADE_MAX = 10.0


def _grade_ok(name, a, r, p, tol, where):
    """The same-grade check of kernel output ``a`` against the f64
    reference ``r``, beside plain f32's ``p``, each sample's largest error
    relative to the largest reference value; prints it, returns whether it
    holds."""
    scale = r.double().abs().max().clamp_min(1.0)

    def per_sample(v):
        e = (v.double() - r).abs()
        return (e if e.ndim == 1 else e.amax(1)) / scale

    ek, ep = per_sample(a), per_sample(p)
    qs = torch.tensor(GRADE_Q, dtype=torch.float64, device=ek.device)
    qk, qp = torch.quantile(ek, qs).tolist(), torch.quantile(ep, qs).tolist()
    mk, mp = float(ek.max()), float(ep.max())
    limit = max(tol, GRADE_MAX * mp)
    print(f"{where}, {name}: per-sample error at quantiles {GRADE_Q}: "
          f"kernel {' '.join(f'{v:.2e}' for v in qk)}, plain f32 "
          f"{' '.join(f'{v:.2e}' for v in qp)}; largest kernel {mk:.3e}, "
          f"plain f32 {mp:.3e} (limit {limit:.2e})")
    return (all(k <= 2.0 * q + 2.0**-24 for k, q in zip(qk, qp))
            and mk < limit)


def _persample_vs_plain(flow, theta, x, dirs, label, loose=False,
                        grade=False):
    """The plain-mode kernel against the plain pipeline in f64 on the same
    f32 inputs, to TOL (with ``loose``, to twice plain f32's own error
    where that is larger; with ``grade``, to plain f32's own error sample
    by sample, _grade_ok); returns the largest abs error of O. The
    Student-t and global-affine rows are also reported on their own."""
    n = x.shape[0]
    got = persample.per_sample_cuda(flow, theta, x, dirs)
    ref = persample.per_sample_plain(flow, theta.double(), x.double(),
                                     dirs.double())
    ref32 = persample.per_sample_plain(flow, theta, x, dirs)
    torch.cuda.synchronize()
    _print_rows(f"kernel vs plain, {label} theta", n, got[3], ref[3],
                ref32[3], _row_groups(flow))
    for name, a, r, p in zip(("logp", "g", "quad", "O"), got, ref, ref32):
        if a.shape != r.shape or not torch.isfinite(a).all():
            fail(f"kernel {name} at N={n}: shape {tuple(a.shape)} vs "
                 f"{tuple(r.shape)}, or not finite")
        rel, rel32 = _rel(a, r), _rel(p, r)
        tol = max(TOL[name], 2.0 * rel32) if loose else TOL[name]
        where = f"kernel vs plain, {label} theta, N={n}"
        print(f"{where}, {name}: max abs err "
              f"{float((a.double() - r).abs().max()):.3e}, relative "
              f"{rel:.3e} (tol {tol:.2e}; plain f32 {rel32:.3e})")
        ok = (_grade_ok(name, a, r, p, TOL[name], where) if grade
              else rel < tol)
        if not ok:
            fail(f"kernel {name} disagrees with the plain version at "
                 f"N={n}: {rel:.3e}")
    return float((got[3].double() - ref[3]).abs().max())


def phase_kernel(dev, prob):
    flow, theta0, perturbed, _, dirs = prob
    gen = torch.Generator(device=dev).manual_seed(0)
    max_abs = 0.0
    # a perturbed theta exercises the nonlinear parts (N=1000 is ragged);
    # the last case is what the main path hands the kernel: its initial
    # theta and a batch of the preset's N=16384. At N=16384 the perturbed
    # flow throws a few samples far out (|x| ~ 47), where f32 itself loses
    # digits: plain f32 misses TOL there (g 1.1e-3, O 1.6e-3 relative), so
    # that case holds the kernel to twice plain f32's own error
    for label, theta, n in (("perturbed", perturbed, 1024),
                            ("perturbed", perturbed, 1000),
                            ("perturbed", perturbed, 16384),
                            ("initial", theta0, 16384)):
        params = flow.layout.unravel(theta)
        x, _ = flow.push(params, flow.latent_sample(gen, params, n,
                                                    torch.float32))
        max_abs = max(max_abs, _persample_vs_plain(
            flow, theta, x, dirs, label,
            loose=label == "perturbed" and n == 16384))

    # time both on the main path's theta and batch, the last case above;
    # then the kernel alone on the chunked path's pilot shape (its first
    # 2048 rows)
    ms = _time_ms(lambda: persample.per_sample_cuda(flow, theta, x, dirs), 20)
    plain_ms = _time_ms(
        lambda: persample.per_sample_plain(flow, theta, x, dirs), 3)
    P, d, k = flow.layout.size, flow.dim, dirs.shape[0]
    bound = bounds.persample(bounds.flow_layers(flow), d, P, n, k)
    print(f"per-sample at N={n}, P={P}: CUDA kernel {ms:.3f} ms, plain "
          f"torch.func {plain_ms:.3f} ms, bound {bound[0]:.3f} ms "
          f"({bound[1]}), the bound's share of the kernel "
          f"{bound[0] / ms:.4f}")
    xp = x[:PILOT_N].contiguous()
    pilot_ms = _time_ms(
        lambda: persample.per_sample_cuda(flow, theta, xp, dirs), 20)
    pilot_bound = bounds.persample(bounds.flow_layers(flow), d, P, PILOT_N,
                                   k)[0]
    print(f"per-sample at the pilot's N={PILOT_N}: CUDA kernel "
          f"{pilot_ms:.4f} ms, bound {pilot_bound:.4f} ms, share "
          f"{pilot_bound / pilot_ms:.4f}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1],
                share_of_bound=bound[0] / ms, pilot_N=PILOT_N,
                pilot_ms=pilot_ms, pilot_bound_ms=pilot_bound,
                pilot_share_of_bound=pilot_bound / pilot_ms)


def _split_vs_plain(flow, theta, x, dirs, label, grade=False):
    """The split-mode kernel against the plain pipeline in f64 and split,
    to TOL (with ``grade``, the per-sample outputs to plain f32's own
    error sample by sample, _grade_ok, and the column statistics to twice
    plain f32's where that is larger). The shift is the pilot's: the
    plain f32 mean O of the first 2048 samples. Returns (kernel outputs,
    shift, largest abs error of hi + lo)."""
    n = x.shape[0]
    shift = persample.per_sample_plain(flow, theta, x[:2048],
                                       dirs)[3].mean(0)
    got = persample.per_sample_split_cuda(flow, theta, x, dirs, shift)
    ref = persample.per_sample_plain(flow, theta.double(), x.double(),
                                     dirs.double())
    ref32 = persample.per_sample_split_plain(flow, theta, x, dirs, shift)
    torch.cuda.synchronize()
    o_ref = ref[3] - shift.double()
    o_scale = o_ref.abs().max().clamp_min(1.0)
    pair = got[3][0].double() + got[3][1].double()
    pair32 = ref32[3][0].double() + ref32[3][1].double()
    _print_rows(f"split kernel vs plain, {label} theta", n, pair, o_ref,
                pair32, _row_groups(flow))
    checks = [(name, a, r, p, TOL[name], None) for name, a, r, p in
              zip(("logp", "g", "quad"), got, ref, ref32)]
    checks += [
        ("hi+lo", pair, o_ref, pair32, TOL["O"] + 2**-16, None),
        # per-element scale: a sum of n terms each within the O bar
        ("colsum", got[4], o_ref.sum(0), ref32[4], TOL["O"], n * o_scale),
        ("colmax", got[5], o_ref.abs().amax(0), ref32[5], TOL["O"],
         o_scale)]
    max_abs = 0.0
    for name, a, r, p, tol, scale in checks:
        if a.shape != r.shape or not torch.isfinite(a).all():
            fail(f"split kernel {name} at N={n}: shape "
                 f"{tuple(a.shape)} vs {tuple(r.shape)}, or not finite")
        rel, rel32 = _rel(a, r, scale), _rel(p, r, scale)
        per_sample = scale is None
        if grade and not per_sample:
            tol = max(tol, 2.0 * rel32)
        where = f"split kernel vs plain, {label} theta, N={n}"
        print(f"{where}, {name}: relative {rel:.3e} (tol {tol:.1e}; plain "
              f"f32 {rel32:.3e})")
        ok = (_grade_ok(name, a, r, p, tol, where) if grade and per_sample
              else rel < tol)
        if not ok:
            fail(f"split kernel {name} disagrees with the plain version "
                 f"at N={n}: {rel:.3e}")
        if name == "hi+lo":
            max_abs = float((a - r).abs().max())
    return got, shift, max_abs


def phase_split(dev, prob):
    """Split mode against the plain pipeline and split."""
    flow, theta0, perturbed, eq, dirs = prob
    gen = torch.Generator(device=dev).manual_seed(1)
    max_abs = 0.0
    for label, theta, n in (("perturbed", perturbed, 1024),
                            ("perturbed", perturbed, 1000),
                            ("initial", theta0, 65536)):
        params = flow.layout.unravel(theta)
        x, _ = flow.push(params, flow.latent_sample(gen, params, n,
                                                    torch.float32))
        got, shift, err = _split_vs_plain(flow, theta, x, dirs, label)
        max_abs = max(max_abs, err)

    P, d, k = flow.layout.size, flow.dim, dirs.shape[0]
    ms = _time_ms(lambda: persample.per_sample_split_cuda(
        flow, theta, x, dirs, shift), 10)
    plain_ms = _time_ms(lambda: persample.per_sample_split_plain(
        flow, theta, x, dirs, shift), 2)
    bound = bounds.persample(bounds.flow_layers(flow), d, P, n, k,
                             split=True)
    print(f"split per-sample at N={n}, P={P}: CUDA kernel {ms:.3f} ms, "
          f"plain torch.func + split {plain_ms:.3f} ms, bound "
          f"{bound[0]:.3f} ms ({bound[1]}), share {bound[0] / ms:.4f}")
    eloc = eq.eloc(x, got[1], got[2], 0.0)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1],
                share_of_bound=bound[0] / ms,
                pair=got[3], omax=got[5], es=eloc - eloc.mean())


def phase_quant8(split):
    """Both quantize+force calls of one chunk, as the chunked path makes
    them, on the real pair: q8 must equal the plain quantization bit for
    bit; f is held against the f64 product."""
    amax = (split["omax"] * (1.0 + 2.0**-8), split["omax"] * 2.0**-8)
    es_hi, es_lo = stats._split_bf16(split["es"].float())
    calls = (("hi", split["pair"][0].T, amax[0],
              torch.stack([es_hi, es_lo], dim=1)),
             ("lo", split["pair"][1].T, amax[1], es_hi[:, None]))
    max_abs = 0.0
    for half, x_pn, am, V in calls:
        inv = stats._int8_scales(am)[1]
        q8, f = quant8.quant_force_cuda(x_pn, inv, V)
        q_ref, f_plain = quant8.quant_force_plain(x_pn, inv, V)
        f64 = x_pn.double() @ V.double()
        torch.cuda.synchronize()
        mismatches = int((q8 != q_ref).sum())
        scale = f64.abs().max().clamp_min(1e-30)
        rel, rel_plain = _rel(f, f64, scale), _rel(f_plain, f64, scale)
        print(f"quant8 vs plain, {half} half (P, n) = {tuple(x_pn.shape)}, "
              f"kv={V.shape[1]}: q8 mismatches {mismatches}, f relative "
              f"{rel:.3e} against f64 (tol 1e-5; plain bf16 product "
              f"{rel_plain:.3e})")
        if mismatches or not rel < 1e-5:
            fail(f"quant8 kernel disagrees on the {half} half")
        max_abs = max(max_abs, float((f.double() - f64).abs().max()))
    # time both calls; the hi call (kv=2) is the kernel's record
    timed = {}
    for half, x_pn, am, V in calls:
        inv = stats._int8_scales(am)[1]
        ms = _time_ms(lambda: quant8.quant_force_cuda(x_pn, inv, V), 20)
        plain_ms = _time_ms(lambda: quant8.quant_force_plain(x_pn, inv, V),
                            20)
        P, n = x_pn.shape
        kv = V.shape[1]
        bound = bounds.quant8(P, n, kv)
        print(f"quant8 {half} at P={P}, n={n}, kv={kv}: CUDA kernel "
              f"{ms:.3f} ms, plain passes {plain_ms:.3f} ms, bound "
              f"{bound[0]:.3f} ms ({bound[1]}), share {bound[0] / ms:.3f}")
        timed[half] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                           bound_by=bound[1], share_of_bound=bound[0] / ms)
    return dict(max_abs_err=max_abs, **timed["hi"],
                shapes={"lo, kv=1": timed["lo"]})


def _zero_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def _drive(args, label, n_steps, dim=32, cfg=None, callbacks=()):
    """Run the driver's CLI on ``args`` (or ``driver.run`` on ``cfg``);
    returns (state, recorder arrays, counts). Each of ``callbacks`` runs
    after every step, outside the step's timing."""
    stamps = []

    def record(n_step, t, state, info):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        for cb in callbacks:
            cb(n_step, t, state, info)
        torch.cuda.synchronize()
        starts.append(time.perf_counter())  # the next step's clock

    starts = []
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if cfg is None:
        state, rec = driver.main(
            args + ["--max-steps", str(n_steps), "--device", "cuda"],
            callbacks=[record])
    else:
        state, rec = driver.run(cfg, max_steps=n_steps, callbacks=[record])
    counts = _counts()
    steps = np.array(stamps) - np.array([t0] + starts[:-1])
    STEP_TIMES[label] = steps
    mean = (f", mean of steps 2-{len(steps)} {steps[1:].mean():.3f} s"
            if len(steps) > 1 else "")
    print(f"{label}: {len(steps)} steps, wall s/step "
          f"{' '.join(f'{s:.3f}' for s in steps)} (first includes "
          f"set-up){mean}")
    print(f"{label}: kernel launches {counts}")
    arrays = rec.as_arrays()
    # the spectrum of eigh/minsr, the Ritz one of cholesky; cg has none
    spectrum = next(k for k in ("ev_topk", "ev", "lambda_max")
                    if k in arrays)
    for key in ("solver_res", "tdvp_error", "entropy", "covar", "x1",
                "eloc_mean", spectrum):
        if not np.isfinite(arrays[key]).all():
            fail(f"non-finite {key} in the {label} run")
    if arrays["nan"].any():
        fail(f"NaN update in the {label} run")
    if arrays["covar"].shape != (n_steps, dim, dim):
        fail(f"covar shape {arrays['covar'].shape}")
    res = arrays["solver_res"]
    print(f"{label} solver_res per step: "
          f"{' '.join(f'{r:.3e}' for r in res)}")
    if not (res < 1e-3).all():
        fail(f"solver residual above 1e-3 in the {label} run: {res}")
    return state, arrays, counts


def phase_main_path():
    state, _, counts = _drive(["fokkerPlanck32"], MAIN_LABEL, 5)
    if counts["persample"] == 0:
        fail("the main path never launched the per-sample kernel")
    return state, counts


def phase_chunked_path():
    n_steps = 3
    _, _, counts = _drive(
        ["fokkerPlanck32", "--samples", "524288", "--chunk-size", "65536",
         "--gram-backend", "tri2", "--gram-cross", "int8"],
        CHUNKED_LABEL, n_steps)
    want = n_steps * 2 * (524288 // 65536)
    if counts["persample_split"] != want:
        fail(f"split kernel launches {counts['persample_split']}, expected "
             f"{want}")
    if counts["quant8"] != 2 * want:
        fail(f"quant8 launches {counts['quant8']}, expected {2 * want}")
    if counts["persample"] == 0:
        fail("the chunked path never ran the plain-mode kernel's pilot")
    return counts


def phase_chunked_vs_f32(theta, syrk_too=True, **flow_overrides):
    """The chunked statistics on one batch of draws through the tri2+int8,
    the syrk (``syrk_too``) and the f32 Gram, at the theta a path ends on;
    tri2+int8 must run the split kernel once per chunk."""
    n, c = 131072, 65536
    out = {}
    backends = [("tri2+int8", dict(gram_backend="tri2", gram_cross="int8")),
                ("syrk", dict(gram_backend="syrk")), ("f32", {})]
    for label, over in backends if syrk_too else backends[::2]:
        cfg = preset("fokkerPlanck32", device="cuda", n_samples_tdvp=n,
                     n_samples_obs=n, chunk_size=c, **over, **flow_overrides)
        state, tdvp = driver.build_problem(cfg)[:2]
        theta_c = theta.to(device=state.device, dtype=torch.float32)
        params = state.flow.layout.unravel(theta_c)
        gen = torch.Generator(device=state.device).manual_seed(7)
        x, _ = state.flow.push(params, state.flow.latent_sample(
            gen, params, n, torch.float32))
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        st = tdvp._chunked_stats(theta_c, 0.0, x)
        torch.cuda.synchronize()
        out[label] = (st, time.perf_counter() - t0)
        if label == "tri2+int8" and _counts()["persample_split"] != n // c:
            fail(f"chunked tri2+int8 statistics ran the split kernel "
                 f"{_counts()['persample_split']} times, expected {n // c}")
    print(f"chunked statistics at N={n}, chunk {c}, first call each: "
          + ", ".join(f"{label} {t:.3f} s" for label, (_, t) in out.items()))
    full = out.pop("f32")[0]
    for label, (st, _) in out.items():
        for key in ("S0", "F0", "A"):
            rel = _rel(st[key], full[key], full[key].abs().max())
            print(f"chunked {label} vs f32 {key} at N={n}: max abs diff / "
                  f"max {rel:.3e} (tol 1e-4)")
            if not rel <= 1e-4:
                fail(f"chunked {label} {key} differs from the f32 Gram "
                     f"path: {rel}")


def phase_mwe():
    cfg = preset("mwe", precision="f64", device="cuda", n_samples_tdvp=4096,
                 n_samples_obs=4096, verbose=False)
    _, rec = driver.run(cfg, max_steps=80)
    a = rec.as_arrays()
    t = a["times"][-1]
    var = 1.0 + 2.0 * t
    cov_err = np.abs(np.diagonal(a["covar"][-1]) - var).max()
    ent = 0.5 * 2 * math.log(2 * math.pi * math.e * var)
    ent_err = abs(a["entropy"][-1] - ent)
    print(f"mwe f64 at t={t:.4f}: covar diag {np.diagonal(a['covar'][-1])} "
          f"vs {var:.4f}, entropy {a['entropy'][-1]:.4f} vs {ent:.4f}, "
          f"solver_res {a['solver_res'][-1]:.3e}")
    # 5 standard errors of the N=4096 Monte Carlo estimates
    if not (t > 0.2 and cov_err < 0.2 and ent_err < 0.08):
        fail(f"mwe misses its closed forms (covar {cov_err:.3f}, "
             f"entropy {ent_err:.3f})")


BUMP_OFFSET = (0.25, 0.25)


def _bump_mean_radius(bound=0.25):
    """Analytic mean radius of the cosine bump, p(s) ~ s (1 + cos(4 pi s))
    on [0, bound]."""
    s_grid = np.linspace(0, bound, 20001)
    w = s_grid * (1 + np.cos(4 * np.pi * s_grid))
    return np.trapezoid(s_grid * w, s_grid) / np.trapezoid(w, s_grid)


def _metropolis_inputs(dev, n_chains, sweeps, seed=2):
    """Initial states and external uniforms of n_chains chains, as
    tests/test_torch_cuda.py makes them: every fourth chain starts outside
    the bump's support (lp = -inf) and draws its first 8 proposals on the
    ball's rim (lp = -inf: -inf - -inf is NaN, which must reject); the
    mask of those chains."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    init = torch.tensor(BUMP_OFFSET, device=dev).repeat(n_chains, 1)
    outside = torch.arange(n_chains, device=dev) % 4 == 3
    init[outside, 0] += 0.5
    u = torch.rand((6, sweeps, n_chains), generator=gen, device=dev) \
        * (1 - 2e-7) + 1e-7
    u[4, :8, outside] = 1.0
    return init, u.reshape(6, -1), outside


def _metropolis_vs_plain(dev, C, sweeps, base, ext):
    """One launch on the global chains [base, base + C) against the plain
    version with the same chain_base (and, for base > 0, against the rows
    of these chains in the plain version over all base + C chains); the
    rim proposals of the chains outside the support rejected. Returns the
    largest difference."""
    G = base + C
    init_all, u_all, outside = _metropolis_inputs(dev, G, sweeps)
    init = init_all[base:].contiguous()
    u = (u_all.reshape(6, sweeps, G)[:, :, base:].reshape(6, -1) if ext
         else None)
    got = metropolis.metropolis_chain_cuda(5, init, sweeps, 0.25,
                                           BUMP_OFFSET, u, chain_base=base)
    ref = metropolis.metropolis_chain_plain(5, init, sweeps, 0.25,
                                            BUMP_OFFSET, u, chain_base=base)
    torch.cuda.synchronize()
    err = max(float((a - r).abs().max()) for a, r in zip(got[:2], ref[:2]))
    rows = got[0].reshape(sweeps, C, 2)
    if base:
        full = metropolis.metropolis_chain_plain(
            5, init_all, sweeps, 0.25, BUMP_OFFSET, u_all if ext else None)
        err = max(err, float((rows - full[0].reshape(sweeps, G, 2)[:, base:])
                             .abs().max()))
    stuck = rows[:8, outside[base:]]
    rejected = (not ext or torch.equal(
        stuck, init[outside[base:]].expand_as(stuck)))
    acc, acc_ref = int(got[2]), int(ref[2])
    label = "external uniforms" if ext else "Philox"
    print(f"metropolis kernel vs plain, {C} chains x {sweeps} sweeps from "
          f"chain {base}, {label}: accepted {acc} vs {acc_ref}, max abs err "
          f"{err:.3e} (tol 2e-6), rim proposals outside the support "
          f"rejected: {rejected}")
    if acc != acc_ref or not err <= 2e-6 or not rejected:
        fail(f"the Metropolis kernel disagrees with its plain version "
             f"({label}, {C} chains x {sweeps} sweeps from {base})")
    return err


def _metropolis_bound(n, ext=False):
    """(bound ms, bound_by, the bound with Philox left out in ms)."""
    t = bounds.metropolis_terms(n, 2, ext=ext)
    return (*bounds.metropolis(n, 2, ext=ext), max(t["bytes"], t["f32"]))


def phase_metropolis(dev):
    """The Metropolis kernel against its plain version on the same
    uniforms and on the Philox stream, exact, at the launch shapes;
    the Philox variant against the torch chain on statistics; timed."""
    max_abs = 0.0
    for C, sweeps, base in ((128, 24, 0), (8192, 128, 0), (8192, 136, 0),
                            (2048, 128, 2048)):
        for ext in (True, False):
            max_abs = max(max_abs, _metropolis_vs_plain(dev, C, sweeps, base,
                                                        ext))

    # statistics of a Philox run from the offset against the torch chain
    C, sweeps = 8192, 128
    init = torch.tensor(BUMP_OFFSET, device=dev).repeat(C, 1)
    got = metropolis.metropolis_chain_cuda(5, init, sweeps, 0.25,
                                           BUMP_OFFSET)
    acc = int(got[2])
    total, burn = sweeps * C, 32 * C
    info = {"offset": np.asarray(BUMP_OFFSET), "bound": 0.25}
    t_s, _, t_acc = sampling.metropolis_chain(
        torch.Generator(device=dev).manual_seed(3), init,
        lambda x: sampling.cos_dist_log_prob(
            x, torch.tensor(BUMP_OFFSET, device=dev)),
        sampling.radial_proposal, sweeps, info)
    off = np.asarray(BUMP_OFFSET)
    rk = np.linalg.norm(got[0].cpu().numpy()[burn:] - off, axis=1)
    rt = np.linalg.norm(t_s.cpu().numpy()[burn:] - off, axis=1)
    mean_r = _bump_mean_radius()
    hk, edges = np.histogram(rk, bins=25, range=(0, 0.25), density=True)
    ht, _ = np.histogram(rt, bins=edges, density=True)
    l1 = np.abs(hk - ht).mean() / ht.mean()
    rate_k, rate_t = acc / total, int(t_acc) / total
    print(f"metropolis Philox vs torch chain: acceptance {rate_k:.4f} vs "
          f"{rate_t:.4f}, mean radius {rk.mean():.5f} and {rt.mean():.5f} "
          f"(analytic {mean_r:.5f}), radial histogram L1 {l1:.4f}")
    if not (abs(rate_k - rate_t) < 0.03 and abs(rk.mean() / mean_r - 1) < 0.05
            and abs(rt.mean() / mean_r - 1) < 0.05 and l1 < 0.15):
        fail("the Philox Metropolis kernel does not sample the cosine bump")

    gen = torch.Generator(device=dev).manual_seed(2)
    u_ext = torch.rand((6, sweeps * C), generator=gen, device=dev) \
        * (1 - 2e-7) + 1e-7
    ms = _time_ms(lambda: metropolis.metropolis_chain_cuda(
        5, init, sweeps, 0.25, BUMP_OFFSET), 50)
    ext_ms = _time_ms(lambda: metropolis.metropolis_chain_cuda(
        5, init, sweeps, 0.25, BUMP_OFFSET, u_ext), 50)
    tail_ms = _time_ms(lambda: metropolis.metropolis_chain_cuda(
        5, init, sweeps + 8, 0.25, BUMP_OFFSET), 50)
    plain_ms = _time_ms(lambda: metropolis.metropolis_chain_plain(
        5, init, sweeps, 0.25, BUMP_OFFSET, u_ext), 3)
    torch_ms = _time_ms(lambda: sampling.metropolis_chain(
        torch.Generator(device=dev).manual_seed(3), init,
        lambda x: sampling.cos_dist_log_prob(
            x, torch.tensor(BUMP_OFFSET, device=dev)),
        sampling.radial_proposal, sweeps, info), 3)
    bound, by, old = _metropolis_bound(total)
    bound_ext, _, _ = _metropolis_bound(total, ext=True)
    print(f"metropolis at {C} chains x {sweeps} sweeps: CUDA kernel Philox "
          f"{ms:.4f} ms (bound {bound:.6f} ms, {by}, share "
          f"{bound / ms:.4f}; without Philox's multiplies {old:.6f} ms, "
          f"share {old / ms:.4f}), external uniforms {ext_ms:.4f} ms (bound "
          f"{bound_ext:.6f} ms, share {bound_ext / ext_ms:.4f}), Philox at "
          f"{sweeps + 8} sweeps {tail_ms:.4f} ms, plain torch on the same "
          f"uniforms {plain_ms:.3f} ms, the torch chain {torch_ms:.3f} ms")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, bound_without_philox_ms=old,
                ext_ms=ext_ms, ext_bound_ms=bound_ext)


def phase_var_state_sample(dev):
    """VarState.sample on fluidpaper's flow with 8192 chains: the path
    that reaches the Metropolis kernel."""
    cfg = preset("fluidpaper")
    flow, theta = build_flow(cfg.seed, cfg.dim, depth=cfg.depth,
                             hidden=cfg.hidden_resolved(),
                             variant=cfg.variant, latent_name=cfg.latent_name,
                             offset=cfg.offset, out_scale=cfg.init_scale,
                             dtype=torch.float32, device=dev)
    sampler = sampling.Sampler(2, cfg.latent_name, n_chains=8192,
                               mcmc_info={"offset": np.asarray(cfg.offset),
                                          "bound": cfg.mcmc_bound})
    state = VarState(flow, theta, sampler=sampler)
    n = 2**20
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, logp = state.sample(n, key=1)
    x2, logp2 = state.sample(n, key=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    rate = sampler.last_info.acceptance_rate
    r = (x2 - torch.tensor(cfg.offset, device=dev)).norm(dim=1)
    print(f"VarState.sample, fluidpaper flow, 8192 chains: 2 x {n} samples "
          f"in {wall:.3f} s, launches {counts}, acceptance {rate:.4f}, "
          f"mean radius {float(r.mean()):.5f} (bump {_bump_mean_radius():.5f}"
          f"; the flow starts near the identity)")
    if counts["metropolis"] != 2:
        fail(f"VarState.sample launched the Metropolis kernel "
             f"{counts['metropolis']} times, expected 2")
    if (x.shape != (n, 2) or not torch.isfinite(x).all()
            or not torch.isfinite(logp).all() or not 0.05 < rate < 0.95):
        fail("VarState.sample gave bad samples")
    return counts["metropolis"]


def _acceptance(arrays):
    return float(arrays["mcmc_accepted"].sum()
                 / arrays["mcmc_proposed"].sum())


def phase_fluidpaper():
    state, arrays, counts = _drive(["fluidpaper"], "fluidpaper", 20, dim=2)
    rate = _acceptance(arrays)
    integral = float(state.integrate(Grid(np.ones(2), 150, sym=False)))
    ent = arrays["entropy"]
    print(f"fluidpaper: acceptance {rate:.4f}, grid integral on [0,1]^2 "
          f"{integral:.5f}, entropy {ent[0]:.6f} -> {ent[-1]:.6f} (drift "
          f"{ent[-1] - ent[0]:+.3e}; the field is divergence-free)")
    if not (0.05 < rate < 0.95 and abs(integral - 1.0) < 0.05):
        fail("fluidpaper: acceptance or mass conservation off")


def phase_doublewell():
    state, arrays, _ = _drive(["doubleWell"], "doubleWell", 20, dim=2)
    rate = _acceptance(arrays)
    scale = float(state.sampler.rw_scale)
    print(f"doubleWell: acceptance {rate:.4f}, adapted rw_scale {scale:.4f} "
          f"(preset 0.8, target acceptance 0.234)")
    if not 0.05 < rate < 0.95:
        fail(f"doubleWell acceptance {rate}")


def _syrk_operands(flow, theta, eq, dirs, gen, n, check_persample=False):
    """(O - mean O, E_loc - mean E_loc) of n fresh draws from the
    per-sample kernel's plain mode: the direct path's centered operands,
    and chunk 0 of the chunked path's (its shifts are chunk 0's means)."""
    params = flow.layout.unravel(theta)
    x, _ = flow.push(params, flow.latent_sample(gen, params, n,
                                                torch.float32))
    if check_persample:
        _persample_vs_plain(flow, theta, x, dirs, "syrk chunk")
    _, g, quad, O = persample.per_sample_cuda(flow, theta, x, dirs)
    eloc = eq.eloc(x, g, quad, 0.0)
    return O - O.mean(0), eloc - eloc.mean()


def _syrk_vs_plain(O_c, cases):
    """syrk_cuda against syrk_plain for each (label, w, tol); returns the
    largest abs error."""
    n, P = O_c.shape
    max_abs = 0.0
    for label, w, tol in cases:
        got = syrk.syrk_cuda(O_c, w)
        ref = syrk.syrk_plain(O_c, w)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        asym = float((got - got.T).abs().max()) / scale
        print(f"syrk kernel vs plain at N={n}, P={P}, {label}: max abs err "
              f"{err:.3e}, relative to the largest entry {err / scale:.3e} "
              f"(tol {tol:.0e}); relative asymmetry {asym:.3e}")
        if not err <= tol * scale:
            fail(f"syrk kernel disagrees with its plain version at N={n} "
                 f"({label})")
        max_abs = max(max_abs, err)
        del got, ref
    return max_abs


def phase_syrk(dev, theta):
    """The syrk kernel on the operands the syrk paths give it, at the theta
    the main path ends on: the direct path's centered O at N=16384 with
    the signed weight E_loc - mean (timed there), and one chunk of the
    chunked path at N=65536 with the weights es and es^2, after the
    plain-mode per-sample kernel that makes the chunk is held against its
    plain version at that N."""
    flow, _, _, eq, dirs = _fp32_problem(dev)
    theta = theta.to(device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(4)
    O_c, e_c = _syrk_operands(flow, theta, eq, dirs, gen, 65536,
                              check_persample=True)
    max_abs = _syrk_vs_plain(O_c, (("chunk, unweighted", None, 2e-5),
                                   ("chunk, signed weight es", e_c, 3e-5),
                                   ("chunk, weight es^2", e_c**2, 3e-5)))
    shapes = {"chunk N=65536": _syrk_timed(lambda: syrk.syrk_cuda(O_c), 3,
                                           bounds.syrk(*O_c.shape),
                                           "the chunk, N=65536")}
    del O_c, e_c
    n = 16384
    O_c, e_c = _syrk_operands(flow, theta, eq, dirs, gen, n)
    max_abs = max(max_abs, _syrk_vs_plain(
        O_c, (("unweighted", None, 2e-5),
              ("signed weight E_loc - mean", e_c, 3e-5))))
    P = O_c.shape[1]
    shapes["weighted N=16384"] = _syrk_timed(
        lambda: syrk.syrk_cuda(O_c, e_c), 10, bounds.syrk(n, P, True),
        f"N={n} with the signed weight")
    ms = _time_ms(lambda: syrk.syrk_cuda(O_c), 10)
    plain_ms = _time_ms(lambda: syrk.syrk_plain(O_c), 5)
    lib_ms = _time_ms(lambda: torch.mm(O_c.T, O_c), 5)
    bound = bounds.syrk(n, P)
    print(f"syrk at N={n}, P={P}: CUDA kernel {ms:.3f} ms, plain split "
          f"products {plain_ms:.3f} ms, torch.mm f32 (TF32 off) "
          f"{lib_ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]}), share "
          f"{bound[0] / ms:.3f}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms,
                share_of_bound=bound[0] / ms, shapes=shapes)


def _syrk_timed(fn, reps, bound, label):
    """syrk's time at one more shape, with its bound and share."""
    ms = _time_ms(fn, reps)
    print(f"syrk at {label}: CUDA kernel {ms:.3f} ms, bound {bound[0]:.3f} "
          f"ms ({bound[1]}), share {bound[0] / ms:.3f}")
    return dict(ms=ms, bound_ms=bound[0], bound_by=bound[1],
                share_of_bound=bound[0] / ms)


def phase_syrk_paths(theta):
    """fokkerPlanck32 with --gram-backend syrk: the direct path with exact
    launch counts, its statistics against the f32 Gram's, and the chunked
    path with exact launch counts."""
    n_steps = 5
    _, _, counts = _drive(["fokkerPlanck32", "--gram-backend", "syrk"],
                          "fokkerPlanck32 N=16384 syrk", n_steps)
    want = n_steps * 2 * 2  # S0 and A per RHS
    if counts["syrk"] != want or counts["persample"] != n_steps * 2:
        fail(f"syrk path launches {counts}, expected {want} syrk")
    direct_launches = counts["syrk"]

    n = 16384
    out = {}
    for backend in ("syrk", "auto"):
        cfg = preset("fokkerPlanck32", device="cuda", gram_backend=backend)
        state, tdvp = driver.build_problem(cfg)[:2]
        theta_c = theta.to(device=state.device, dtype=torch.float32)
        params = state.flow.layout.unravel(theta_c)
        gen = torch.Generator(device=state.device).manual_seed(8)
        x, _ = state.flow.push(params, state.flow.latent_sample(
            gen, params, n, torch.float32))
        out[backend] = tdvp._direct_stats(theta_c, 0.0, x)
    for key in ("S0", "F0", "A"):
        full = out["auto"][key]
        rel = _rel(out["syrk"][key], full, full.abs().max())
        print(f"syrk vs f32 Gram {key} at N={n}: max abs diff / max "
              f"{rel:.3e} (tol 1e-4)")
        if not rel <= 1e-4:
            fail(f"syrk {key} differs from the f32 Gram's: {rel}")
    del out

    n_steps, n, c = 2, 131072, 65536
    _, _, counts = _drive(
        ["fokkerPlanck32", "--samples", str(n), "--chunk-size", str(c),
         "--gram-backend", "syrk"],
        f"fokkerPlanck32 N={n} chunked syrk", n_steps)
    chunks = n_steps * 2 * (n // c)
    if counts["syrk"] != 3 * chunks or counts["persample"] != chunks:
        fail(f"chunked syrk launches {counts}, expected {3 * chunks} syrk "
             f"and {chunks} per-sample")
    return direct_launches



def _student_problem(dev):
    """fokkerPlanck32's flow with the Student-t latent and the global
    affine in every block (P=9397): the preset's initial theta, and a
    perturbed one with nu = 2.5 and g_scale 0.9, 1.1, 0.95, 1.05."""
    cfg = preset("fokkerPlanck32")
    flow, theta0 = build_flow(cfg.seed, cfg.dim, depth=cfg.depth,
                              hidden=cfg.hidden_resolved(),
                              variant=cfg.variant, global_affine=True,
                              latent_name="Student_t",
                              out_scale=cfg.init_scale, dtype=torch.float32,
                              device=dev)
    lay = flow.layout
    if lay.size != 9397:
        fail(f"the Student-t fokkerPlanck32 flow has P={lay.size}, "
             f"expected 9397")
    perturbed = perturb_theta(flow, theta0, np.random.default_rng(0),
                              out_scale=0.03)
    perturbed[lay.offset(("latent", "dist_params"))] = math.log(1.5)
    for b, g in enumerate((0.9, 1.1, 0.95, 1.05)):
        perturbed[lay.offset(("blocks", b, "g_scale"))] = g
    eq = make_equation(cfg.equation, cfg.dim, **cfg.equation_params)
    dirs = torch.as_tensor(eq.hessian_trace_dirs(cfg.dim),
                           dtype=torch.float32, device=dev)
    return flow, theta0, perturbed, dirs


def phase_student_kernel(dev):
    """Phase A: the kernel's Student-t and global-affine branches against
    the plain version at full width, plain and split mode, on the preset's
    initial theta (to TOL) and the perturbed one (to plain f32's own error
    sample by sample, _grade_ok); timed at the main paths' N; then the
    kernel on diffusion_anisotropic's flow with its dense trace
    directions."""
    flow, theta0, perturbed, dirs = _student_problem(dev)
    gen = torch.Generator(device=dev).manual_seed(10)
    P, d, k = flow.layout.size, flow.dim, dirs.shape[0]
    n_ga = bounds.flow_ga(flow)
    out = {}
    max_abs = 0.0
    for label, theta, n in (("Student-t perturbed", perturbed, 1024),
                            ("Student-t perturbed", perturbed, 1000),
                            ("Student-t perturbed", perturbed, 16384),
                            ("Student-t initial", theta0, 16384)):
        params = flow.layout.unravel(theta)
        x, _ = flow.push(params, flow.latent_sample(gen, params, n,
                                                    torch.float32))
        max_abs = max(max_abs, _persample_vs_plain(
            flow, theta, x, dirs, label, grade="perturbed" in label))
    ms = _time_ms(lambda: persample.per_sample_cuda(flow, theta, x, dirs), 20)
    plain_ms = _time_ms(
        lambda: persample.per_sample_plain(flow, theta, x, dirs), 3)
    bound = bounds.persample(bounds.flow_layers(flow), d, P, n, k, n_ga=n_ga)
    print(f"per-sample, Student-t + global affine, at N={n}, P={P}: CUDA "
          f"kernel {ms:.3f} ms, plain torch.func {plain_ms:.3f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]}), share {bound[0] / ms:.4f}")
    xp = x[:PILOT_N].contiguous()
    pilot_ms = _time_ms(
        lambda: persample.per_sample_cuda(flow, theta, xp, dirs), 20)
    pilot_bound = bounds.persample(bounds.flow_layers(flow), d, P, PILOT_N,
                                   k, n_ga=n_ga)[0]
    print(f"per-sample, Student-t + global affine, at the pilot's "
          f"N={PILOT_N}: CUDA kernel {pilot_ms:.4f} ms, bound "
          f"{pilot_bound:.4f} ms, share {pilot_bound / pilot_ms:.4f}")
    out["persample"] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound[0], bound_by=bound[1], P=P, N=n,
                            share_of_bound=bound[0] / ms,
                            pilot_ms=pilot_ms, pilot_bound_ms=pilot_bound)

    max_abs = 0.0
    for label, theta, n in (("Student-t perturbed", perturbed, 1024),
                            ("Student-t perturbed", perturbed, 1000),
                            ("Student-t initial", theta0, 65536)):
        params = flow.layout.unravel(theta)
        x, _ = flow.push(params, flow.latent_sample(gen, params, n,
                                                    torch.float32))
        _, shift, err = _split_vs_plain(flow, theta, x, dirs, label,
                                        grade="perturbed" in label)
        max_abs = max(max_abs, err)
    ms = _time_ms(lambda: persample.per_sample_split_cuda(
        flow, theta, x, dirs, shift), 10)
    plain_ms = _time_ms(lambda: persample.per_sample_split_plain(
        flow, theta, x, dirs, shift), 2)
    bound = bounds.persample(bounds.flow_layers(flow), d, P, n, k,
                             split=True, n_ga=n_ga)
    print(f"split per-sample, Student-t + global affine, at N={n}, P={P}: "
          f"CUDA kernel {ms:.3f} ms, plain torch.func + split "
          f"{plain_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}), share "
          f"{bound[0] / ms:.4f}")
    out["persample_split"] = dict(max_abs_err=max_abs, ms=ms,
                                  plain_ms=plain_ms, bound_ms=bound[0],
                                  bound_by=bound[1], P=P, N=n,
                                  share_of_bound=bound[0] / ms)
    del x

    acfg = preset("diffusion_anisotropic")
    aflow, atheta = build_flow(acfg.seed, acfg.dim, depth=acfg.depth,
                               hidden=acfg.hidden_resolved(),
                               variant=acfg.variant,
                               out_scale=acfg.init_scale,
                               dtype=torch.float32, device=dev)
    if aflow.layout.size != 762:
        fail(f"diffusion_anisotropic has P={aflow.layout.size}, "
             f"expected 762")
    aeq = make_equation(acfg.equation, acfg.dim, **acfg.equation_params)
    adirs = torch.as_tensor(aeq.hessian_trace_dirs(acfg.dim),
                            dtype=torch.float32, device=dev)
    aperturbed = perturb_theta(aflow, atheta, np.random.default_rng(1),
                               out_scale=0.03)
    for label, theta in (("anisotropic initial", atheta),
                         ("anisotropic perturbed", aperturbed)):
        params = aflow.layout.unravel(theta)
        x, _ = aflow.push(params, aflow.latent_sample(gen, params, 16384,
                                                      torch.float32))
        _persample_vs_plain(aflow, theta, x, adirs, label,
                            grade="perturbed" in label)
    return out


def phase_student_path():
    """Phase B: fokkerPlanck32 with the Student-t latent and the global
    affine through driver.run at N=16384: one plain-mode launch per RHS,
    no NaN, residual below 1e-3; nu per step."""
    n_steps = 4
    cfg = preset("fokkerPlanck32", latent_name="Student_t",
                 global_affine=True, device="cuda")
    state, arrays, counts = _drive(
        None, "fokkerPlanck32 Student-t + global affine N=16384", n_steps,
        cfg=cfg)
    if counts["persample"] != 2 * n_steps:
        fail(f"the Student-t path launched the per-sample kernel "
             f"{counts['persample']} times, expected {2 * n_steps}")
    nu = np.exp(arrays["dist_params"][:, 0]) + 1.0
    print(f"fokkerPlanck32 Student-t: nu per step "
          f"{' '.join(f'{v:.7f}' for v in nu)}")
    return state, counts


def _crn_entropy(n=65536, seed=123):
    """(values, callback): the flow's entropy -E[log p] in f64 on common
    random numbers (the same generator seed every step), so that its
    change from step to step is the model's, free of Monte Carlo noise."""
    values = []

    def cb(n_step, t, state, info):
        theta = state.theta.double()
        params = state.flow.layout.unravel(theta)
        gen = torch.Generator(device=theta.device).manual_seed(seed)
        z = state.flow.latent_sample(gen, params, n, torch.float64)
        values.append(float(-state.flow.push(params, z)[1].mean()))

    return values, cb


def phase_diffusion():
    """Phase C: the d=8 Student-t diffusion preset through the CLI with
    the per-sample kernel (P=365: auto would leave it on torch), 20 steps:
    exactly one plain-mode launch per RHS (direct statistics, the
    observables on the same batch), no NaN, residual below 1e-3, the
    entropy on common random numbers rising every step; then 10 steps with
    --is-gamma 0.5 (one launch per RHS; observables resample without the
    kernel) and the IS weights' effective sample share."""
    n_steps = 20
    ent, cb = _crn_entropy()
    _, arrays, counts = _drive(["diffusion", "--per-sample-backend", "cuda"],
                               "diffusion (d=8, Student-t) N=10000", n_steps,
                               dim=8, callbacks=[cb])
    if counts["persample"] != 2 * n_steps:
        fail(f"diffusion launched the per-sample kernel "
             f"{counts['persample']} times, expected {2 * n_steps}")
    rise = np.diff(ent)
    nu = np.exp(arrays["dist_params"][:, 0]) + 1.0
    print(f"diffusion: f64 entropy on common random numbers (N=65536) "
          f"{ent[0]:.9f} -> {ent[-1]:.9f}, smallest step-to-step rise "
          f"{rise.min():.3e}; nu {nu[0]:.7f} -> {nu[-1]:.7f}; recorded MC "
          f"entropy {arrays['entropy'][0]:.5f} -> {arrays['entropy'][-1]:.5f}")
    if not (rise > 0).all():
        fail(f"diffusion entropy did not rise every step: {rise}")
    launches = counts["persample"]

    n_is = 10
    _, arrays, counts = _drive(
        ["diffusion", "--per-sample-backend", "cuda", "--is-gamma", "0.5"],
        "diffusion --is-gamma 0.5", n_is, dim=8)
    if counts["persample"] != 2 * n_is:
        fail(f"diffusion --is-gamma launched the per-sample kernel "
             f"{counts['persample']} times, expected {2 * n_is}")
    ess = arrays["is_ess_share"]
    print(f"diffusion --is-gamma 0.5: IS effective sample share per step "
          f"{' '.join(f'{v:.4f}' for v in ess)}")
    if not ((ess > 0) & (ess <= 1)).all():
        fail(f"IS effective sample share out of (0, 1]: {ess}")
    return launches


def phase_anisotropic_and_oscillators():
    """Phase D: diffusion_anisotropic in f64 (the torch pipeline; the
    kernel is f32 only) against Sigma(t) = I + 2 t D and the entropy
    1/2 log det(2 pi e Sigma(t)); then harmonicOsc and harmonicOsc_diff
    for 20 steps each."""
    n_steps = 50
    cfg = preset("diffusion_anisotropic", precision="f64", device="cuda",
                 verbose=False)
    _, a, _ = _drive(None, "diffusion_anisotropic f64 N=10000", n_steps,
                     dim=12, cfg=cfg)
    D = make_equation("diffusion_anisotropic", 12).D_matrix
    t, N = a["times"][-1], cfg.n_samples_obs
    sigma = np.eye(12) + 2.0 * t * D
    cov_err = np.abs(a["covar"][-1] - sigma).max()
    # Gaussian sample covariance: Var(S_ij) = (S_ii S_jj + S_ij^2) / N;
    # Var(-log p) = d/2 for a Gaussian
    se_cov = math.sqrt(float((np.outer(np.diag(sigma), np.diag(sigma))
                              + sigma**2).max()) / N)
    ent = 0.5 * np.linalg.slogdet(2 * math.pi * math.e * sigma)[1]
    ent_err = abs(a["entropy"][-1] - ent)
    se_ent = math.sqrt(6.0 / N)
    print(f"diffusion_anisotropic f64 at t={t:.4f} (D's eigenvalues "
          f"{np.linalg.eigvalsh(D).min():.3f}..{np.linalg.eigvalsh(D).max():.3f}"
          f"): covar max abs err {cov_err:.4f} (5 SE {5 * se_cov:.4f}), "
          f"entropy {a['entropy'][-1]:.5f} vs {ent:.5f} (5 SE "
          f"{5 * se_ent:.4f}), solver_res {a['solver_res'][-1]:.3e}")
    if not (t > 0.05 and cov_err < 5 * se_cov and ent_err < 5 * se_ent):
        fail("diffusion_anisotropic misses Sigma(t) = I + 2 t D")

    state, a, _ = _drive(["harmonicOsc"], "harmonicOsc", 20, dim=2)
    ent = math.log(2 * math.pi * math.e)  # the initial N(offset, I)
    se = math.sqrt(1.0 / preset("harmonicOsc").n_samples_obs)
    drift = np.abs(a["entropy"] - ent).max()
    integral = float(state.integrate(Grid(np.ones(2) * 8.0, 200)))
    print(f"harmonicOsc: entropy {a['entropy'][0]:.5f} -> "
          f"{a['entropy'][-1]:.5f}, largest distance from log(2 pi e) "
          f"{drift:.4f} (5 SE {5 * se:.4f}; Liouville transport conserves "
          f"it), grid integral on [-8, 8]^2 {integral:.5f}")
    if not (drift < 5 * se and abs(integral - 1.0) < 0.05):
        fail("harmonicOsc: entropy not conserved or mass lost")
    _drive(["harmonicOsc_diff"], "harmonicOsc_diff", 20, dim=6)


def _time_all_reduces(log):
    """Time every torch.distributed.all_reduce (what parallel/mesh.py
    calls) between two device synchronizations, with its bytes: ``log``
    accumulates "s" and "bytes"."""
    plain = dist.all_reduce

    def timed(tensor, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain(tensor, *args, **kw)
        torch.cuda.synchronize()
        log["s"] += time.perf_counter() - t0
        log["bytes"] += tensor.numel() * tensor.element_size()
        return out

    dist.all_reduce = timed


def _rank_drive(cfg, n_steps, label, log):
    """``driver.run`` of this rank for n_steps with every count set to 0
    just before: the counts just after, each step's wall time and its
    all-reduce seconds and bytes, and whether theta was bitwise the
    coordinator's after every step (checked outside the step's time)."""
    stamps, starts, ar_s, ar_bytes, same = [], [], [], [], []

    def record(n_step, t, state, info):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        ar_s.append(log["s"])
        ar_bytes.append(log["bytes"])
        theta = state.get_parameters()
        same.append(bool(torch.equal(
            theta, mesh.broadcast_from_coordinator(theta))))
        torch.cuda.synchronize()
        log.update(s=0.0, bytes=0)
        starts.append(time.perf_counter())

    _zero_counts()
    log.update(s=0.0, bytes=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, rec = driver.run(cfg, max_steps=n_steps, callbacks=[record])
    counts = _counts()
    steps = np.array(stamps) - np.array([t0] + starts[:-1])
    a = rec.as_arrays()
    for key in ("solver_res", "tdvp_error", "entropy", "covar", "x1"):
        if not np.isfinite(a[key]).all():
            fail(f"non-finite {key} in the {label} run")
    if a["nan"].any() or not (a["solver_res"] < 1e-3).all():
        fail(f"{label}: NaN or residual above 1e-3: {a['solver_res']}")
    if not all(same) or len(same) != n_steps:
        fail(f"{label}: theta differs across ranks after a step: {same}")
    if mesh.is_coordinator():
        print(f"[mesh] {label}: {n_steps} Heun steps per rank, wall s/step "
              f"{' '.join(f'{v:.3f}' for v in steps)} (first includes "
              f"set-up), all-reduce s/step "
              f"{' '.join(f'{v:.3f}' for v in ar_s)} (gloo through the host, "
              f"{ar_bytes[-1] / 2 / 1e6:.1f} MB per RHS), share of steps "
              f"2-{n_steps} {sum(ar_s[1:]) / steps[1:].sum():.3f}; "
              f"solver_res {' '.join(f'{r:.3e}' for r in a['solver_res'])};"
              f" launches on rank 0 {counts}", flush=True)
    return state, dict(step_s=steps.tolist(), all_reduce_s=ar_s,
                       all_reduce_bytes_per_rhs=ar_bytes[-1] / 2,
                       counts=counts)


def _sharded_vs_one_rank(ctx, cfg, ref_cfg, theta, n, label):
    """The mesh's statistics on one batch (this rank's rows of a global
    draw) against one rank's on the whole batch, computed by the
    coordinator (``ref_cfg``): S0, F0 and A within 1e-4 of each one's
    largest value."""
    state, tdvp = driver.build_problem(cfg)[:2]
    chunked = cfg.chunk_size > 0
    theta_c = theta.to(device=ctx.device, dtype=torch.float32)
    params = state.flow.layout.unravel(theta_c)
    gen = torch.Generator(device=ctx.device).manual_seed(7)
    z = state.flow.latent_sample(gen, params, n, torch.float32)
    x_loc = state.flow.push(params, ctx.local_rows(z))[0]
    fn = tdvp._chunked_stats if chunked else tdvp._direct_stats
    st = fn(theta_c, 0.0, x_loc)
    del tdvp, x_loc
    out = {}
    torch.cuda.synchronize()
    if ctx.rank == 0:
        one = ParallelCtx.single_device(ctx.device)
        rtdvp = driver.build_problem(ref_cfg, ctx=one)[1]
        x = state.flow.push(params, z)[0]
        ref = (rtdvp._chunked_stats if chunked
               else rtdvp._direct_stats)(theta_c, 0.0, x)
        for key in ("S0", "F0", "A"):
            out[key] = _rel(st[key], ref[key], ref[key].abs().max())
        print(f"[mesh] {label} vs one rank's f32 statistics on the same "
              f"N={n} draws: " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in out.items())
              + " (max abs diff / max, tol 1e-4)", flush=True)
        if not all(v <= 1e-4 for v in out.values()):
            fail(f"{label} differs from one rank's statistics: {out}")
        del rtdvp, ref, x
    del st
    torch.cuda.synchronize()
    mesh.sync_global_devices()
    return out


def _coordinator_times(ctx, fns):
    """Time each (label, fn, reps) on the coordinator while the other
    ranks wait at a barrier with an idle card; {label: ms}."""
    torch.cuda.synchronize()
    out = {}
    if ctx.rank == 0:
        out = {label: _time_ms(fn, reps) for label, fn, reps in fns}
    mesh.sync_global_devices()
    return out


def phase_mesh_stats(ctx, log):
    """Phase 19 on this rank: (a) direct and (b) chunked shard_map
    statistics through driver.run, each against one rank on one batch;
    (c) per_sample_sharded against its plain version, timed, and the GSPMD
    counterpart through driver.run."""
    W = ctx.world
    base = dict(device="cuda", mesh_dp=W, verbose=False)
    n_steps = 3
    cfg = preset("fokkerPlanck32", stats_partitioning="shard_map", **base)
    state, direct = _rank_drive(cfg, n_steps, "19a fokkerPlanck32 N=16384 "
                                "shard_map direct", log)
    if direct["counts"]["persample"] != 2 * n_steps:
        fail(f"19a: plain-mode launches {direct['counts']} on rank "
             f"{ctx.rank}, expected {2 * n_steps}")
    theta = state.get_parameters()
    direct["vs_one_rank"] = _sharded_vs_one_rank(
        ctx, cfg, preset("fokkerPlanck32", device="cuda"), theta, 16384,
        "19a direct, 4 ranks")
    del state

    n_steps, n, c = 2, 262144, 65536
    over = dict(n_samples_tdvp=n, n_samples_obs=n, chunk_size=c)
    cfg = preset("fokkerPlanck32", stats_partitioning="shard_map",
                 gram_backend="tri2", gram_cross="int8", **over, **base)
    _, chunked = _rank_drive(cfg, n_steps, "19b fokkerPlanck32 N=262144 "
                             "chunk 65536 shard_map tri2+int8", log)
    local_chunks = (n // W) // (c // W)
    want = n_steps * 2 * local_chunks
    got = chunked["counts"]
    if (got["persample_split"] != want or got["quant8"] != 2 * want
            or got["persample"] != n_steps * 2):
        fail(f"19b: launches {got} on rank {ctx.rank}, expected {want} "
             f"split, {2 * want} quant8, {n_steps * 2} pilot")
    chunked["vs_one_rank"] = _sharded_vs_one_rank(
        ctx, cfg, preset("fokkerPlanck32", device="cuda", **over), theta, n,
        "19b chunked tri2+int8, 4 ranks")

    # (c) the sharded per-sample wrapper on a rank's rows at the preset's
    # theta, against its plain version, then timed
    flow, theta0, _, eq, dirs = _fp32_problem(ctx.device)
    params = flow.layout.unravel(theta0)
    gen = torch.Generator(device=ctx.device).manual_seed(11)
    x_loc = ctx.local_rows(flow.push(params, flow.latent_sample(
        gen, params, 16384, torch.float32))[0])
    got = persample.per_sample_sharded(ctx, flow, theta0, x_loc, dirs)
    ref = persample.per_sample_plain(flow, theta0.double(), x_loc.double(),
                                     dirs.double())
    max_abs = float((got[3].double() - ref[3]).abs().max())
    for name, a, r in zip(("logp", "g", "quad", "O"), got, ref):
        rel = _rel(a, r)
        if not rel < TOL[name]:
            fail(f"per_sample_sharded {name} on rank {ctx.rank}: {rel:.3e}")
    del got, ref
    ms = _coordinator_times(ctx, [
        ("ms", lambda: persample.per_sample_cuda(flow, theta0, x_loc,
                                                 dirs), 20),
        ("plain_ms", lambda: persample.per_sample_plain(flow, theta0, x_loc,
                                                        dirs), 3)])
    P, d, k = flow.layout.size, flow.dim, dirs.shape[0]
    bound = bounds.persample(bounds.flow_layers(flow), d, P,
                             x_loc.shape[0], k)
    del x_loc
    n_steps = 2
    cfg = preset("fokkerPlanck32", eloc_clip=2.0, **base)
    _, gspmd = _rank_drive(cfg, n_steps, "19c fokkerPlanck32 N=16384 GSPMD "
                           "counterpart, eloc_clip=2", log)
    if gspmd["counts"]["persample_sharded"] != 2 * n_steps:
        fail(f"19c: sharded per-sample launches {gspmd['counts']} on rank "
             f"{ctx.rank}, expected {2 * n_steps}")
    kernel = dict(max_abs_err=max_abs, bound_ms=bound[0], bound_by=bound[1],
                  launches=gspmd["counts"]["persample_sharded"],
                  rows_per_rank=16384 // W, **ms)
    if ctx.rank == 0:
        kernel["share_of_bound"] = bound[0] / ms["ms"]
        print(f"[mesh] per_sample_sharded on a rank's {16384 // W} rows, "
              f"P={P}: max abs err of O {max_abs:.3e}; CUDA kernel "
              f"{ms['ms']:.3f} ms, plain torch.func {ms['plain_ms']:.3f} "
              f"ms, bound {bound[0]:.4f} ms ({bound[1]}), share "
              f"{bound[0] / ms['ms']:.4f}, the other ranks idle",
              flush=True)
    return dict(direct=direct, chunked=chunked, gspmd=gspmd), kernel


def phase_mesh_metropolis(ctx):
    """Phase 20 on this rank: the sharded Metropolis kernel against its
    plain version and, gathered, against the single launch; timed; then
    VarState.sample on the mesh."""
    W, dev = ctx.world, ctx.device
    C = 8192
    C_loc = C // W
    base = ctx.rank * C_loc
    max_abs = 0.0
    # 128 sweeps, the VarState.sample launch; 136, a last chunk of 8
    for sweeps in (128, 136):
        init_all, u, outside = _metropolis_inputs(dev, C, sweeps)
        init = ctx.local_rows(init_all)
        u_loc = u.reshape(6, sweeps, C)[:, :, base:base + C_loc].reshape(
            6, -1)
        for label, uu, uu_loc in (("external uniforms", u, u_loc),
                                  ("Philox", None, None)):
            s, f, acc = metropolis.metropolis_chain_sharded(
                ctx, 5, init, sweeps, 0.25, BUMP_OFFSET, uu)
            ps, pf, pacc = metropolis.metropolis_chain_plain(
                5, init, sweeps, 0.25, BUMP_OFFSET, uu_loc, chain_base=base)
            (pacc,) = mesh.all_reduce_sum(ctx, [pacc])
            err = max(float((s - ps).abs().max()),
                      float((f - pf).abs().max()))
            stuck = s.reshape(sweeps, C_loc, 2)[:8, ctx.local_rows(outside)]
            rejected = uu is None or torch.equal(
                stuck, init[ctx.local_rows(outside)].expand_as(stuck))
            if int(acc) != int(pacc) or not err <= 2e-6 or not rejected:
                fail(f"metropolis_chain_sharded ({label}, {sweeps} sweeps) "
                     f"on rank {ctx.rank}: accepted {int(acc)} vs plain "
                     f"{int(pacc)}, max abs err {err:.3e}, rim proposals "
                     f"outside the support rejected: {rejected}")
            max_abs = max(max_abs, err)
            gathered = metropolis.gather_sweep_major(ctx, s, sweeps)
            final = mesh.all_gather_rows(ctx, f)
            if ctx.rank == 0:
                single = metropolis.metropolis_chain_cuda(
                    5, init_all, sweeps, 0.25, BUMP_OFFSET, uu)
                same = (torch.equal(gathered, single[0])
                        and torch.equal(final, single[1])
                        and int(acc) == int(single[2]))
                print(f"[mesh] metropolis_chain_sharded, {W} ranks x "
                      f"{C_loc} chains x {sweeps} sweeps, {label}: accepted "
                      f"{int(acc)} (single launch {int(single[2])}), "
                      f"gathered samples and final states bitwise the "
                      f"single launch's: {same}; each rank vs its plain "
                      f"version max abs err {err:.3e}", flush=True)
                if not same:
                    fail(f"the sharded Metropolis kernel ({label}) does not "
                         "replay the single launch")
    sweeps = 128
    init = ctx.local_rows(torch.tensor(BUMP_OFFSET, device=dev).repeat(C, 1))
    u_loc = u_loc[:, :sweeps * C_loc].contiguous()
    ms = _coordinator_times(ctx, [
        ("ms", lambda: metropolis.metropolis_chain_cuda(
            5, init, sweeps, 0.25, BUMP_OFFSET, chain_base=base), 20),
        ("ext_ms", lambda: metropolis.metropolis_chain_cuda(
            5, init, sweeps, 0.25, BUMP_OFFSET, u_loc, chain_base=base), 20),
        ("plain_ms", lambda: metropolis.metropolis_chain_plain(
            5, init, sweeps, 0.25, BUMP_OFFSET, u_loc, chain_base=base), 3)])
    bound = _metropolis_bound(C_loc * sweeps)
    bound_ext = _metropolis_bound(C_loc * sweeps, ext=True)

    cfg = preset("fluidpaper")
    flow, theta = build_flow(cfg.seed, cfg.dim, depth=cfg.depth,
                             hidden=cfg.hidden_resolved(),
                             variant=cfg.variant, latent_name=cfg.latent_name,
                             offset=cfg.offset, out_scale=cfg.init_scale,
                             dtype=torch.float32, device=dev)
    sampler = sampling.Sampler(2, cfg.latent_name, n_chains=C,
                               mcmc_info={"offset": np.asarray(cfg.offset),
                                          "bound": cfg.mcmc_bound}, ctx=ctx)
    state = VarState(flow, theta, sampler=sampler, ctx=ctx)
    n = 2**20
    _zero_counts()
    x, logp = state.sample(n, key=1)
    x2, _ = state.sample(n, key=2)
    counts = _counts()
    rate = sampler.last_info.acceptance_rate
    if (counts["metropolis_sharded"] != 2 or counts["metropolis"] != 2
            or x.shape != (n // W, 2) or not torch.isfinite(x).all()
            or not torch.isfinite(logp).all() or not 0.05 < rate < 0.95):
        fail(f"VarState.sample on the mesh, rank {ctx.rank}: launches "
             f"{counts}, shard {tuple(x.shape)}, acceptance {rate}")
    if ctx.rank == 0:
        print(f"[mesh] per-rank Metropolis launch, {C_loc} chains x "
              f"{sweeps} sweeps: Philox {ms['ms']:.4f} ms (bound "
              f"{bound[0]:.6f} ms, {bound[1]}, share "
              f"{bound[0] / ms['ms']:.4f}; without Philox's multiplies "
              f"{bound[2]:.6f} ms, share {bound[2] / ms['ms']:.4f}), "
              f"external uniforms {ms['ext_ms']:.4f} ms (bound "
              f"{bound_ext[0]:.6f} ms, share "
              f"{bound_ext[0] / ms['ext_ms']:.4f}), plain torch "
              f"{ms['plain_ms']:.3f} ms, the other ranks idle; "
              f"VarState.sample on the "
              f"mesh, 8192 chains: 2 x {n} samples, launches per rank "
              f"{counts['metropolis_sharded']}, acceptance {rate:.4f}",
              flush=True)
    return dict(max_abs_err=max_abs, ms=ms["ms"] if ms else None,
                ext_ms=ms.get("ext_ms"), plain_ms=ms.get("plain_ms"),
                bound_ms=bound[0], bound_by=bound[1],
                bound_without_philox_ms=bound[2], ext_bound_ms=bound_ext[0],
                launches=counts["metropolis_sharded"],
                chains_per_rank=C_loc)


def _mesh_rank(rank, world, rendezvous, results):
    """One rank of phases 19 and 20 (a spawned process): its outcome goes
    to the ``results`` queue, a traceback on failure."""
    try:
        mesh.distributed_init(f"file://{rendezvous}", world, rank)
        ctx = ParallelCtx.create(dp=world, device="cuda")
        full_f32_matmuls()
        log = {"s": 0.0, "bytes": 0}
        _time_all_reduces(log)
        paths, ps_kernel = phase_mesh_stats(ctx, log)
        mc_kernel = phase_mesh_metropolis(ctx)
        results.put((rank, True, dict(paths=paths, persample_sharded=ps_kernel,
                                      metropolis_sharded=mc_kernel)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def phase_mesh():
    """Phases 19 and 20: MESH_WORLD rank processes on the one card (spawn:
    CUDA is initialized here; the kernels are built, the ranks only load
    them); each rank's outcome, rank 0's first. A rank that fails or
    outlives the time limit fails the phase, and every rank is stopped."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    spawn = multiprocessing.get_context("spawn")
    results = spawn.Queue()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    procs = [spawn.Process(target=_mesh_rank, args=(
        r, MESH_WORLD, os.path.join(tmp, "rendezvous"), results))
        for r in range(MESH_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    out = {}
    try:
        deadline = time.monotonic() + 600
        while len(out) < MESH_WORLD:
            try:
                rank, ok, payload = results.get(
                    timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                fail("the mesh ranks did not finish within 600 s")
            if not ok:
                fail(f"mesh rank {rank} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phases 19-20: {MESH_WORLD} ranks in "
          f"{time.perf_counter() - t0:.1f} s")
    return [out[r] for r in range(MESH_WORLD)]


# The steppers' stages per step (or per attempt of the adaptive ones)
STAGES = {"fixed_euler": 1, "fixed_heun": 2, "fixed_rk3": 3,
          "adaptive_heun": 5, "adaptive_rk23": 4}


def _step_table(label, arrays):
    """Print each step's t, dt, attempts, error and residual."""
    att = arrays.get("attempts", np.ones(len(arrays["times"]), int))
    err = arrays.get("step_error", np.full(len(arrays["times"]), np.nan))
    for i, t in enumerate(arrays["times"]):
        print(f"{label} step {i}: t {t:.6e} dt {arrays['dt'][i]:.6e} "
              f"attempts {int(att[i])} error {err[i]:.4e} solver_res "
              f"{arrays['solver_res'][i]:.3e}")
    return [int(a) for a in att]


def _matfree_pass_ms(args, reps=10):
    """(matrix-free pass ms, one per-sample launch ms) on a path: one rhs()
    at the preset's initial theta stashes the last stage's samples (and O
    on the direct path), then v^T SExp v for a random v is timed with CUDA
    events, beside the plain-mode kernel at the path's (chunk) batch."""
    cfg = preset(args["preset"], device="cuda", **args["over"])
    state, tdvp = driver.build_problem(cfg)[:2]
    theta = state.get_parameters()
    tdvp.rhs(theta, 0.0, 11)
    v = torch.randn(tdvp.n_params, device=state.device,
                    generator=torch.Generator(
                        device=state.device).manual_seed(12))
    ms = _time_ms(lambda: tdvp.sexp_norm(v), 5 * reps)
    x = tdvp._sexp_ctx[1]
    c = tdvp.cfg.chunk_size or x.shape[0]
    ps_ms = _time_ms(lambda: persample.per_sample_cuda(
        state.flow, state.theta, x[:c], tdvp._hess_dirs), reps)
    return ms, ps_ms


def phase_steppers():
    """G: fokkerPlanck32 at N=16384 (cholesky, so the adaptive S metric is
    the matrix-free one on the kept O) with every stepper but the fixed
    Heun of phase 5, 3 steps each: exactly stages x attempts plain-mode
    launches, each step's attempts, dt, error and residual; adaptive Heun
    once more at a tolerance that rejects the first attempt; the
    matrix-free pass timed beside one per-sample launch."""
    out = {}
    for name in ("fixed_euler", "fixed_rk3", "adaptive_heun",
                 "adaptive_rk23"):
        label = f"fokkerPlanck32 N=16384 {name}"
        t0 = time.perf_counter()
        _, arrays, counts = _drive(["fokkerPlanck32", "--stepper", name],
                                   label, 3)
        wall = time.perf_counter() - t0
        att = _step_table(label, arrays)
        want = STAGES[name] * sum(att)
        if counts["persample"] != want:
            fail(f"{label}: {counts['persample']} per-sample launches, "
                 f"expected {STAGES[name]} x {sum(att)} attempts")
        if name.startswith("adaptive") and not np.isfinite(
                arrays["step_error"]).all():
            fail(f"{label}: non-finite step error")
        out[name] = dict(launches=counts["persample"], attempts=att,
                         rhs_per_step=[STAGES[name] * a for a in att],
                         dt=arrays["dt"].tolist(),
                         step_error=arrays.get("step_error",
                                               np.array([])).tolist(),
                         wall_s=wall)
    # a tolerance below the ~1.1e-4 error of a first attempt at dt0 = 2e-3:
    # the first step rejects at least one attempt (the keys 5 * attempt +
    # stage, the chain state and the kept O of a discarded attempt) and
    # retries at a smaller dt
    label = "fokkerPlanck32 N=16384 adaptive_heun tol=2e-5"
    cfg = preset("fokkerPlanck32", device="cuda", stepper="adaptive_heun",
                 tol=2e-5)
    _, arrays, counts = _drive(None, label, 2, cfg=cfg)
    att = _step_table(label, arrays)
    if counts["persample"] != 5 * sum(att):
        fail(f"{label}: {counts['persample']} per-sample launches, "
             f"expected 5 x {sum(att)} attempts")
    if att[0] < 2 or not arrays["dt"][0] < cfg.dt0:
        fail(f"{label}: the first step took {att[0]} attempts and dt "
             f"{arrays['dt'][0]}; a retry at a dt below {cfg.dt0} expected")
    if not (np.isfinite(arrays["step_error"]).all()
            and (arrays["step_error"] <= cfg.tol).all()):
        fail(f"{label}: accepted errors {arrays['step_error']} above tol")
    out["adaptive_heun_retry"] = dict(
        launches=counts["persample"], attempts=att,
        dt=arrays["dt"].tolist(), step_error=arrays["step_error"].tolist())
    ms, ps_ms = _matfree_pass_ms(dict(preset="fokkerPlanck32", over=dict(
        stepper="adaptive_heun")))
    print(f"fokkerPlanck32 N=16384 matrix-free S metric (one product with "
          f"the kept O): {ms:.3f} ms, one per-sample launch {ps_ms:.3f} ms "
          f"(CUDA events)")
    out["matfree_ms"] = {"direct N=16384": ms}
    out["persample_ms"] = {"N=16384": ps_ms}
    return out


def phase_exact_t_end_and_dispatch(out):
    """G: --exact-t-end lands fokkerPlanck32 on t_end = 5e-3 (dt 2e-3,
    2e-3, then 1e-3); --steps-per-dispatch 3 against 1 on fixed_heun and
    adaptive_heun, 3 steps without verbose output (with it every step
    reads its residual and the NaN flag): theta bit for bit (else the
    largest difference is printed and the phase fails)."""
    _, arrays, _ = _drive(["fokkerPlanck32", "--t-end", "5e-3",
                           "--exact-t-end"], "fokkerPlanck32 exact_t_end",
                          3)
    end = float(arrays["times"][-1] + arrays["dt"][-1])
    print(f"fokkerPlanck32 --t-end 5e-3 --exact-t-end: {len(arrays['dt'])} "
          f"steps, dt {arrays['dt'].tolist()}, ends at {end!r}")
    if abs(end - 5e-3) > 1e-15 or (arrays["times"] >= 5e-3).any():
        fail(f"--exact-t-end ended at {end!r}, not on t_end 5e-3")
    out["exact_t_end"] = dict(dt=arrays["dt"].tolist(), end=end)
    for name in ("fixed_heun", "adaptive_heun"):
        thetas = {}
        for k in ("1", "3"):
            # no callbacks: _drive's waits for the card after every step
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, rec = driver.run(preset(
                "fokkerPlanck32", device="cuda", stepper=name,
                steps_per_dispatch=int(k), verbose=False), max_steps=3)
            torch.cuda.synchronize()
            arrays = rec.as_arrays()
            print(f"fokkerPlanck32 {name} --steps-per-dispatch {k}: 3 "
                  f"steps in {time.perf_counter() - t0:.3f} s, launches "
                  f"{_counts()['persample']}, solver_res "
                  f"{arrays['solver_res'].tolist()}")
            if arrays["nan"].any() or not (arrays["solver_res"]
                                           < 1e-3).all():
                fail(f"{name} --steps-per-dispatch {k}: NaN or residual")
            thetas[k] = (state.get_parameters(), arrays)
        (t1, a1), (t3, a3) = thetas["1"], thetas["3"]
        diff = float((t1 - t3).abs().max())
        same_rows = all(np.array_equal(a1[k], a3[k]) for k in a1)
        print(f"fokkerPlanck32 {name} --steps-per-dispatch 3 vs 1: theta "
              f"bitwise equal {torch.equal(t1, t3)} (largest difference "
              f"{diff:.3e}), recorded rows equal {same_rows}")
        if not (torch.equal(t1, t3) and same_rows):
            fail(f"{name}: --steps-per-dispatch 3 is not the K=1 run "
                 f"(theta differs by up to {diff})")
        out[f"dispatch_{name}"] = dict(theta_bitwise=True)
    out["host_waits"] = _host_waits()


def _host_waits():
    """The synchronizing CUDA operations inside one fused Heun pair and one
    fused adaptive-Heun attempt of fokkerPlanck32 at N=16384, and one Heun
    pair of the chunked tri2 + int8 statistics at N=131072, as torch's sync
    debug mode reports them (the attempt's error read by the stepper is
    outside); printed with where they come from."""
    state, tdvp = driver.build_problem(preset(
        "fokkerPlanck32", device="cuda", stepper="adaptive_heun"))[:2]
    chunked = driver.build_problem(preset(
        "fokkerPlanck32", device="cuda", n_samples_tdvp=131072,
        n_samples_obs=131072, chunk_size=65536, gram_backend="tri2",
        gram_cross="int8"))[1]
    theta = state.get_parameters()
    found = {}
    for label, call in (
            ("heun_pair", lambda: tdvp.heun_pair(theta, 0.0, 2e-3, 5)),
            ("heun_attempt", lambda: tdvp.heun_attempt(theta, 0.0, 2e-3, 5)),
            ("chunked heun_pair", lambda: chunked.heun_pair(
                theta, 0.0, 2e-3, 5))):
        found[label] = waits = _sync_sites(call)
        print(f"host waits inside one fused {label}: "
              f"{len(waits)} {sorted(set(waits))}")
    return found


def _sync_sites(call):
    """The file:line of every synchronizing CUDA operation in ``call()``
    (after a warm-up call), as torch's sync debug mode reports them."""
    call()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def phase_sexp_batch(theta, theta_student, out):
    """G: one batch at the theta phase 5 ends on, with the dense SExp: the
    direct statistics at N=16384 through syrk (weighted with logp^2) and
    the chunked ones at N=131072 in chunks of 65536 through tri2 + int8
    (the SExp moments from the split pair), each within 1e-4 of the f32
    Gram's on the same draws; the matrix-free v^T SExp v on the direct f32
    path against the dense one, within 1e-4 relative. Then the syrk SExp
    once more on the Student-t + global-affine flow at the theta phase 16
    ends on, where logp^2 is largest on the heavy tails."""
    res = {}
    student = dict(latent_name="Student_t", global_affine=True)
    for n, c, backends, theta, flow_over in (
            (16384, 0, ("syrk", "auto"), theta, {}),
            (131072, 65536, ("tri2", "auto"), theta, {}),
            (16384, 0, ("syrk", "auto"), theta_student, student)):
        sts = {}
        for backend in backends:
            over = dict(gram_cross="int8") if backend == "tri2" else {}
            cfg = preset("fokkerPlanck32", device="cuda", n_samples_tdvp=n,
                         n_samples_obs=n, chunk_size=c, gram_backend=backend,
                         **over, **flow_over)
            state, tdvp = driver.build_problem(cfg)[:2]
            tdvp = TDVP(state, tdvp.equation, dataclasses.replace(
                tdvp.cfg, compute_sexp=True, sexp_mode="matfree"),
                n_samples=n, n_samples_obs=n)
            theta_c = theta.to(device=state.device, dtype=torch.float32)
            params = state.flow.layout.unravel(theta_c)
            gen = torch.Generator(device=state.device).manual_seed(9)
            x, _ = state.flow.push(params, state.flow.latent_sample(
                gen, params, n, torch.float32))
            _zero_counts()
            fn = tdvp._chunked_stats if c else tdvp._direct_stats
            st = fn(theta_c, 0.0, x)
            torch.cuda.synchronize()
            sts[backend] = (st, _counts())
            if backend == "auto" and not c and not flow_over:
                v = torch.randn(tdvp.n_params, device=state.device,
                                generator=torch.Generator(
                                    device=state.device).manual_seed(10))
                quad = float(tdvp._sexp_quad(theta_c, x, st["logp"], None,
                                             st["O"], v))
                vd = v.double()
                dense = float(vd @ (st["SExp"].double() @ vd))
                rel = abs(quad - dense) / abs(dense)
                print(f"matrix-free v^T SExp v {quad:.9e} vs dense "
                      f"{dense:.9e} at N={n}: relative {rel:.3e} (tol 1e-4)")
                if not rel <= 1e-4:
                    fail(f"matrix-free S metric off the dense one by {rel}")
                res["matfree_vs_dense"] = rel
            del x
        full = sts["auto"][0]["SExp"]
        name = ("chunked tri2+int8" if c else
                "syrk Student-t + global affine" if flow_over else "syrk")
        got, counts = sts[backends[0]]
        rel = _rel(got["SExp"], full, full.abs().max())
        print(f"{name} SExp vs f32 Gram at N={n}: max abs diff / max "
              f"{rel:.3e} (tol 1e-4); launches {counts}")
        if not rel <= 1e-4:
            fail(f"{name} SExp differs from the f32 Gram's: {rel}")
        want = ({"syrk": 3} if not c else
                {"persample_split": n // c, "quant8": 2 * (n // c)})
        if any(counts[k] != v for k, v in want.items()):
            fail(f"{name} SExp batch launches {counts}, expected {want}")
        res[f"{name}_vs_f32"] = rel
        if not c and not flow_over:
            out.setdefault("launches", {})["syrk"] = counts["syrk"]
        del sts
    out["sexp_batch"] = res


def phase_steppers_production(out):
    """G: one adaptive_heun step at the production point (N=524288 in
    chunks of 65536, tri2 + int8; cholesky, so the matrix-free S metric
    re-makes O chunk by chunk with the plain-mode kernel): per attempt 5 x
    8 split and 5 x 16 quant8 launches, 5 pilots and 8 plain-mode launches
    for the metric; the matrix-free pass timed there."""
    n, c = 524288, 65536
    args = ["fokkerPlanck32", "--samples", str(n), "--chunk-size", str(c),
            "--gram-backend", "tri2", "--gram-cross", "int8", "--stepper",
            "adaptive_heun"]
    label = f"fokkerPlanck32 N={n} chunked tri2+int8 adaptive_heun"
    t0 = time.perf_counter()
    _, arrays, counts = _drive(args, label, 1)
    wall = time.perf_counter() - t0
    att = sum(_step_table(label, arrays))
    chunks = n // c
    want = {"persample_split": 5 * chunks * att,
            "quant8": 10 * chunks * att, "persample": (5 + chunks) * att}
    if any(counts[k] != v for k, v in want.items()):
        fail(f"{label}: launches {counts}, expected {want}")
    ms, ps_ms = _matfree_pass_ms(dict(preset="fokkerPlanck32", over=dict(
        n_samples_tdvp=n, n_samples_obs=n, chunk_size=c, gram_backend="tri2",
        gram_cross="int8", stepper="adaptive_heun")), reps=3)
    print(f"{label}: matrix-free S metric ({chunks} plain-mode launches of "
          f"{c} and their products) {ms:.3f} ms, one per-sample launch at "
          f"{c} {ps_ms:.3f} ms (CUDA events)")
    out["production_adaptive_heun"] = dict(
        attempts=att, launches={k: counts[k] for k in want}, wall_s=wall)
    out["matfree_ms"][f"chunked N={n}"] = ms
    out["persample_ms"][f"N={c}"] = ps_ms
    return counts


def phase_fluidpaper_adaptive(out):
    """G: fluidpaper with adaptive_heun (eigh: the dense SExp; the torch
    chain in every stage) for 3 steps: the recorded proposals are the
    budget x 5 stages x attempts, acceptance in (0.05, 0.95)."""
    _, arrays, _ = _drive(["fluidpaper", "--stepper", "adaptive_heun"],
                          "fluidpaper adaptive_heun", 3, dim=2)
    att = np.asarray(_step_table("fluidpaper adaptive_heun", arrays))
    n = driver.build_problem(preset("fluidpaper",
                                    device="cuda"))[1].n_samples
    rate = _acceptance(arrays)
    print(f"fluidpaper adaptive_heun: acceptance {rate:.4f}, proposals per "
          f"step {arrays['mcmc_proposed'].tolist()} for attempts "
          f"{att.tolist()}")
    if not (np.array_equal(arrays["mcmc_proposed"], 5 * n * att)
            and 0.05 < rate < 0.95):
        fail("fluidpaper adaptive_heun: acceptance counts off")
    out["fluidpaper_adaptive_heun"] = dict(attempts=att.tolist(),
                                           acceptance=rate)


# --------------------------------------------------------------------------
# H: the solvers and Gram precisions (phases 26-30)
# --------------------------------------------------------------------------


def _batch(state, theta, n, seed):
    """(theta_c, x): f32 theta on the card and n pushed draws of a fixed
    generator seed."""
    theta_c = theta.to(device=state.device, dtype=torch.float32)
    params = state.flow.layout.unravel(theta_c)
    gen = torch.Generator(device=state.device).manual_seed(seed)
    return theta_c, state.flow.push(params, state.flow.latent_sample(
        gen, params, n, torch.float32))[0]


def _cos_rel(u, ref):
    u, ref = u.double(), ref.double()
    return (float(u @ ref / (u.norm() * ref.norm())),
            float((u - ref).norm() / ref.norm()))


def phase_cg(theta5):
    """H1 (phase 26): --solver cg at fokkerPlanck32's N=16384, direct: 3
    fixed-Heun steps through the CLI (2 plain-mode launches per step,
    lambda_max recorded and no spectrum); one RHS at the theta phase 5
    ends on against the Cholesky solve on the same draws at the JAX
    test's setting (svd_tol 1e-5, 600 iterations, cg_tol 1e-10;
    tests/test_tdvp.py:215-239): cosine > 0.999, residual below 1e-3,
    lambda_max within 3e-2; the update, 2e-2, is held on one batch's O
    rows against an f64 solve of the same Tikhonov system (S and F formed
    in f64, cg's lambda_max). The f32 Cholesky solve is not the
    reference there: at a condition of ~1e5 f32 rounding moves its
    solution by ~2e-2, while CG reads O and never forms S (an H100 80GB
    HBM3 at 700 W); its gap is printed beside. Then the CG solve timed with
    CUDA events at the CLI defaults, its iterations and the host
    waits of one RHS; one adaptive-Heun step with the matrix-free S
    metric (5 launches per attempt)."""
    n_steps = 3
    label = "fokkerPlanck32 N=16384 cg"
    _, arrays, counts = _drive(["fokkerPlanck32", "--solver", "cg"], label,
                               n_steps)
    if counts["persample"] != 2 * n_steps:
        fail(f"{label}: {counts['persample']} plain-mode launches, "
             f"expected {2 * n_steps}")
    if "ev" in arrays or "ev_topk" in arrays:
        fail(f"{label} recorded a spectrum")
    print(f"{label}: lambda_max per step {arrays['lambda_max'].tolist()}")
    out = dict(launches=counts["persample"])
    rhs = {}
    for method, extra in (("cholesky", {}), ("cg", dict(cg_maxiter=600,
                                                        cg_tol=1e-10))):
        state, tdvp = driver.build_problem(preset(
            "fokkerPlanck32", device="cuda", solver_method=method,
            svd_tol=1e-5, **extra))[:2]
        theta_c = theta5.to(device=state.device, dtype=torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = tdvp._rhs_impl(theta_c, 0.0, 21)
        torch.cuda.synchronize()
        rhs[method] = aux
        print(f"one {method} RHS at svd_tol 1e-5 (phase 5's theta): "
              f"{time.perf_counter() - t0:.3f} s, solver_res "
              f"{float(aux['solver_res']):.3e}, lambda_max "
              f"{float(aux['lambda_max']):.6e}" + (
                  f", {int(aux['_cg_iters'])} iterations"
                  if method == "cg" else ""))
    cos, rel = _cos_rel(rhs["cg"]["update"], rhs["cholesky"]["update"])
    lam = abs(float(rhs["cg"]["lambda_max"])
              / float(rhs["cholesky"]["lambda_max"]) - 1.0)
    res = float(rhs["cg"]["solver_res"])
    print(f"cg vs cholesky on the same draws: cosine {cos:.6f} (gate "
          f"0.999), lambda_max relative {lam:.3e} (3e-2), residual "
          f"{res:.3e} (1e-3), update relative {rel:.3e}")
    out.update(vs_cholesky=dict(cosine=cos, update_rel=rel, residual=res,
                                lambda_max_rel=lam))
    # one batch's O rows: CG and the f32 Cholesky solve against an f64
    # solve of the same Tikhonov system (S and F formed in f64 from the
    # same rows, cg's lambda_max), at the JAX test's setting and at the
    # CLI defaults
    state, tdvp = driver.build_problem(preset(
        "fokkerPlanck32", device="cuda", solver_method="cg"))[:2]
    theta_c, x = _batch(state, theta5, tdvp.n_samples, 22)
    _, eloc, O = tdvp._per_sample_batch(theta_c, x, 0.0)
    O_c, e_c = O - O.mean(0), eloc - eloc.mean()
    del O
    n = O_c.shape[0]
    O64 = O_c.double()
    S64, F64 = O64.T @ O64 / n, e_c.double() @ O64 / n
    del O64
    S32, F32 = O_c.T @ O_c / n, e_c @ O_c / n
    acc = {}
    for setting, cfg in (
            ("svd_tol 1e-5, 600 iterations", dataclasses.replace(
                tdvp.cfg, svd_tol=1e-5, cg_maxiter=600, cg_tol=1e-10)),
            ("the CLI defaults", tdvp.cfg)):
        u, _, lam_max, _, iters = tdvp_mod._solve_cg(O_c, e_c, cfg, "high")
        u_ref = tdvp_mod._solve_cholesky(S64, F64, cfg, lam_max=lam_max)[0]
        u_chol = tdvp_mod._solve_cholesky(S32, F32, cfg, lam_max=lam_max)[0]
        acc[setting] = err = {
            k: float((v.double() - u_ref).norm() / u_ref.norm())
            for k, v in (("cg", u), ("cholesky_f32", u_chol))}
        print(f"{label}, {setting} (svd_tol {cfg.svd_tol:.3e}): against an "
              f"f64 solve of the same Tikhonov system, cg after "
              f"{int(iters)} iterations {err['cg']:.3e} (2e-2 at 1e-5), the "
              f"f32 Cholesky solve {err['cholesky_f32']:.3e}")
    del S64, S32
    out["vs_f64_solve"] = acc
    if not (cos > 0.999 and res < 1e-3 and lam < 3e-2
            and acc["svd_tol 1e-5, 600 iterations"]["cg"] < 2e-2):
        fail("cg disagrees with the Cholesky solve")
    # the CG solve alone at the CLI defaults
    iters = int(tdvp_mod._solve_cg(O_c, e_c, tdvp.cfg, "high")[4])
    ms = _time_ms(lambda: tdvp_mod._solve_cg(O_c, e_c, tdvp.cfg, "high"),
                  3)
    del O_c
    waits = _sync_sites(lambda: tdvp._rhs_impl(theta_c, 0.0, 23))
    print(f"{label}: the CG solve {ms:.3f} ms for {iters} iterations "
          f"(cg_maxiter {tdvp.cfg.cg_maxiter}, cg_tol {tdvp.cfg.cg_tol}, "
          f"CUDA events), {ms / max(iters, 1):.4f} ms per iteration; host "
          f"waits in one RHS: {len(waits)} {sorted(set(waits))}")
    if len(waits) > -(-tdvp.cfg.cg_maxiter // tdvp_mod.CG_CHECK_EVERY) + 2:
        fail(f"{label}: {len(waits)} host waits in one RHS")
    out.update(solve_ms=ms, iterations=iters, host_waits_per_rhs=len(waits))
    label = "fokkerPlanck32 N=16384 cg adaptive_heun"
    _, arrays, counts = _drive(["fokkerPlanck32", "--solver", "cg",
                                "--stepper", "adaptive_heun"], label, 1)
    att = sum(_step_table(label, arrays))
    if counts["persample"] != 5 * att:
        fail(f"{label}: {counts['persample']} launches for {att} attempts")
    out["adaptive_heun"] = dict(attempts=att, launches=counts["persample"])
    return out


MINSR_FLOWS = {
    # the preset's flow at N=2048 < P=9264
    "fokkerPlanck32 N=2048": dict(n_samples_tdvp=2048, n_samples_obs=2048),
    # scripts/bench_minsr.py's default: d=32, depth 8, hidden (32,),
    # diffusion, N=1024; P=34,864 is above auto's kernel range (32768)
    "bench_minsr d=32 depth 8 N=1024": dict(
        depth=8, hidden=(32,), equation="diffusion", equation_params={},
        n_samples_tdvp=1024, n_samples_obs=1024, per_sample_backend="cuda"),
}


def _minsr_explicit(cfg, tdvp, theta, label):
    """One batch's direct minSR against explicit P-space forms on the same
    O rows: the residual ||S u - F|| / ||F|| by f64 matvecs with O (gate:
    within a factor 1.5 of the kernel-space one), and the leading
    eigenvalues of S = O_c^T O_c / N by the Cholesky path's randomized
    top-k Ritz routine run to 16 subspace iterations (the top 8 within
    1e-2 of the largest; at the path's own 2 iterations the Ritz values
    fall ~3-4% short of S's, printed beside); the N x N
    eigh, the RHS and, for comparison, a Cholesky RHS (``cfg`` with
    solver_method cholesky) timed."""
    n = tdvp.n_samples
    theta_c, x = _batch(tdvp.state, theta, n, 31)
    _, eloc, O = tdvp._per_sample_batch(theta_c, x, 0.0)
    O_c, e_c = O - O.mean(0), eloc - eloc.mean()
    del O
    sdt = tdvp.precision.solve
    u, ev, _, res, _ = tdvp_mod._solve_minsr(O_c, e_c, tdvp.cfg, "high", sdt)
    O64 = O_c.double()
    F = e_c.double() @ O64 / n
    Su = (O64 @ u.double()) @ O64 / n
    res_p = float((Su - F).norm() / F.norm())
    del O64
    S = O_c.T @ O_c / n
    top = {}
    for n_iter in (2, 16):
        ritz, _ = tdvp_mod._randomized_topk_eigh(
            S, 64, torch.Generator(device=S.device).manual_seed(5),
            n_iter=n_iter)
        top[n_iter] = float((ev[-8:].double() - ritz[-8:].double()).abs()
                            .max() / ritz[-1].double())
    del S
    T = O_c @ O_c.T
    eigh_ms = _time_ms(lambda: torch.linalg.eigh(T.to(sdt)), 3)
    rhs_ms = _time_ms(lambda: tdvp._rhs_impl(theta_c, 0.0, 32), 3)
    del T
    chol = driver.build_problem(dataclasses.replace(
        cfg, solver_method="cholesky"))[1]
    chol_ms = _time_ms(lambda: chol._rhs_impl(theta_c, 0.0, 32), 2)
    del chol
    print(f"{label} minsr: residual kernel-space {float(res):.4e} vs "
          f"P-space {res_p:.4e}; top-8 ev vs the Ritz values of S "
          f"{top[16]:.3e} of the largest at 16 subspace iterations "
          f"(1e-2), {top[2]:.3e} at the Cholesky path's 2; ev[-3:] "
          f"{ev[-3:].tolist()}; N x N eigh {eigh_ms:.3f} ms, RHS "
          f"{rhs_ms:.3f} ms, a Cholesky RHS {chol_ms:.3f} ms (CUDA events)")
    ratio = float(res) / res_p
    if not (top[16] < 1e-2 and 1 / 1.5 < ratio < 1.5):
        fail(f"{label}: minsr diagnostics off the explicit ones "
             f"(ev {top}, residual ratio {ratio})")
    return dict(residual=float(res), residual_pspace=res_p,
                top8_ev=top[16], top8_ev_ritz2=top[2],
                eigh_ms=eigh_ms, rhs_ms=rhs_ms, cholesky_rhs_ms=chol_ms)


def phase_minsr():
    """H2 and H3 (phases 27-28): minSR in its regime, P > N, on two flows
    (MINSR_FLOWS). H2: 3 fixed-Heun steps each with exactly 1 plain-mode
    launch per RHS, and one batch's kernel-space diagnostics against
    explicit P-space ones (_minsr_explicit). H3: the streaming solve at
    chunk_size N/4, 3 steps with exactly 4 * 7 / 2 + 4 = 18 launches per
    RHS, and one RHS against the direct one on the same draws: the
    spectrum within 1e-4 of its largest value, the residuals within a
    factor 2, the update within 1e-3. The JAX package bounds the update at
    2e-4 in f64, where the regularized kernel inverse amplifies T's last
    bits by up to ~1/svd_tol on threshold modes; in f32 that could reach
    eps_f32 / svd_tol = 8e-3, but the chunked T's blocks are the direct
    T's dot products to a few ulp and the measured gap is 3e-6 to 9e-6
    (an H100 80GB HBM3 at 700 W): 1e-3 keeps a hundredfold margin and still
    catches a wrong block."""
    out = {}
    for name, over in MINSR_FLOWS.items():
        n = over["n_samples_tdvp"]
        res = {}
        for chunk in (0, n // 4):
            cfg = preset("fokkerPlanck32", device="cuda",
                         solver_method="minsr", chunk_size=chunk, **over)
            label = f"{name} minsr" + (f" chunk {chunk}" if chunk else "")
            state, arrays, counts = _drive(None, label, 3, cfg=cfg)
            per_rhs = 18 if chunk else 1
            if counts["persample"] != 2 * 3 * per_rhs:
                fail(f"{label}: {counts['persample']} launches, expected "
                     f"{per_rhs} per RHS")
            if arrays["ev"].shape != (3, n):
                fail(f"{label}: ev of shape {arrays['ev'].shape}")
            tdvp = driver.build_problem(cfg)[1]
            if not chunk:
                res["explicit"] = _minsr_explicit(
                    cfg, tdvp, state.get_parameters(), name)
                theta = state.get_parameters()
            theta_c = theta.to(device=state.device, dtype=torch.float32)
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            aux = tdvp._rhs_impl(theta_c, 0.0, 33)
            torch.cuda.synchronize()
            res[chunk] = dict(aux=aux, s=time.perf_counter() - t0,
                              launches=_counts()["persample"])
        d, c = res[0]["aux"], res[n // 4]["aux"]
        ev = float((c["ev"] - d["ev"]).abs().max() / d["ev"][-1].abs())
        r_d, r_c = float(d["solver_res"]), float(c["solver_res"])
        cos, rel = _cos_rel(c["update"], d["update"])
        print(f"{name} streaming (chunk {n // 4}, {res[n // 4]['launches']} "
              f"launches, {res[n // 4]['s']:.3f} s) vs direct "
              f"({res[0]['s']:.3f} s) on the same draws: spectrum "
              f"{ev:.3e} of the largest (1e-4), residual {r_c:.4e} vs "
              f"{r_d:.4e}, update relative {rel:.3e} (1e-3), cosine "
              f"{cos:.6f}, tdvp_error {float(c['tdvp_error']):.6e} vs "
              f"{float(d['tdvp_error']):.6e}")
        if not (ev < 1e-4 and 0.5 < r_c / r_d < 2.0 and rel < 1e-3):
            fail(f"{name}: streaming minsr off the direct solve")
        out[name] = dict(res["explicit"], streaming=dict(
            spectrum=ev, residual=r_c, residual_direct=r_d, update_rel=rel,
            cosine=cos, s=res[n // 4]["s"], direct_s=res[0]["s"],
            launches_per_rhs=res[n // 4]["launches"]))
    return out


def phase_precisions_direct(theta5):
    """H4a (phase 29): the direct statistics at N=16384 on the theta phase
    5 ends on, under --precision tpu_f64stats: gram_precision f64 (the
    plain-mode kernel, f64 products) and default (one bf16 pass) against
    high (the f32 product) on the same draws: S0 and F0 of f64 within
    1e-4 of f32's largest entry, default's gap printed (bf16's ~1e-3
    class expected, gate 1e-2 and above 1e-6, which shows the bf16 pass
    ran); the f64 Cholesky solve's residual against S and against the
    Tikhonov system S + lam I it solves."""
    sts, out = {}, {}
    for mode in ("high", "f64", "default"):
        state, tdvp = driver.build_problem(preset(
            "fokkerPlanck32", device="cuda", precision="tpu_f64stats",
            gram_precision=mode))[:2]
        theta_c, x = _batch(state, theta5, tdvp.n_samples, 41)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = tdvp._direct_stats(theta_c, 0.0, x)
        torch.cuda.synchronize()
        print(f"direct statistics N={tdvp.n_samples} gram_precision {mode}: "
              f"{time.perf_counter() - t0:.3f} s, S0 {st['S0'].dtype}")
        sts[mode] = (st, tdvp)
    ref = sts["high"][0]
    for mode in ("f64", "default"):
        st = sts[mode][0]
        gaps = {k: _rel(st[k], ref[k], ref[k].abs().max())
                for k in ("S0", "F0")}
        print(f"gram_precision {mode} vs high: S0 {gaps['S0']:.3e}, F0 "
              f"{gaps['F0']:.3e} of the largest entry")
        out[f"{mode}_vs_high"] = gaps
    if not max(out["f64_vs_high"].values()) < 1e-4:
        fail("f64 statistics off the f32 ones")
    if not 1e-6 < max(out["default_vs_high"].values()) < 1e-2:
        fail("the default statistics are not one bf16 pass")
    st, tdvp = sts["f64"]
    aux = tdvp._solve_device(st["S0"], st["S0"], st["F0"], st,
                             tdvp.n_samples, 42)
    S, F, u = st["S0"], st["F0"], aux["update"]
    lam = tdvp.cfg.svd_tol * float(aux["lambda_max"])
    tik = float((S @ u + lam * u - F).norm() / F.norm())
    res = float(aux["solver_res"])
    print(f"f64 statistics + f64 Cholesky (svd_tol {tdvp.cfg.svd_tol:.1e}):"
          f" residual against S {res:.3e}, against S + lam I {tik:.3e}")
    if not (res < 1e-3 and math.isfinite(tik)):
        fail("the f64 solve's residual")
    out.update(residual=res, residual_tikhonov=tik)
    return out


def phase_f64acc_production(theta5):
    """H4b (phase 29): f64acc at the production point (N=524288 in chunks
    of 65536, tri2 + int8) for 3 fixed-Heun steps: exactly 16 split, 32
    quant8 and 2 pilot launches per step; then on one batch the statistics
    under f64acc, under high (the same split chunks, f32 sums) and under
    chunked f64 (the plain-mode kernel and f64 products), and the JAX
    test's ordering (tests/test_tdvp.py:1410-1460) in the Frobenius norm:
    ||S_f64acc - S_f64|| < ||S_high - S_f64||. The largest entry's error
    is printed too but not gated: per chunk the split's own error (1e-5
    class) dwarfs the f32 sums' (1e-7 class), so the max-abs order is a
    coin toss, where the Frobenius norm adds the two independent errors'
    squares."""
    n, c = 524288, 65536
    label = f"fokkerPlanck32 N={n} chunked tri2+int8 f64acc"
    args = ["fokkerPlanck32", "--samples", str(n), "--chunk-size", str(c),
            "--gram-backend", "tri2", "--gram-cross", "int8",
            "--gram-precision", "f64acc"]
    _, _, counts = _drive(args, label, 3)
    want = {"persample_split": 3 * 16, "quant8": 3 * 32, "persample": 3 * 2}
    if any(counts[k] != v for k, v in want.items()):
        fail(f"{label}: launches {counts}, expected {want}")
    S, times = {}, {}
    for mode, over in (("f64acc", dict(gram_backend="tri2",
                                       gram_cross="int8")),
                       ("high", dict(gram_backend="tri2", gram_cross="int8")),
                       ("f64", {})):
        state, tdvp = driver.build_problem(preset(
            "fokkerPlanck32", device="cuda", n_samples_tdvp=n,
            n_samples_obs=n, chunk_size=c, gram_precision=mode, **over))[:2]
        theta_c, x = _batch(state, theta5, n, 43)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S[mode] = tdvp._chunked_stats(theta_c, 0.0, x)["S0"].double()
        torch.cuda.synchronize()
        times[mode] = time.perf_counter() - t0
        del x
    ref = S.pop("f64")
    fro = {m: float((v - ref).norm() / ref.norm()) for m, v in S.items()}
    mx = {m: _rel(v, ref, ref.abs().max()) for m, v in S.items()}
    acc_only = float((S["high"] - S["f64acc"]).norm() / ref.norm())
    print(f"{label}: statistics of one batch in {times} s; against chunked "
          f"f64, Frobenius f64acc {fro['f64acc']:.4e} < high "
          f"{fro['high']:.4e} (gate), largest entry f64acc "
          f"{mx['f64acc']:.4e}, high {mx['high']:.4e}; the f32 sums alone "
          f"(high - f64acc) {acc_only:.4e}")
    if not fro["f64acc"] < fro["high"]:
        fail("f64acc is not closer to the f64 statistics than high")
    return dict(launches=counts, stats_s=times, frobenius=fro, max_abs=mx,
                f32_sums_only=acc_only)


def phase_host_solve(theta5):
    """H5 (phase 30): the host f64 solve. mwe in f64 with --host-solve (the
    eigh branch) for 10 steps: residual below 1e-10; then one
    fokkerPlanck32 RHS under tpu_f64stats with the host solve (Cholesky
    branch: numpy f64, lambda_max by power iteration at P > 512) against
    the device's f64 Cholesky solve on the same draws with the same
    power-iteration lambda_max (spectrum_topk=0): within 1e-6."""
    _, arrays, _ = _drive(["mwe", "--precision", "f64", "--host-solve"],
                          "mwe f64 --host-solve", 10, dim=2)
    res = float(arrays["solver_res"].max())
    if not res < 1e-10:
        fail(f"mwe --host-solve residual {res}")
    out = dict(mwe_residual=res)
    aux = {}
    for on_device in (False, True):
        state, tdvp = driver.build_problem(preset(
            "fokkerPlanck32", device="cuda", precision="tpu_f64stats",
            solve_on_device=on_device))[:2]
        if on_device:
            # the power-iteration lambda_max of the host solve, not the
            # top-k Ritz one
            tdvp = TDVP(state, tdvp.equation, dataclasses.replace(
                tdvp.cfg, spectrum_topk=0), n_samples=tdvp.n_samples)
        theta_c = theta5.to(device=state.device, dtype=torch.float32)
        a = tdvp._rhs_impl(theta_c, 0.0, 51)
        if not on_device:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.update(tdvp._host_solve(a))
            out["host_solve_s"] = time.perf_counter() - t0
        aux[on_device] = a
    cos, rel = _cos_rel(aux[False]["update"], aux[True]["update"])
    lam = abs(float(aux[False]["lambda_max"])
              / float(aux[True]["lambda_max"]) - 1.0)
    print(f"fokkerPlanck32 host solve (numpy f64, P={tdvp.n_params}): "
          f"{out['host_solve_s']:.3f} s; against the device f64 solve: "
          f"update relative {rel:.3e} (1e-6), lambda_max {lam:.3e}, "
          f"residual {float(aux[False]['solver_res']):.4e} vs "
          f"{float(aux[True]['solver_res']):.4e}")
    if not rel < 1e-6:
        fail("the host solve differs from the device solve")
    out.update(update_rel=rel, lambda_max_rel=lam)
    return out


def phase_solvers(theta5):
    """H1-H5 (phases 26-30); returns their records and the kernels'
    launches by path."""
    out = {"cg": phase_cg(theta5), "minsr": phase_minsr(),
           "precisions_direct": phase_precisions_direct(theta5),
           "f64acc_production": phase_f64acc_production(theta5),
           "host_solve": phase_host_solve(theta5)}
    prod = out["f64acc_production"]["launches"]
    paths = {"fokkerPlanck32 N=16384 cg": out["cg"]["launches"],
             "fokkerPlanck32 N=16384 cg adaptive_heun":
                 out["cg"]["adaptive_heun"]["launches"],
             "fokkerPlanck32 N=524288 chunked tri2+int8 f64acc (pilots)":
                 prod["persample"]}
    for name in MINSR_FLOWS:
        paths[f"{name} minsr"] = 6
        paths[f"{name} minsr streaming, 4 chunks"] = 108
    split = {"fokkerPlanck32 N=524288 chunked tri2+int8 f64acc":
             prod["persample_split"]}
    q8 = {"fokkerPlanck32 N=524288 chunked tri2+int8 f64acc":
          prod["quant8"]}
    return out, paths, split, q8


# -- phase I (31-35): randomized QMC, the Hessian block mode and the MC
# sphere integrals

QMC_N = 524288  # the production point's batch


def _chi2_bound(x, bits, nu):
    """Per-sample bound on the relative gap of two f64 chi^2 inversions of
    the same 30-bit uniforms: 1e-10 plus the inversion's conditioning,
    16 eps u / (x pdf(x)) (tests/test_torch_qmc.py), computed in f64 on the
    host; 1e-8 above nu = 40, where torch.special.gammainc's own relative
    error (1.8e-9 at a = 25) moves x by 2e-10."""
    from scipy.stats import chi2 as schi2

    if nu > 40:
        return np.full(x.shape, 1e-8)
    u = (bits.astype(np.float64) + 0.5) * 2.0**-30
    return 1e-10 + 16 * np.finfo(np.float64).eps * u / (x * schi2.pdf(x, nu))


def phase_qmc_draws():
    """I1 (phase 31): the QMC draws on the card against the CPU: the same
    words at d=33 and n=524288 (the joint Student-t net of fokkerPlanck32's
    production batch) give the same scrambled bits bit for bit;
    _mirrored_ndtri in f32 on the card within 8 f32 ulps of max(|z|, 1) of
    the CPU's f64 value; chi2_from_bits for nu in {1.05, 2.5, 50} within
    _chi2_bound of the CPU's; the Sobol generation (d=32 and 33), the
    normals and the Newton solve at N=524288 timed with CUDA events."""
    from vmc_pde_torch.sampling import qmc

    n, d = QMC_N, 33
    lms, shift = qmc.draw_words(torch.Generator().manual_seed(5), d)
    cpu = qmc.scrambled_bits_from_words(n, lms, shift)
    dev = qmc.scrambled_bits_from_words(n, lms.cuda(), shift.cuda())
    if not torch.equal(dev.cpu(), cpu):
        fail("the scrambled Sobol bits differ between the card and the CPU")
    z32 = qmc._mirrored_ndtri(dev, torch.float32).cpu().double()
    z64 = qmc._mirrored_ndtri(cpu, torch.float64)
    ulps = float(((z32 - z64).abs() / (z64.abs().clamp_min(1.0)
                                       * 2.0**-23)).max())
    print(f"QMC at d={d}, n={n}: scrambled bits on the card equal the "
          f"CPU's; f32 normals on the card within {ulps:.3f} f32 ulps of "
          f"max(|z|, 1) of the CPU's f64 (bound 8), |z| up to "
          f"{float(z64.abs().max()):.4f}")
    if not ulps <= 8.0:
        fail(f"the f32 QMC normals on the card are {ulps} ulps off")
    out = dict(bits_equal=True, ndtri_f32_ulps=ulps)
    col = cpu[:, d - 1]
    for nu in (1.05, 2.5, 50.0):
        x_dev = qmc.chi2_from_bits(col.cuda(), nu, dtype=torch.float64)
        x_cpu = qmc.chi2_from_bits(col, nu, dtype=torch.float64).numpy()
        rel = np.abs(x_dev.cpu().numpy() - x_cpu) / x_cpu
        worst = float((rel / _chi2_bound(x_cpu, col.numpy(), nu)).max())
        print(f"chi2_from_bits nu={nu}: card vs CPU, largest relative gap "
              f"{rel.max():.3e}, largest share of its bound {worst:.3f}")
        if not worst <= 1.0:
            fail(f"chi2_from_bits nu={nu} differs on the card: {rel.max()}")
        out[f"chi2_nu{nu}_max_rel"] = float(rel.max())
    gen = torch.Generator(device="cuda")
    times = {}
    for label, fn in (
            ("scrambled bits d=32", lambda: qmc.scrambled_bits(
                gen.manual_seed(1), 32, n)),
            ("scrambled bits d=33", lambda: qmc.scrambled_bits(
                gen.manual_seed(1), 33, n)),
            ("normals f32 d=32", lambda: qmc.normal(gen.manual_seed(1), n,
                                                    32)),
            ("chi2 Newton (25 steps, f64)", lambda: qmc.chi2_from_bits(
                dev[:, d - 1], 2.0, dtype=torch.float32))):
        times[label] = _time_ms(fn, 10)
    print(f"QMC at N={n} on the card: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in times.items()))
    out["ms"] = times
    return out


def _step_mean(label):
    steps = STEP_TIMES[label]
    return float(np.mean(steps[1:])) if len(steps) > 1 else float(steps[0])


def _f0_spread(theta5, qmc_on, n=16384, reps=8):
    """F0 at theta5 over ``reps`` randomizations of n draws: the norm of
    its per-entry standard deviation over the norm of its mean."""
    state, tdvp = driver.build_problem(preset(
        "fokkerPlanck32", device="cuda", qmc=qmc_on, n_samples_tdvp=n,
        n_samples_obs=n))[:2]
    F = []
    for s in range(reps):
        theta_c, x = _batch(state, theta5, n, 60 + s)
        F.append(tdvp._direct_stats(theta_c, 0.0, x)["F0"].double())
    F = torch.stack(F)
    return float(F.std(0).norm() / F.mean(0).norm())


def phase_qmc_paths(theta5):
    """I2 (phase 32): fokkerPlanck32 --qmc through driver.main at N=16384
    for 5 fixed-Heun steps (exactly 10 plain-mode launches) and at the
    production point (N=524288 in chunks of 65536, tri2 + int8) for 3
    steps (exactly 48 split, 96 quant8 and 6 pilot launches); no NaN,
    residual below 1e-3 (_drive), each mean step beside the pseudo-random
    run's of phases 5 and 7; then the spread of F0 over 8 randomizations
    at the theta phase 5 ends on, QMC against pseudo-random draws at
    N=16384 (printed, no gate)."""
    out = {}
    label = "fokkerPlanck32 --qmc N=16384"
    _, _, counts = _drive(["fokkerPlanck32", "--qmc"], label, 5)
    if counts["persample"] != 10 or counts["persample_split"]:
        fail(f"{label}: launches {counts}, expected 10 plain-mode")
    out["direct"] = dict(launches=counts["persample"],
                         s_per_step=_step_mean(label),
                         prng_s_per_step=_step_mean(MAIN_LABEL))
    plabel = "fokkerPlanck32 --qmc N=524288 chunked tri2+int8"
    _, _, counts = _drive(
        ["fokkerPlanck32", "--qmc", "--samples", str(QMC_N), "--chunk-size",
         "65536", "--gram-backend", "tri2", "--gram-cross", "int8"],
        plabel, 3)
    want = dict(persample_split=48, quant8=96, persample=6)
    if any(counts[k] != v for k, v in want.items()):
        fail(f"{plabel}: launches {counts}, expected {want}")
    out["production"] = dict(launches=want, s_per_step=_step_mean(plabel),
                             prng_s_per_step=_step_mean(CHUNKED_LABEL))
    for key, lab in (("direct", label), ("production", plabel)):
        o = out[key]
        print(f"{lab}: {o['s_per_step']:.4f} s per step against "
              f"{o['prng_s_per_step']:.4f} s with pseudo-random draws "
              f"(ratio {o['s_per_step'] / o['prng_s_per_step']:.4f})")
    spread = {name: _f0_spread(theta5, on)
              for name, on in (("qmc", True), ("prng", False))}
    print(f"F0 at phase 5's theta, N=16384, 8 randomizations: relative "
          f"spread QMC {spread['qmc']:.4e}, pseudo-random "
          f"{spread['prng']:.4e} (ratio "
          f"{spread['prng'] / spread['qmc']:.3f})")
    out["f0_spread"] = spread
    return out


def phase_qmc_student(dev):
    """I3 (phase 33): the Student-t + global affine fokkerPlanck32 with
    --qmc through driver.run at N=16384 for 4 steps (exactly 8 plain-mode
    launches); then the kernel held to plain f32 on QMC draws of the
    joint (d+1)-column net at phase 15's perturbed theta (nu = 2.5) with
    phase 15's grading (GRADE_Q, GRADE_MAX), the largest |x| of the QMC
    and the pseudo-random draws printed."""
    n_steps = 4
    label = "fokkerPlanck32 Student-t + global affine --qmc N=16384"
    cfg = preset("fokkerPlanck32", latent_name="Student_t",
                 global_affine=True, qmc=True, device="cuda")
    state, _, counts = _drive(None, label, n_steps, cfg=cfg)
    if not state.flow.qmc or counts["persample"] != 2 * n_steps:
        fail(f"{label}: launches {counts}, expected {2 * n_steps}")
    flow, _, perturbed, dirs = _student_problem(dev)
    params = flow.layout.unravel(perturbed)
    reach = {}
    for name, f in (("qmc", dataclasses.replace(flow, qmc=True)),
                    ("prng", flow)):
        gen = torch.Generator(device=dev).manual_seed(12)
        x, _ = f.push(params, f.latent_sample(gen, params, 16384,
                                              torch.float32))
        reach[name] = float(x.abs().max())
        if name == "qmc":
            err = _persample_vs_plain(flow, perturbed, x, dirs,
                                      "Student-t perturbed, QMC draws",
                                      grade=True)
    print(f"Student-t perturbed theta, N=16384: largest |x| of the QMC "
          f"draws {reach['qmc']:.2f}, of the pseudo-random ones "
          f"{reach['prng']:.2f}")
    return dict(launches=counts["persample"], s_per_step=_step_mean(label),
                max_abs_err_O=err, max_abs_x=reach)


def _eloc_block_vs_trace(name, precision, theta=None, n=16384, seed=70):
    """E_loc of one batch under hessian_mode block and trace on the same
    draws (``theta``: f32 on the card, default the preset's initial one),
    and the f64 trace-mode E_loc of the plain pipeline on them."""
    out = {}
    for mode in ("block", "trace"):
        state, tdvp = driver.build_problem(preset(
            name, device="cuda", precision=precision, hessian_mode=mode,
            n_samples_tdvp=n, n_samples_obs=n))[:2]
        th = state.theta if theta is None else theta
        theta_c, x = _batch(state, th, n, seed)
        theta_c, x = theta_c.to(state.theta.dtype), x.to(state.theta.dtype)
        out[mode] = tdvp._per_sample_batch(theta_c, x, 0.1)[1]
        out[f"{mode}_tdvp"] = tdvp
    eq = out["trace_tdvp"].equation
    dirs = torch.as_tensor(eq.hessian_trace_dirs(state.flow.dim),
                           dtype=torch.float64, device=x.device)
    _, g, quad, _ = persample.per_sample_plain(state.flow, theta_c.double(),
                                               x.double(), dirs)
    out["f64"] = eq.eloc(x.double(), g, quad, 0.1)
    return out


def phase_hessian_block(theta5):
    """I4 (phase 34): fokkerPlanck32 --hessian-mode block at N=16384, the
    16 x 16 momentum block on the torch.func pipeline: 2 steps through
    the CLI with no kernel launch, no NaN, residual below 1e-3, timed;
    on one batch at the theta phase 5 ends on, the block-mode E_loc (f32,
    torch.func) and the trace-mode one (f32, the kernel) against the f64
    plain pipeline's, the block within 4 times the kernel's error or
    1e-5 of the largest value; mwe and diffusion_anisotropic in f64,
    block against trace on the same draws, within 1e-10."""
    label = "fokkerPlanck32 --hessian-mode block N=16384"
    _, _, counts = _drive(["fokkerPlanck32", "--hessian-mode", "block"],
                          label, 2)
    if any(counts.values()):
        fail(f"{label} launched kernels: {counts}")
    e = _eloc_block_vs_trace("fokkerPlanck32", "tpu", theta=theta5)
    if e["block_tdvp"].uses_kernel or not e["trace_tdvp"].uses_kernel:
        fail("the block mode must run the torch.func pipeline, trace mode "
             "the kernel")
    scale = e["f64"].abs().max()
    err_b, err_t = (_rel(e[m], e["f64"], scale) for m in ("block", "trace"))
    print(f"fokkerPlanck32 N=16384 E_loc against the f64 plain pipeline: "
          f"block (f32 torch.func) {err_b:.3e}, trace (f32 kernel) "
          f"{err_t:.3e} of the largest value (bound max(4 x trace, 1e-5))")
    if not err_b <= max(4.0 * err_t, 1e-5):
        fail(f"block-mode E_loc off by {err_b}")
    out = dict(launches=0, s_per_step=_step_mean(label),
               prng_trace_s_per_step=_step_mean(MAIN_LABEL),
               eloc_err_block_f32=err_b, eloc_err_trace_kernel=err_t)
    for name in ("mwe", "diffusion_anisotropic"):
        e = _eloc_block_vs_trace(name, "f64", n=4096)
        rel = _rel(e["block"], e["trace"])
        print(f"{name} f64 N=4096: block against trace E_loc {rel:.3e} "
              f"(tol 1e-10)")
        if not rel < 1e-10:
            fail(f"{name}: block E_loc differs from trace: {rel}")
        out[f"{name}_block_vs_trace"] = rel
    print(f"{label}: {out['s_per_step']:.4f} s per step against "
          f"{out['prng_trace_s_per_step']:.4f} s in trace mode (the kernel)")
    return out


def phase_integrals():
    """I5 (phase 35): mwe in f64 with integrals=True (dt 1e-2) for 10
    steps: each of the three integrals within 5 Monte Carlo standard
    errors of 1 - exp(-r^2 / (2 sigma^2(t))), sigma^2(t) = 1 + 2t (the
    standard error from p's first two moments on a 2-D ball); then
    fokkerPlanck32 at N=16384 with integrals=True for 3 steps (exactly 6
    plain-mode launches): finite values in [0, 1 + 5 SE], SE from p's
    spread on one ball batch at the last theta, and the step time beside
    phase 5's."""
    n = 4096
    cfg = preset("mwe", device="cuda", precision="f64", n_samples_tdvp=n,
                 n_samples_obs=n, integrals=True, verbose=False, dt0=1e-2)
    _, a, _ = _drive(None, "mwe f64 integrals", 10, dim=2, cfg=cfg)
    s2 = 1.0 + 2.0 * a["times"]
    out = {}
    for label, lim in (("1", 1.0), ("0.5", 0.5), ("0.1", 0.1)):
        r2 = lim**2 * 10.0
        est = a[f"integral_{label}sigma"]
        exact = 1.0 - np.exp(-r2 / (2.0 * s2))
        m1 = exact / (math.pi * r2)
        m2 = (1.0 - np.exp(-r2 / s2)) / (4.0 * math.pi**2 * s2 * r2)
        se = math.pi * r2 * np.sqrt((m2 - m1**2) / n)
        z = float((np.abs(est - exact) / se).max())
        print(f"mwe integral_{label}sigma: last {est[-1]:.5f} vs "
              f"{exact[-1]:.5f}, largest gap {z:.2f} SE over 10 steps")
        if not z < 5.0:
            fail(f"mwe integral_{label}sigma misses its closed form")
        out[f"mwe_{label}sigma_max_se"] = z
    label = "fokkerPlanck32 integrals N=16384"
    state, a, counts = _drive(None, label, 3, cfg=preset(
        "fokkerPlanck32", device="cuda", integrals=True))
    if counts["persample"] != 6:
        fail(f"{label}: launches {counts}, expected 6 plain-mode")
    params = state.params
    gen = torch.Generator(device="cuda").manual_seed(80)
    ball = tdvp_mod.unit_ball(gen, 16384, 32, torch.float32, state.device)
    for label_i, lim in (("1", 1.0), ("0.5", 0.5), ("0.1", 0.1)):
        r = lim * math.sqrt(10.0)
        p = torch.exp(state.flow.log_prob(params, r * ball)).double()
        se = float(p.std()) * tdvp_mod._ball_volume(32, r) / math.sqrt(16384)
        v = a[f"integral_{label_i}sigma"]
        print(f"fokkerPlanck32 integral_{label_i}sigma per step "
              f"{' '.join(f'{x:.4e}' for x in v)} (SE {se:.2e})")
        if not (np.isfinite(v).all() and (v >= 0).all()
                and (v <= 1.0 + 5 * se).all()):
            fail(f"fokkerPlanck32 integral_{label_i}sigma out of range")
    out["fokkerPlanck32"] = dict(
        launches=counts["persample"], s_per_step=_step_mean(label),
        prng_s_per_step=_step_mean(MAIN_LABEL))
    print(f"{label}: {out['fokkerPlanck32']['s_per_step']:.4f} s per step "
          f"against {out['fokkerPlanck32']['prng_s_per_step']:.4f} s "
          f"without the integrals")
    return out


def phase_qmc_hessian_integrals(dev, theta5):
    """I1-I5 (phases 31-35); returns their records and the kernels'
    launches by path."""
    out = {"qmc_draws": phase_qmc_draws(),
           "qmc_paths": phase_qmc_paths(theta5),
           "qmc_student": phase_qmc_student(dev),
           "hessian_block": phase_hessian_block(theta5),
           "integrals": phase_integrals()}
    prod = "fokkerPlanck32 N=524288 chunked tri2+int8 --qmc"
    paths = {"fokkerPlanck32 --qmc": out["qmc_paths"]["direct"]["launches"],
             f"{prod} (pilots)": 6,
             "fokkerPlanck32 Student-t + global affine --qmc":
                 out["qmc_student"]["launches"],
             "fokkerPlanck32 --hessian-mode block": 0,
             "fokkerPlanck32 integrals":
                 out["integrals"]["fokkerPlanck32"]["launches"]}
    return out, paths, {prod: 48}, {prod: 96}


def main():
    phase_device()
    full_f32_matmuls()
    dev = torch.device("cuda")
    phase_build()
    prob = _fp32_problem(dev)
    results = {"persample": phase_kernel(dev, prob)}
    split = phase_split(dev, prob)
    results["quant8"] = phase_quant8(split)
    results["persample_split"] = {
        k: split[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by")}
    del split, prob
    state, counts = phase_main_path()
    theta5 = state.get_parameters()
    launches = {"persample": counts["persample"]}
    phase_chunked_vs_f32(state.get_parameters())
    counts = phase_chunked_path()
    launches.update(persample_split=counts["persample_split"],
                    quant8=counts["quant8"])
    phase_mwe()
    results["metropolis"] = phase_metropolis(dev)
    launches["metropolis"] = phase_var_state_sample(dev)
    phase_fluidpaper()
    phase_doublewell()
    results["syrk"] = phase_syrk(dev, state.get_parameters())
    launches["syrk"] = phase_syrk_paths(state.get_parameters())
    student = phase_student_kernel(dev)
    state, counts = phase_student_path()
    theta_student = state.get_parameters()
    paths = {"fokkerPlanck32": launches["persample"],
             "fokkerPlanck32 Student-t + global affine": counts["persample"]}
    phase_chunked_vs_f32(state.get_parameters(), syrk_too=False,
                         latent_name="Student_t", global_affine=True)
    paths["diffusion"] = phase_diffusion()
    phase_anisotropic_and_oscillators()
    steppers = phase_steppers()
    for name in ("fixed_euler", "fixed_rk3", "adaptive_heun",
                 "adaptive_rk23"):
        paths[f"fokkerPlanck32 {name}"] = steppers[name]["launches"]
    paths["fokkerPlanck32 adaptive_heun tol=2e-5 (a retry)"] = \
        steppers["adaptive_heun_retry"]["launches"]
    phase_exact_t_end_and_dispatch(steppers)
    phase_sexp_batch(theta5, theta_student, steppers)
    prod = phase_steppers_production(steppers)
    paths["fokkerPlanck32 N=524288 chunked adaptive_heun"] = \
        prod["persample"]
    phase_fluidpaper_adaptive(steppers)
    solvers, solver_paths, split_paths, q8_paths = phase_solvers(theta5)
    paths.update(solver_paths)
    qhi, qhi_paths, qhi_split, qhi_q8 = phase_qmc_hessian_integrals(
        dev, theta5)
    paths.update(qhi_paths)
    split_paths.update(qhi_split)
    q8_paths.update(qhi_q8)
    ranks = phase_mesh()
    for name in ("persample_sharded", "metropolis_sharded"):
        results[name] = dict(ranks[0][name])
        launches[name] = results[name].pop("launches")
        results[name]["launches_by_rank"] = [r[name]["launches"]
                                             for r in ranks]
    results["persample_sharded"]["launches_by_path"] = {
        "fokkerPlanck32 GSPMD counterpart (eloc_clip=2), per rank":
            launches["persample_sharded"]}
    paths["fokkerPlanck32 shard_map direct, per rank"] = \
        ranks[0]["paths"]["direct"]["counts"]["persample"]
    mesh_paths = {name: {k: v for k, v in path.items() if k != "counts"}
                  for name, path in ranks[0]["paths"].items()}
    scope = {"persample": "Gauss and Student_t latents, with and without "
                          "the global affine (fokkerPlanck32 flows at "
                          "P=9264 and P=9397, diffusion_anisotropic's)",
             "persample_split": "Gauss and Student_t latents, with and "
                                "without the global affine (P=9264, 9397)"}
    for name in scope:
        results[name] = dict(results[name], scope=scope[name],
                             student_t_global_affine=student[name])
    results["persample"]["launches_by_path"] = paths
    for name, more in (("persample_split", split_paths),
                       ("quant8", q8_paths)):
        results[name]["launches_by_path"] = {
            "fokkerPlanck32 N=524288 chunked tri2+int8 fixed_heun":
                launches[name],
            "fokkerPlanck32 N=524288 chunked tri2+int8 adaptive_heun":
                prod[name], **more}
    results["syrk"]["launches_by_path"] = {
        "fokkerPlanck32 N=16384 syrk fixed_heun": launches["syrk"],
        "one direct batch with the dense SExp (S0, A, SExp)":
            steppers["launches"]["syrk"]}
    print(json.dumps({"steppers": steppers}))
    print(json.dumps({"solvers": solvers}))
    print(json.dumps({"mesh_paths": mesh_paths}))
    print(json.dumps({"qmc_hessian_integrals": qhi}))
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNELS[name][0],
             replaces=KERNELS[name][1], launches=launches[name],
             **{"library_ms": None, **results[name]})
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
