"""Smoke test of the PyTorch port on one CUDA card:

    python3 chip_smoke.py

1. the device, and its name and power limit as nvidia-smi reports them;
   then every CUDA kernel is built from vmc_pde_torch/kernels/csrc, one
   nvcc per source, all at once;
2. the per-sample kernel against its plain torch.func version at the
   fokkerPlanck32 shape (d=32, P=9264): N=1024, a ragged N=1000 and the
   main path's N=16384 on a perturbed theta (there within twice plain
   f32's own error), then the preset's initial theta at N=16384, where
   both are also timed with CUDA events;
3. the same kernel in split mode (bf16 hi/lo of O - shift, column sums,
   column max) against the plain pipeline and split: N=1024 and a ragged
   N=1000 on the perturbed theta, the chunked path's N=65536 on the
   initial theta, where both are timed;
4. the fused quantize+force kernel against its plain passes at P=9264,
   n=65536 on the split pair of phase 3: q8 bit-identical, f against f64;
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
   uniforms (128 chains x 24 sweeps, 8192 x 128): the same accept count,
   samples and final states within 2e-6; its Philox variant at 8192 x 128
   against the plain version on the same stream, and against the torch
   chain on statistics (acceptance within 0.03, mean radius within 5% of
   the analytic value, radial-histogram L1 below 0.15); all three timed;
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
   against the plain version and against torch.mm(O^T, O) in f32;
14. ``fokkerPlanck32 --gram-backend syrk``: 5 steps at N=16384 with
   exactly 20 syrk launches, S0 and A within 1e-4 of the f32 Gram's on one
   batch, then the chunked statistics at N=131072 in chunks of 65536 for
   2 steps with exactly 24 syrk and 8 per-sample launches. The chunked
   syrk run is cut to 2 steps and N=131072, the direct one to 5 steps,
   to keep the whole script well inside its time limit.

Any failure raises and exits nonzero. On success the second-to-last line
is the per-kernel JSON record and the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.kernels import (bounds, build, metropolis, persample,
                                   quant8, syrk)
from vmc_pde_torch.models.flow import build_flow, perturb_theta
from vmc_pde_torch.models.state import VarState
from vmc_pde_torch.ops.evolution import make_equation
from vmc_pde_torch.parallel import stats
from vmc_pde_torch.sampling import sampler as sampling
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
}
WRAPPERS = {"persample": persample.per_sample_cuda,
            "persample_split": persample.per_sample_split_cuda,
            "quant8": quant8.quant_force_cuda,
            "metropolis": metropolis.metropolis_chain_cuda,
            "syrk": syrk.syrk_cuda}


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


def _persample_vs_plain(flow, theta, x, dirs, label, loose=False):
    """The plain-mode kernel against the plain pipeline in f64 on the same
    f32 inputs, to TOL (with ``loose``, to twice plain f32's own error
    where that is larger); returns the largest abs error of O."""
    n = x.shape[0]
    got = persample.per_sample_cuda(flow, theta, x, dirs)
    ref = persample.per_sample_plain(flow, theta.double(), x.double(),
                                     dirs.double())
    ref32 = persample.per_sample_plain(flow, theta, x, dirs)
    torch.cuda.synchronize()
    for name, a, r, p in zip(("logp", "g", "quad", "O"), got, ref, ref32):
        if a.shape != r.shape or not torch.isfinite(a).all():
            fail(f"kernel {name} at N={n}: shape {tuple(a.shape)} vs "
                 f"{tuple(r.shape)}, or not finite")
        rel, rel32 = _rel(a, r), _rel(p, r)
        tol = max(TOL[name], 2.0 * rel32) if loose else TOL[name]
        print(f"kernel vs plain, {label} theta, N={n}, {name}: max abs "
              f"err {float((a.double() - r).abs().max()):.3e}, relative "
              f"{rel:.3e} (tol {tol:.2e}; plain f32 {rel32:.3e})")
        if not rel < tol:
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

    # time both on the main path's theta and batch, the last case above
    ms = _time_ms(lambda: persample.per_sample_cuda(flow, theta, x, dirs), 20)
    plain_ms = _time_ms(
        lambda: persample.per_sample_plain(flow, theta, x, dirs), 3)
    P, d, k = flow.layout.size, flow.dim, dirs.shape[0]
    bound = bounds.persample(bounds.flow_layers(flow), d, P, n, k)
    print(f"per-sample at N={n}, P={P}: CUDA kernel {ms:.3f} ms, plain "
          f"torch.func {plain_ms:.3f} ms, bound {bound[0]:.3f} ms "
          f"({bound[1]})")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1])


def phase_split(dev, prob):
    """Split mode against the plain pipeline and split. The shift is the
    pilot's: the plain f32 mean O of the first 2048 samples."""
    flow, theta0, perturbed, eq, dirs = prob
    gen = torch.Generator(device=dev).manual_seed(1)
    max_abs = 0.0
    for label, theta, n in (("perturbed", perturbed, 1024),
                            ("perturbed", perturbed, 1000),
                            ("initial", theta0, 65536)):
        params = flow.layout.unravel(theta)
        x, _ = flow.push(params, flow.latent_sample(gen, params, n,
                                                    torch.float32))
        shift = persample.per_sample_plain(flow, theta, x[:2048],
                                           dirs)[3].mean(0)
        got = persample.per_sample_split_cuda(flow, theta, x, dirs, shift)
        ref = persample.per_sample_plain(flow, theta.double(), x.double(),
                                         dirs.double())
        ref32 = persample.per_sample_split_plain(flow, theta, x, dirs, shift)
        torch.cuda.synchronize()
        o_ref = ref[3] - shift.double()
        o_scale = o_ref.abs().max().clamp_min(1.0)
        checks = [(name, a, r, p, TOL[name], None) for name, a, r, p in
                  zip(("logp", "g", "quad"), got, ref, ref32)]
        checks += [
            ("hi+lo", got[3][0].double() + got[3][1].double(), o_ref,
             ref32[3][0].double() + ref32[3][1].double(),
             TOL["O"] + 2**-16, None),
            # per-element scale: a sum of n terms each within the O bar
            ("colsum", got[4], o_ref.sum(0), ref32[4], TOL["O"],
             n * o_scale),
            ("colmax", got[5], o_ref.abs().amax(0), ref32[5], TOL["O"],
             o_scale)]
        for name, a, r, p, tol, scale in checks:
            if a.shape != r.shape or not torch.isfinite(a).all():
                fail(f"split kernel {name} at N={n}: shape "
                     f"{tuple(a.shape)} vs {tuple(r.shape)}, or not finite")
            rel, rel32 = _rel(a, r, scale), _rel(p, r, scale)
            print(f"split kernel vs plain, {label} theta, N={n}, {name}: "
                  f"relative {rel:.3e} (tol {tol:.1e}; plain f32 "
                  f"{rel32:.3e})")
            if not rel < tol:
                fail(f"split kernel {name} disagrees with the plain version "
                     f"at N={n}: {rel:.3e}")
            if name == "hi+lo":
                max_abs = max(max_abs, float((a - r).abs().max()))
        del ref, ref32

    P, d, k = flow.layout.size, flow.dim, dirs.shape[0]
    ms = _time_ms(lambda: persample.per_sample_split_cuda(
        flow, theta, x, dirs, shift), 10)
    plain_ms = _time_ms(lambda: persample.per_sample_split_plain(
        flow, theta, x, dirs, shift), 2)
    bound = bounds.persample(bounds.flow_layers(flow), d, P, n, k,
                             split=True)
    print(f"split per-sample at N={n}, P={P}: CUDA kernel {ms:.3f} ms, "
          f"plain torch.func + split {plain_ms:.3f} ms, bound "
          f"{bound[0]:.3f} ms ({bound[1]})")
    eloc = eq.eloc(x, got[1], got[2], 0.0)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1],
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
    # time the hi call, the larger of the two
    _, x_pn, am, V = calls[0]
    inv = stats._int8_scales(am)[1]
    ms = _time_ms(lambda: quant8.quant_force_cuda(x_pn, inv, V), 20)
    plain_ms = _time_ms(lambda: quant8.quant_force_plain(x_pn, inv, V), 20)
    P, n = x_pn.shape
    kv = V.shape[1]
    bound = bounds.quant8(P, n, kv)
    print(f"quant8 at P={P}, n={n}, kv={kv}: CUDA kernel {ms:.3f} ms, "
          f"plain passes {plain_ms:.3f} ms, bound {bound[0]:.3f} ms "
          f"({bound[1]})")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1])


def _zero_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def _drive(args, label, n_steps, dim=32):
    """Run the driver; returns (state, recorder arrays, counts)."""
    stamps = []

    def record(n_step, t, state, info):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, rec = driver.main(args + ["--max-steps", str(n_steps),
                                     "--device", "cuda"], callbacks=[record])
    counts = _counts()
    steps = np.diff([t0] + stamps)
    print(f"{label}: {len(steps)} Heun steps, wall s/step "
          f"{' '.join(f'{s:.3f}' for s in steps)} (first includes set-up), "
          f"mean of steps 2-{len(steps)} {steps[1:].mean():.3f} s")
    print(f"{label}: kernel launches {counts}")
    arrays = rec.as_arrays()
    spectrum = "ev_topk" if "ev_topk" in arrays else "ev"
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
    state, _, counts = _drive(["fokkerPlanck32"], "fokkerPlanck32 N=16384",
                              5)
    if counts["persample"] == 0:
        fail("the main path never launched the per-sample kernel")
    return state, counts


def phase_chunked_path():
    n_steps = 3
    _, _, counts = _drive(
        ["fokkerPlanck32", "--samples", "524288", "--chunk-size", "65536",
         "--gram-backend", "tri2", "--gram-cross", "int8"],
        "fokkerPlanck32 N=524288 chunked tri2+int8", n_steps)
    want = n_steps * 2 * (524288 // 65536)
    if counts["persample_split"] != want:
        fail(f"split kernel launches {counts['persample_split']}, expected "
             f"{want}")
    if counts["quant8"] != 2 * want:
        fail(f"quant8 launches {counts['quant8']}, expected {2 * want}")
    if counts["persample"] == 0:
        fail("the chunked path never ran the plain-mode kernel's pilot")
    return counts


def phase_chunked_vs_f32(theta):
    """The chunked statistics on one batch of draws through the tri2+int8,
    the syrk and the f32 Gram, at the theta the main path ends on."""
    n, c = 131072, 65536
    out = {}
    for label, over in (("tri2+int8", dict(gram_backend="tri2",
                                           gram_cross="int8")),
                        ("syrk", dict(gram_backend="syrk")),
                        ("f32", {})):
        cfg = preset("fokkerPlanck32", device="cuda", n_samples_tdvp=n,
                     n_samples_obs=n, chunk_size=c, **over)
        state, tdvp = driver.build_problem(cfg)[:2]
        theta_c = theta.to(device=state.device, dtype=torch.float32)
        params = state.flow.layout.unravel(theta_c)
        gen = torch.Generator(device=state.device).manual_seed(7)
        x, _ = state.flow.push(params, state.flow.latent_sample(
            gen, params, n, torch.float32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = tdvp._chunked_stats(theta_c, 0.0, x)
        torch.cuda.synchronize()
        out[label] = (st, time.perf_counter() - t0)
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


def phase_metropolis(dev):
    """The Metropolis kernel against its plain version on the same
    uniforms, exact; the Philox variant against the plain version on its
    stream and against the torch chain on statistics."""
    max_abs = 0.0
    gen = torch.Generator(device=dev).manual_seed(2)
    for C, sweeps, uniforms in ((128, 24, True), (8192, 128, True),
                                (8192, 128, False)):
        init = torch.tensor(BUMP_OFFSET, device=dev).repeat(C, 1)
        u = None
        if uniforms:
            u = torch.rand((6, sweeps * C), generator=gen, device=dev) \
                * (1 - 2e-7) + 1e-7
        got = metropolis.metropolis_chain_cuda(5, init, sweeps, 0.25,
                                               BUMP_OFFSET, u)
        ref = metropolis.metropolis_chain_plain(5, init, sweeps, 0.25,
                                                BUMP_OFFSET, u)
        torch.cuda.synchronize()
        err = max(float((a - r).abs().max()) for a, r in zip(got[:2],
                                                             ref[:2]))
        acc, acc_ref = int(got[2]), int(ref[2])
        label = "external uniforms" if uniforms else "Philox"
        print(f"metropolis kernel vs plain, {C} chains x {sweeps} sweeps, "
              f"{label}: accepted {acc} vs {acc_ref}, max abs err {err:.3e} "
              f"(tol 2e-6)")
        if acc != acc_ref or not err <= 2e-6:
            fail(f"the Metropolis kernel disagrees with its plain version "
                 f"({label}, {C} chains)")
        max_abs = max(max_abs, err)

    # statistics of the Philox run against the torch chain
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

    u_ext = torch.rand((6, sweeps * C), generator=gen, device=dev) \
        * (1 - 2e-7) + 1e-7
    ms = _time_ms(lambda: metropolis.metropolis_chain_cuda(
        5, init, sweeps, 0.25, BUMP_OFFSET), 20)
    ext_ms = _time_ms(lambda: metropolis.metropolis_chain_cuda(
        5, init, sweeps, 0.25, BUMP_OFFSET, u_ext), 20)
    plain_ms = _time_ms(lambda: metropolis.metropolis_chain_plain(
        5, init, sweeps, 0.25, BUMP_OFFSET, u_ext), 3)
    torch_ms = _time_ms(lambda: sampling.metropolis_chain(
        torch.Generator(device=dev).manual_seed(3), init,
        lambda x: sampling.cos_dist_log_prob(
            x, torch.tensor(BUMP_OFFSET, device=dev)),
        sampling.radial_proposal, sweeps, info), 3)
    bound = bounds.metropolis(total, 2)
    bound_ext = bounds.metropolis(total, 2, ext=True)
    print(f"metropolis at {C} chains x {sweeps} sweeps: CUDA kernel Philox "
          f"{ms:.4f} ms (bound {bound[0]:.6f} ms, {bound[1]}), external "
          f"uniforms {ext_ms:.4f} ms (bound {bound_ext[0]:.6f} ms), plain "
          f"torch on the same uniforms {plain_ms:.3f} ms, the torch chain "
          f"{torch_ms:.3f} ms")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1])


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
    del O_c, e_c
    n = 16384
    O_c, e_c = _syrk_operands(flow, theta, eq, dirs, gen, n)
    max_abs = max(max_abs, _syrk_vs_plain(
        O_c, (("unweighted", None, 2e-5),
              ("signed weight E_loc - mean", e_c, 3e-5))))
    P = O_c.shape[1]
    ms = _time_ms(lambda: syrk.syrk_cuda(O_c), 10)
    plain_ms = _time_ms(lambda: syrk.syrk_plain(O_c), 5)
    lib_ms = _time_ms(lambda: torch.mm(O_c.T, O_c), 5)
    bound = bounds.syrk(n, P)
    print(f"syrk at N={n}, P={P}: CUDA kernel {ms:.3f} ms, plain split "
          f"products {plain_ms:.3f} ms, torch.mm f32 (TF32 off) "
          f"{lib_ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]})")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms)


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
