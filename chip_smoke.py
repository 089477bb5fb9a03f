"""Smoke test of the PyTorch port on one CUDA card:

    python3 chip_smoke.py

1. the device, and its name and power limit as nvidia-smi reports them;
2. the hand-written per-sample CUDA kernel (built from
   vmc_pde_torch/kernels/csrc on first use) against its plain torch.func
   version at the fokkerPlanck32 shape (d=32, P=9264): N=1024 and a
   ragged N=1000 on a perturbed theta, then the main path's initial theta
   at its N=16384, where both are also timed with CUDA events;
3. the port's main path, ``vmc_pde_torch.driver.main`` on fokkerPlanck32
   at the preset's N=16384 for 5 fixed-Heun steps: the kernel's launch
   counter must rise, nothing may be NaN, the solver residual must be
   finite and below 1e-3;
4. the 2-D Gaussian diffusion ``mwe`` in f64 against its closed forms.

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
from vmc_pde_torch.kernels import build, persample
from vmc_pde_torch.models.flow import build_flow, perturb_theta
from vmc_pde_torch.ops.evolution import make_equation
from vmc_pde_torch.utils.dtypes import full_f32_matmuls

# Kernel (f32) vs plain version in f64 on the same f32-rounded inputs,
# relative to the largest reference value: f32 rounding amplified by four
# coupling blocks of exp/tanh (the plain pipeline in f32 shows 1e-5 to
# 7e-5 on the perturbed flow at N=1024), and a second derivative with
# cancellations for quad. The plain pipeline's own f32 error is printed
# beside the kernel's.
TOL = {"logp": 1e-4, "g": 2e-4, "quad": 1e-3, "O": 2e-4}


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


def _time_ms(fn, reps):
    fn()  # warm-up (and the kernel build on its first call)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(dev):
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
    gen = torch.Generator(device=dev).manual_seed(0)

    max_abs = 0.0
    build.library()  # nvcc, on first use
    for line in build.build_log().splitlines():
        if "registers" in line or "stack frame" in line:
            print("ptxas:", line.strip())
    # a perturbed theta exercises the nonlinear parts (N=1000 is ragged);
    # the last case is what the main path hands the kernel: its initial
    # theta and a batch of the preset's N=16384
    for label, theta, n in (("perturbed", perturbed, 1024),
                            ("perturbed", perturbed, 1000),
                            ("initial", theta0, cfg.n_samples_tdvp)):
        params = flow.layout.unravel(theta)
        z = flow.latent_sample(gen, params, n, torch.float32)
        x, _ = flow.push(params, z)
        got = persample.per_sample_cuda(flow, theta, x, dirs)
        ref = persample.per_sample_plain(flow, theta.double(), x.double(),
                                         dirs.double())
        ref32 = persample.per_sample_plain(flow, theta, x, dirs)
        torch.cuda.synchronize()
        for name, a, r, p in zip(("logp", "g", "quad", "O"), got, ref, ref32):
            if a.shape != r.shape or not torch.isfinite(a).all():
                fail(f"kernel {name} at N={n}: shape {tuple(a.shape)} vs "
                     f"{tuple(r.shape)}, or not finite")
            diff = (a.double() - r).abs().max()
            scale = r.abs().max().clamp_min(1.0)
            rel = float(diff / scale)
            rel32 = float((p.double() - r).abs().max() / scale)
            print(f"kernel vs plain, {label} theta, N={n}, {name}: max abs "
                  f"err {float(diff):.3e}, relative {rel:.3e} (tol "
                  f"{TOL[name]:.0e}; plain f32 {rel32:.3e})")
            if not rel < TOL[name]:
                fail(f"kernel {name} disagrees with the plain version at "
                     f"N={n}: {rel:.3e}")
            if name == "O":
                max_abs = max(max_abs, float(diff))
        del got, ref, ref32

    # time both on the main path's theta and batch, the last case above
    ms = _time_ms(lambda: persample.per_sample_cuda(flow, theta, x, dirs), 20)
    plain_ms = _time_ms(
        lambda: persample.per_sample_plain(flow, theta, x, dirs), 3)
    print(f"per-sample at N={n}, P=9264: CUDA kernel {ms:.3f} ms, plain "
          f"torch.func {plain_ms:.3f} ms")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)


def phase_main_path():
    persample.per_sample_cuda.launches = 0
    stamps = []

    def record(n_step, t, state, info):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, rec = driver.main(["fokkerPlanck32", "--max-steps", "5",
                          "--device", "cuda"], callbacks=[record])
    launches = persample.per_sample_cuda.launches
    steps = np.diff([t0] + stamps)
    print(f"fokkerPlanck32 N=16384: {len(steps)} Heun steps, wall s/step "
          f"{' '.join(f'{s:.3f}' for s in steps)} (first includes set-up), "
          f"mean of steps 2-{len(steps)} {steps[1:].mean():.3f} s")
    print(f"per-sample kernel launches in the main path: {launches}")
    if launches == 0:
        fail("the main path never launched the per-sample kernel")
    arrays = rec.as_arrays()
    for key in ("solver_res", "tdvp_error", "entropy", "covar", "x1",
                "eloc_mean", "ev_topk"):
        if not np.isfinite(arrays[key]).all():
            fail(f"non-finite {key} in the fokkerPlanck32 run")
    if arrays["nan"].any():
        fail("NaN update in the fokkerPlanck32 run")
    if arrays["covar"].shape != (5, 32, 32):
        fail(f"covar shape {arrays['covar'].shape}")
    res = arrays["solver_res"]
    print(f"fokkerPlanck32 solver_res per step: "
          f"{' '.join(f'{r:.3e}' for r in res)}")
    if not (res < 1e-3).all():
        fail(f"solver residual above 1e-3: {res}")
    return launches


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


def main():
    phase_device()
    full_f32_matmuls()
    dev = torch.device("cuda")
    kern = phase_kernel(dev)
    launches = phase_main_path()
    phase_mwe()
    print(json.dumps({"kernels": [{
        "name": "persample",
        "route": "cuda",
        "source": "vmc_pde_torch/kernels/csrc/persample.cu",
        "replaces": "vmc_pde_tpu/kernels/persample.py:899",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
