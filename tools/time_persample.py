"""Card times of the per-sample CUDA kernel at the shapes of the port's
paths, and of one fixed-Heun step of the two fokkerPlanck32 operating
points, as one JSON line. Needs a CUDA card:

    python -m tools.time_persample [--reps 20] [--steps 3] [--out FILE]

To compare two checkouts on one card, run each one's copy of this tool
in the same call, in the order parent, new, new, parent. chip_smoke.py
times the kernels of its own tree alone.

Kernel shapes (fokkerPlanck32's flow, d=32, P=9264, 16 trace directions,
the preset's initial theta and draws pushed through it): plain mode at
N=16384 (the direct step), 2048 (the chunked path's pilot) and 4096 (one
rank's rows of 4, launched alone); split mode at N=65536 (the production
chunk); the Student-t + global-affine flow (P=9397) plain at N=16384 and
split at N=65536. Each time is the mean of ``--reps`` launches between
CUDA events after one warm-up launch (the wrapper's calls back to back,
as chip_smoke.py times them), the profiler's device time of the kernel
itself per launch, its bound (vmc_pde_torch/kernels/bounds.py) and the
bound's share of the call time; at the two small plain shapes, where the
wrapper's host work outlasts the kernel, where that host time goes
(``host_ops``). Steps:
``driver.main`` on fokkerPlanck32 at N=16384 direct, and at N=524288 in
chunks of 65536 with tri2 + int8, each the mean wall time of the steps
after the first (host clock, synchronized).
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from torch.profiler import ProfilerActivity, profile

from chip_smoke import _time_ms
from tools.profile_step import device_rows
from vmc_pde_torch import driver
from vmc_pde_torch.config import preset
from vmc_pde_torch.kernels import bounds, build, persample
from vmc_pde_torch.models.flow import build_flow
from vmc_pde_torch.ops.evolution import make_equation
from vmc_pde_torch.utils.dtypes import full_f32_matmuls


def device_ms(fn, reps, name="persample_kernel"):
    """The profiler's device time per call of the kernels whose name
    contains ``name`` over ``reps`` calls of fn (the kernel alone, without
    the wrapper's host work and the small torch ops around it)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ms for key, ms, _ in device_rows(prof) if name in key) / reps


def host_ops(fn, reps, top=10):
    """Where a call's host time goes: the host wall time per call with
    the card kept idle in between (a synchronize after each call, the
    kernel's device time not subtracted), and the ``top`` torch ops by
    the profiler's self CPU time per call (its own overhead included)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = sorted(((e.key, e.self_cpu_time_total / 1e3 / reps, e.count // reps)
                  for e in prof.key_averages()), key=lambda r: -r[1])
    return dict(wall_ms=wall, ops_ms=sum(ms for _, ms, _ in ops),
                top=[dict(op=k, ms=ms, per_call=c) for k, ms, c in ops[:top]])


def problem(dev, **flow_kw):
    cfg = preset("fokkerPlanck32")
    flow, theta = build_flow(cfg.seed, cfg.dim, depth=cfg.depth,
                             hidden=cfg.hidden_resolved(),
                             variant=cfg.variant, out_scale=cfg.init_scale,
                             dtype=torch.float32, device=dev, **flow_kw)
    eq = make_equation(cfg.equation, cfg.dim, **cfg.equation_params)
    dirs = torch.as_tensor(eq.hessian_trace_dirs(cfg.dim),
                           dtype=torch.float32, device=dev)
    return flow, theta, dirs


def kernel_rows(dev, reps):
    out = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, kw, cases in (
            ("Gauss", {}, (("plain", 16384), ("plain", 2048),
                           ("plain", 4096), ("split", 65536))),
            ("Student-t + global affine",
             dict(latent_name="Student_t", global_affine=True),
             (("plain", 16384), ("split", 65536)))):
        flow, theta, dirs = problem(dev, **kw)
        params = flow.layout.unravel(theta)
        P, d, k = flow.layout.size, flow.dim, dirs.shape[0]
        for mode, n in cases:
            x = flow.push(params, flow.latent_sample(gen, params, n,
                                                     torch.float32))[0]
            if mode == "plain":
                fn = lambda: persample.per_sample_cuda(flow, theta, x, dirs)
            else:
                shift = torch.zeros(P, device=dev)
                fn = lambda: persample.per_sample_split_cuda(  # noqa: E731
                    flow, theta, x, dirs, shift)
            r = max(3, reps * 16384 // max(n, 16384))
            ms = _time_ms(fn, r)
            dev_ms = device_ms(fn, r)
            bound, by = bounds.persample(bounds.flow_layers(flow), d, P, n, k,
                                         split=mode == "split",
                                         n_ga=bounds.flow_ga(flow))
            out.append(dict(flow=label, mode=mode, N=n, P=P, ms=ms,
                            device_ms=dev_ms, bound_ms=bound, bound_by=by,
                            share=bound / ms))
            print(f"{label} {mode} N={n} P={P}: {ms:.4f} ms per call, "
                  f"kernel device time {dev_ms:.4f} ms, bound {bound:.4f} "
                  f"ms ({by}), share {bound / ms:.4f}", flush=True)
            if mode == "plain" and n <= 4096:
                out[-1]["host"] = host_ops(fn, r)
                print(json.dumps(out[-1]["host"]), flush=True)
            del x
    return out


def step_rows(n_steps):
    out = []
    for label, args in (
            ("fokkerPlanck32 N=16384 direct", ["fokkerPlanck32"]),
            ("fokkerPlanck32 N=524288 chunk 65536 tri2+int8",
             ["fokkerPlanck32", "--samples", "524288", "--chunk-size",
              "65536", "--gram-backend", "tri2", "--gram-cross", "int8"])):
        stamps = []

        def record(n_step, t, state, info):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        driver.main(args + ["--max-steps", str(n_steps), "--device",
                            "cuda"], callbacks=[record])
        steps = np.diff(stamps)
        out.append(dict(path=label, s_per_step=float(steps.mean()),
                        steps=steps.tolist()))
        print(f"{label}: s/step after the first {steps.tolist()}, mean "
              f"{steps.mean():.4f}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    full_f32_matmuls()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    t0 = time.perf_counter()
    build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s; {card}", flush=True)
    ptxas = [line.strip() for line in build.build_log("persample")
             .splitlines() if "registers" in line or "stack frame" in line]
    rec = dict(card=card, ptxas=ptxas, kernels=kernel_rows(dev, args.reps),
               steps=step_rows(args.steps) if args.steps > 1 else [])
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
