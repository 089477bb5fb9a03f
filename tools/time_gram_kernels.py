"""Card times of the syrk and quant8 CUDA kernels at the shapes of the
port's paths, and of the two steps that run them, as one JSON line. Needs
a CUDA card:

    python -m tools.time_gram_kernels [--reps 10] [--steps 3] [--out FILE]

To compare two checkouts on one card, run each one's copy of this tool in
the same call, in the order parent, new, new, parent (the tool uses only
the wrappers' public functions, so a copy of it runs in an older checkout
too). chip_smoke.py times the kernels of its own tree alone.

Kernel shapes (P=9264, fokkerPlanck32's parameter count): syrk at N=16384
(the direct step), unweighted and with a signed weight (S0 and A), and at
N=65536 (one chunk of the chunked path), on a feature-major operand as the
per-sample kernel hands it over; quant8 at n=65536 with kv=2 (the hi half)
and kv=1 (the lo half), on random bf16 operands. Each ``ms`` is the mean
of ``--reps`` wrapper calls between CUDA events after one warm-up call
(chip_smoke._time_ms), ``device_ms`` the profiler's device time of every
kernel the call runs (the split pass and the product, or the parent's
kernel and its mirror select), itemized by kernel in ``device_by_kernel``,
and ``share`` the bound (vmc_pde_torch/kernels/bounds.py) over ``ms``.
Steps: ``driver.main`` on ``fokkerPlanck32 --gram-backend syrk`` at
N=16384 and on the chunked tri2 + int8 production point (N=524288 in
chunks of 65536), each the mean wall time of the steps after the first
(host clock, synchronized).
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
from vmc_pde_torch.kernels import bounds, build, quant8, syrk
from vmc_pde_torch.utils.dtypes import full_f32_matmuls

P = 9264


def device_ms(fn, reps):
    """(device ms per call of every kernel fn runs, {kernel: ms per
    call}) over ``reps`` calls, from the profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {key: ms / reps for key, ms, _ in device_rows(prof)}
    return sum(rows.values()), rows


def _row(label, fn, reps, bound, **shape):
    ms = _time_ms(fn, reps)
    dev_ms, by = device_ms(fn, reps)
    row = dict(kernel=label, **shape, ms=ms, device_ms=dev_ms,
               device_by_kernel=by, bound_ms=bound[0], bound_by=bound[1],
               share=bound[0] / ms)
    print(f"{label} {shape}: {ms:.4f} ms per call, device {dev_ms:.4f} ms, "
          f"bound {bound[0]:.4f} ms ({bound[1]}), share {bound[0] / ms:.4f}",
          flush=True)
    return row


def kernel_rows(dev, reps):
    out = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, weighted in ((16384, False), (16384, True), (65536, False)):
        O = torch.randn((P, n), generator=gen, device=dev).T
        w = torch.randn((n,), generator=gen, device=dev) if weighted else None
        r = max(2, reps * 16384 // n)
        out.append(_row("syrk", lambda: syrk.syrk_cuda(O, w), r,
                        bounds.syrk(n, P, weighted), N=n, P=P,
                        weighted=weighted))
        del O, w
    n = 65536
    x = torch.randn((P, n), generator=gen, device=dev).to(torch.bfloat16)
    amax = x.float().abs().amax(1)
    inv = 127.0 / amax
    for kv in (2, 1):
        V = torch.randn((n, kv), generator=gen, device=dev).to(
            torch.bfloat16)
        out.append(_row("quant8", lambda: quant8.quant_force_cuda(x, inv, V),
                        reps * 2, bounds.quant8(P, n, kv), P=P, n=n, kv=kv))
    return out


def step_rows(n_steps):
    out = []
    for label, args in (
            ("fokkerPlanck32 N=16384 direct, syrk Gram",
             ["fokkerPlanck32", "--gram-backend", "syrk"]),
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
    ap.add_argument("--reps", type=int, default=10)
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
    ptxas = {name: [line.strip() for line in build.build_log(name)
                    .splitlines()
                    if "registers" in line or "stack frame" in line
                    or "spill" in line]
             for name in ("syrk", "quant8")}
    rec = dict(card=card, ptxas=ptxas, kernels=kernel_rows(dev, args.reps),
               steps=step_rows(args.steps) if args.steps > 1 else [])
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
