"""Card times of the Metropolis CUDA kernel at the shapes of the port's
paths, as one JSON line. Needs a CUDA card:

    python -m tools.time_metropolis [--reps 50] [--label L] [--chains]
        [--plans] [--out FILE]

To compare two checkouts on one card, run a copy of this tool in each of
them in the same call, in the order parent, new, new, parent: it calls only
``metropolis_chain_cuda`` and ``bounds.metropolis``, which older checkouts
have too. chip_smoke.py times the kernel of its own tree alone.

Shapes (chains x sweeps, the first chain's global index, d=2, bound 0.25
around (0.25, 0.25), every chain started at the offset), each with the
Philox stream and with external uniforms: 128 x 24; 8192 x 128, the
``VarState.sample`` launch of chip_smoke.py; 8192 x 136, a chunk of 8
sweeps at the end; 2048 x 128 from chain 2048, one rank's launch of 4.
For each: ``ms``, the mean of ``--reps`` wrapper calls between CUDA events
after one warm-up call (chip_smoke._time_ms); ``device_ms``, the
profiler's device time per call of the kernel alone (kernels named
metropolis); ``host_ms``, the host's time per call to issue it, the card
busy with the calls before (a copy from pageable host memory in the
wrapper would wait for them); the bound (vmc_pde_torch/kernels/bounds.py)
and, where the checkout has its terms, the bound with Philox left out.

``--chains``: the Philox launch at 128 sweeps on 128, 1024, 2048, 8192 and
65536 chains, the time against the chain count. ``--plans`` (a checkout
with ``metropolis.tile_plan``): the kernel at 8192 x 128 (both uniform
sources) and 2048 x 128 under other tile plans than the wrapper's, each
checked bit for bit against the wrapper's own plan.
"""

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import _time_ms
from tools.profile_step import device_rows
from vmc_pde_torch.kernels import bounds, build, metropolis

OFFSET = (0.25, 0.25)
SHAPES = ((128, 24, 0), (8192, 128, 0), (8192, 136, 0), (2048, 128, 2048))
CHAINS = (128, 1024, 2048, 8192, 65536)
# (chains per block, sweeps per chunk, threads) tried by --plans
PLANS = ((32, 16, 288), (32, 32, 288), (32, 16, 544), (16, 16, 288),
         (16, 32, 288), (16, 16, 160), (16, 32, 544), (8, 32, 288),
         (8, 16, 160), (8, 32, 160), (8, 64, 288))


def device_ms(fn, reps):
    """The profiler's device time per call of the kernels named
    metropolis over ``reps`` calls of fn."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ms for key, ms, _ in device_rows(prof)
               if "metropolis" in key) / reps


def host_ms(fn, reps):
    """Host time per call to issue fn, calls back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def problem(dev, C, sweeps, ext, gen):
    init = torch.tensor(OFFSET, device=dev).repeat(C, 1)
    u = None
    if ext:
        u = torch.rand((6, sweeps * C), generator=gen, device=dev) \
            * (1 - 2e-7) + 1e-7
    return init, u


def bound_row(C, sweeps, ext):
    n = C * sweeps
    ms, by = bounds.metropolis(n, 2, ext=ext)
    row = dict(bound_ms=ms, bound_by=by)
    if hasattr(bounds, "metropolis_terms"):
        t = bounds.metropolis_terms(n, 2, ext=ext)
        row.update(terms_ms=t, bound_without_philox_ms=max(t["bytes"],
                                                           t["f32"]))
    return row


def shape_rows(dev, reps):
    out = []
    gen = torch.Generator(device=dev).manual_seed(2)
    for C, sweeps, base in SHAPES:
        for ext in (False, True):
            init, u = problem(dev, C, sweeps, ext, gen)

            def fn():
                return metropolis.metropolis_chain_cuda(
                    5, init, sweeps, 0.25, OFFSET, u, chain_base=base)

            row = dict(chains=C, sweeps=sweeps, chain_base=base,
                       uniforms="external" if ext else "philox",
                       ms=_time_ms(fn, reps), device_ms=device_ms(fn, reps),
                       host_ms=host_ms(fn, reps), **bound_row(C, sweeps, ext))
            row["share"] = row["bound_ms"] / row["ms"]
            out.append(row)
            print(f"{C} x {sweeps} from {base}, {row['uniforms']}: "
                  f"{row['ms']:.4f} ms per call, device "
                  f"{row['device_ms']:.4f} ms, host {row['host_ms']:.4f} ms, "
                  f"bound {row['bound_ms']:.6f} ms ({row['bound_by']}), "
                  f"share {row['share']:.4f}", flush=True)
    return out


def chain_rows(dev, reps):
    out = []
    for C in CHAINS:
        init, _ = problem(dev, C, 128, False, None)

        def fn():
            return metropolis.metropolis_chain_cuda(5, init, 128, 0.25,
                                                    OFFSET)

        row = dict(chains=C, sweeps=128, ms=_time_ms(fn, reps),
                   device_ms=device_ms(fn, reps))
        out.append(row)
        print(f"Philox, {C} chains x 128 sweeps: {row['ms']:.4f} ms per "
              f"call, device {row['device_ms']:.4f} ms", flush=True)
    return out


def plan_rows(dev, reps):
    """Each plan of PLANS in place of the wrapper's (tile_plan replaced for
    the call), against the wrapper's own plan bit for bit."""
    own = metropolis.tile_plan
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(4)
    out = []
    for C, sweeps, ext in ((8192, 128, False), (8192, 128, True),
                           (2048, 128, False)):
        init, u = problem(dev, C, sweeps, ext, gen)

        def fn():
            return metropolis.metropolis_chain_cuda(5, init, sweeps, 0.25,
                                                    OFFSET, u)

        ref = fn()
        for TC, KS, threads in (own(C, sweeps, n_sm)[:3],) + PLANS:
            metropolis.tile_plan = (
                lambda *a, p=(TC, KS, threads):
                (*p, 2 * p[0] * p[1] * metropolis.PAIR_BYTES))
            try:
                got = fn()
                same = all(torch.equal(a, r) for a, r in zip(got, ref))
                row = dict(chains=C, sweeps=sweeps,
                           uniforms="external" if ext else "philox",
                           plan=[TC, KS, threads], same=same,
                           ms=_time_ms(fn, reps),
                           device_ms=device_ms(fn, reps))
            finally:
                metropolis.tile_plan = own
            out.append(row)
            print(f"plan TC={TC} KS={KS} threads={threads}, {C} x {sweeps} "
                  f"{row['uniforms']}: {row['ms']:.4f} ms, device "
                  f"{row['device_ms']:.4f} ms, bitwise the wrapper's plan: "
                  f"{same}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--label", default="")
    ap.add_argument("--chains", action="store_true")
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    t0 = time.perf_counter()
    build.build_all()
    print(f"[{args.label}] built in {time.perf_counter() - t0:.1f} s; {card}",
          flush=True)
    ptxas = [line.strip() for line in build.build_log("metropolis")
             .splitlines() if "registers" in line or "stack frame" in line
             or "spill" in line]
    rec = dict(label=args.label, card=card, ptxas=ptxas,
               shapes=shape_rows(dev, args.reps))
    if args.chains:
        rec["chains"] = chain_rows(dev, args.reps)
    if args.plans:
        rec["plans"] = plan_rows(dev, args.reps)
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
