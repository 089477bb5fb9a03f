"""The per-sample CUDA kernel at every launch plan the wrapper could
choose (kernels/persample.py candidates), beside the one it chooses
(tile_plan), on the flows past dim 64, halves of 32, widths of 64 and four
linear layers. Needs a CUDA card:

    python -m tools.persample_plans [--n 16384] [--reps 3] [--out FILE]

Flows (chip_smoke.py's WIDE, their initial theta and draws pushed through
them): A (d=128, depth 2, hidden 16), d=96 depth 4, B (five linear
layers), width 96 and scripts/bench_persample.py's d=128 depth 4 hidden 64
(P=141,504), at ``--n`` samples (by default chip_smoke.py's W_N, the size
phase W times); and fokkerPlanck32's own flow at N=16384 at its plan
alone. Each candidate -- a tile T of TILES, a placement of PLACEMENTS
(which of theta, the constants, the tile's arrays and the work rows sit in
shared memory; the rest in global memory or the workspace) with its most
jet slots J that fit -- with the grid the wrapper would give it at that N
(persample.grid_of): the plain-mode call's ms (the mean of ``--reps``
calls between CUDA events after a warm-up, chip_smoke._time_ms). Every
plan's outputs must equal the wrapper's own plan's bit for bit (a plan
places the work; it changes no sum). One JSON line per flow, the plans
fastest first.
"""

import argparse
import json
import subprocess

import torch

from chip_smoke import W_N, WIDE, _time_ms, _wide_flow
from vmc_pde_torch.kernels import persample

FLOWS = [label for label in WIDE if "Student" not in label
         and not label.startswith("SanityFlow")]


def plans(flow, k, n, n_sm):
    """The wrapper's plan for n samples, then every other candidate with
    its grid at n."""
    own = persample.tile_plan(flow, k, n, n_sm)
    return [own] + [p for p in (persample.grid_of(c, flow, n, n_sm)
                                for c in persample.candidates(flow, k))
                    if p != own]


def sweep(label, n, reps, n_sm, dev, every=True):
    flow, theta, dirs = _wide_flow(label, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = flow.layout.unravel(theta)
    x = flow.push(params, flow.latent_sample(gen, params, n,
                                             torch.float32))[0]
    k = dirs.shape[0]
    own = persample.tile_plan
    rows, ref = [], None
    for plan in plans(flow, k, n, n_sm) if every else [own(flow, k, n,
                                                            n_sm)]:
        persample.tile_plan = lambda *a, plan=plan, **kw: plan
        try:
            ms = _time_ms(lambda: persample.per_sample_cuda(flow, theta, x,
                                                            dirs), reps)
            got = persample.per_sample_cuda(flow, theta, x, dirs)
        finally:
            persample.tile_plan = own
        if ref is None:
            ref = got
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise RuntimeError(f"{label}: plan {plan} changed the outputs")
        rows.append(dict(plan._asdict(), ms=ms,
                         own=len(rows) == 0))
        print(f"{label} N={n} T={plan.T} J={plan.J} MW={plan.MW} where="
              f"{plan.where:04b} (work, tile, constants, theta) ws="
              f"{plan.ws}: {ms:.3f} ms" + ("  <- the wrapper's plan"
                                          if len(rows) == 1 else ""),
              flush=True)
    return dict(flow=label, N=n, P=flow.layout.size, k=k,
                plans=sorted(rows, key=lambda r: r["ms"]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=W_N)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    results = [sweep(label, args.n, args.reps, n_sm, dev)
               for label in FLOWS]
    results.append(sweep("fokkerPlanck32", 16384, 10, n_sm, dev,
                         every=False))
    for r in results:
        line = json.dumps(dict(r, card=card))
        print(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
