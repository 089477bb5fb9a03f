"""What limits the Metropolis CUDA kernel, from copies of its source
edited in memory (the port's library is built from the file as it is,
with no option for any of these). Needs a CUDA card:

    python -m tools.metropolis_probe [--reps 50] [--out FILE]

- ``proposals_only``: the scan warp takes each chunk's buffer and hands
  it back without its accept tests and sample stores: the proposal warps
  and the buffer hand-over alone;
- ``scan_only``: the proposal warps write a constant proposal in place of
  each pair's: the scan's accept tests, its sample stores and the
  hand-over alone;
- ``no_philox``: four multiplies of a cheap hash in place of each
  Philox-4x32-10 call (80 multiplies a proposal down to 8): what the
  Philox rounds cost;
- ``sqrt_radius``: ``sqrtf`` in place of ``powf(u, 1/2)`` for the ball
  radius: what the general power costs. Not the kernel's bits: the plain
  version's ``torch.pow`` rounds as ``powf``.

Shapes, with the wrapper's tile plan: 8192 chains x 128 sweeps with the
Philox stream and with external uniforms, and 2048 x 128 with Philox.
Each time is the mean of ``--reps`` launches of the C entry point on
inputs made once, between CUDA events (chip_smoke._time_ms), taken twice:
the builds in order, then in reverse order (tools/gram_probe.py, whose
build helpers this tool shares).
"""

import argparse
import ctypes
import json
import subprocess

import torch

from tools import gram_probe
from vmc_pde_torch.kernels import build, metropolis

NAME = "metropolis"
EDITS = {
    (NAME, "proposals_only"): ("", [(
        "      if (live) {\n        const float4* v = buf",
        "      if (false) {\n        const float4* v = buf", 1)]),
    (NAME, "scan_only"): (
        "\ntemplate <bool EXT>\n__device__ __forceinline__ float4 "
        "probe_constant(const float*, size_t, int, uint32_t, uint32_t,\n"
        "    unsigned, int, int s, const float* off, float) {\n"
        "  return make_float4(off[0], off[1], -1.f - 1e-3f * (s & 7), "
        "0.5f);\n}\n",
        [("dst[p] = propose<EXT>(", "dst[p] = probe_constant<EXT>(", 1)]),
    (NAME, "no_philox"): ("", [(
        "      philox4x32_10(w, k0, k1);\n",
        "      w[0] = (w[0] ^ k0) * 0x9E3779B9u + w[1] * 0x85EBCA6Bu;\n"
        "      w[1] = w[0] * 0xC2B2AE35u;\n"
        "      w[2] = (w[1] ^ k1) * 0x27D4EB2Fu + w[2];\n"
        "      w[3] = w[2] * 0x165667B1u;\n", 1)]),
    (NAME, "sqrt_radius"): ("", [("powf(uu[2 * DIM], INV_DIM)",
                                  "sqrtf(uu[2 * DIM])", 1)]),
}
SHAPES = ((8192, 128, False), (8192, 128, True), (2048, 128, False))


def rows(libs, dev, reps):
    out = []
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    off = torch.tensor((0.25, 0.25), device=dev)
    for C, sweeps, ext in SHAPES:
        init = off.repeat(C, 1)
        u = (torch.rand((6, sweeps * C), generator=gen, device=dev)
             * (1 - 2e-7) + 1e-7) if ext else None
        samples = torch.empty((sweeps * C, 2), device=dev)
        final = torch.empty((C, 2), device=dev)
        n_acc = torch.empty((), dtype=torch.int64, device=dev)
        TC, KS, threads, _ = metropolis.tile_plan(C, sweeps, n_sm)

        def call(lib, kind):
            build.check(lib.metropolis_f32(
                init.data_ptr(), off.data_ptr(), ctypes.c_float(0.25),
                None if u is None else u.data_ptr(), 5, 0, C, sweeps, TC, KS,
                threads, samples.data_ptr(), final.data_ptr(),
                n_acc.data_ptr(), stream), kind)

        row = dict(chains=C, sweeps=sweeps, plan=[TC, KS, threads],
                   uniforms="external" if ext else "philox")
        gram_probe._there_and_back(row, libs, call, reps)
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    jobs = {kind: gram_probe.start_build(NAME, kind, EDITS)
            for _, kind in EDITS}
    libs = {"kernel": build.library(NAME)}
    for kind, job in jobs.items():
        libs[kind] = gram_probe.load(NAME, *job)
    rec = dict(card=card, rows=rows(libs, torch.device("cuda"), args.reps))
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
