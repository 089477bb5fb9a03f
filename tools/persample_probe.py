"""Two measurements of the per-sample CUDA kernel that need another build
of it, made here from copies of csrc/persample.cu edited in memory (the
port's own library is built from the file as it is, with no option for
either). Needs a CUDA card:

    python -m tools.persample_probe [--reps 20] [--out FILE]

- ``phases``: block 0's thread 0 records clock64() at the kernel's section
  boundaries -- loading theta, the constants and the tile; the forward;
  the latent and its O rows; the conditioners' backward with their O rows
  (and g); the jets -- read back after the launch.
- ``no_stores``: every streaming O store (``__stcs``) happens only where
  the bits of the value equal a key no value takes, so each value is still
  computed and nothing is written: the kernel's time less this one's is
  what its O stores cost.

Shapes: fokkerPlanck32's flow (d=32, P=9264, 16 trace directions, the
preset's initial theta and draws pushed through it), plain mode at
N=16384 (the direct step) and 2048 (the chunked path's pilot), split mode
at N=65536 (the production chunk). Each time is the mean of ``--reps``
launches of the C entry point on inputs made once (the kernel and its
launch, without the wrapper's host work), between CUDA events
(chip_smoke._time_ms). The store rate is the O bytes (P N 4: f32, or the
bf16 pair) over the kernel's time; the card writes at most 3.35 TB/s.
"""

import argparse
import ctypes
import hashlib
import json
import subprocess

import torch

from chip_smoke import _time_ms
from tools.time_persample import problem
from vmc_pde_torch.kernels import build, persample

HBM_TBS = 3.35
PHASES = ("load", "forward", "latent", "backward", "jets")
# (line of the kernel, stamp, placed before or after it): stamps 0..5
# bound the five phases
ANCHORS = (("    float* __restrict__ saves_out) {", 0, "after"),
           ("  // ---- forward:", 1, "before"),
           ("  if (DUMP) {", 2, "before"),
           ("  // scratch rows: four for bwd_nets", 3, "before"),
           ("  // ---- Hessian quadratic trace", 4, "before"),
           ("  jets<MW>(C, C.th, quad_out);", 5, "after"))
PRELUDE = {
    "phases": r"""
__device__ long long probe_clock[6];
#define PROBE_STAMP(k)                          \
  do {                                          \
    if (blockIdx.x == 0 && threadIdx.x == 0)    \
      probe_clock[k] = clock64();               \
  } while (0)
extern "C" int probe_phases(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, probe_clock, sizeof(probe_clock));
}
""",
    "no_stores": r"""
template <class P, class V>
__device__ __forceinline__ void probe_sink(P* p, V v) {
  uint32_t w[sizeof(V) / 4], h = 0;
  memcpy(w, &v, sizeof(V));
#pragma unroll
  for (int i = 0; i < (int)(sizeof(V) / 4); ++i) h ^= w[i];
  if (h == 0x7fc00001u) __stcs(p, v);
}
#define __stcs probe_sink
""",
}
INCLUDE = "#include <cstring>\n"


def variant_source(kind: str) -> str:
    """csrc/persample.cu with the ``kind`` edit; raises if an anchor is
    not found exactly once (the kernel changed under the tool)."""
    src = (build.CSRC / "persample.cu").read_text()
    if src.count(INCLUDE) != 1:
        raise RuntimeError(f"{INCLUDE.strip()!r} not found once")
    src = src.replace(INCLUDE, INCLUDE + PRELUDE[kind])
    if kind == "no_stores":
        return src
    lines = src.split("\n")
    for text, k, where in ANCHORS:
        at = [i for i, line in enumerate(lines) if line.startswith(text)]
        if len(at) != 1:
            raise RuntimeError(f"anchor {text!r} found {len(at)} times")
        lines.insert(at[0] + (where == "after"), f"  PROBE_STAMP({k});")
    return "\n".join(lines)


def start_build(kind: str):
    """Starts nvcc on the edited source (the port's flags) in the ignored
    build directory; returns (library path, process or None if built)."""
    src = variant_source(kind)
    h = hashlib.sha256((" ".join(build.NVCC_FLAGS) + src).encode())
    out = build.BUILD_ROOT / f"probe-{kind}-{h.hexdigest()[:16]}"
    so = out / "libpersample.so"
    if so.exists():
        return so, None
    out.mkdir(parents=True, exist_ok=True)
    (out / "persample.cu").write_text(src)
    return so, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
         str(out / "persample.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def load(so, proc):
    if proc is not None:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {so.parent.name}:\n{err}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in build.SIGNATURES["persample"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def launcher(lib, flow, theta, x, dirs, split):
    """A closure that launches ``lib``'s kernel on inputs and outputs made
    once, and the outputs (logp, and O or the hi/lo pair)."""
    inputs = persample._launch_inputs(flow, theta, x, dirs)
    args = persample._launch_args(*inputs[:6])
    n, d, P, dev = x.shape[0], flow.dim, flow.layout.size, x.device
    f32 = dict(dtype=torch.float32, device=dev)
    logp, g, quad = (torch.empty(n, **f32), torch.empty((d, n), **f32),
                     torch.empty(n, **f32))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if not split:
        O = torch.empty((P, n), **f32)

        def call():
            build.check(lib.persample_f32(
                *args, logp.data_ptr(), g.data_ptr(), quad.data_ptr(),
                O.data_ptr(), None, stream), "persample_f32")
        call.inputs = inputs  # args holds their raw pointers
        return call, (logp, O)
    shift = torch.zeros(P, **f32)
    hi, lo = (torch.empty((P, n), dtype=torch.bfloat16, device=dev)
              for _ in range(2))
    colsum, omax = torch.empty(P, **f32), torch.empty(P, **f32)
    n_tiles = -(-n // args[8])
    psum, pmax = (torch.empty((n_tiles, P), **f32) for _ in range(2))

    def call():
        build.check(lib.persample_split_f32(
            *args, shift.data_ptr(), logp.data_ptr(), g.data_ptr(),
            quad.data_ptr(), hi.data_ptr(), lo.data_ptr(), colsum.data_ptr(),
            omax.data_ptr(), psum.data_ptr(), pmax.data_ptr(), stream),
            "persample_split_f32")
    call.inputs = inputs
    return call, (logp, hi, lo)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    jobs = {kind: start_build(kind) for kind in PRELUDE}
    libs = {"kernel": build.library("persample")}
    libs.update({kind: load(*job) for kind, job in jobs.items()})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flow, theta, dirs = problem(dev)
    params = flow.layout.unravel(theta)
    P = flow.layout.size
    rows = []
    for mode, n in (("plain", 16384), ("plain", 2048), ("split", 65536)):
        x = flow.push(params, flow.latent_sample(gen, params, n,
                                                 torch.float32))[0]
        reps = max(3, args.reps * 16384 // max(n, 16384))
        row = dict(mode=mode, N=n, P=P, o_bytes=4 * P * n)
        outs = {}
        for kind, lib in libs.items():
            call, outs[kind] = launcher(lib, flow, theta, x, dirs,
                                        mode == "split")
            row[f"{kind}_ms"] = _time_ms(call, reps)
            if kind == "phases":
                buf = (ctypes.c_longlong * 6)()
                build.check(lib.probe_phases(buf), "probe_phases")
                row["block0_cycles"] = {name: buf[k + 1] - buf[k]
                                        for k, name in enumerate(PHASES)}
        torch.cuda.synchronize()
        # the edits change no value the kernel computes
        row["same_logp"] = all(torch.equal(o[0], outs["kernel"][0])
                               for o in outs.values())
        row["same_o"] = all(torch.equal(a, b) for a, b in zip(
            outs["phases"][1:], outs["kernel"][1:]))
        row["store_tbs"] = row["o_bytes"] / row["kernel_ms"] / 1e9
        row["store_share_of_hbm"] = row["store_tbs"] / HBM_TBS
        row["stores_cost_ms"] = row["kernel_ms"] - row["no_stores_ms"]
        rows.append(row)
        print(json.dumps(row), flush=True)
        del x, outs
    line = json.dumps({"card": card, "plan": [
        persample.tile_plan(flow, dirs.shape[0], r["N"])[:5] for r in rows],
        "rows": rows})
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
