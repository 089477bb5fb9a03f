"""What limits the syrk and quant8 CUDA kernels, from copies of their
sources edited in memory (the port's own libraries are built from the
files as they are, with no option for either). Needs a CUDA card:

    python -m tools.gram_probe [--reps 10] [--out FILE]

- syrk ``load_only``: the product kernel with its three wgmma per 16
  samples removed -- the TMA loads, the mbarrier ring, the flushes and
  the epilogue stay. Its time is what moving the operands into the SMs
  takes; the kernel's time beside it says whether the loads or the
  tensor cores set the pace.
- syrk ``in_order``: every stage's products complete before the next
  stage's are issued (no stage in flight across the wait); ``one_launch``:
  all samples in one launch (the kernel's launches of KCHUNK stages
  each keep the blocks in step, so the rows they share stay in L2);
  ``kchunk128``: launches of half as many stages.
- quant8 ``no_v``: the kernel without its V term (f is not accumulated,
  so V is never loaded): the read of x and the int8 stores alone;
  ``rows1``, ``rows8``: 1 or 8 rows per block instead of ROWS;
  ``evict_first``: x read with evict-first loads (``__ldcs``);
  ``two_blocks``: the launch bounds of two blocks per SM instead of three.

Shapes: syrk's product at P=9264 (fokkerPlanck32's parameter count) for
N=16384 (the direct step) and 65536 (a chunk of the chunked path), on the
split operands made once; quant8 at P=9264, n=65536, kv=2 and 1. Each
time is the mean of ``--reps`` launches of the C entry point on inputs
made once, between CUDA events (chip_smoke._time_ms), taken twice: the
builds in order, then in reverse order, so that a drift of the card's
clock over the run shows as the spread of each pair (``<kind>_ms`` is the
pair). The operand rate is the bytes the product's stages bring into the
SMs (64 KB per stage of 64 samples, per lower tile) over the kernel's
mean time.
"""

import argparse
import ctypes
import hashlib
import json
import subprocess

import numpy as np
import torch

from chip_smoke import _time_ms
from vmc_pde_torch.kernels import build, syrk

P = 9264
# (source, kind) -> the prelude inserted after INCLUDE, and the (old, new,
# count) replacements
INCLUDE = "#include <cstdint>\n"
EDITS = {
    ("syrk", "load_only"): (
        "\n__device__ __forceinline__ void probe_skip(float (&)[64], "
        "uint64_t, uint64_t, int) {}\n",
        [("    wgmma_m64n128k16(acc, ", "    probe_skip(acc, ", 3)]),
    ("syrk", "in_order"): ("", [("wgmma_wait<1>();", "wgmma_wait<0>();",
                                  1)]),
    ("syrk", "one_launch"): ("", [("constexpr int KCHUNK = 256;",
                                   "constexpr int KCHUNK = 1 << 24;", 1)]),
    ("syrk", "kchunk128"): ("", [("constexpr int KCHUNK = 256;",
                                  "constexpr int KCHUNK = 128;", 1)]),
    ("quant8", "no_v"): (
        "",
        [("          acc[r][k] = fmaf(xf[j], v[k][j], acc[r][k]);\n",
          "          acc[r][k] = acc[r][k];\n", 1)]),
    ("quant8", "rows1"): ("", [("constexpr int ROWS = 2;",
                                "constexpr int ROWS = 1;", 1)]),
    ("quant8", "rows8"): ("", [("constexpr int ROWS = 2;",
                                "constexpr int ROWS = 8;", 1)]),
    ("quant8", "evict_first"): ("", [(
        "raw[r] = *reinterpret_cast<const uint4*>(",
        "raw[r] = __ldcs(reinterpret_cast<const uint4*>(", 1), (
        "                                                  i);",
        "                                                  i));", 1)]),
    ("quant8", "two_blocks"): ("", [("__launch_bounds__(THREADS, 3)",
                                     "__launch_bounds__(THREADS, 2)", 1)]),
}


def variant_source(name: str, kind: str, table=None) -> str:
    """csrc/<name>.cu with the ``kind`` edit of ``table`` (EDITS by
    default); raises if an anchor is not found as often as expected (the
    kernel changed under the tool)."""
    src = (build.CSRC / f"{name}.cu").read_text()
    prelude, edits = (table or EDITS)[(name, kind)]
    if src.count(INCLUDE) != 1:
        raise RuntimeError(f"{INCLUDE.strip()!r} not found once")
    src = src.replace(INCLUDE, INCLUDE + prelude)
    for old, new, count in edits:
        if src.count(old) != count:
            raise RuntimeError(f"{old.strip()!r} found {src.count(old)} "
                               f"times, expected {count}")
        src = src.replace(old, new)
    return src


def start_build(name: str, kind: str, table=None):
    """Starts nvcc on the edited source (the port's flags) in the ignored
    build directory; returns (library path, process or None if built)."""
    src = variant_source(name, kind, table)
    h = hashlib.sha256((" ".join(build.NVCC_FLAGS) + src).encode())
    out = build.BUILD_ROOT / f"probe-{name}-{kind}-{h.hexdigest()[:16]}"
    so = out / f"lib{name}.so"
    if so.exists():
        return so, None
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(src)
    return so, subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
         str(out / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def load(name, so, proc):
    if proc is not None:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {so.parent.name}:\n{err}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in build.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _there_and_back(row, libs, call, reps):
    """row[<kind>_ms] = [ms in order, ms in reverse order] per build."""
    kinds = list(libs)
    for kind in kinds + kinds[::-1]:
        row.setdefault(f"{kind}_ms", []).append(
            _time_ms(lambda: call(libs[kind], kind), reps))


def syrk_rows(libs, dev, reps):
    rows = []
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    nb = -(-P // syrk.TILE)
    tiles = torch.from_numpy(syrk.tile_list(nb)).to(dev)
    S = torch.empty((P, P), dtype=torch.float32, device=dev)
    for n in (16384, 65536):
        O = torch.randn((P, n), generator=gen, device=dev).T
        ops = syrk.split_cuda(O)
        del O
        row = dict(N=n, P=P, operand_bytes=len(tiles) * -(-ops.shape[2]
                                                          // syrk.KBOX)
                   * 4 * syrk.TILE * syrk.KBOX * 2)
        def call(lib, kind):
            build.check(lib.syrk_tiles_bf16(
                ops.data_ptr(), 2, P, ops.shape[2], tiles.data_ptr(),
                len(tiles), S.data_ptr(), stream), kind)
        _there_and_back(row, libs, call, max(2, reps * 16384 // n))
        for kind in ("kernel", "load_only"):
            row[f"{kind}_operand_tbs"] = (row["operand_bytes"] / 1e9
                                          / np.mean(row[f"{kind}_ms"]))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del ops
    return rows


def quant8_rows(libs, dev, reps):
    rows = []
    gen = torch.Generator(device=dev).manual_seed(1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = 65536
    x = torch.randn((P, n), generator=gen, device=dev).to(torch.bfloat16)
    inv = 127.0 / x.float().abs().amax(1)
    q8 = torch.empty((P, n), dtype=torch.int8, device=dev)
    for kv in (2, 1):
        V = torch.randn((n, kv), generator=gen, device=dev).to(
            torch.bfloat16)
        f = torch.empty((P, kv), dtype=torch.float32, device=dev)
        row = dict(P=P, n=n, kv=kv, bytes=3 * P * n)
        def call(lib, kind):
            build.check(lib.quant_force_bf16(
                x.data_ptr(), inv.data_ptr(), V.data_ptr(), P, n, kv,
                q8.data_ptr(), f.data_ptr(), stream), kind)
        _there_and_back(row, libs, call, reps * 2)
        row["kernel_tbs"] = row["bytes"] / 1e9 / np.mean(row["kernel_ms"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    jobs = {key: start_build(*key) for key in EDITS}
    libs = {name: {"kernel": build.library(name)} for name in ("syrk",
                                                               "quant8")}
    for (name, kind), job in jobs.items():
        libs[name][kind] = load(name, *job)
    dev = torch.device("cuda")
    rec = dict(card=card, syrk=syrk_rows(libs["syrk"], dev, args.reps),
               quant8=quant8_rows(libs["quant8"], dev, args.reps))
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
