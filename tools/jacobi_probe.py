"""Where a round of the Jacobi eigensolve kernel spends its time, from
edited copies of vmc_pde_torch/kernels/csrc/jacobi.cu that this tool
writes and builds itself (the port's source has no option for any of
them). Needs a CUDA card and nvcc:

    python -m tools.jacobi_probe [--reps 20] [--out FILE]

Every copy runs exactly ``SWEEPS`` sweeps (the convergence test never
stops it), so that the copies' times divide into the same number of
rounds. Copies: ``base``; ``identity`` (every rotation the identity: the
round's loads, arithmetic and stores stay, the rotation's arithmetic
goes); ``no_a`` (no update of A's 2 x 2 blocks); ``no_v`` (no update of
V's rows); ``no_a_v`` (neither: the barriers and the rotations alone).
At the orders of tools/time_jacobi.py's first rows (72 in f32 and f64)
and one cluster order each (208 f32, 256 f64): ms a call (CUDA events,
mean of ``--reps`` after a warm-up) and us a round.
"""

import argparse
import ctypes
import json
import os
import subprocess
import tempfile

import torch

from chip_smoke import _gram, _time_ms
from vmc_pde_torch.kernels import build, jacobi

SWEEPS = 6
STOP = "if (o <= tol * tol * tot || (prev >= 0 && o >= prev)) break;"
NO_A = ("for (int k0 = g; k0 < half;", "for (int k0 = half; k0 < half;")
NO_V = ("for (int i0 = g; i0 < n;", "for (int i0 = n; i0 < n;")
EDITS = {
    "base": [],
    "identity": [("  if (live) {\n    const T d",
                  "  if (false) {\n    const T d")],
    "no_a": [NO_A],
    "no_v": [NO_V],
    "no_a_v": [NO_A, NO_V],
}
CASES = ((72, torch.float32), (72, torch.float64), (208, torch.float32),
         (256, torch.float64))


def build_copies(tmp):
    src = (build.CSRC / "jacobi.cu").read_text()
    src = src.replace("constexpr int MAX_SWEEPS = 30;",
                      f"constexpr int MAX_SWEEPS = {SWEEPS};")
    assert STOP in src
    src = src.replace(STOP, "(void)prev;")
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            assert old in text, (name, old)
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}: {err}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in build.SIGNATURES["jacobi"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_copies(tmp)
        rows = []
        for n, dtype in CASES:
            A = _gram(n, dtype, dev)
            cluster = jacobi.in_cluster(n, dtype)
            # n padded to a multiple of 2 blocks
            pad = 2 * (8 if cluster else 1)
            w = torch.empty(n, dtype=dtype, device=dev)
            V = torch.empty((n, n), dtype=dtype, device=dev)
            rounds = SWEEPS * (-(-n // pad) * pad - 1)
            row = dict(n=n, dtype=str(dtype).split(".")[1], cluster=cluster,
                       rounds=rounds)
            for name, lib in libs.items():
                fn = (lib.jacobi_eigh_f32 if dtype == torch.float32
                      else lib.jacobi_eigh_f64)

                def call(fn=fn):
                    build.check(fn(A.data_ptr(), n, int(cluster),
                                   w.data_ptr(), V.data_ptr(), 0,
                                   torch.cuda.current_stream().cuda_stream),
                                "jacobi_eigh")
                ms = _time_ms(call, args.reps)
                row[name] = dict(ms=ms, us_per_round=1e3 * ms / rounds)
            rows.append(row)
            print(json.dumps(row), flush=True)
    line = json.dumps(dict(card=smi, sweeps=SWEEPS, cases=rows))
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
