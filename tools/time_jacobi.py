"""Card times of the Jacobi eigensolve kernel (csrc/jacobi.cu) against
torch.linalg.eigh, at the orders of the port's small eigensolves, as one
JSON line. Needs a CUDA card:

    python -m tools.time_jacobi [--reps 20] [--parent DIR] [--out FILE]

Each order runs chip_smoke.py phase 48's routine (``_jacobi_vs_eigh``):
the Gram X X^T / 2n of an (n, 2n) standard normal X (seed n) in the
solve's dtype (``_gram``; at 72, the main path's caught Ritz matrix and
its f64 copy), its gates (eigenvalues within 64 n eps of the norm of an
f64 torch.linalg.eigh's, V diag(w) V^T and V^T V - I within 1e-4 (f32) or
1e-12 (f64), ascending), the sweeps, the kernel and torch.linalg.eigh
timed in turns (eigh, kernel, kernel, eigh; CUDA events), the bound and
its share; and the kernel's device ms (``_device_ms``, the profiler).
Orders: the one block's 72 (the top-k Ritz matrix of k = 64, the main
path's) and reach; the block variant's first order, the presets' spectral
solves (365, 411, 684, 762), the earlier cluster variant's 208, 384, 464
(f32) and 200, 256, 320 (f64), 1024 and the reach 2048.

``--parent DIR``: the jacobi.cu of an earlier checkout at DIR too (its C
entry ``(a, n, cluster, w, v, sweeps, stream)``, as before the block
variant), built here with the port's flags, timed in turns against the
kernel at every order within its reach (parent, kernel, kernel, parent).
"""

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import tempfile

import torch

from chip_smoke import (TRACE_KERNELS, _caught_ritz_matrix, _device_ms,
                        _gram, _jacobi_vs_eigh, _time_ms)
from vmc_pde_torch.kernels import build, jacobi

ORDERS = {torch.float32: (72, 168, 169, 208, 365, 384, 411, 464, 684, 762,
                          1024, 2048),
          torch.float64: (72, 118, 119, 200, 256, 320, 411, 762, 2048)}


def parent_library(root, tmp):
    """The earlier checkout's csrc/jacobi.cu, built into ``tmp``."""
    src = pathlib.Path(root) / "vmc_pde_torch/kernels/csrc/jacobi.cu"
    so = os.path.join(tmp, "libparent_jacobi.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.jacobi_eigh_f32, lib.jacobi_eigh_f64):
        fn.argtypes = [vp, ci, ci, vp, vp, vp, vp]
        fn.restype = ci
    lib.jacobi_reach.argtypes = [ci, ci]
    lib.jacobi_reach.restype = ci
    return lib


def parent_call(lib, A):
    """One solve of A by the earlier kernel, or None past its reach."""
    n, f64 = A.shape[0], int(A.dtype == torch.float64)
    if n > lib.jacobi_reach(f64, 1):
        return None
    cluster = int(n > lib.jacobi_reach(f64, 0))
    w = torch.empty(n, dtype=A.dtype, device=A.device)
    V = torch.empty((n, n), dtype=A.dtype, device=A.device)
    fn = lib.jacobi_eigh_f64 if f64 else lib.jacobi_eigh_f32

    def call():
        build.check(fn(A.data_ptr(), n, cluster, w.data_ptr(), V.data_ptr(),
                       0, torch.cuda.current_stream().cuda_stream),
                    "parent jacobi_eigh")
    return call


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    build.build_all()
    ptxas = [ln.strip() for ln in build.build_log("jacobi").splitlines()
             if "registers" in ln or "spill" in ln]
    caught = _caught_ritz_matrix()[0]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        parent = parent_library(args.parent, tmp) if args.parent else None
        for dtype, orders in ORDERS.items():
            for n in orders:
                A = (caught.to(dtype) if n == caught.shape[0]
                     else _gram(n, dtype, dev))
                reps = args.reps if n <= 800 else max(3, args.reps // 4)
                row = dict(n=n, dtype=str(dtype).split(".")[1],
                           **_jacobi_vs_eigh("tools.time_jacobi", A, reps))
                kern = lambda: jacobi.eigh_cuda(A)  # noqa: E731
                old = parent and parent_call(parent, A)
                if old:
                    p1, k1, k2, p2 = (_time_ms(fn, reps)
                                      for fn in (old, kern, kern, old))
                    row.update(parent_ms_turns=[p1, p2],
                               kernel_vs_parent_ms_turns=[k1, k2])
                row["device_ms"] = _device_ms(
                    kern, max(3, reps // 4), TRACE_KERNELS[
                        "jacobi_blocks" if row["blocks"] else "jacobi"])
                rows.append(row)
                print(json.dumps(row), flush=True)
    line = json.dumps(dict(card=smi, ptxas=ptxas, solves=rows))
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
