"""Card times of the Jacobi eigensolve kernel (csrc/jacobi.cu) against
torch.linalg.eigh, at the orders of the port's small eigensolves, as one
JSON line. Needs a CUDA card:

    python -m tools.time_jacobi [--reps 20] [--out FILE]

Each order runs chip_smoke.py phase 48's routine (``_jacobi_vs_eigh``):
the Gram X X^T / 2n of an (n, 2n) standard normal X (seed n) in the
solve's dtype (``_gram``), its gates (eigenvalues within 64 n eps of the
norm of an f64 torch.linalg.eigh's, V diag(w) V^T and V^T V - I within
1e-4 (f32) or 1e-12 (f64), ascending), the sweeps, the kernel and
torch.linalg.eigh timed in turns (eigh, kernel, kernel, eigh; CUDA
events), the bound; and the kernel's device ms (``_device_ms``, the
profiler). Orders: 72 in f32 and f64 (the top-k Ritz matrix of k = 64,
the main path's), the cluster's 169, 208, 365 (the diffusion preset's P),
384 and its reach in f32, 119, 200, 256 and its reach in f64.
"""

import argparse
import json
import subprocess

import torch

from chip_smoke import TRACE_KERNELS, _device_ms, _gram, _jacobi_vs_eigh
from vmc_pde_torch.kernels import build, jacobi

ORDERS = {torch.float32: (72, 169, 208, 365, 384, 464),
          torch.float64: (72, 119, 200, 256, 320)}


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
    build.build_all()
    ptxas = [ln.strip() for ln in build.build_log("jacobi").splitlines()
             if "registers" in ln or "spill" in ln]
    rows = []
    for dtype, orders in ORDERS.items():
        for n in orders:
            A = _gram(n, dtype, dev)
            row = dict(n=n, dtype=str(dtype).split(".")[1],
                       **_jacobi_vs_eigh("tools.time_jacobi", A, args.reps))
            row["device_ms"] = _device_ms(
                lambda: jacobi.eigh_cuda(A), max(3, args.reps // 4),
                TRACE_KERNELS["jacobi_cluster" if row["cluster"]
                              else "jacobi"])
            rows.append(row)
            print(json.dumps(row), flush=True)
    line = json.dumps(dict(card=smi, ptxas=ptxas, solves=rows))
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
