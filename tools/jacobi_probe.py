"""Where a round of the Jacobi eigensolve's block variant spends its time,
from edited copies of vmc_pde_torch/kernels/csrc/jacobi.cu that this tool
writes and builds itself (the port's source has no option for any of
them). Needs a CUDA card and nvcc:

    python -m tools.jacobi_probe [--reps 10] [--out FILE]

Every copy runs exactly ``SWEEPS`` sweeps (the convergence test never
stops it), so that the copies' times divide into the same number of
rounds. Copies: ``base``; ``no_inner`` (each pair's subproblem loaded and
written back, no inner rotation); ``no_update``, ``no_ahead`` and
``no_q`` (the inner rounds without one of their three roles: the
subproblem's update, the next round's rotations, Q's update; the others
run on what they find); ``no_tiles`` (no update of A's off-diagonal pair
tiles); ``no_v`` (no update of V); ``barriers`` (no pair solved, no tile
and no V: the grid's barriers, the flags, the stopping sums and the
ranking); ``one_cta_per_sm`` and ``two_ctas_per_sm`` (the grid at most
one, or up to two, CTAs an SM at every order); ``plain_rotation`` (f64's
rotations by `rotation`'s four chained roots and divisions, not
`block_rotation`'s two). At the orders of chip_smoke.py phase 48: ms a call (CUDA
events, mean of ``--reps`` after a warm-up) and us a round.
"""

import argparse
import ctypes
import json
import os
import subprocess
import tempfile

import torch

from chip_smoke import _gram, _time_ms
from vmc_pde_torch.kernels import build

SWEEPS = 4
STOP = "if (o <= tol * tol * s || (prev >= 0 && o >= prev)) break;"
NO_INNER = ("const int rounds = full ? PW - 1 : BW;",
            "const int rounds = 0;")
NO_PAIRS = ("solve_pair(A, m, n, P, Q, r == 0,",
            "if (false) solve_pair(A, m, n, P, Q, r == 0,")
NO_TILES = ("for (int t = first; t < n_tiles; t += G) {",
            "for (int t = n_tiles; t < n_tiles; t += G) {")
NO_V = [("if (vr >= 0) {\n        const double* q_prev",
         "if (false) {\n        const double* q_prev"),
        ("for (int x = first; x < n_v; x += G) {",
         "for (int x = first; x < 0; x += G) {")]
ONE_PER_SM = ("constexpr int CTAS_PER_SM = 2;",
              "constexpr int CTAS_PER_SM = 1;")
TWO_PER_SM = ("const int slots = items > 3 * sms ? sms * per_sm : sms;",
              "const int slots = sms * per_sm;")
NO_UPDATE = ("    if (warp < BWARPS / 2) {\n      if (r < rounds) {",
             "    if (warp < BWARPS / 2) {\n      if (false) {")
NO_AHEAD = ("} else if (ahead && r + 1 < rounds) {", "} else if (false) {")
NO_Q = ("      if (r > 0) {\n        // Q's rows",
        "      if (false) {\n        // Q's rows")
PLAIN_ROTATION = [
    ("block_rotation(S[p][p], S[q][q], S[q][p], live(p, q, S[q][p]));",
     "rotation(S[p][p], S[q][q], S[q][p], live(p, q, S[q][p]), 0);"),
    ("block_rotation(app, aqq, apq, live(p1, q1, apq));",
     "rotation(app, aqq, apq, live(p1, q1, apq), 0);")]
EDITS = {
    "base": [],
    "no_inner": [NO_INNER],
    "no_update": [NO_UPDATE],
    "no_ahead": [NO_AHEAD],
    "no_q": [NO_Q],
    "no_tiles": [NO_TILES],
    "no_v": NO_V,
    "barriers": [NO_PAIRS, NO_TILES, *NO_V],
    "one_cta_per_sm": [ONE_PER_SM],
    "two_ctas_per_sm": [TWO_PER_SM],
    "plain_rotation": PLAIN_ROTATION,
}
CASES = ((365, torch.float32), (762, torch.float32), (2048, torch.float32),
         (256, torch.float64), (411, torch.float64))


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
    ap.add_argument("--reps", type=int, default=10)
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
            f64 = int(dtype == torch.float64)
            w = torch.empty(n, dtype=dtype, device=dev)
            V = torch.empty((n, n), dtype=dtype, device=dev)
            nb = -(-n // 32) * 2  # blocks of 16, n padded to 32
            rounds = SWEEPS * (nb - 1)
            row = dict(n=n, dtype=str(dtype).split(".")[1], rounds=rounds)
            for name, lib in libs.items():
                fn = lib.jacobi_eigh_f64 if f64 else lib.jacobi_eigh_f32
                scratch = torch.empty(lib.jacobi_scratch_bytes(n, f64, 1),
                                      dtype=torch.uint8, device=dev)

                def call(fn=fn, scratch=scratch):
                    build.check(fn(A.data_ptr(), n, 1, w.data_ptr(),
                                   V.data_ptr(), 0, scratch.data_ptr(),
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
