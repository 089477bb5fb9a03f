"""Phase K of chip_smoke.py alone (``chip_smoke.phase_mesh_k``: the GSPMD
statistics at dp 2 x tp 2, ``auto`` on the depth-8 flow, chunked GSPMD,
and cg, minSR, the precisions and the host solve on a mesh), in 4 gloo
rank processes on one card, after building the kernels. Needs a CUDA
card:

    python -m tools.mesh_phase_k

Prints what the phase prints, then rank 0's record as one JSON line;
exits nonzero when a rank fails. The ranks are spawned with this
module's own target: a spawned rank imports chip_smoke.py afresh, so a
runner cannot change what the phase does by patching it in the parent.
"""

import json
import multiprocessing
import os
import queue
import sys
import tempfile
import time
import traceback

import torch.distributed as dist

import chip_smoke as cs
from vmc_pde_torch.parallel import mesh
from vmc_pde_torch.parallel.mesh import ParallelCtx

WORLD = 4


def _rank(rank, rendezvous, results):
    try:
        cs._rank_allocator()
        mesh.distributed_init(f"file://{rendezvous}", WORLD, rank)
        ctx = ParallelCtx.create(dp=WORLD, device="cuda")
        cs.full_f32_matmuls()
        log = {"s": 0.0, "bytes": 0}
        cs._time_all_reduces(log)
        t0 = time.perf_counter()
        out = cs.phase_mesh_k(ctx, log)
        out["seconds"] = time.perf_counter() - t0
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main():
    cs.phase_device()
    cs.phase_build()
    spawn = multiprocessing.get_context("spawn")
    results = spawn.Queue()
    rdv = os.path.join(tempfile.mkdtemp(prefix="mesh_phase_k_"), "rdv")
    procs = [spawn.Process(target=_rank, args=(r, rdv, results))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    out = {}
    try:
        while len(out) < WORLD:
            try:
                rank, ok, payload = results.get(timeout=700)
            except queue.Empty:
                sys.exit("the ranks did not finish within 700 s")
            if not ok:
                sys.exit(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    print(json.dumps(out[0], default=str))


if __name__ == "__main__":
    main()
