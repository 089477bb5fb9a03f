"""Device-time profile of one step of the port's driver (any --stepper;
fixed Heun by default), on a CUDA card:

    python -m tools.profile_step fokkerPlanck32 --samples 524288 \\
        --chunk-size 65536 --gram-backend tri2 --gram-cross int8
    python -m tools.profile_step fokkerPlanck32 --stepper adaptive_heun

Runs the driver (any of its arguments; --max-steps and --device are set
here) for one warm-up step, then one step under torch.profiler, and prints
the device time by class of kernel (the per-sample kernel in plain and
split mode, quant8, syrk, Metropolis, GEMMs by operand type, the solve,
the rest), each
class's share of the device total, the device's busy share of the step's
wall time, and the 25 kernels that took the most device time.
"""

import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vmc_pde_torch import driver

CLASSES = (
    ("per-sample kernel, split mode", ("persample_kernel<true",
                                       "split_finish")),
    ("per-sample kernel, plain mode", ("persample_kernel<false",)),
    ("quant8 kernel", ("quant_force_kernel",)),
    ("syrk kernels (split pass, product)", ("syrk_kernel", "split_kernel",
                                            "tiles_kernel")),
    ("Metropolis kernel", ("metropolis_kernel",)),
    ("GEMM int8", ("s8", "i8", "imma", "int8")),
    ("GEMM bf16", ("bf16",)),
    ("GEMM f32", ("gemm", "nvjet", "xmma", "cutlass", "gemv", "sgemm")),
    ("Cholesky, QR, triangular solves", ("potrf", "geqrf", "trsm", "syrk",
                                         "orgqr", "ormqr", "larf", "trsv",
                                         "cusolver", "potrs", "getrf")),
)


def classify(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            # a GEMM names its operand type; the f32 class catches the rest
            if label.startswith("GEMM") and label != "GEMM f32" and not any(
                    g in low for g in ("gemm", "nvjet", "xmma", "cutlass",
                                       "gemv")):
                continue
            return label
    return "elementwise, reductions, other"


def device_rows(prof):
    """(name, device ms, calls) of every kernel in a finished profile:
    device-side events only (the CPU ops that launched them carry the same
    time again)."""
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def callback(n_step, t, state, info):
        torch.cuda.synchronize()
        if n_step == 0:
            prof.start()
            window["t0"] = time.perf_counter()
        else:
            prof.stop()
            window["wall"] = time.perf_counter() - window["t0"]

    driver.main(argv + ["--max-steps", "2", "--device", "cuda"],
                callbacks=[callback])
    rows = device_rows(prof)
    total = sum(ms for _, ms, _ in rows)
    wall = 1e3 * window["wall"]
    by_class = {}
    for name, ms, _ in rows:
        by_class[classify(name)] = by_class.get(classify(name), 0.0) + ms
    print(f"one step, {' '.join(argv)}: wall {wall:.1f} ms, device "
          f"{total:.1f} ms, busy {100 * total / wall:.1f}%")
    for label, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {label:<34s} {ms:10.2f} ms  {100 * ms / total:5.1f}%")
    print("top kernels by device time (ms, calls):")
    for name, ms, count in sorted(rows, key=lambda r: -r[1])[:25]:
        print(f"  {ms:10.3f} {count:6d}  {name[:110]}")


if __name__ == "__main__":
    main()
