"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``. The first use builds every source at once, one ``nvcc`` process
per source running in parallel, into ``_build/<hash>/`` next to this file
(listed in .gitignore), where the hash covers that source and the flags: a
changed source rebuilds, an unchanged one loads in milliseconds. Nothing
here runs at import time, so the CPU tests import every module without a
toolkit.

The C entry points return ``cudaGetLastError()`` after their launch; the
wrappers raise on a nonzero code (``check``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp, _ci = ctypes.c_void_p, ctypes.c_int
# argument types of every C entry point, by source
SIGNATURES = {
    "persample": {
        "persample_f32": [_vp] * 5 + [_ci] * 11 + [_vp] * 7,
        "persample_split_f32": [_vp] * 5 + [_ci] * 11 + [_vp] * 12,
    },
    "quant8": {
        "quant_force_bf16": [_vp] * 3 + [_ci] * 3 + [_vp] * 3,
    },
    "metropolis": {
        "metropolis_f32": [_vp, _vp, ctypes.c_float, _vp, ctypes.c_ulonglong]
        + [_ci] * 6 + [_vp] * 4,
    },
    "syrk": {
        "syrk_split_bf16": [_vp] * 2 + [_ci] * 2 + [ctypes.c_longlong, _ci]
        + [_vp] * 2,
        "syrk_tiles_bf16": [_vp] + [_ci] * 3 + [_vp, _ci] + [_vp] * 2,
    },
    "jacobi": {
        "jacobi_eigh_f32": [_vp] + [_ci] * 2 + [_vp] * 5,
        "jacobi_eigh_f64": [_vp] + [_ci] * 2 + [_vp] * 5,
        "jacobi_reach": [_ci] * 2,
        "jacobi_scratch_bytes": [_ci] * 3,
        "jacobi_block_solves": [],
    },
    "graphcond": {
        "cond_if_begin": [_vp] * 3,
        "cond_end": [_vp],
        "stream_create": [ctypes.POINTER(ctypes.c_void_p)],
        "stream_destroy": [_vp],
    },
}

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ on first use")


def source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    path = CSRC / f"{name}.cu"
    h.update(path.name.encode())
    h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _out_dir(name: str) -> pathlib.Path:
    return BUILD_ROOT / source_hash(name)


def build_all() -> None:
    """Compile every source without a build for its hash, all nvcc
    processes at once. The ptxas report (registers, shared memory,
    spills) is kept beside each library as build.log."""
    jobs = []
    for name in SIGNATURES:
        out_dir = _out_dir(name)
        if (out_dir / f"lib{name}.so").exists():
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        # compile to a temporary name and rename: processes building
        # the same hash never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, out_dir, tmp, cmd, proc))
    errors = []
    for name, out_dir, tmp, cmd, proc in jobs:
        out, err = proc.communicate()
        (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n"
                          f"{err}")
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    if errors:
        raise RuntimeError("\n".join(errors))


def build_log(name: str) -> str:
    path = _out_dir(name) / "build.log"
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (every source is built on the
    first call), with the argument types of its C entry points
    declared."""
    with _lock:
        if name not in _libs:
            build_all()
            lib = ctypes.CDLL(str(_out_dir(name) / f"lib{name}.so"))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _ci
            _libs[name] = lib
        return _libs[name]


def check(code: int, what: str) -> None:
    """Raise on a nonzero code returned by a C entry point: a CUDA runtime
    error, or -1000 - the CUresult of a TMA tensor map the driver refused
    (-1000 alone: no cuTensorMapEncodeTiled in the driver)."""
    if code <= -1000:
        raise RuntimeError(f"{what}: the driver refused a TMA tensor map "
                           f"(CUresult {-1000 - code})")
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
