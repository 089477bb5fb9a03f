"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into ONE
shared library with a plain C interface, loaded with ``ctypes``. The build
happens on first use, into ``_build/<hash>/`` next to this file (listed in
.gitignore), where the hash covers the sources and the flags: a changed
source rebuilds, an unchanged one loads in milliseconds. Nothing here runs
at import time, so the CPU tests import every module without a toolkit.

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
LIB_NAME = "libvmc_kernels.so"

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ on first use")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the library if this source hash has no build yet; return
    its path. The ptxas report (registers, shared memory, spills) is kept
    beside it as build.log."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename: concurrent builders of the
    # same hash never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def build_log() -> str:
    path = BUILD_ROOT / source_hash() / "build.log"
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with the argument
    types of every C entry point declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.persample_f32.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                          vp, vp, vp, vp, vp, vp]
            lib.persample_f32.restype = ci
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
