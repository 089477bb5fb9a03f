"""The native asynchronous metrics recorder (native/recorder.cpp), the
counterpart of vmc_pde_tpu/utils/recorder.py.

Each record is copied into a bounded queue of the C++ library and written
to a compact binary log (the "VPDR1" format, the JAX package's) by a
background thread, so the step loop never waits on file IO. The library
is built with g++ on first use into ``native/_build/<hash>/`` (listed in
.gitignore), the hash covering the source and the flags, as
kernels/build.py builds the CUDA kernels; a build that fails raises with
the compiler's output (a recorder the user asked for never silently
records nothing). ``read_log`` and ``log_to_infos`` read a log written by
either package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import struct
import subprocess
import tempfile
import threading

import numpy as np
import torch

SRC = pathlib.Path(__file__).resolve().parent.parent / "native" / \
    "recorder.cpp"
BUILD_ROOT = SRC.parent / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
# the native queue's bound: a record call waits while it is full
QUEUE_BYTES = 64 << 20

_lock = threading.Lock()
_dll = None


def _lib_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "librecorder.so"


def build() -> pathlib.Path:
    """The library's path, compiled first when no build of this source
    exists; raises RuntimeError with g++'s output when it fails."""
    lib = _lib_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename: processes building the same
    # hash never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, str(SRC), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run g++ to build the recorder: {e}")
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {SRC.name} ({proc.returncode}):"
                           f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _dll
    with _lock:
        if _dll is None:
            dll = ctypes.CDLL(str(build()))
            dll.rec_open.restype = ctypes.c_void_p
            dll.rec_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            dll.rec_register.restype = ctypes.c_int
            dll.rec_register.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            dll.rec_write.restype = ctypes.c_int
            dll.rec_write.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_double), ctypes.c_uint64]
            dll.rec_close.restype = None
            dll.rec_close.argtypes = [ctypes.c_void_p]
            _dll = dll
        return _dll


def _to_host(values: dict) -> dict:
    """``values`` with its tensors as float64 numpy arrays, read in one
    transfer per device (one wait for each device's work)."""
    out = dict(values)
    by_device = {}
    for k, v in values.items():
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append(k)
    for keys in by_device.values():
        flat = torch.cat([values[k].detach().reshape(-1).to(torch.float64)
                          for k in keys]).cpu().numpy()
        off = 0
        for k in keys:
            n = values[k].numel()
            out[k] = flat[off:off + n]
            off += n
    return out


class AsyncRecorder:
    """Non-blocking metrics sink backed by the native writer; raises when
    the library cannot be built or the log cannot be opened."""

    def __init__(self, path: str):
        self.path = path
        self._dll = _load()
        self._handle = self._dll.rec_open(path.encode(), QUEUE_BYTES)
        if not self._handle:
            raise OSError(f"cannot open recorder log {path!r}")
        self._tags = {}

    def _tag(self, name: str) -> int:
        t = self._tags.get(name)
        if t is None:
            t = self._dll.rec_register(self._handle, name.encode())
            self._tags[name] = t
        return t

    def record(self, name: str, step: int, value) -> None:
        """One record of ``value`` (a number, an array, or a tensor, read
        on the host here) under ``name``."""
        if not self._handle:
            raise RuntimeError(f"recorder log {self.path!r} is closed")
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu()
        arr = np.ascontiguousarray(np.asarray(value, dtype=np.float64)
                                   .reshape(-1))
        ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        self._dll.rec_write(self._handle, self._tag(name), step, ptr,
                            arr.size)

    def record_dict(self, step: int, d: dict) -> None:
        """A record of every entry of ``d`` but dicts and names starting
        with "_", in ``d``'s order; its tensors come to the host in one
        transfer."""
        items = {k: v for k, v in d.items()
                 if not k.startswith("_") and not isinstance(v, dict)}
        for k, v in _to_host(items).items():
            self.record(k, step, v)

    def close(self) -> None:
        """Write what is queued, join the writer thread, close the file."""
        if self._handle:
            self._dll.rec_close(self._handle)
            self._handle = None

    def __del__(self):
        # an abnormal exit (a NaN abort raising out of the driver's loop)
        # still writes what is queued and joins the writer thread
        try:
            self.close()
        except Exception:
            pass


def read_log(path: str):
    """A recorder log as a list of (name, step, wall time, values)."""
    out = []
    tags = {}
    with open(path, "rb") as f:
        if f.read(6) != b"VPDR1\x00":
            raise ValueError(f"{path!r} is not a recorder log")
        f.read(2)  # version
        while True:
            kind = f.read(1)
            if not kind:
                break
            if kind[0] == 0:
                tag, nlen = struct.unpack("<II", f.read(8))
                tags[tag] = f.read(nlen).decode()
            elif kind[0] == 1:
                tag, step, t, n = struct.unpack("<IQdQ", f.read(28))
                data = np.frombuffer(f.read(8 * n), dtype="<f8")
                out.append((tags[tag], step, t, data))
            else:
                raise ValueError(f"corrupt record kind {kind[0]}")
    return out


def log_to_infos(path: str) -> dict:
    """A recorder log as an infos dict: one list of rows per name, a
    one-value record as a number."""
    infos = {}
    for name, _, _, data in read_log(path):
        infos.setdefault(name, []).append(
            data if data.size != 1 else data[0])
    return infos
