"""CUDA graphs of the TDVP's batched steps (TDVP.heun_multi and
TDVP.adaptive_multi), the counterpart of the JAX package's lax.scan and
lax.while_loop step programs (vmc_pde_tpu/solver/tdvp.py:2305-2479).

A ``Program`` captures one step once per (stepper kind, shape) and
replays it on static buffers: the caller writes a step's inputs (theta,
t, dt, the chain state) into the program's tensors, replays, and copies
the outputs off before the next replay. Nothing in a replay waits for the
host, so a batch of K steps is K replays and one host read at its end.

Capture runs the step function twice: a warm-up (eager, every
conditional body run, so that every lazy initialization happens outside
the capture and every random draw site is seen), then the capture
itself, both on the streams ``Program._new_streams`` picks. What the
function must keep:

- Random numbers. Every generator of the step comes from
  ``Program.generator(key)`` with a key derived from the step's root key
  by ``Program.fold`` (the TDVP's fold_in chain). The warm-up records the
  chain of fold indices of each draw site; the capture gets one
  generator per site, registered with the graph
  (``CUDAGraph.register_generator_state``); before each replay every
  site's generator is seeded from the new root key along its chain. A
  registered generator seeded with k gives a replay the numbers a fresh
  generator seeded with k gives an eager call, so a replayed step draws
  what the per-step path draws.
- Device control flow. ``Program.run_if(flag, fn)`` captures ``fn`` into
  the body of a conditional IF node (kernels/csrc/graphcond.cu) that runs
  at replay only when the bool ``flag`` is set at that point of the
  graph. The body is captured on a stream of its own; its allocations go
  to a memory pool of the program's (torch routes a capture's
  allocations by its capture id, which the body's capture does not
  share). Whatever a body computes for later use it copies into tensors
  made before the node. ``eager_if`` is the host branch of the same
  call: the plain version.
- No host reads. Anything that waits for the host inside the capture
  (.item(), bool(), a pageable copy) makes the capture raise; there is
  no fallback to eager.

Launch counts: the kernel wrappers count their own calls, the warm-up's
and the capture's among them; a replay calls no wrapper, so the kernels a
replay runs show only in a profiler trace of it.

The graph's pool and the bodies' pool are released with the program
(``release``), which the TDVP holding it does in ``release_graphs``.
"""

from __future__ import annotations

import ctypes

import torch

def _own_stream(device):
    """(raw handle, torch stream) of a new non-blocking stream."""
    from ..kernels import build

    lib = build.library("graphcond")
    raw = ctypes.c_void_p()
    build.check(lib.stream_create(ctypes.byref(raw)), "stream_create")
    return raw.value, torch.cuda.ExternalStream(raw.value, device=device)


# the stream of every captured cuSOLVER call, one per device for the
# process (Program._new_streams): it lives as long as the process, as the
# library state it matches does
_SOLVER_STREAMS = {}


def _device_index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def _solver_stream(device):
    key = _device_index(device)
    if key not in _SOLVER_STREAMS:
        _SOLVER_STREAMS[key] = (None, _own_stream(device)[1])
    return _SOLVER_STREAMS[key]


def eager_if(flag, fn):
    """The host branch of ``Program.run_if``: fn() when ``flag`` holds
    (one host read of the flag)."""
    if bool(flag):
        fn()


class Program:
    """One captured step on static buffers, with its random draw sites
    and its conditional bodies. ``fold(key, i)`` is the key derivation of
    the step (the TDVP's fold_in)."""

    def __init__(self, device: torch.device, fold, bodies: bool = False):
        self.device = torch.device(device)
        self._fold = fold
        self._bodies = bodies
        self._mode = "idle"
        self._root = None
        self._parent = {}
        self.sites = []      # fold-index chain of each draw, in call order
        self._gens = []
        self._next_site = 0
        self.graph = None
        self.outputs = None
        # the static input tensors the captured step reads, the caller's
        self.buffers = None
        # (raw handle or None, torch stream): the capture's, the bodies'
        self._streams = []
        self._body_pool = None
        self.capture_s = None
        self.pool_bytes = None

    # -- random draws ------------------------------------------------------
    def fold(self, key: int, i: int) -> int:
        out = self._fold(key, i)
        self._parent[out] = (key, i)
        return out

    def _chain(self, key: int):
        path = []
        while key != self._root:
            if key not in self._parent:
                raise RuntimeError("a random draw of the captured step uses "
                                   "a key not derived from the step's key")
            key, i = self._parent[key]
            path.append(i)
        return tuple(reversed(path))

    def generator(self, key: int) -> torch.Generator:
        path = self._chain(key)
        if self._mode == "warmup":
            self.sites.append(path)
            g = torch.Generator(device=self.device)
            g.manual_seed(key)
            return g
        if self._mode != "capture":
            raise RuntimeError("Program.generator outside warm-up or capture")
        i = self._next_site
        if i >= len(self.sites) or self.sites[i] != path:
            raise RuntimeError("the capture drew at other sites than its "
                               "warm-up")
        self._next_site += 1
        return self._gens[i]

    def _reseed(self, root: int) -> None:
        for path, g in zip(self.sites, self._gens):
            k = root
            for i in path:
                k = self._fold(k, i)
            g.manual_seed(k)

    # -- control flow ------------------------------------------------------
    def run_if(self, flag, fn):
        """fn inside a conditional IF node on ``flag`` (a 0-dim bool CUDA
        tensor) during capture; during the warm-up fn runs whatever the
        flag says, on the bodies' stream."""
        if not self._bodies:
            raise ValueError("run_if in a Program made without bodies=True")
        body = self._streams[1][1]
        cur = torch.cuda.current_stream(self.device)
        if self._mode == "warmup":
            body.wait_stream(cur)
            with torch.cuda.stream(body):
                fn()
            cur.wait_stream(body)
            return
        if self._mode != "capture":
            raise RuntimeError("Program.run_if outside warm-up or capture")
        if flag.dtype != torch.bool or flag.numel() != 1:
            raise ValueError("run_if takes a one-element bool flag")
        from ..kernels import build

        lib = build.library("graphcond")
        build.check(lib.cond_if_begin(cur.cuda_stream, body.cuda_stream,
                                      flag.data_ptr()), "cond_if_begin")
        idx = _device_index(self.device)
        try:
            with torch.cuda.stream(body):
                torch._C._cuda_beginAllocateCurrentStreamToPool(
                    idx, self._body_pool.id)
                try:
                    fn()
                finally:
                    torch._C._cuda_endAllocateToPool(idx, self._body_pool.id)
                    torch._C._cuda_releasePool(idx, self._body_pool.id)
        finally:
            build.check(lib.cond_end(body.cuda_stream), "cond_end")

    # -- capture and replay --------------------------------------------------
    def capture(self, fn, root: int):
        """Warm fn(root) up, then capture it; returns (and keeps as
        ``outputs``) what the captured call returned: the static output
        tensors."""
        import time

        if self.device.type != "cuda":
            raise ValueError("a Program captures on a CUDA device")
        t0 = time.perf_counter()
        self._root = root
        self._new_streams()
        self._body_pool = torch.cuda.MemPool()
        side = self._streams[0][1]
        side.wait_stream(torch.cuda.current_stream(self.device))
        self._mode = "warmup"
        try:
            with torch.cuda.stream(side):
                fn(root)
        finally:
            self._mode = "idle"
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        # the capture empties the cache first: measure the pool from there
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved(self.device)
        self._gens = [torch.Generator(device=self.device)
                      for _ in self.sites]
        self.graph = torch.cuda.CUDAGraph()
        for g in self._gens:
            self.graph.register_generator_state(g)
        self._mode = "capture"
        self._next_site = 0
        try:
            # captured on the stream the warm-up ran on
            with torch.cuda.graph(self.graph, stream=side):
                self.outputs = fn(root)
        finally:
            self._mode = "idle"
        if self._next_site != len(self.sites):
            raise RuntimeError("the capture drew at fewer sites than its "
                               "warm-up")
        torch.cuda.synchronize(self.device)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - mem0
        self.capture_s = time.perf_counter() - t0
        return self.outputs

    def replay(self, root: int) -> None:
        """One replay with every draw site seeded from ``root``."""
        self._reseed(root)
        self.graph.replay()

    def _new_streams(self):
        """The streams of the warm-up and capture, and of the conditional
        bodies. cuSOLVER's own cuBLAS handle keeps one capture workspace,
        tied to the stream of the first capture in the thread that calls a
        cuSOLVER routine; captured on any other stream, each of its GEMMs
        allocates and frees a buffer (graph memory nodes), which a
        conditional body may not hold (measured on an H100 with torch
        2.11 and CUDA 12.8: a second program's capture failed at
        instantiate). So every captured cuSOLVER call runs on one stream
        per device, ``_solver_stream``: a program without bodies captures
        on it, and a program with bodies captures its bodies there and
        its top level, which calls no solver, on a stream of its own."""
        solver = _solver_stream(self.device)
        if self._bodies:
            self._streams = [_own_stream(self.device), solver]
        else:
            self._streams = [solver]

    def release(self) -> None:
        """Free the graph, its pool, the bodies' pool and the streams."""
        self.outputs = None
        if self.graph is not None:
            self.graph.reset()
            self.graph = None
        self._gens = []
        self._body_pool = None
        own = [raw for raw, _ in self._streams if raw is not None]
        if own:
            from ..kernels import build

            torch.cuda.synchronize(self.device)
            lib = build.library("graphcond")
            for raw in own:
                build.check(lib.stream_destroy(raw), "stream_destroy")
        self._streams = []
