"""Wall-clock section timing and the profiler window, the counterpart of
vmc_pde_tpu/utils/timings.py.

Sections are explicit start timestamps plus a history of completed
durations; opening an open section or closing one never opened raises.
``profiler_trace`` records a torch.profiler trace (CUDA activity too when
asked) and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _cuda_tensors(tree):
    """The CUDA tensors among the leaves of nested tuples, lists and
    dicts."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _cuda_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _cuda_tensors(v)


def wait_for(tree) -> None:
    """Wait until the work queued on the current stream of each CUDA
    device that holds a tensor of ``tree`` is done (other devices, and
    other streams, are not waited for); CPU tensors need no wait."""
    for dev in {t.device for t in _cuda_tensors(tree)}:
        torch.cuda.current_stream(dev).synchronize()


class Timings:
    """Named wall-clock sections with per-call history.

    ``section(key)`` / ``start_timing(key)`` + ``stop_timing(key)`` record
    one duration per completed span into ``timing_dict[key]``.
    """

    def __init__(self):
        self.timing_dict: dict[str, list[float]] = {}
        self._open: dict[str, float] = {}

    def start_timing(self, key: str) -> None:
        if key in self._open:
            raise RuntimeError(f"timing section {key!r} is already open")
        self._open[key] = time.perf_counter()

    def stop_timing(self, key: str, waitFor=None) -> None:
        """Close ``key``; with ``waitFor`` (tensors, possibly nested) the
        span ends when their device work does, not at its dispatch."""
        if waitFor is not None:
            wait_for(waitFor)
        try:
            t0 = self._open.pop(key)
        except KeyError:
            raise RuntimeError(f"timing section {key!r} was never started")
        self.timing_dict.setdefault(key, []).append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def section(self, key: str, waitFor=None):
        self.start_timing(key)
        try:
            yield
        finally:
            self.stop_timing(key, waitFor=waitFor)

    def last(self, key: str) -> float:
        return self.timing_dict[key][-1]

    def totals(self) -> dict[str, float]:
        return {k: sum(v) for k, v in self.timing_dict.items()}

    def print_timings(self) -> None:
        """The latest span of every section and their total, in the
        reference's log line shape."""
        latest = {k: v[-1] for k, v in self.timing_dict.items() if v}
        for key, dt in latest.items():
            print(f"\t > {key}: {dt}")
        print(f"\t > TOTAL: {sum(latest.values())}")


@contextlib.contextmanager
def profiler_trace(logdir: str, cuda: bool = False, name: str = "trace"):
    """torch.profiler over the block (host activity, and the card's when
    ``cuda``), written to ``<logdir>/<name>.json`` as a Chrome trace
    (chrome://tracing, Perfetto) when the block ends, however it ends.
    Yields the path."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(logdir, f"{name}.json")
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)
