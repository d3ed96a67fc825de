"""Timing / profiling utilities.

TicToc mirrors the reference's inline wall-clock profiler
(rvi/utility/tic_toc.h:9-27); StageTimer adds the structured per-stage
aggregation the reference approximates with printf running averages
(swf_core.cpp:404-413), with device synchronization for stages that
launch CUDA work (a stage is only "done" after ``torch.cuda.synchronize``)
and optional ``torch.profiler`` range annotations.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class TicToc:
    def __init__(self):
        self.tic()

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        """Elapsed milliseconds since tic()."""
        return (time.perf_counter() - self._t0) * 1e3


def _sync(obj):
    """Wait for the device work behind ``obj``: a CUDA tensor (or a
    list/tuple/dict holding one) synchronizes its device."""
    if torch.is_tensor(obj):
        if obj.is_cuda:
            torch.cuda.synchronize(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _sync(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _sync(v)


class StageTimer:
    """Aggregated per-stage timing with device sync.

    Usage:
        timer = StageTimer()
        with timer.stage("solve", sync=result):
            result = solve(...)
        print(timer.report())

    ``sync`` is read when the stage ends: a CUDA tensor (or a list, tuple
    or dict holding some) waits for its device.
    """

    def __init__(self, use_profiler: bool = False):
        self.total_ms = defaultdict(float)
        self.count = defaultdict(int)
        self.use_profiler = use_profiler

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        cm = (torch.profiler.record_function(name)
              if self.use_profiler else contextlib.nullcontext())
        t0 = time.perf_counter()
        with cm:
            yield
            if sync is not None:
                _sync(sync)
        dt = (time.perf_counter() - t0) * 1e3
        self.total_ms[name] += dt
        self.count[name] += 1

    def mean_ms(self, name: str) -> float:
        return self.total_ms[name] / max(self.count[name], 1)

    def report(self) -> str:
        lines = []
        for name in sorted(self.total_ms, key=self.total_ms.get,
                           reverse=True):
            lines.append(
                f"{name:24s} {self.mean_ms(name):9.2f} ms/call "
                f"x{self.count[name]:5d} = {self.total_ms[name]:10.1f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(path: str):
    """Capture a ``torch.profiler`` trace (CPU and, where a GPU is visible,
    CUDA activity) of the enclosed block into the chrome-trace file
    ``path``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
