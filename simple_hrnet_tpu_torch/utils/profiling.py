"""Tracing and profiling utilities.

Counterpart of ``simple_hrnet_tpu/utils/profiling.py``. The reference's
only observability is wall-clock fps prints (live-demo.py:143-144). Here:

  * ``trace(logdir)``  — context manager around ``torch.profiler`` (CPU
                         and, on a card, CUDA activity), writing a Chrome
                         trace to ``logdir`` for Perfetto or TensorBoard;
  * ``StageTimer``     — named wall-clock stage timers with exponential
                         smoothing for per-frame pipeline stages
                         (detector / crops / pose / decode);
  * ``device_timer``   — seconds per call of ``fn(*args)`` on the card,
                         timed with CUDA events around a run of calls.
                         The JAX package's scan chaining (a relay
                         workaround) has no counterpart: events time the
                         device directly.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict


@contextlib.contextmanager
def trace(logdir: str = './trace'):
    """Profile the enclosed block with ``torch.profiler`` and write
    ``logdir/trace.json`` (Chrome trace format); yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


class StageTimer:
    """Named per-stage timers with exponential smoothing."""

    def __init__(self, alpha: float = 0.9):
        self.alpha = alpha
        self.means: Dict[str, float] = {}
        self._start: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            prev = self.means.get(name)
            self.means[name] = dt if prev is None else \
                self.alpha * prev + (1 - self.alpha) * dt

    def summary(self) -> str:
        return ' | '.join(f'{k}: {v * 1000:.1f}ms'
                          for k, v in self.means.items())


def device_timer(fn: Callable, *args, iters: int = 10, warmup: int = 2,
                 repeats: int = 3) -> float:
    """Seconds per call of ``fn(*args)`` on the current CUDA device: the
    best of ``repeats`` runs of ``iters`` calls, each run between two CUDA
    events on the current stream, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn(*args)
    best = float('inf')
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1000.0 / iters)
    return best
