"""Tracing and profiling utilities.

Counterpart of ``simple_hrnet_tpu/utils/profiling.py``. The reference's
only observability is wall-clock fps prints (live-demo.py:143-144). Here:

  * ``trace(logdir)``  — context manager around ``torch.profiler`` (CPU
                         and, on a card, CUDA activity), writing a Chrome
                         trace to ``logdir`` for Perfetto or TensorBoard;
  * ``span(name, n)``  — the port's named host ranges, ``sht.<name>`` or
                         ``sht.<name>[<n>]``: a ``record_function`` while
                         a ``torch.profiler`` is recording, a shared null
                         context (one flag read) otherwise. Being profiler
                         events, they share the trace's clock with the
                         CUDA activity, and every kernel, memcpy and memset
                         is tied to the span that launched it through its
                         runtime call's correlation id;
  * ``device_timer``   — seconds per call of ``fn(*args)`` on the card,
                         timed with CUDA events around a run of calls.
                         The JAX package's scan chaining (a relay
                         workaround) has no counterpart: events time the
                         device directly.

The spans, two levels. The stream's four (``SimpleHRNet._pipeline``,
which every ``predict_stream`` mode runs) carry the chunk index ``c``,
counted from 0 in each stream, and enclose all others, so the outermost
host range at any moment names the stream's phase:

  ``sht.stack[c]``     stacking and padding chunk c's frames (pulling them
                       from the caller's iterator is the caller's time);
  ``sht.upload[c]``    pinning, copying and flipping them to the device;
  ``sht.dispatch[c]``  enqueuing the chunk's device work;
  ``sht.resolve[c]``   reading its results back and building per-frame
                       results, adaptive re-runs and compact follow-up
                       launches included.

Inside them (and in ``predict``), ``sht.read`` (a host read of device
outputs: the wait for the device), ``sht.finish`` (the per-frame arrays),
and the runners' ``sht.detect[frames]`` (letterbox, network, boxes,
NMS), ``sht.nms[frames]``, ``sht.crops[slots]`` (box padding and the crop
resampler, or the single-person resize), ``sht.pose[slots]`` (the pose
model) and ``sht.decode[slots]`` (the argmax decode). ``[n]`` is the
count the span's work covers; slots include padding slots.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional

import torch

_recording = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


def span(name: str, n: Optional[int] = None):
    """``with span('dispatch', c): ...`` — a ``sht.<name>[<n>]`` range
    (``sht.<name>`` without ``n``) in the trace of any recording
    ``torch.profiler``; with none recording, the shared null context and
    no other work."""
    if not _recording():
        return _NULL
    return torch.autograd.profiler.record_function(
        f'sht.{name}' if n is None else f'sht.{name}[{int(n)}]')


@contextlib.contextmanager
def trace(logdir: str = './trace'):
    """Profile the enclosed block with ``torch.profiler`` and write
    ``logdir/trace.json`` (Chrome trace format, the ``sht.`` spans
    included); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


def device_timer(fn: Callable, *args, iters: int = 10, warmup: int = 2,
                 repeats: int = 3) -> float:
    """Seconds per call of ``fn(*args)`` on the current CUDA device: the
    best of ``repeats`` runs of ``iters`` calls, each run between two CUDA
    events on the current stream, after ``warmup`` calls."""
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
