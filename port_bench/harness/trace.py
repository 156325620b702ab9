"""The card's own trace of a stretch of the window, kept in memory.

``torch.profiler`` with CPU and CUDA activity records, over a fixed number
of the stream's chunks, every CUDA runtime call of the host, every device
operation (kernel, memcpy, memset) with its correlation to the runtime
call that launched it, the benchmark's own spans (chunk marks, and the
detector and pose networks' forward ranges from hooks the harness puts on
their ``nn.Module``) and the input shapes of the program's custom ops. No
trace file is written; ``Trace`` holds the few fields the readers use.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

MARK = 'port_bench.chunk'
SPAN_PREFIX = 'port_bench.'
# CUDA runtime and driver calls that put work on a stream
LAUNCH = re.compile(r'^(cuda|cu)(LaunchKernel|LaunchCooperativeKernel|'
                    r'Memcpy|Memset|GraphLaunch)')


@dataclass
class Ev:
    name: str
    start: int          # ns, the profiler's clock
    end: int
    corr: int = 0
    thread: int = 0
    shapes: list = field(default_factory=list)
    dtypes: list = field(default_factory=list)


@dataclass
class Trace:
    """A traced stretch: host events (ops, runtime calls, spans), device
    events, and the chunk marks, all on one clock (ns)."""
    host: List[Ev]
    device: List[Ev]
    marks: List[Tuple[int, int]]        # (first frame index, time)

    # -- stretches ---------------------------------------------------------

    def stretch(self, skip: int, chunks: int
                ) -> Optional[Tuple[int, int, int]]:
        """(t0, t1, first frame) between the mark ``skip`` chunks after the
        first one and the mark ``chunks`` later; None if the trace holds
        fewer marks."""
        if len(self.marks) < skip + chunks + 1:
            return None
        (f0, t0), (_, t1) = self.marks[skip], self.marks[skip + chunks]
        return t0, t1, f0

    # -- reductions --------------------------------------------------------

    def busy_ns(self, t0: int, t1: int) -> int:
        """Length of the union of device activity within [t0, t1]."""
        iv = sorted((max(e.start, t0), min(e.end, t1)) for e in self.device
                    if e.end > t0 and e.start < t1)
        return union_length(iv)

    def launches(self, t0: int, t1: int) -> List[Ev]:
        return [e for e in self.host if LAUNCH.match(e.name)
                and t0 <= e.start < t1]

    def spans(self, name: str, t0: int, t1: int) -> List[Ev]:
        """The benchmark's spans called ``name`` (up to a ``[...]``
        suffix) that start within [t0, t1)."""
        return [e for e in self.host if (e.name == name or e.name.startswith(
            name + '[')) and t0 <= e.start < t1]

    def ops(self, name: str, t0: int, t1: int) -> List[Ev]:
        return [e for e in self.host if e.name == name and t0 <= e.start < t1]

    def launched_within(self, ranges: Sequence[Ev],
                        kernel: Optional[str] = None) -> List[List[Ev]]:
        """For each host range, the device events whose launching runtime
        call lies inside it (same thread), in launch order; ``kernel`` a
        regex on the device event's name."""
        by_corr = {}
        for e in self.device:
            if kernel is None or re.search(kernel, e.name):
                by_corr.setdefault(e.corr, []).append(e)
        launches = [e for e in self.host if LAUNCH.match(e.name)]
        starts = [e.start for e in launches]
        out = []
        for r in ranges:
            hit = []
            for ln in launches[bisect.bisect_left(starts, r.start):
                               bisect.bisect_left(starts, r.end)]:
                if ln.thread == r.thread:
                    hit.extend(by_corr.get(ln.corr, ()))
            out.append(hit)
        return out


def union_length(intervals: Iterable[Tuple[int, int]]) -> int:
    """Total length covered by sorted (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in intervals:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def from_kineto(events) -> Trace:
    """A ``Trace`` from the profiler's ``_KinetoEvent`` list. Device events
    are kernels, memcpys and memsets on the CUDA track; the GPU copies of
    user annotations are left out."""
    host, device = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            device.append(Ev(e.name(), e.start_ns(), e.end_ns(),
                             e.correlation_id()))
        else:
            host.append(Ev(e.name(), e.start_ns(), e.end_ns(),
                           e.correlation_id(), e.start_thread_id(),
                           e.shapes(), e.dtypes()))
    marks = sorted((int(e.name[len(MARK) + 1:-1]), e.start) for e in host
                   if e.name.startswith(MARK + '['))
    host.sort(key=lambda e: e.start)
    device.sort(key=lambda e: e.start)
    return Trace(host=host, device=device, marks=marks)


class Spans:
    """Forward pre/post hooks that open and close a ``record_function``
    named ``port_bench.<label>[<batch>]`` around an ``nn.Module``'s
    forward: the host range within which its kernels are launched."""

    def __init__(self):
        self.handles = []

    def wrap(self, module: torch.nn.Module, label: str) -> None:
        stack = []

        def pre(mod, args):
            batch = args[0].shape[0] if args and hasattr(args[0], 'shape') \
                else 0
            rf = torch.autograd.profiler.record_function(
                f'{SPAN_PREFIX}{label}[{batch}]')
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out):
            stack.pop().__exit__(None, None, None)

        self.handles += [module.register_forward_pre_hook(pre),
                         module.register_forward_hook(post)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


def mark(frame: int) -> None:
    """A zero-length span at a chunk boundary (the first frame index)."""
    with torch.autograd.profiler.record_function(f'{MARK}[{frame}]'):
        pass


def batch_of(span: Ev) -> int:
    m = re.search(r'\[(\d+)\]$', span.name)
    return int(m.group(1)) if m else 0
