"""Reductions over the program's own ``sht.`` spans
(``simple_hrnet_tpu_torch/utils/profiling.span``) in the traced stretch,
which the per-layer readers of the stream, crops, decode and pose slots
share. Only spans that start inside the stretch are read; a program
without the spans (no ``sht.`` range in the trace) reads None."""

from __future__ import annotations

import statistics
from typing import List, Optional, Sequence, Tuple

from port_bench.harness import readers
from port_bench.harness.trace import Ev, batch_of

PREFIX = 'sht.'


def spans(run, name: str) -> Optional[List[Ev]]:
    """The program's ``sht.<name>`` spans that start inside the stretch,
    or None (no stretch, or no such span)."""
    st = readers.stretch(run)
    if st is None:
        return None
    got = run.trace.spans(PREFIX + name, st[0], st[1])
    return got or None


def device_ms_per_count(run, name: str) -> Optional[float]:
    """Device ms of the events (kernels, memcpys, memsets) launched inside
    the ``sht.<name>[n]`` spans, over their summed ``n``."""
    got = spans(run, name)
    if got is None:
        return None
    hits = run.trace.launched_within(got)
    count = sum(batch_of(s) for s in got)
    if count == 0 or not any(hits):
        return None
    return sum(e.end - e.start for h in hits for e in h) / 1e6 / count


def merged(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, disjoint union of (start, end) intervals."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap(a: Sequence[Tuple[int, int]], b: Sequence[Tuple[int, int]]
            ) -> int:
    """Length of the intersection of two merged interval lists."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_within(run, names: Sequence[str]) -> Optional[float]:
    """Share (%) of the stretch in which the device runs nothing (no
    kernel, memcpy or memset) while the host is inside one of the spans
    ``sht.<name>``: the device's idle time that those phases of the
    program leave."""
    st = readers.stretch(run)
    if st is None:
        return None
    t0, t1 = st[0], st[1]
    host = [s for name in names for s in spans(run, name) or ()]
    if not host:
        return None
    inside = merged([(max(s.start, t0), min(s.end, t1)) for s in host])
    busy = merged([(max(e.start, t0), min(e.end, t1))
                   for e in run.trace.device if e.end > t0 and e.start < t1])
    held = sum(e - s for s, e in inside)
    return 100.0 * (held - overlap(inside, busy)) / (t1 - t0)


def chunk_hold_ms(run) -> Optional[float]:
    """Median over the stretch's chunks ``c`` of how long chunk c's
    finished device work waited for the host to start reading it: the
    start of ``sht.resolve[c]`` less the latest end of the device events
    launched inside ``sht.dispatch[c]``, at least 0."""
    dispatch, resolve = spans(run, 'dispatch'), spans(run, 'resolve')
    if dispatch is None or resolve is None:
        return None
    starts = {batch_of(s): s.start for s in resolve}
    holds = []
    for span, hit in zip(dispatch, run.trace.launched_within(dispatch)):
        c = batch_of(span)
        if c in starts and hit:
            holds.append(max(0, starts[c] - max(e.end for e in hit)) / 1e6)
    return statistics.median(holds) if holds else None
