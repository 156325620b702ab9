"""Reductions the per-layer metric readers share: the traced stretch, the
frames and people in it, and device time of the kernels launched inside
the benchmark's spans or the program's custom ops."""

from __future__ import annotations

from typing import Optional

from port_bench.harness import bound
from port_bench.harness.trace import batch_of


def stretch(run) -> Optional[tuple]:
    """(t0, t1, first frame, frames) of the traced stretch, or None."""
    if run.trace is None or run.stretch is None or not run.trace.device:
        return None
    t0, t1, f0 = run.stretch
    chunks = int(run.cell.mix['trace_chunks'])
    return t0, t1, f0, chunks * int(run.cell.mix['batch_frames'])


def span_device_s(run, label: str, kernel: Optional[str] = None):
    """(device seconds, summed batch, per-span device event lists) of the
    spans ``port_bench.<label>`` in the stretch, counting device events
    launched inside them (``kernel``: a regex on their names)."""
    st = stretch(run)
    if st is None:
        return None
    spans = run.trace.spans(f'port_bench.{label}', st[0], st[1])
    if not spans:
        return None
    hits = run.trace.launched_within(spans, kernel)
    if not any(hits):
        return None
    secs = sum(e.end - e.start for h in hits for e in h) / 1e9
    return secs, sum(batch_of(s) for s in spans), hits, spans


def op_roofline(run, op: str, kernel: str, counts) -> Optional[float]:
    """Share (%) of the roofline reached by the kernels that the custom op
    ``op`` launched in the stretch: the sum of each call's least time
    (``counts(shapes, dtypes) -> (bytes, ops, arith)``) over the device
    time of its kernels matching ``kernel``."""
    st = stretch(run)
    if st is None:
        return None
    calls = run.trace.ops(op, st[0], st[1])
    if not calls:
        return None
    hits = run.trace.launched_within(calls, kernel)
    least = busy = 0.0
    for call, kernels in zip(calls, hits):
        if not kernels:
            continue
        nbytes, ops, arith = counts(call.shapes, call.dtypes)
        least += bound.least_s(nbytes, ops, arith)[0]
        busy += sum(e.end - e.start for e in kernels) / 1e9
    return 100.0 * least / busy if busy > 0 else None


def itemsize(dtype: str) -> int:
    return bound.BYTES.get(dtype, 2)


def frames_people(run) -> Optional[tuple]:
    """(frames, detected people) of the stretch's frames."""
    st = stretch(run)
    if st is None:
        return None
    frames = range(st[2], st[2] + st[3])
    return st[3], sum(run.people.get(f, 0) for f in frames)
