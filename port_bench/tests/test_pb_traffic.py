"""The open-loop latency arithmetic: each frame timed from its tick's
due time, so a stall delays every frame behind it."""

import numpy as np
import pytest

from port_bench.harness import traffic


def test_open_loop_latency_with_stall():
    hz, cams = 10.0, 2
    due = [t // cams / hz for t in range(12)]
    # service 30 ms a tick; tick 2 stalls 250 ms; later ticks queue behind
    # it and drain at 30 ms a tick
    done, free = [], 0.0
    for k in range(6):
        start = max(free, k / hz)
        free = start + (0.28 if k == 2 else 0.03)
        done += [free] * cams
    lat = traffic.open_loop_latencies(due, done, 0, 12)
    assert lat[:4] == pytest.approx([30, 30, 30, 30])
    assert lat[4:6] == pytest.approx([280, 280])
    # tick 3 was due at 300 ms and starts when tick 2 ends (480 ms)
    assert lat[6] == pytest.approx(210)
    assert lat[8] == pytest.approx(140) and lat[10] == pytest.approx(70)
    assert traffic.percentile(lat, 95) >= 210


def test_open_loop_latency_needs_every_frame():
    with pytest.raises(ValueError):
        traffic.open_loop_latencies([0.0] * 4, [0.1] * 3, 0, 4)


def test_source_ticks_and_marks():
    ring = np.zeros((4, 2, 2, 3), np.uint8)
    marks = []
    src = traffic.Source(ring, {'loop': 'open', 'cameras': 2,
                                'tick_hz': 200.0, 'batch_frames': 2},
                         marks=marks.append)
    it = iter(src)
    for _ in range(6):
        next(it)
    assert marks == [0, 2, 4]
    assert np.allclose(np.diff(src.due[::2]), 1 / 200.0)
    assert all(p >= d - 1e-4 for p, d in zip(src.pulled, src.due))
