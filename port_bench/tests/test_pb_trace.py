"""The trace reductions on a small synthetic trace: the union of device
activity, launch counts, span attribution by correlation, and the
roofline readers' operations and bytes against hand counts."""

import types

import numpy as np
import pytest

from port_bench.harness import bound, spec, trace
from port_bench.harness.trace import Ev, Trace


def _trace():
    # host: two chunk marks 0 and 1000; a pose span [100, 400) on thread 1
    # launching kernels 1 and 2, a launch outside it, a memcpy
    host = [
        Ev('port_bench.chunk[0]', 0, 0, thread=1),
        Ev('port_bench.pose[16]', 100, 400, thread=1),
        Ev('cudaLaunchKernel', 110, 120, corr=1, thread=1),
        Ev('cudaLaunchKernelExC', 200, 210, corr=2, thread=1),
        Ev('cudaMemcpyAsync', 500, 505, corr=3, thread=1),
        Ev('cudaLaunchKernel', 600, 610, corr=4, thread=1),
        Ev('cudaStreamSynchronize', 700, 900, thread=1),
        Ev('port_bench.chunk[8]', 1000, 1000, thread=1),
    ]
    device = [Ev('conv_a', 150, 350, corr=1), Ev('conv_b', 300, 450, corr=2),
              Ev('Memcpy HtoD', 520, 560, corr=3),
              Ev('relu', 640, 700, corr=4)]
    return Trace(host=host, device=device,
                 marks=[(0, 0), (8, 1000)])


def test_union_idle_share():
    tr = _trace()
    # [150, 450) + [520, 560) + [640, 700) = 300 + 40 + 60
    assert tr.busy_ns(0, 1000) == 400
    assert tr.busy_ns(200, 600) == 250 + 40
    assert trace.union_length([(0, 10), (5, 8), (9, 12), (20, 21)]) == 13


def test_launch_count_and_spans():
    tr = _trace()
    assert len(tr.launches(0, 1000)) == 4     # sync is no launch
    spans = tr.spans('port_bench.pose', 0, 1000)
    assert [trace.batch_of(s) for s in spans] == [16]
    hits = tr.launched_within(spans)
    assert [e.name for e in hits[0]] == ['conv_a', 'conv_b']
    assert tr.stretch(0, 1) == (0, 1000, 0)
    assert tr.stretch(1, 1) is None


def _run(tr, cell='w48_yolov3_crowd_video'):
    c = spec.cell(cell)
    c.mix = dict(c.mix, trace_chunks=1, batch_frames=8)
    return types.SimpleNamespace(cell=c, trace=tr, stretch=(0, 1000, 0),
                                 people={f: 2 for f in range(8)},
                                 latencies_ms=np.asarray([1.0, 2.0, 9.0]))


def test_readers_on_synthetic_trace():
    run = _run(_trace())
    read = lambda name: spec.metric_reader(name)(run)
    assert read('host_launches_per_frame.video') == pytest.approx(4 / 8)
    assert read('device_idle_share.video') == pytest.approx(60.0)
    assert read('pose_device_ms_per_crop.video') == pytest.approx(
        350e-6 / 16)
    assert read('detector_device_ms_per_frame.video') is None
    assert read('frame_latency_p50_ms.live') == 2.0
    flops = run.cell.config['flops']
    need = 8 * flops['detector_per_frame'] + 16 * flops['pose_per_crop']
    assert read('mfu.video') == pytest.approx(100 * need / 1e-6 / 989e12)


def test_roofline_counts_by_hand():
    # K2 at W48's branch 0, 128 crops: x (128, 96, 72, 48) bf16
    nbytes, ops = bound.chain((128, 96, 72, 48), (8, 9, 48, 48), (8, 48))
    assert ops == 8 * 2 * 128 * 96 * 72 * 48 * 48 * 9
    assert nbytes == 2 * 128 * 96 * 72 * 48 * 2 + 8 * 9 * 48 * 48 * 2 \
        + 8 * 48 * 4
    # K3 at stage 3: base (128, 96, 72, 48), sources 96 and 192 channels
    ys = [(128, 48, 36, 96), (128, 24, 18, 192)]
    ws = [(96, 48), (192, 48)]
    nbytes, ops = bound.fuse_up((128, 96, 72, 48), ys, ws, (48,))
    assert ops == 2 * (128 * 48 * 36 * 96) * 48 \
        + 2 * (128 * 24 * 18 * 192) * 48 + 128 * 96 * 72 * 48 * 5
    assert nbytes == 2 * 2 * 128 * 96 * 72 * 48 + 2 * (
        128 * 48 * 36 * 96 + 128 * 24 * 18 * 192) + 2 * (96 + 192) * 48 \
        + 4 * 48
    # K4: one SiLU over 16 frames of YOLOv5m's first activation
    nbytes, ops = bound.activation(16 * 4915200)
    assert nbytes == 2 * 16 * 4915200 * 2 and ops == 5 * 16 * 4915200
    t, by = bound.least_s(3.35e12, 1.0, 'bf16')
    assert t == pytest.approx(1.0) and by == 'bytes'


def test_roofline_reader_uses_op_shapes():
    host = [Ev('port_bench.chunk[0]', 0, 0, thread=1),
            Ev('sht::basic_chain', 100, 300, thread=1,
               shapes=[[128, 96, 72, 48], [8, 9, 48, 48], [8, 48]],
               dtypes=['c10::BFloat16', 'c10::BFloat16', 'float']),
            Ev('cudaLaunchKernelExC', 150, 160, corr=7, thread=1),
            Ev('port_bench.chunk[8]', 1000, 1000, thread=1)]
    device = [Ev('void conv3x3_bf16_tc<48>(Conv)', 200, 200 + 10 ** 6,
                 corr=7)]
    run = _run(Trace(host=host, device=device, marks=[(0, 0), (8, 1000)]))
    got = spec.metric_reader('K2_chain_roofline.video')(run)
    nbytes, ops = bound.chain((128, 96, 72, 48), (8, 9, 48, 48), (8, 48))
    want = 100 * bound.least_s(nbytes, ops, 'bf16')[0] / 1e-3
    assert got == pytest.approx(want)
