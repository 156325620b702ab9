"""The readers of the program's ``sht.`` spans on a hand-built trace: idle
attributed to the stream's phases, the live cell's hold, pose slot use
and the crops' and decode's device time a slot, and None on a program
without the spans."""

import types

import pytest

from port_bench.harness import spec
from port_bench.harness.trace import Ev, Trace

NEW = ('dispatch_host_ms_per_frame.video', 'device_idle_in_dispatch.video',
       'device_idle_in_stream_host.video', 'crops_device_ms_per_crop.video',
       'decode_device_ms_per_crop.video', 'pose_slot_use.video',
       'chunk_hold_ms.live')


def _launch(t, corr):
    return Ev('cudaLaunchKernel', t, t + 1, corr=corr, thread=1)


def _trace(resolve_at=600):
    """Two chunks of 8 frames in a stretch [0, 1000). Chunk 0: stack,
    upload (a copy), dispatch [100, 300) with detect, crops, pose and
    decode, each launching one device event, the last ending at 520;
    resolve[0] from ``resolve_at`` for 100 ns, holding a read and a
    finish. Chunk 1: stack, upload (a copy), dispatch [780, 900) with
    crops and pose launching and a decode that launches nothing; its
    resolve comes after the stretch."""
    r = resolve_at
    host = [
        Ev('port_bench.chunk[0]', 0, 0, thread=1),
        Ev('sht.stack[0]', 10, 60, thread=1),
        Ev('sht.upload[0]', 60, 100, thread=1), _launch(70, 1),
        Ev('sht.dispatch[0]', 100, 300, thread=1),
        Ev('sht.detect[8]', 110, 150, thread=1), _launch(120, 2),
        Ev('sht.crops[128]', 150, 200, thread=1), _launch(160, 3),
        Ev('sht.pose[128]', 200, 260, thread=1), _launch(210, 4),
        Ev('sht.decode[128]', 260, 300, thread=1), _launch(270, 5),
        Ev('sht.resolve[0]', r, r + 100, thread=1),
        Ev('sht.read', r, r + 50, thread=1),
        Ev('sht.finish', r + 50, r + 100, thread=1),
        Ev('port_bench.chunk[8]', 720, 720, thread=1),
        Ev('sht.stack[1]', 730, 760, thread=1),
        Ev('sht.upload[1]', 760, 780, thread=1), _launch(765, 6),
        Ev('sht.dispatch[1]', 780, 900, thread=1),
        Ev('sht.crops[128]', 790, 830, thread=1), _launch(800, 7),
        Ev('sht.pose[128]', 830, 870, thread=1), _launch(860, 8),
        Ev('sht.decode[128]', 870, 890, thread=1),
        Ev('port_bench.chunk[16]', 1000, 1000, thread=1),
        Ev('sht.resolve[1]', 1100, 1200, thread=1),
    ]
    device = [Ev('Memcpy HtoD', 80, 120, corr=1), Ev('det', 130, 200, corr=2),
              Ev('crop', 200, 260, corr=3), Ev('pose', 260, 500, corr=4),
              Ev('decode', 500, 520, corr=5),
              Ev('Memcpy HtoD', 770, 790, corr=6),
              Ev('crop', 800, 850, corr=7), Ev('pose', 860, 990, corr=8)]
    host.sort(key=lambda e: e.start)
    return Trace(host=host, device=device,
                 marks=[(0, 0), (8, 720), (16, 1000)])


def _run(tr, cell='w48_yolov3_crowd_video'):
    c = spec.cell(cell)
    c.mix = dict(c.mix, trace_chunks=2, batch_frames=8)
    return types.SimpleNamespace(cell=c, trace=tr, stretch=(0, 1000, 0),
                                 people={f: 13 for f in range(16)},
                                 latencies_ms=None)


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_idle_attribution_adds_up():
    run = _run(_trace())
    # busy: [80, 120) + [130, 520) + [770, 790) + [800, 850) + [860, 990)
    idle = _read('device_idle_share.video', run)
    assert idle == pytest.approx(37.0)
    # dispatch: [120, 130) of chunk 0, [790, 800) + [850, 860) of chunk 1
    in_dispatch = _read('device_idle_in_dispatch.video', run)
    assert in_dispatch == pytest.approx(3.0)
    # stack 50 + 30, upload 20 + 10, resolve 100
    in_host = _read('device_idle_in_stream_host.video', run)
    assert in_host == pytest.approx(21.0)
    # outside every span: [0, 10), [520, 600), [700, 730), [990, 1000)
    outside = 100.0 * (10 + 80 + 30 + 10) / 1000
    assert in_dispatch + in_host + outside == pytest.approx(idle, rel=1e-12)


def test_dispatch_host_time():
    run = _run(_trace())
    assert _read('dispatch_host_ms_per_frame.video', run) == \
        pytest.approx((200 + 120) / 1e6 / 16)


def test_hold_from_dispatch_end_to_resolve():
    # chunk 0's last device event ends at 520, its resolve starts at 600;
    # chunk 1's resolve lies past the stretch and is not read
    assert _read('chunk_hold_ms.live', _run(_trace())) == \
        pytest.approx(80 / 1e6)
    # a resolve that starts while the device still works holds nothing
    assert _read('chunk_hold_ms.live', _run(_trace(resolve_at=400))) == 0.0


def test_slot_use_and_per_crop_device_time():
    run = _run(_trace())
    # 13 people in each of 16 frames over two pose batches of 128 slots
    assert _read('pose_slot_use.video', run) == pytest.approx(
        100.0 * 208 / 256)
    assert _read('crops_device_ms_per_crop.video', run) == pytest.approx(
        (60 + 50) / 1e6 / 256)
    assert _read('decode_device_ms_per_crop.video', run) == pytest.approx(
        20 / 1e6 / 256)


def test_readers_without_program_spans():
    """A program that opens no ``sht.`` span (the trace of the harness's
    own spans only) reads None, as does a run without a stretch."""
    tr = _trace()
    tr.host = [e for e in tr.host if not e.name.startswith('sht.')]
    run = _run(tr)
    assert _read('device_idle_share.video', run) == pytest.approx(37.0)
    for name in NEW:
        assert _read(name, run) is None, name
        assert _read(name, types.SimpleNamespace(
            cell=run.cell, trace=None, stretch=None, people={})) is None
