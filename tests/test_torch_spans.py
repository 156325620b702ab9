"""The port's ``sht.`` spans (``utils/profiling.span``) as a CPU
``torch.profiler`` records them, on HRNet-W8 at 64x64.

Every stream mode (fixed-slot chunked, adaptive, compact, single) gives
each chunk ``c`` its four stream spans, ``sht.stack/upload/dispatch/
resolve[c]``, once each and in that order; every runner span (detect,
NMS, crops, pose, decode) lies inside its chunk's ``sht.dispatch[c]``, or
its ``sht.resolve[c]`` for an adaptive re-run or a compact follow-up
launch, and counts its frames or slots in ``[n]``; ``sht.read`` and
``sht.finish`` lie inside ``sht.resolve[c]``. ``predict`` gives the
runner spans. With no profiler recording, ``span`` builds nothing, and
``profiling.trace`` writes the spans into its ``trace.json``.

The detector is ``VaryStub``'s count rule (the person count of a frame
follows its mean) behind the program's own ``PersonDetector.detect_padded``,
so ``sht.detect`` is the program's; ``predict`` runs the real YOLOv3-tiny
with its seeded random weights, which reaches ``nms_ingraph``.
"""

import json
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)
from torch_stream_stubs import VaryStub, frames_with_counts

from simple_hrnet_tpu_torch import SimpleHRNet
from simple_hrnet_tpu_torch.detectors.yolov3 import PersonDetector
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.utils import profiling

KW = dict(resolution=(64, 64), yolo_model_def='yolov3-tiny',
          return_heatmaps=True, return_bounding_boxes=True, device='cpu')
STREAM = ('stack', 'upload', 'dispatch', 'resolve')
RUNNER = ('detect', 'nms', 'crops', 'pose', 'decode')
# people a frame: chunks of 2 frames [1, 3], [2, 2], [1, 4] — the adaptive
# stream's launches at 2 slots saturate and re-run in their resolve; the
# compact stream's first bucket (4) is short for the third chunk's 5
COUNTS = [1, 3, 2, 2, 1, 4]


class StubDetector(PersonDetector):
    """``VaryStub``'s rows and count rule as a ``PersonDetector``."""

    device = torch.device('cpu')
    max_batch_size = 32
    img_size = 64
    phase_stem = False
    max_detections = 8

    def __init__(self):
        self.stub = VaryStub()

    def _detect(self, frames):
        return self.stub.detect_padded(frames)


@pytest.fixture(scope='module')
def pth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('ckpt') / 'pose_hrnet_w8.pth')
    torch.save(TH.init(8, 17, seed=0).state_dict(), path)
    return path


@pytest.fixture(scope='module')
def facade(pth):
    port = SimpleHRNet(8, 17, pth, **KW)
    port.detector = StubDetector()
    return port


@pytest.fixture(scope='module')
def single(pth):
    return SimpleHRNet(8, 17, pth, multiperson=False, **KW)


def _spans(prof):
    """(name, [n] or None, start, end) of every ``sht.`` span, by start."""
    out = []
    for e in prof.events():
        m = re.fullmatch(r'sht\.(\w+)(?:\[(\d+)\])?', e.name)
        if m:
            out.append((m.group(1), None if m.group(2) is None
                        else int(m.group(2)), e.time_range.start,
                        e.time_range.end))
    return sorted(out, key=lambda s: (s[2], -s[3]))


def _recorded(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _inside(inner, outer):
    return outer[2] <= inner[2] and inner[3] <= outer[3]


def _enclosing(span, stream):
    """The one stream span that holds ``span``."""
    hold = [s for s in stream if _inside(span, s)]
    assert len(hold) == 1, (span, hold)
    return hold[0]


MODES = {
    'chunked': dict(max_people=4, batch_frames=2, prefetch=1),
    'adaptive': dict(max_people=4, batch_frames=2, prefetch=1,
                     adaptive_slots=True),
    'compact': dict(max_people=4, batch_frames=2, prefetch=1,
                    compact_crops=True),
    'single': dict(prefetch=1),
}


@pytest.mark.parametrize('mode', sorted(MODES))
def test_stream_spans(mode, facade, single):
    port = single if mode == 'single' else facade
    frames = frames_with_counts(COUNTS)
    out, spans = _recorded(lambda: list(port.predict_stream(frames,
                                                            **MODES[mode])))
    assert len(out) == len(frames)
    n_chunks = len(frames) if mode == 'single' else len(frames) // 2
    stream = [s for s in spans if s[0] in STREAM]
    for c in range(n_chunks):
        mine = [s for s in stream if s[1] == c]
        assert [s[0] for s in mine] == list(STREAM), (c, mine)
        assert all(a[3] <= b[2] for a, b in zip(mine, mine[1:]))
    assert len(stream) == 4 * n_chunks
    runner = [s for s in spans if s[0] in RUNNER]
    where = {}    # (phase, chunk) -> that stream span's runner spans
    for s in runner:
        holder = _enclosing(s, stream)
        assert holder[0] in ('dispatch', 'resolve'), s
        where.setdefault((holder[0], holder[1]), []).append(s)
    for (phase, c), inner in where.items():
        k = [(s[0], s[1]) for s in inner if s[0] in ('crops', 'pose',
                                                       'decode')]
        # each crop batch is posed and decoded at its own slot count
        assert k == [(name, n) for n in [s[1] for s in inner
                                         if s[0] == 'crops']
                     for name in ('crops', 'pose', 'decode')], inner
    for s in spans:
        if s[0] in ('read', 'finish'):
            assert _enclosing(s, stream)[0] == 'resolve', s
    for c in range(n_chunks):
        inner = [s for s in spans if s[0] in ('read', 'finish')
                 and _inside(s, [t for t in stream
                                 if t[:2] == ('resolve', c)][0])]
        assert {s[0] for s in inner} == {'read', 'finish'}, (c, inner)

    def slots(phase, c):
        return [s[1] for s in where.get((phase, c), ()) if s[0] == 'pose']

    def detects(phase, c):
        return [s[1] for s in where.get((phase, c), ()) if s[0] == 'detect']

    if mode == 'single':
        assert all(detects('dispatch', c) == [] and
                   slots('dispatch', c) == [1] and slots('resolve', c) == []
                   for c in range(n_chunks))
        return
    assert all(detects('dispatch', c) == [2] for c in range(n_chunks))
    # only the adaptive re-runs launch the detector again, in a resolve
    assert [detects('resolve', c) for c in range(n_chunks)] == \
        ([[2], [2], []] if mode == 'adaptive' else [[], [], []])
    if mode == 'chunked':
        assert [slots('dispatch', c) for c in range(3)] == [[8]] * 3
        assert [slots('resolve', c) for c in range(3)] == [[]] * 3
    elif mode == 'adaptive':
        # chunks 0 and 1 leave at rung 2 (one frame ahead), both saturate
        # and re-run at rung 4, where chunk 2 leaves
        assert [slots('dispatch', c) for c in range(3)] == [[4], [4], [8]]
        assert [slots('resolve', c) for c in range(3)] == [[8], [8], []]
    else:
        # the first gather of 4, sized from the prior window; the third
        # chunk's 5 people need one exact follow-up of 1
        assert [slots('dispatch', c) for c in range(3)] == [[4]] * 3
        assert [slots('resolve', c) for c in range(3)] == [[], [], [1]]


def test_predict_spans(pth):
    """``predict`` on one frame and on a stack of two, with the real
    YOLOv3-tiny: detect and NMS count frames, crops/pose/decode the
    gather bucket, and the count read follows the first pose batch."""
    port = SimpleHRNet(8, 17, pth, **KW)
    frames = np.random.default_rng(3).integers(
        0, 256, (2, 96, 128, 3)).astype(np.uint8)
    for image, n in ((frames[0], 1), (frames, 2)):
        _, spans = _recorded(lambda: port.predict(image))
        names = [s[0] for s in spans]
        assert [(s[0], s[1]) for s in spans if s[0] in ('detect', 'nms')] \
            == [('detect', n), ('nms', n)]
        assert _inside([s for s in spans if s[0] == 'nms'][0],
                       [s for s in spans if s[0] == 'detect'][0])
        crops = [s for s in spans if s[0] == 'crops']
        assert crops and crops[0][1] == 2 * n
        for name in ('pose', 'decode'):
            assert [s[1] for s in spans if s[0] == name] == \
                [s[1] for s in crops]
        assert names.index('read') > names.index('pose')
        assert not set(names) & set(STREAM)


def test_span_idle_builds_nothing(facade, monkeypatch):
    """No profiler recording: ``span`` is one shared null context, and a
    whole stream and ``predict`` run without building a
    ``record_function``."""
    assert profiling.span('dispatch', 3) is profiling.span('read')

    def refuse(*_args, **_kw):
        raise AssertionError('record_function built with no profiler')

    monkeypatch.setattr(torch.autograd.profiler, 'record_function', refuse)
    frames = frames_with_counts(COUNTS)
    out = list(facade.predict_stream(frames, max_people=4, batch_frames=2))
    assert [o[2].shape[0] for o in out] == COUNTS
    assert facade.predict(frames[3])[2].shape[0] == COUNTS[3]


def test_trace_file_holds_spans(facade, tmp_path):
    """``profiling.trace`` writes the stream's spans into trace.json."""
    frames = frames_with_counts(COUNTS[:4])
    with profiling.trace(str(tmp_path)):
        list(facade.predict_stream(frames, max_people=4, batch_frames=2))
    with open(tmp_path / 'trace.json') as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    for c in (0, 1):
        assert {f'sht.{p}[{c}]' for p in STREAM} <= names
    assert {'sht.detect[2]', 'sht.crops[8]', 'sht.pose[8]', 'sht.decode[8]',
            'sht.read', 'sht.finish'} <= names
