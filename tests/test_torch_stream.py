"""The port's ``predict_stream`` (fixed-slot and chunked modes), its slot
controller, its errors and ``warmup`` against the JAX facade, on the CPU
in f32 (the adaptive and compact modes: test_torch_stream_adaptive.py).

Detectors: the real YOLOv3-tiny with the JAX package's seeded weights
carried across, or the ``VaryStub`` pair, whose person count follows each
frame's mean. Geometry and tolerances: tests/torch_stream_parity.py.
"""

import numpy as np
import pytest

import jax
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)
from torch_stream_parity import (KW, assert_same_stream, jax_stream,
                                 port_facade, stub_facades)
from torch_stream_stubs import frames_with_counts

from simple_hrnet_tpu import SimpleHRNet as JaxSimpleHRNet
from simple_hrnet_tpu import api as JA
from simple_hrnet_tpu.detectors import darknet as JD
from simple_hrnet_tpu.detectors.yolov3 import YOLOv3 as JaxYOLOv3

from simple_hrnet_tpu_torch import SimpleHRNet
from simple_hrnet_tpu_torch import api as TA
from simple_hrnet_tpu_torch.detectors import darknet as TD
from simple_hrnet_tpu_torch.models import convert as TC
from simple_hrnet_tpu_torch.models import hrnet as TH


@pytest.fixture(scope='module')
def pth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('ckpt') / 'pose_hrnet_w8.pth')
    torch.save(TH.init(8, 17, seed=0).state_dict(), path)
    return path


@pytest.fixture(scope='module')
def tiny_facades(pth):
    """Both facades with YOLOv3-tiny carrying the JAX package's seeded
    weights."""
    port = SimpleHRNet(8, 17, pth, device='cpu', **KW)
    ref = JaxSimpleHRNet(8, 17, pth, **KW)
    ref.detector = JaxYOLOv3('yolov3-tiny', phase_stem=False,
                             max_batch_size=32)
    tree = JD.init(jax.random.PRNGKey(0), ref.detector.blocks)
    net = TC.load_into(TD.Darknet(port.detector.blocks),
                       TC.from_jax_params(tree)).eval()
    port.detector.net = TD.fold_weights(net)
    return port, ref


def _drive(ctl, n, cap):
    """One launch of the adaptive stream against ``ctl`` for a scene of
    ``n`` people: rung 0 escalates to fit, a saturated launch escalates
    until it is not, then the launch's count is observed."""
    slots = ctl.slots
    if slots == 0 and n > 0:
        slots = ctl.escalate(min(n, cap - 1))
    seen = min(n, slots)
    while seen >= slots and slots < cap:
        slots = ctl.escalate(slots)
        seen = min(n, slots)
    ctl.observe(seen)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_slot_controller_matches_jax(seed):
    """The ladder for every cap up to 40, and the controller's state after
    each launch of a seeded random scene: runs of empty frames, sparse
    and crowded frames."""
    for cap in range(1, 41):
        assert TA._slot_ladder(cap) == JA._slot_ladder(cap)
    rng = np.random.default_rng(seed)
    cap = int(rng.choice([4, 8, 16, 32]))
    window = int(rng.integers(1, 6))
    ours = TA._SlotController(cap, window)
    ref = JA._SlotController(cap, window)
    trajectory = []
    for _ in range(60):
        hi = int(rng.choice([0, 1, cap // 2, cap + 4]))
        for n in rng.integers(0, hi + 1, int(rng.integers(1, 12))):
            _drive(ours, int(n), cap)
            _drive(ref, int(n), cap)
            assert (ours.idx, ours.slots, list(ours.counts)) == \
                (ref.idx, ref.slots, list(ref.counts))
            trajectory.append(ours.slots)
    assert 0 in trajectory and cap in trajectory


def test_fixed_stream_yolov3_tiny_matches_jax(tiny_facades):
    """Per-frame fixed-slot stream through the real detector: each frame's
    people (at most 8 slots) as the JAX facade's stream gives them."""
    port, ref = tiny_facades
    frames = list(np.random.default_rng(5).integers(
        0, 256, (3, 120, 160, 3)).astype(np.uint8))
    out = list(port.predict_stream(frames, max_people=8, prefetch=1))
    expect = jax_stream(ref, frames, max_people=8, prefetch=1)
    assert sum(o[2].shape[0] for o in out) > 0
    assert_same_stream(out, expect)


def test_chunked_stream_matches_jax(pth):
    """batch_frames=2 over a shape change and a trailing partial chunk
    (chunks [a, a], [a + pad], [b, b], [b + pad]): the JAX facade's chunked
    stream, and the port's own per-frame stream."""
    port, ref = stub_facades(pth)
    counts = [1, 3, 2, 2, 1, 4]
    frames = (frames_with_counts(counts[:3])
              + frames_with_counts(counts[3:], shape=(80, 100, 3)))
    out = list(port.predict_stream(frames, max_people=4, prefetch=1,
                                   batch_frames=2))
    expect = jax_stream(ref, frames, max_people=4, prefetch=1,
                        batch_frames=2)
    assert_same_stream(out, expect, counts)
    assert set(port._fused_runs) == {((100, 120), 4, 2), ((80, 100), 4, 2)}
    assert_same_stream(out, list(port.predict_stream(frames, max_people=4)))


def test_fixed_stream_equals_predict(pth):
    """The per-frame stream gives the first ``max_people`` people of
    ``predict(frame)``, in the detector's order."""
    port = port_facade(pth)
    frames = frames_with_counts([5, 3, 2])
    out = list(port.predict_stream(frames, max_people=4))
    for o, frame, n in zip(out, frames, (4, 3, 2)):
        hm, boxes, pts = port.predict(frame)
        assert o[2].shape[0] == n
        np.testing.assert_array_equal(o[1], boxes[:n])
        np.testing.assert_allclose(o[0], hm[:n], rtol=0, atol=2e-4)
        np.testing.assert_allclose(o[2], pts[:n], rtol=0, atol=1e-4)


@pytest.mark.parametrize('case', ['compact_per_frame', 'compact_adaptive',
                                  'max_people_over_cap'])
def test_stream_config_errors(tiny_facades, case):
    """The three ValueErrors, as the JAX facade raises them."""
    kw, match = {
        'compact_per_frame': (dict(compact_crops=True), 'batch_frames'),
        'compact_adaptive': (dict(compact_crops=True, batch_frames=2,
                                  adaptive_slots=True), 'adaptive_slots'),
        'max_people_over_cap': (dict(max_people=64), 'max_detections'),
    }[case]
    frames = frames_with_counts([1, 1])
    for facade in tiny_facades:
        with pytest.raises(ValueError, match=match):
            list(facade.predict_stream(frames, **kw))


@pytest.mark.parametrize('mode', ['adaptive', 'compact'])
def test_warmup_counts_match_jax(pth, mode):
    """``warmup``'s runner-cache counts equal the JAX facade's
    executable-cache counts; a stream afterwards builds no new runner."""
    port, ref = stub_facades(pth, return_heatmaps=False,
                             return_bounding_boxes=False)
    kw = dict(batch_sizes=(), stream_max_people=(mode, 8),
              stream_batch_frames=(1, 2) if mode == 'adaptive' else (2,))
    sizes = port.warmup((100, 120), **kw)
    with jax.enable_x64(True):
        assert sizes == ref.warmup((100, 120), **kw)
    assert sizes['single'] == 0 and sizes['fused'] > 0
    keys = (set(port._fused_runs), set(port._gather_runs))
    if mode == 'adaptive':
        assert {((100, 120), 0, 1), ((100, 120), 0, 2),
                ((100, 120), 8, 2)} <= keys[0]
        out = list(port.predict_stream(frames_with_counts([1, 1]),
                                       max_people=8, adaptive_slots=True))
    else:
        assert ('rows', (100, 120), 2, 8) in keys[0]
        assert {('gather', b, None) for b in (1, 2, 4, 8, 16)} <= keys[1]
        out = list(port.predict_stream(frames_with_counts([1, 1, 7, 0]),
                                       max_people=8, batch_frames=2,
                                       compact_crops=True))
    assert [o.shape[0] for o in out] == ([1, 1] if mode == 'adaptive'
                                         else [1, 1, 7, 0])
    assert (set(port._fused_runs), set(port._gather_runs)) == keys
