"""The port's adaptive and compact ``predict_stream`` modes against the JAX
facade's, on the CPU in f32: the same results, and the same sequence of
launches — the rungs the adaptive stream runs (0 = the detect-only
counts runner) and the people buckets the compact stream's pose launches
take. Geometry and tolerances: tests/torch_stream_parity.py.
"""

import pytest

import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)
from torch_stream_parity import assert_same_stream, jax_stream, stub_facades
from torch_stream_stubs import frames_with_counts

from simple_hrnet_tpu_torch.models import hrnet as TH


@pytest.fixture(scope='module')
def facades(tmp_path_factory):
    """One facade pair for the module, so the JAX graphs compile once."""
    path = str(tmp_path_factory.mktemp('ckpt') / 'pose_hrnet_w8.pth')
    torch.save(TH.init(8, 17, seed=0).state_dict(), path)
    return stub_facades(path)


def spy_rungs(port, ref, chunked):
    """Record each facade's launches: the slot count of every fixed-slot
    runner asked for and 0 for every counts runner. Returns the two lists
    and a function that removes the spies."""
    names = {'port': ('_fused_frames' if chunked else '_fused_frame',
                      '_detect_counts'),
             'ref': ('_get_fused_frames' if chunked else '_get_fused_frame',
                     '_get_detect_counts')}
    logs = {'port': [], 'ref': []}
    for who, facade in (('port', port), ('ref', ref)):
        fused, counts = names[who]
        orig_f, orig_c = getattr(facade, fused), getattr(facade, counts)

        def spy_f(in_hw, slots, *a, _o=orig_f, _l=logs[who]):
            _l.append(slots)
            return _o(in_hw, slots, *a)

        def spy_c(in_hw, n, _o=orig_c, _l=logs[who]):
            _l.append(0)
            return _o(in_hw, n)

        setattr(facade, fused, spy_f)
        setattr(facade, counts, spy_c)

    def restore():
        for who, facade in (('port', port), ('ref', ref)):
            for name in names[who]:
                delattr(facade, name)
    return logs['port'], logs['ref'], restore


@pytest.mark.parametrize('prefetch', [0, 2])
def test_adaptive_per_frame_matches_jax(facades, prefetch):
    """Escalation through saturated rungs (5 people at rung 2), descent
    after quiet windows, rung 0 after an all-empty window and the wake-up
    escalation straight to a fitting rung: results equal the JAX facade's
    and the port's fixed-slot stream; rung sequences equal the JAX
    facade's."""
    port, ref = facades
    counts = [1, 5, 1, 1, 1, 0, 0, 0, 0, 0, 2, 0]
    frames = frames_with_counts(counts)
    fixed = list(port.predict_stream(frames, max_people=8))
    ours, theirs, restore = spy_rungs(port, ref, chunked=False)
    try:
        kw = dict(max_people=8, prefetch=prefetch, adaptive_slots=True,
                  slot_window=2)
        out = list(port.predict_stream(frames, **kw))
        expect = jax_stream(ref, frames, **kw)
    finally:
        restore()
    assert_same_stream(out, expect, counts)
    assert_same_stream(out, fixed)
    assert ours == theirs
    assert 0 in ours and 8 in ours


@pytest.mark.parametrize('prefetch', [0, 1])
def test_adaptive_chunked_matches_jax(facades, prefetch):
    """Chunked adaptive serving (2 frames a launch, cap 4): a saturated
    chunk escalates, all-empty chunks reach rung 0, a chunk with a person
    wakes up, and the trailing chunk is partial."""
    port, ref = facades
    counts = [1, 1, 3, 1] + [0] * 10 + [1, 0, 2]
    frames = frames_with_counts(counts)
    fixed = list(port.predict_stream(frames, max_people=4, batch_frames=2))
    ours, theirs, restore = spy_rungs(port, ref, chunked=True)
    try:
        kw = dict(max_people=4, prefetch=prefetch, batch_frames=2,
                  adaptive_slots=True, slot_window=2)
        out = list(port.predict_stream(frames, **kw))
        expect = jax_stream(ref, frames, **kw)
    finally:
        restore()
    assert_same_stream(out, expect, counts)
    assert_same_stream(out, fixed)
    assert ours == theirs
    assert 0 in ours and 4 in ours


def spy_buckets(port, ref):
    logs = ([], [])
    for log, facade, name in ((logs[0], port, '_gather_crop'),
                              (logs[1], ref, '_get_gather_crop')):
        orig = getattr(facade, name)

        def spy(bucket, clamp_hw=None, _o=orig, _l=log):
            _l.append(bucket)
            return _o(bucket, clamp_hw)

        setattr(facade, name, spy)

    def restore():
        del port._gather_crop, ref._get_gather_crop
    return logs[0], logs[1], restore


def test_compact_overflow_and_idle_matches_jax(facades):
    """A density jump overflows the optimistic bucket (exact follow-up
    launches), all-empty windows drop to the detect-only idle tier, and
    the wake-up window is sized from the read counts."""
    port, ref = facades
    counts = [1, 1, 7, 7, 0, 0, 0, 0, 2, 1]
    frames = frames_with_counts(counts)
    fixed = list(port.predict_stream(frames, max_people=8, batch_frames=2))
    ours, theirs, restore = spy_buckets(port, ref)
    try:
        kw = dict(max_people=8, prefetch=0, batch_frames=2,
                  compact_crops=True)
        out = list(port.predict_stream(frames, **kw))
        expect = jax_stream(ref, frames, **kw)
    finally:
        restore()
    assert_same_stream(out, expect, counts)
    assert_same_stream(out, fixed)
    assert ours == theirs == [4, 2, 16, 16, 4]


def test_compact_partial_window_and_shape_change_matches_jax(facades):
    """Windows [a, a], [a + pad], [b, b]: a shape change flushes the
    window, and the padded duplicate frame's people are never consumed."""
    port, ref = facades
    counts = [1, 3, 2, 2, 1]
    frames = (frames_with_counts(counts[:3])
              + frames_with_counts(counts[3:], shape=(80, 100, 3)))
    fixed = list(port.predict_stream(frames, max_people=4))
    ours, theirs, restore = spy_buckets(port, ref)
    try:
        kw = dict(max_people=4, prefetch=1, batch_frames=2,
                  compact_crops=True)
        out = list(port.predict_stream(frames, **kw))
        expect = jax_stream(ref, frames, **kw)
    finally:
        restore()
    assert_same_stream(out, expect, counts)
    assert_same_stream(out, fixed)
    assert ours == theirs
