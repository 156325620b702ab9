"""The port's single-person path (``SimpleHRNet(multiperson=False)``), its
whole-frame resizers, HRNet's plain graph (``use_fused_kernels=False``)
and the TF32 helper, against the JAX package on the CPU.

HRNet-W8 at 64x64 (W16 for int8: the int8 policy skips C < 16) from
seeded weights; frames drawn from a seed with numpy. Each test's docstring
states its tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu import SimpleHRNet as JaxSimpleHRNet
from simple_hrnet_tpu.ops import image as JI

from simple_hrnet_tpu_torch import SimpleHRNet
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.models.layers import QConv2d
from simple_hrnet_tpu_torch.ops import image as TI
from simple_hrnet_tpu_torch.utils.device import true_f32

RES = (64, 64)
# a frame the facade resizes: a downscale on both sides by factors that
# are not integers
FRAME_HW = (90, 120)
KW = dict(resolution=RES, multiperson=False, return_heatmaps=True,
          return_bounding_boxes=True)
# interpolation -> (the port's resizer, the JAX package's)
RESIZERS = {'cubic': (TI.resize_cubic, JI.resize_cubic),
            'linear': (TI.resize_linear, JI.resize_linear),
            'bilinear_aa': (TI.resize_bilinear_aa, JI.resize_bilinear_aa)}


def _frames(n, hw=FRAME_HW, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, *hw, 3)).astype(np.uint8)


def _tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _set_tf32_flags(flags):
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


@pytest.fixture(scope='module')
def pth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('ckpt') / 'pose_hrnet_w8.pth')
    torch.save(TH.init(8, 17, seed=0).state_dict(), path)
    return path


@pytest.fixture(scope='module')
def facades(pth):
    """(port, JAX) single-person facades by interpolation, built once: the
    JAX facade compiles each (frame shape, batch) once for the module."""
    cache = {}

    def get(interpolation):
        if interpolation not in cache:
            cache[interpolation] = (
                SimpleHRNet(8, 17, pth, device='cpu',
                            interpolation=interpolation, **KW),
                JaxSimpleHRNet(8, 17, pth, interpolation=interpolation, **KW))
        return cache[interpolation]
    return get


def _assert_close(out, ref):
    """One predict result of each facade: boxes exact and float32, shapes
    equal, heatmaps within 2e-4 (f32, the house tolerance), keypoint
    positions within 1e-4 px, confidences within 2e-4."""
    (hm, bx, pts), (rhm, rbx, rpts) = out, ref
    assert bx.dtype == rbx.dtype == np.float32
    np.testing.assert_array_equal(bx, rbx)
    assert hm.shape == rhm.shape and pts.shape == rpts.shape
    np.testing.assert_allclose(hm, rhm, rtol=0, atol=2e-4)
    np.testing.assert_allclose(pts[..., :2], rpts[..., :2], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(pts[..., 2], rpts[..., 2], rtol=0, atol=2e-4)


def test_resizers_match_jax():
    """The bicubic and antialiased-bilinear weights are bitwise the JAX
    package's for a downscale, an upscale and odd sizes. The f32 resizes
    agree within 1e-3 (``test_resize_linear_matches_jax``'s tolerance: two
    matmuls summed in another order) and, rounded and clipped to 8 bits,
    within one count."""
    img = np.random.default_rng(1).integers(0, 256, (2, 50, 70, 3)).astype(
        np.float32)
    for kind, tw, jw in (('cubic', TI._cubic_weights, JI._cubic_weights),
                         ('bilinear_aa', TI._linear_aa_weights,
                          JI._linear_aa_weights)):
        for n_in, n_out in ((50, 37), (50, 90), (37, 23), (23, 37)):
            np.testing.assert_array_equal(tw(n_in, n_out), jw(n_in, n_out))
        ours, theirs = RESIZERS[kind]
        for out_hw in ((37, 90), (100, 20), (23, 41)):
            ref = np.asarray(theirs(img, out_hw))
            out = ours(torch.from_numpy(img), out_hw).numpy()
            assert out.dtype == np.float32 and out.shape == ref.shape
            np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
            assert np.abs(np.clip(np.round(out), 0, 255)
                          - np.clip(np.round(ref), 0, 255)).max() <= 1


def test_predict_without_resize_matches_jax(facades):
    """Frames of the model's size (no resize, so no rounding enters): one
    frame and a stack of two through both facades, at ``_assert_close``'s
    tolerances, with the JAX facade's shapes and dtypes."""
    port, ref = facades('cubic')
    frames = _frames(2, RES, seed=1)
    single, stack = port.predict(frames[0]), port.predict(frames)
    _assert_close(single, ref.predict(frames[0]))
    _assert_close(stack, ref.predict(frames))
    assert [a.shape for a in single] == [(1, 17, 16, 16), (1, 4), (1, 17, 3)]
    assert [a.shape for a in stack] == [(2, 17, 16, 16), (2, 4),
                                        (2, 1, 17, 3)]
    np.testing.assert_array_equal(stack[1], [[0, 0, 64, 64]] * 2)


@pytest.mark.parametrize('interpolation', list(RESIZERS))
def test_predict_with_resize_matches_jax(facades, interpolation):
    """One 90x120 frame resized to 64x64. The port's rounded frame P and
    the JAX facade's J (its own steps, jitted) are within one count: f32
    matmuls summed in another order can put a half-way value one count
    apart. The port's facade heatmaps are its runner's on P exactly. Its
    heatmaps are within 2e-4 of the JAX facade's plus the port's own
    response to the flipped pixels, pixel by pixel: |port(P) - port(J)|,
    from running the port on both rounded frames (with no flip, 2e-4
    alone). Keypoint positions are held to 1e-4 px where the JAX peak
    clears its runner-up by more than twice the largest bound; boxes
    exact."""
    port, ref = facades(interpolation)
    frame = _frames(1, seed=2)[0]
    hm, bx, pts = port.predict(frame)
    rhm, rbx, rpts = ref.predict(frame)
    np.testing.assert_array_equal(bx, rbx)
    assert hm.shape == rhm.shape == (1, 17, 16, 16)

    ours, theirs = RESIZERS[interpolation]
    rgb = np.ascontiguousarray(frame[..., ::-1]).astype(np.float32)
    p = np.clip(np.round(ours(torch.from_numpy(rgb), RES).numpy()), 0, 255)
    j = np.asarray(jax.jit(lambda f: jnp.clip(jnp.round(theirs(f, RES)),
                                              0.0, 255.0))(rgb))
    assert np.abs(p - j).max() <= 1
    run = port._single(RES, 1)
    hp, hj = (np.transpose(run(torch.from_numpy(x.astype(np.uint8))[None])[
        0].numpy(), (0, 3, 1, 2)) for x in (p, j))
    np.testing.assert_array_equal(hp, hm)

    bound = np.abs(hp - hj) + 2e-4
    assert (np.abs(hm - rhm) <= bound).all()
    two = np.sort(rhm.reshape(1, 17, -1), axis=-1)[..., -2:]
    clear = (two[..., 1] - two[..., 0]) > 2 * bound.max()
    assert clear.sum() >= 4, (interpolation, int((p != j).sum()))
    np.testing.assert_allclose(pts[clear][:, :2], rpts[clear][:, :2],
                               rtol=0, atol=1e-4)


def test_stream_matches_predict_and_jax(facades):
    """predict_stream without a detector, heatmaps and boxes on, over three
    frames of the model's size and one 90x120 frame: each frame's result
    is the port's own ``predict(frame)`` exactly (the same runner); the
    JAX stream's results are the JAX ``predict``'s, and at the model's size
    the two streams agree at ``_assert_close``'s tolerances (the resized
    frame's parity is the resize test's). ``batch_frames`` and
    ``adaptive_slots`` change nothing, as in the JAX facade;
    ``compact_crops=True`` raises its ``ValueError`` in both."""
    port, ref = facades('cubic')
    frames = list(_frames(3, RES, seed=1)) + [_frames(1, seed=2)[0]]
    out = list(port.predict_stream(frames, prefetch=2))
    expect = list(ref.predict_stream(frames, prefetch=2))
    assert len(out) == len(expect) == 4
    for o, e, f in zip(out, expect, frames):
        for a, b in zip(o, port.predict(f)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(e, ref.predict(f)):
            np.testing.assert_array_equal(a, b)
    for o, e in zip(out[:3], expect[:3]):
        _assert_close(o, e)
    assert [a.shape for a in out[3]] == [(1, 17, 16, 16), (1, 4), (1, 17, 3)]
    for kw in (dict(batch_frames=3), dict(adaptive_slots=True),
               dict(batch_frames=2, adaptive_slots=True, max_people=1)):
        for o, e in zip(port.predict_stream(frames, **kw), out):
            for a, b in zip(o, e):
                np.testing.assert_array_equal(a, b)
    for model in (port, ref):
        with pytest.raises(ValueError, match='requires multiperson'):
            list(model.predict_stream(frames, compact_crops=True,
                                      batch_frames=2))


def test_warmup_matches_jax(pth):
    """warmup without a detector runs ``predict`` for each batch size and
    skips the stream runners: the same runner-cache counts as the JAX
    facade ('single' one per batch size, 'gather' and 'fused' none), and
    the stream afterwards builds no runner."""
    port = SimpleHRNet(8, 17, pth, device='cpu', **KW)
    ref = JaxSimpleHRNet(8, 17, pth, **KW)
    assert port.detector is None and ref.detector is None
    kw = dict(batch_sizes=(1, 2), stream_max_people=('adaptive', 4),
              stream_batch_frames=(1, 2))
    counts = port.warmup(FRAME_HW, **kw)
    assert counts == ref.warmup(FRAME_HW, **kw)
    assert counts == {'single': 2, 'gather': 0, 'fused': 0}
    list(port.predict_stream(list(_frames(2)), batch_frames=2))
    assert sorted(port._single_runs) == [(FRAME_HW, 1), (FRAME_HW, 2)]


@pytest.mark.parametrize('dtype', [None, 'int8'])
def test_plain_graph_matches_jax(tmp_path, dtype):
    """``use_fused_kernels=False``: HRNet's plain graph in both facades
    (no stage module packs a chain or a fusion; under int8 branch 0's convs
    are ``QConv2d`` modules), one frame of the model's size. f32 (W8):
    ``_assert_close``'s tolerances. int8 (W16): test_torch_api_int8.py's
    bound — one activation quantum ``q`` (the last stage module's largest
    activation scale) through the head's largest row L1 norm, 4 such
    quanta at every heatmap pixel and 1 on average; keypoints are not
    compared (random-weight heatmaps are near flat)."""
    c = 16 if dtype == 'int8' else 8
    path = str(tmp_path / f'pose_hrnet_w{c}.pth')
    torch.save(TH.init(c, 17, seed=0).state_dict(), path)
    port = SimpleHRNet(c, 17, path, device='cpu', dtype=dtype,
                       use_fused_kernels=False, **KW)
    ref = JaxSimpleHRNet(c, 17, path, dtype=dtype, use_fused_kernels=False,
                         **KW)
    for m in port.model.stage_modules():
        assert m.chain is None and m.chain_int8 is None and m.fuse is None
    frame = _frames(1, RES, seed=3)[0]
    out, expect = port.predict(frame), ref.predict(frame)
    if dtype is None:
        _assert_close(out, expect)
        return
    last = port.model.stage4[2]
    assert isinstance(last.branches[0][0].conv1, QConv2d)
    q = max(m.ascale.item() for m in last.modules()
            if isinstance(m, QConv2d))
    gain = port.model.final_layer.weight.abs().sum(dim=1).max().item()
    np.testing.assert_array_equal(out[1], expect[1])
    diff = np.abs(out[0] - expect[0])
    assert diff.max() <= 4 * q * gain
    assert diff.mean() <= q * gain


def test_no_detector_ignores_the_yolo_arguments(pth):
    """``multiperson=False`` builds no detector and, like the JAX facade,
    does not look at ``yolo_version``, ``yolo_model_def`` or
    ``yolo_class_path``; with a detector, 'v4' still raises."""
    kw = dict(yolo_version='v4', yolo_model_def='my.cfg',
              yolo_class_path='coco.names')
    port = SimpleHRNet(8, 17, pth, device='cpu', **KW, **kw)
    ref = JaxSimpleHRNet(8, 17, pth, **KW, **kw)
    assert port.detector is None and ref.detector is None
    with pytest.raises(ValueError, match='Unsupported YOLO version.'):
        SimpleHRNet(8, 17, pth, resolution=RES, device='cpu',
                    yolo_version='v4')


def test_true_f32_restores_the_flags(pth):
    """``true_f32`` turns both TF32 flags off inside (as a block and as a
    decorator) and puts back the values it found, after an exception too,
    whatever they were; a facade built and run on the CPU leaves them as
    they were."""
    found = _tf32_flags()

    @true_f32()
    def inside():
        return _tf32_flags()

    try:
        for start in ((True, True), (False, True), (True, False),
                      (False, False)):
            _set_tf32_flags(start)
            with true_f32():
                assert _tf32_flags() == (False, False)
            assert _tf32_flags() == start
            with pytest.raises(RuntimeError, match='inside'):
                with true_f32():
                    raise RuntimeError('inside')
            assert _tf32_flags() == start
            assert inside() == (False, False) and _tf32_flags() == start
        _set_tf32_flags((True, True))
        port = SimpleHRNet(8, 17, pth, device='cpu', **KW)
        port.predict(_frames(1)[0])
        list(port.predict_stream(list(_frames(2, RES))))
        assert _tf32_flags() == (True, True)
    finally:
        _set_tf32_flags(found)
