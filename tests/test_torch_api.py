"""The port's image/decode ops and its SimpleHRNet facade against the JAX
package, on the CPU, plus the package's import and device rules.

Tolerances: ``normalize`` bitwise; PIL crops bitwise against the JAX
resampler under x64 (both exact there) and within one 8-bit count of its
f32 path (f32 reduction order can flip a round-half case,
tests/test_crop_pil.py) — so the JAX facade runs under x64 where the two
facades are compared; heatmaps 2e-4 (f32, the house tolerance); boxes
exact; decoded keypoint positions to 1e-4 px (the same heatmap argmax; the
x64-traced JAX decode may round its scaling differently in the last ulp).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu import SimpleHRNet as JaxSimpleHRNet
from simple_hrnet_tpu import api as JA
from simple_hrnet_tpu.detectors import darknet as JD
from simple_hrnet_tpu.detectors.yolov3 import YOLOv3 as JaxYOLOv3
from simple_hrnet_tpu.ops import decode as JDec
from simple_hrnet_tpu.ops import image as JI

from simple_hrnet_tpu_torch import SimpleHRNet
from simple_hrnet_tpu_torch import api as TA
from simple_hrnet_tpu_torch.detectors import darknet as TD
from simple_hrnet_tpu_torch.models import convert as TC
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.ops import decode as TDec
from simple_hrnet_tpu_torch.ops import image as TI

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (128, 96)


def test_normalize_bitwise():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 255, (64, 3)),
                        rng.integers(0, 256, (64, 3))]).astype(np.float32)
    np.testing.assert_array_equal(TI.MEAN255, JI.MEAN255)
    np.testing.assert_array_equal(TI.INV255_STD, JI.INV255_STD)
    out = TI.normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, np.asarray(JI.normalize(x)))


def test_resize_linear_matches_jax():
    img = np.random.default_rng(1).uniform(0, 255, (2, 50, 70, 3)).astype(
        np.float32)
    for out_hw in ((37, 90), (100, 20)):
        np.testing.assert_array_equal(TI._linear_weights(50, out_hw[0]),
                                      JI._linear_weights(50, out_hw[0]))
        ref = np.asarray(JI.resize_linear(img, out_hw))
        out = TI.resize_linear(torch.from_numpy(img), out_hw).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-3)


@pytest.mark.parametrize('clamp', [False, True])
def test_pad_to_aspect_matches_jax(clamp):
    boxes = np.array([[40, 30, 120, 200], [150, 60, 300, 230],
                      [0, 0, 17, 5], [90, 10, 93, 95], [5, 5, 50, 80]],
                     np.float32)
    clamp_hw = (100, 120) if clamp else None
    ref = np.asarray(JI.pad_to_aspect(boxes, RES[0] / RES[1], clamp_hw))
    out = TI.pad_to_aspect(torch.from_numpy(boxes), RES[0] / RES[1],
                           clamp_hw).numpy()
    np.testing.assert_array_equal(out, ref)


def test_crop_resize_pil_matches_jax():
    """Batched port crops vs the JAX per-crop resampler, with windows
    overhanging every frame edge and a real-pixel box: bitwise under x64,
    within a count of the f32 path."""
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (2, 100, 120, 3)).astype(np.uint8)
    orig = np.array([[10, 10, 60, 90], [5, 5, 50, 80], [70, 30, 130, 110],
                     [0, 0, 119, 99]], np.float32)
    padded = np.array(JI.pad_to_aspect(orig, RES[0] / RES[1]))
    fi = np.array([0, 1, 1, 0])
    out = TI.crop_resize_pil(torch.from_numpy(frames), torch.from_numpy(fi),
                             torch.from_numpy(padded), RES,
                             valid_boxes=torch.from_numpy(orig)).numpy()
    assert out.dtype == np.float32
    for p in range(len(fi)):
        args = (jnp.asarray(frames[fi[p]]), padded[p], RES)
        ref = np.asarray(JI.crop_resize_pil(*args, valid_box=orig[p]))
        assert np.abs(out[p] - ref).max() <= 1.0
        with jax.enable_x64(True):
            exact = np.asarray(JI.crop_resize_pil(
                jnp.asarray(frames[fi[p]]), jnp.asarray(padded[p], jnp.float64),
                RES, valid_box=jnp.asarray(orig[p], jnp.float64)))
        np.testing.assert_array_equal(out[p], exact)


def test_decode_matches_jax():
    rng = np.random.default_rng(3)
    hm = rng.standard_normal((3, 32, 24, 17)).astype(np.float32)
    hm[0, :, :, 2] = -1.0  # a joint with no positive peak
    boxes = np.array([[10, 20, 110, 220], [0, 0, 96, 128], [5, 7, 9, 11]],
                     np.float32)
    p, m = JDec.get_max_preds(hm)
    tp, tm = TDec.get_max_preds(torch.from_numpy(hm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(p))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(m))
    np.testing.assert_array_equal(
        TDec.argmax_decode(torch.from_numpy(hm),
                           torch.from_numpy(boxes)).numpy(),
        np.asarray(JDec.argmax_decode(hm, boxes)))


def test_buckets_match_jax():
    for n in range(0, 70):
        for cap in (1, 16, 32):
            assert TA._buckets(n, cap) == JA._buckets(n, cap)


@pytest.fixture(scope='module')
def facades(tmp_path_factory):
    """W8 pose net (seeded .pth) behind both facades, each with a
    YOLOv3-tiny carrying the JAX package's seeded weights."""
    path = str(tmp_path_factory.mktemp('ckpt') / 'pose_hrnet_w8.pth')
    torch.save(TH.init(8, 17, seed=0).state_dict(), path)
    kw = dict(resolution=RES, yolo_model_def='yolov3-tiny',
              return_heatmaps=True, return_bounding_boxes=True)
    port = SimpleHRNet(8, 17, path, device='cpu', **kw)
    ref = JaxSimpleHRNet(8, 17, path, **kw)
    ref.detector = JaxYOLOv3('yolov3-tiny', phase_stem=False,
                             max_batch_size=32)
    tree = JD.init(jax.random.PRNGKey(0), ref.detector.blocks)
    net = TC.load_into(TD.Darknet(port.detector.blocks),
                       TC.from_jax_params(tree)).eval()
    port.detector.net = TD.fold_weights(net)
    port.detector.phase_stem = False  # the plain stem, as the JAX one
    return port, ref


class _JaxStub:
    """Fixed boxes for both facades (tests/test_api.py's pattern)."""

    def __init__(self, boxes_per_image, torch_out):
        self.boxes = boxes_per_image
        self.torch_out = torch_out

    def detect_padded(self, frames_rgb):
        n, max_det = len(self.boxes), 8
        rows = np.zeros((n, max_det, 7), np.float32)
        valid = np.zeros((n, max_det), bool)
        for i, b in enumerate(self.boxes):
            rows[i, :len(b), :4] = b
            rows[i, :len(b), 4:6] = 0.9
            valid[i, :len(b)] = True
        if self.torch_out:
            return torch.from_numpy(rows), torch.from_numpy(valid)
        return jnp.asarray(rows), jnp.asarray(valid)


def _assert_same_people(out, ref):
    (hm, boxes, pts), (rhm, rboxes, rpts) = out, ref
    np.testing.assert_array_equal(boxes, rboxes)
    assert hm.shape == rhm.shape
    np.testing.assert_allclose(hm, rhm, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(pts[..., :2], rpts[..., :2], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(pts[..., 2], rpts[..., 2], atol=2e-4)


def test_facade_with_stub_detector_matches_jax(facades):
    port, ref = facades
    # the whole-slice test's frame shape and bucket: one JAX compile less
    boxes = [np.array([[5, 5, 50, 80], [20, 10, 70, 95], [90, 40, 170, 130]],
                      np.float32),
             np.zeros((0, 4), np.float32)]
    frames = np.random.default_rng(4).integers(
        0, 256, (2, 120, 160, 3)).astype(np.uint8)
    pdet, rdet = port.detector, ref.detector
    try:
        port.detector = _JaxStub(boxes, torch_out=True)
        ref.detector = _JaxStub(boxes, torch_out=False)
        out = port.predict(frames)
        with jax.enable_x64(True):  # exact PIL crops, as the port's
            expect = ref.predict(frames)
    finally:
        port.detector, ref.detector = pdet, rdet
    assert [len(p) for p in out[2]] == [3, 0]
    for i in range(2):
        _assert_same_people([o[i] for o in out], [e[i] for e in expect])


def test_keypoints_only_by_default(facades):
    """With return_heatmaps / return_bounding_boxes off, predict returns
    the keypoints alone (heatmaps stay on the device), the same ones."""
    port = facades[0]
    boxes = [np.array([[10, 10, 60, 90], [20, 10, 70, 95]], np.float32)]
    frames = np.random.default_rng(6).integers(
        0, 256, (1, 100, 120, 3)).astype(np.uint8)
    det = port.detector
    try:
        port.detector = _JaxStub(boxes, torch_out=True)
        hm, bx, pts = port.predict(frames[0])
        _, _, pts_b = port.predict(frames)
        port.return_heatmaps = port.return_bounding_boxes = False
        only = port.predict(frames[0])
        only_b = port.predict(frames)
    finally:
        port.detector = det
        port.return_heatmaps = port.return_bounding_boxes = True
    assert hm.shape == (2, 17, 32, 24) and bx.shape == (2, 4)
    np.testing.assert_array_equal(only, pts)
    assert isinstance(only_b, list) and len(only_b) == 1
    np.testing.assert_array_equal(only_b[0], pts_b[0])


def test_whole_slice_matches_jax(facades):
    """Detect -> crop -> pose -> decode through both facades: a 2-frame
    stack, then one frame (the single-frame path keeps unclamped boxes)."""
    port, ref = facades
    frames = np.random.default_rng(5).integers(
        0, 256, (2, 120, 160, 3)).astype(np.uint8)
    out = port.predict(frames)
    with jax.enable_x64(True):  # exact PIL crops, as the port's
        expect = ref.predict(frames)
        single = ref.predict(frames[0])
    assert sum(len(p) for p in out[2]) > 0
    for i in range(2):
        _assert_same_people([o[i] for o in out], [e[i] for e in expect])
    _assert_same_people(port.predict(frames[0]), single)


class _TwoProcessMesh:
    """A training mesh: one CPU device in each of two processes."""
    devices = [torch.device('cpu')]
    process_count, local_size, size = 2, 1, 2


@pytest.mark.parametrize('kwargs', [dict(mesh=_TwoProcessMesh())])
def test_unported_options_raise(tmp_path, kwargs):
    """The facade drives a mesh from one process: a mesh that spans
    several processes is refused."""
    path = str(tmp_path / 'w8.pth')
    torch.save(TH.init(8, 17).state_dict(), path)
    with pytest.raises(ValueError, match='from one process'):
        SimpleHRNet(8, 17, path, resolution=RES, device='cpu', **kwargs)


@pytest.mark.parametrize('kwargs, message', [
    (dict(model_name='Unknown'), 'Wrong model name.'),
    (dict(yolo_version='v4'), 'Unsupported YOLO version.')])
def test_wrong_model_choices_raise(tmp_path, kwargs, message):
    """The JAX facade's errors for a model or detector it does not know
    (its api.py:322 and :355)."""
    path = str(tmp_path / 'w8.pth')
    torch.save(TH.init(8, 17).state_dict(), path)
    with pytest.raises(ValueError, match=message):
        SimpleHRNet(8, 17, path, resolution=RES, device='cpu', **kwargs)


@pytest.mark.parametrize('kwargs', [
    dict(int8_exclude=('stage4',)),
    dict(calibration_images=[np.zeros((8, 8, 3), np.uint8)]),
    dict(int8_exclude=('stage4',), dtype='bfloat16')])
def test_int8_options_need_int8(tmp_path, kwargs):
    """As in the JAX facade (api.py:177-196): nothing is calibrated or
    quantized without dtype='int8'."""
    path = str(tmp_path / 'w8.pth')
    torch.save(TH.init(8, 17).state_dict(), path)
    with pytest.raises(ValueError, match="dtype='int8'"):
        SimpleHRNet(8, 17, path, resolution=RES, device='cpu', **kwargs)


def test_int8_exclude_unmatched_prefix_raises(tmp_path):
    path = str(tmp_path / 'w16.pth')
    torch.save(TH.init(16, 17).state_dict(), path)
    with pytest.raises(ValueError, match='match no conv'):
        SimpleHRNet(16, 17, path, resolution=RES, device='cpu', dtype='int8',
                    yolo_model_def='yolov3-tiny', int8_exclude=('stage_4',))


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is visible')
    path = str(tmp_path / 'w8.pth')
    torch.save(TH.init(8, 17).state_dict(), path)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        SimpleHRNet(8, 17, path, resolution=RES)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        SimpleHRNet(8, 17, path, resolution=RES, device='cuda')


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port, nor ``chip_smoke.py``, imports JAX or the JAX
    package, nor (the card host has neither) cv2 or matplotlib, when it
    is imported."""
    code = (
        'import pkgutil, sys\n'
        'import simple_hrnet_tpu_torch as pkg\n'
        'for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):\n'
        '    __import__(m.name)\n'
        'import chip_smoke\n'
        'bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")'
        ' or m == "simple_hrnet_tpu" or m.startswith("simple_hrnet_tpu.")'
        ' or m == "cv2" or m.split(".")[0] == "matplotlib"]\n'
        'assert not bad, bad\n'
        'print(len([m for m in sys.modules if m.startswith(pkg.__name__)]))\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
