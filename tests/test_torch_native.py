"""The port's host libraries, live source and profiling utilities against
the JAX package's, on the CPU.

The port compiles its own copies of ``native/nms.cpp`` and
``native/imgproc.cpp`` (``csrc/host/``) with g++ at first use; the JAX
package loads the committed ``native/libimgproc.so`` and its
``libnms.so``. ``jpeg_dims``, ``decode_jpeg_rgb``, ``warp_affine`` and
``decode_warp_normalize`` equal JAX's bit for bit on seeded cv2-encoded
JPEGs (both builds are ``-O3 -march=native``, so the compiler contracts
the same multiply-adds). ``COCODataset(use_native_decode=True)`` items,
the flip folded into the warp and the raw ``device_targets`` tail
included, equal JAX's bit for bit under the same ``random`` seed.
``nms_numpy``'s host-library route gives the numpy route's keep lists and
JAX's ``_native_nms``'s, ties included. ``LiveCameraDataset`` on a
cv2-written 8-frame video with ``resolution`` (height, width),
``rotation_code`` and a stub detector gives JAX's frames and detections
frame for frame. ``chip_smoke.check_native_decode`` (the card script's
check of the fused decode against the plain decode warped in numpy, in
f64) holds within its 1e-4. ``StageTimer`` and ``trace`` run.
"""

import ctypes
import os
import random

import numpy as np
import pytest

from simple_hrnet_tpu.data import coco as JCOCO
from simple_hrnet_tpu.data import live as JLive
from simple_hrnet_tpu.data import native as JN
from simple_hrnet_tpu.ops import nms as JNMS

from simple_hrnet_tpu_torch.data import coco as TCOCO
from simple_hrnet_tpu_torch.data import live as TLive
from simple_hrnet_tpu_torch.data import native as TN
from simple_hrnet_tpu_torch.ops import nms as TNMS
from simple_hrnet_tpu_torch.ops.cuda import build
from simple_hrnet_tpu_torch.ops.image import INV255_STD, MEAN255
from simple_hrnet_tpu_torch.utils import profiling

from test_coco_pipeline import mini_coco  # noqa: F401 (fixture)


def _jpegs(n=4, seed=0):
    import cv2
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = 60 + 17 * i, 80 + 9 * i
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3)).astype(
            np.uint8), (5, 5), 1.5)
        ok, enc = cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY,
                                             70 + 7 * i])
        assert ok
        out.append(enc.tobytes())
    return out


def test_host_libraries_build_here():
    for name in ('nms', 'imgproc'):
        lib = build.host_library(name)
        assert isinstance(lib, ctypes.CDLL)
        path = build._host_so_path(name)
        assert os.path.exists(path)
        assert os.path.dirname(path) == build.BUILD_DIR
    assert TN.available()


def test_image_functions_equal_jax_bitwise():
    assert JN.available()
    rng = np.random.default_rng(1)
    for data in _jpegs():
        assert TN.jpeg_dims(data) == JN.jpeg_dims(data)
        np.testing.assert_array_equal(TN.decode_jpeg_rgb(data),
                                      JN.decode_jpeg_rgb(data))
        w, h = TN.jpeg_dims(data)
        m = np.asarray([[rng.uniform(0.5, 1.5), rng.uniform(-0.3, 0.3),
                         rng.uniform(-5, 5)],
                        [rng.uniform(-0.3, 0.3), rng.uniform(0.5, 1.5),
                         rng.uniform(-5, 5)]], np.float32)
        for mean, scale in ((MEAN255, INV255_STD),
                            (np.zeros(3, np.float32),
                             np.ones(3, np.float32))):
            np.testing.assert_array_equal(
                TN.decode_warp_normalize(data, m, 64, 48, mean, scale),
                JN.decode_warp_normalize(data, m, 64, 48, mean, scale))
        src = rng.standard_normal((h, w, 3)).astype(np.float32)
        np.testing.assert_array_equal(TN.warp_affine(src, m, 40, 30),
                                      JN.warp_affine(src, m, 40, 30))
    assert TN.jpeg_dims(b'not a jpeg') is None
    assert TN.decode_jpeg_rgb(b'not a jpeg') is None


def test_native_decode_items_match_jax(mini_coco):  # noqa: F811
    kw = dict(root_path=str(mini_coco), data_version='train2017',
              image_width=64, image_height=64, use_native_decode=True)
    for extra in (dict(is_train=True, flip_prob=1.0),
                  dict(is_train=True, device_targets=True),
                  dict(is_train=False)):
        jds = JCOCO.COCODataset(**kw, **extra)
        tds = TCOCO.COCODataset(**kw, **extra)
        assert tds.use_native_decode
        for i in range(len(jds)):
            random.seed(30 + i)
            want = jds[i]
            random.seed(30 + i)
            got = tds[i]
            for a, b in zip(got[:3], want[:3]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            for k, v in want[3].items():
                np.testing.assert_array_equal(np.asarray(got[3][k]),
                                              np.asarray(v), err_msg=k)


def test_nms_numpy_host_library_route():
    rng = np.random.default_rng(2)
    for n, levels in ((1, 0), (40, 0), (300, 0), (200, 6)):
        xy = rng.uniform(0, 200, (n, 2))
        wh = rng.uniform(5, 80, (n, 2))
        score = rng.uniform(0, 1, n) if not levels else \
            np.ceil(rng.uniform(0, 1, n) * levels) / levels  # exact ties
        dets = np.concatenate([xy, xy + wh, score[:, None]], 1).astype(
            np.float32)
        for thr in (0.3, 0.5, 0.7):
            native = TNMS.nms_numpy(dets, thr)
            assert native == TNMS.nms_numpy(dets, thr, native=False)
            lib = JNMS._native_nms()
            assert lib is not None
            keep = np.zeros(n, np.int32)
            k = lib.cpu_nms(dets.ctypes.data_as(ctypes.POINTER(
                ctypes.c_float)), n, ctypes.c_float(thr),
                keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
            assert native == keep[:k].tolist()
    assert TNMS.nms_numpy(np.zeros((0, 5), np.float32), 0.5) == []


class _StubDetector:
    """Detections from the frame's content (its mean per channel)."""

    def predict_single(self, frame):
        m = frame.reshape(-1, 3).mean(0)
        return np.asarray([[m[0], m[1], m[0] + 10, m[1] + 20, 0.9, 0.8, 0]],
                          np.float32)


def test_live_camera_dataset_matches_jax(tmp_path):
    import cv2
    path = str(tmp_path / 'clip.avi')
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'MJPG'), 10,
                             (80, 60))
    rng = np.random.default_rng(3)
    for i in range(8):
        writer.write(cv2.GaussianBlur(rng.integers(0, 256, (60, 80, 3))
                                      .astype(np.uint8), (5, 5), 2))
    writer.release()
    for kw in (dict(resolution=(48, 64), detector=_StubDetector(),
                    rotation_code=cv2.ROTATE_90_CLOCKWISE),
               dict(max_frames=5)):
        got, want = TLive.LiveCameraDataset(filename=path, **kw), \
            JLive.LiveCameraDataset(filename=path, **kw)
        frames = list(zip(got, want))
        got.release()
        want.release()
        assert len(frames) == kw.get('max_frames', 8)
        for g, w in frames:
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if 'resolution' in kw:
            assert frames[0][0][1].shape == (48, 64, 3)


def test_chip_smoke_native_decode_check():
    """The card script's check of the fused decode against the library's
    plain decode warped and normalized in numpy (it runs on a card host
    only where jpeglib.h is installed; here it runs on the CPU)."""
    import chip_smoke
    for data in _jpegs(2, seed=4):
        assert chip_smoke.check_native_decode(data) <= \
            chip_smoke.NATIVE_DECODE_TOL


def test_profiling_utilities(tmp_path):
    timer = profiling.StageTimer(alpha=0.5)
    for _ in range(3):
        with timer.stage('detector'):
            sum(range(1000))
    assert set(timer.means) == {'detector'} and timer.means['detector'] > 0
    assert timer.summary().startswith('detector: ')
    import torch
    with profiling.trace(str(tmp_path / 'tr')) as prof:
        torch.ones(4).add_(1)
    assert prof is not None
    assert os.path.exists(tmp_path / 'tr' / 'trace.json')
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            profiling.device_timer(lambda: None)
