"""The port's single-person path and its TF32 rule on a card: the detectors
and the facade compute f32 in true f32 by themselves and leave PyTorch's
TF32 flags as they found them.

Marked ``cuda``; skips on a host without a CUDA device. Imports neither
JAX nor the JAX package:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_single.py

Each test turns both TF32 flags on (cuDNN's is on by PyTorch's default)
and puts back what it found. Tolerances: f32 summation order only, which
TF32's 10-bit products exceed (``chip_smoke.py`` phase 7 holds a TF32
control above its 1e-5 heatmap limit) — YOLOv3-tiny's raw network output
within 1e-4 of max, YOLOv5n's boxes within 1e-2 px and scores within 1e-5
(``test_torch_cuda_v5.py``'s), heatmaps 1e-3 of max (``chip_smoke.py``
phase 3's limit through ~90 layers) and keypoints 1e-4 px where the
heatmap peak clears its runner-up.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch_v5_weights import write_yolov5_pt

from simple_hrnet_tpu_torch import SimpleHRNet
from simple_hrnet_tpu_torch.detectors import yolov3 as TY3
from simple_hrnet_tpu_torch.detectors import yolov5 as TY5
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.ops import image as TI
from simple_hrnet_tpu_torch.ops.cuda import fuse_up as TF
from simple_hrnet_tpu_torch.ops.cuda import fused_block as TB
from simple_hrnet_tpu_torch.ops.cuda import nms as TN
from simple_hrnet_tpu_torch.utils.dispatch import strict_dispatch

RES = (64, 64)


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@contextlib.contextmanager
def tf32_on():
    """Both TF32 flags on inside; fails unless the block leaves them on;
    puts back what it found."""
    found = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
        assert _flags() == (True, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = found


@pytest.fixture(scope='module')
def paths(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    tmp = tmp_path_factory.mktemp('ckpt')
    pth = str(tmp / 'pose_hrnet_w16.pth')
    torch.save(TH.init(16, 17, seed=0).state_dict(), pth)
    return pth, write_yolov5_pt(str(tmp / 'yolov5n_seed0.pt'))


def _frames(n, hw=(240, 320), seed=3):
    return np.random.default_rng(seed).integers(
        0, 256, (n, *hw, 3)).astype(np.uint8)


@pytest.mark.cuda
def test_detectors_run_true_f32_without_a_facade(paths):
    """YOLOv3-tiny and YOLOv5n built on the card before any facade, with
    TF32 allowed, against the same detectors on the CPU: YOLOv3-tiny's raw
    network output (read inside ``detect_padded``) and validity, YOLOv5n's
    rows."""
    frames = _frames(2)
    rgb = np.ascontiguousarray(frames[..., ::-1])
    with tf32_on():
        raw, valid = {}, {}
        for dev in ('cuda', 'cpu'):
            det = TY3.YOLOv3('yolov3-tiny', device=dev)
            hook = det.net.register_forward_hook(
                lambda _m, _i, out, _d=dev: raw.update({_d: out.cpu()}))
            try:
                valid[dev] = det.detect_padded(rgb)[1].cpu()
            finally:
                hook.remove()
        torch.testing.assert_close(valid['cuda'], valid['cpu'], rtol=0,
                                   atol=0)
        err = (raw['cuda'] - raw['cpu']).abs().max().item()
        assert err <= 1e-4 * raw['cpu'].abs().max().item(), err
        (cr, cv), (hr, hv) = (
            (t.cpu().numpy() for t in TY5.YOLOv5(
                paths[1], img_size=320, device=dev).detect_padded(rgb))
            for dev in ('cuda', 'cpu'))
        np.testing.assert_array_equal(cv, hv)
        assert hv.sum() > 0
        np.testing.assert_allclose(cr[cv][:, :4], hr[hv][:, :4], atol=1e-2)
        np.testing.assert_allclose(cr[cv][:, 4:6], hr[hv][:, 4:6],
                                   atol=1e-5)


@pytest.mark.cuda
def test_single_facade_true_f32_and_flags(paths):
    """The single-person W16 f32 facade on the card against the CPU with
    TF32 allowed: frames of the model's size (one and a stack of two),
    heatmaps within 1e-4 of max (f32 order), boxes exact, keypoints 1e-4 px where the peak clears its runner-up by 4x the
    heatmap error; the three whole-frame resizers within 1e-3 of the CPU's
    unrounded values (TF32 would be ~0.1). A multi-person facade's
    ``predict`` leaves the flags as found too, on or off."""
    pth = paths[0]
    kw = dict(resolution=RES, multiperson=False, return_heatmaps=True,
              return_bounding_boxes=True)
    with tf32_on():
        card, cpu = (SimpleHRNet(16, 17, pth, device=d, **kw)
                     for d in ('cuda', 'cpu'))
        frames = _frames(2, RES, seed=4)
        for arg in (frames[0], frames):
            (hm, bx, pts), (rhm, rbx, rpts) = card.predict(arg), \
                cpu.predict(arg)
            np.testing.assert_array_equal(bx, rbx)
            assert hm.shape == rhm.shape and pts.shape == rpts.shape
            err = float(np.abs(hm - rhm).max())
            assert err <= 1e-4 * float(np.abs(rhm).max()), err
            flat = rhm.reshape(*rhm.shape[:2], -1)
            two = np.sort(flat, axis=-1)[..., -2:]
            clear = (two[..., 1] - two[..., 0]) > 4 * err
            assert clear.any()
            np.testing.assert_allclose(
                pts.reshape(clear.shape + (3,))[clear][:, :2],
                rpts.reshape(clear.shape + (3,))[clear][:, :2], atol=1e-4)
        rgb = torch.from_numpy(_frames(1)[0][..., ::-1].copy())
        for resize in (TI.resize_cubic, TI.resize_linear,
                       TI.resize_bilinear_aa):
            out = resize(rgb.cuda(), RES).cpu()
            torch.testing.assert_close(out, resize(rgb, RES), rtol=0,
                                       atol=1e-3)
        multi = SimpleHRNet(16, 17, pth, device='cuda', resolution=RES,
                            yolo_model_def='yolov3-tiny')
        multi.predict(_frames(1)[0])
    found = _flags()
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card.predict(frames[0])
        multi.predict(_frames(1)[0])
        assert _flags() == (False, False)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = found


@pytest.mark.cuda
def test_single_stream_dispatch_and_launches(paths):
    """The single-person stream in bf16 after ``warmup``: every upload and
    runner call in sync-debug mode 'error', one pose forward a frame, K1
    never, the chain and the fuse 8 times a frame; each frame's keypoints
    equal ``predict(frame)``'s. ``use_fused_kernels=False`` launches no
    port kernel."""
    pth = paths[0]
    model = SimpleHRNet(16, 17, pth, device='cuda', resolution=RES,
                        multiperson=False, dtype='bfloat16')
    assert all(m.chain is not None and m.fuse is not None
               for m in model.model.stage_modules())
    frames = list(_frames(4, seed=5)) + list(_frames(2, RES, seed=6))
    assert model.warmup((240, 320)) == {'single': 1, 'gather': 0,
                                        'fused': 0}
    kernels = (TN.nms, TB.basic_chain, TF.fuse_up)
    for k in kernels:
        k.launches = 0
    with strict_dispatch(model) as calls:
        out = list(model.predict_stream(frames, prefetch=2))
    torch.cuda.synchronize()
    assert tuple(k.launches for k in kernels) == (0, 8 * 6, 8 * 6)
    assert calls == {'_upload': 6, '_single': 6}
    for o, f in zip(out, frames):
        np.testing.assert_array_equal(o, model.predict(f))
    plain = SimpleHRNet(16, 17, pth, device='cuda', resolution=RES,
                        multiperson=False, dtype='bfloat16',
                        use_fused_kernels=False)
    for k in kernels:
        k.launches = 0
    plain.predict(frames[0])
    torch.cuda.synchronize()
    assert all(k.launches == 0 for k in kernels)
