"""The port's ``predict_stream`` modes on a card, against the same modes on
the CPU; their dispatch free of host synchronizations; their kernel
launches.

Marked ``cuda``; skips on a host without a CUDA device. Imports neither
JAX nor the JAX package:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_stream.py

HRNet-W8 at 64x64 in f32 with TF32 off, where the chain kernel K2 and the
fuse kernel K3 take every stage module. Tolerances: boxes exact (the stub
detector's rows; PIL crops are exact in f64 on both devices); heatmaps and
confidences 1e-3 of max (f32 summation order through ~90 layers, as
chip_smoke.py phase 3 holds the W48 forward); keypoint coordinates 1e-4
px (the same heatmap argmax).
"""

import numpy as np
import pytest
import torch
from torch_stream_stubs import VaryStub, frames_with_counts

from simple_hrnet_tpu_torch import SimpleHRNet
from simple_hrnet_tpu_torch.api import _pose_tail
from simple_hrnet_tpu_torch.detectors.yolov3 import YOLOv3
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.ops import image as TI
from simple_hrnet_tpu_torch.ops.cuda import fuse_up as TF
from simple_hrnet_tpu_torch.ops.cuda import fused_block as TB
from simple_hrnet_tpu_torch.ops.cuda import nms as TN
from simple_hrnet_tpu_torch.utils.dispatch import strict_dispatch

KW = dict(resolution=(64, 64), yolo_model_def='yolov3-tiny',
          return_heatmaps=True, return_bounding_boxes=True)
COUNTS = [1, 5, 1, 1, 0, 0, 0, 0, 0, 0, 2, 7, 0, 3]
MODES = {
    'fixed': dict(max_people=8),
    'chunked': dict(max_people=8, batch_frames=2),
    'adaptive': dict(max_people=8, adaptive_slots=True, slot_window=2),
    'adaptive_chunked': dict(max_people=8, batch_frames=2,
                             adaptive_slots=True, slot_window=2),
    'compact': dict(max_people=8, batch_frames=2, compact_crops=True),
}


@pytest.fixture(scope='module')
def facades(tmp_path_factory):
    """W8 f32 facades on the card and on the CPU, from one seeded .pth,
    each with the VaryStub detector on its device."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    path = str(tmp_path_factory.mktemp('ckpt') / 'pose_hrnet_w8.pth')
    torch.save(TH.init(8, 17, seed=0).state_dict(), path)
    card = SimpleHRNet(8, 17, path, device='cuda', **KW)  # true f32
    cpu = SimpleHRNet(8, 17, path, device='cpu', **KW)
    card.detector, cpu.detector = VaryStub('cuda'), VaryStub()
    return card, cpu


@pytest.mark.cuda
@pytest.mark.parametrize('mode', list(MODES))
def test_stream_mode_on_card_matches_cpu(facades, mode):
    card, cpu = facades
    frames = frames_with_counts(COUNTS)
    out = list(card.predict_stream(frames, **MODES[mode]))
    ref = list(cpu.predict_stream(frames, **MODES[mode]))
    assert [o[2].shape[0] for o in out] == COUNTS
    for (hm, boxes, pts), (rhm, rboxes, rpts) in zip(out, ref):
        assert hm.shape == rhm.shape and pts.shape == rpts.shape
        np.testing.assert_array_equal(boxes, rboxes)
        tol = 1e-3 * max(1.0, float(np.abs(rhm).max(initial=0.0)))
        np.testing.assert_allclose(hm, rhm, rtol=0, atol=tol)
        np.testing.assert_allclose(pts[..., :2], rpts[..., :2], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(pts[..., 2], rpts[..., 2], rtol=0,
                                   atol=tol)


@pytest.mark.cuda
def test_stream_dispatch_makes_no_sync(facades):
    """Every upload and runner call of every mode runs in sync-debug mode
    'error' (a synchronizing call there raises)."""
    card, _ = facades
    frames = frames_with_counts(COUNTS)
    for mode, kw in MODES.items():
        with strict_dispatch(card) as calls:
            out = list(card.predict_stream(frames, prefetch=2, **kw))
        assert [o[2].shape[0] for o in out] == COUNTS, mode
        assert calls.get('_upload', 0) > 0, (mode, calls)
        assert sum(calls.values()) > calls['_upload'], (mode, calls)


@pytest.mark.cuda
def test_detect_and_pose_tail_make_no_sync(facades):
    """The real detector (K1 inside) and the pose tail (K2 and K3 inside)
    queue their work without a host synchronization."""
    card, _ = facades
    det = YOLOv3('yolov3-tiny', device='cuda')
    frames = card._upload(np.random.default_rng(5).integers(
        0, 256, (2, 120, 160, 3)).astype(np.uint8))
    boxes = torch.tensor([[10.0, 10.0, 60.0, 90.0], [0.0, 5.0, 40.0, 70.0]],
                         device='cuda')
    crops = TI.crop_resize_pil(frames, torch.arange(2, device='cuda'),
                               boxes, card.resolution)
    torch.cuda.synchronize()
    launches = (TN.nms.launches, TB.basic_chain.launches,
                TF.fuse_up.launches)
    torch.cuda.set_sync_debug_mode('error')
    try:
        rows, valid = det.detect_padded(frames)
        hm, pts = _pose_tail(card.model, crops, boxes)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert rows.shape == (2, 32, 7) and valid.shape == (2, 32)
    assert hm.shape == (2, 16, 16, 17) and pts.shape == (2, 17, 3)
    assert (TN.nms.launches - launches[0], TB.basic_chain.launches -
            launches[1], TF.fuse_up.launches - launches[2]) == (1, 8, 8)


@pytest.mark.cuda
def test_stream_launch_counts(facades):
    """With the real detector: K1 once a detect, the chain 8 times and the
    fuse 8 times a pose forward (W8 f32 packs all 8 stage modules), in
    every mode."""
    card, _ = facades
    model = SimpleHRNet(8, 17, card.checkpoint_path, device='cuda', **KW)
    assert all(m.chain is not None and m.fuse is not None
               for m in model.model.stage_modules())
    frames = list(np.random.default_rng(5).integers(
        0, 256, (5, 120, 160, 3)).astype(np.uint8))
    det = model.detector
    detects, forwards = [], []
    orig = det._detect
    det._detect = lambda f: (detects.append(f.shape[0]), orig(f))[1]
    hook = model.model.register_forward_pre_hook(
        lambda _m, args: forwards.append(args[0].shape[0]))
    try:
        for mode, kw in MODES.items():
            detects.clear()
            forwards.clear()
            for k in (TN.nms, TB.basic_chain, TF.fuse_up):
                k.launches = 0
            list(model.predict_stream(frames, **kw))
            torch.cuda.synchronize()
            got = (TN.nms.launches, TB.basic_chain.launches,
                   TF.fuse_up.launches)
            assert detects and got == (len(detects), 8 * len(forwards),
                                       8 * len(forwards)), (mode, got)
    finally:
        hook.remove()
        del det._detect
