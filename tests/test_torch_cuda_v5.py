"""The port's YOLOv5 detector and PoseResNet on a card, against the same
modules on the CPU or their plain form.

Marked ``cuda``; skips on a host without a CUDA device. Imports neither
JAX nor the JAX package:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_v5.py

yolov5n from the seeded checkpoint of ``tests/torch_v5_weights.py`` at
img_size 320, in f32 with TF32 off. Tolerances: the same valid rows
(K1 on the card equals its plain version slot for slot, so the rows
differ only by the network's f32 summation order), boxes within 1e-2 px,
scores within 1e-5; PoseResNet's folded bf16 transposed convs (cuDNN,
channels_last) within 2^-6 of max of the unfolded f32 modules
(chip_smoke.py's bf16 limit: one bf16 rounding of the folded weights and
of each output).
"""

import numpy as np
import pytest
import torch
from torch_v5_weights import write_yolov5_pt

from simple_hrnet_tpu_torch.detectors import yolov5 as TY
from simple_hrnet_tpu_torch.models import poseresnet as TP
from simple_hrnet_tpu_torch.ops.cuda import build
from simple_hrnet_tpu_torch.ops.cuda import nms as TN
from simple_hrnet_tpu_torch.utils.device import host_to_device

SIZE = 320


@pytest.fixture(scope='module')
def pt(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return write_yolov5_pt(
        str(tmp_path_factory.mktemp('det') / 'yolov5n_seed0.pt'))


def _frames(n):
    return np.random.default_rng(3).integers(
        0, 256, (n, 240, 320, 3)).astype(np.uint8)


@pytest.mark.cuda
def test_yolov5_card_matches_cpu(pt):
    card = TY.YOLOv5(pt, img_size=SIZE, device='cuda')
    cpu = TY.YOLOv5(pt, img_size=SIZE, device='cpu')
    frames = _frames(3)
    cr, cv = (t.cpu().numpy() for t in card.detect_padded(frames))
    hr, hv = (t.numpy() for t in cpu.detect_padded(frames))
    np.testing.assert_array_equal(cv, hv)
    assert hv.sum() > 0
    np.testing.assert_allclose(cr[cv][:, :4], hr[hv][:, :4], atol=1e-2)
    np.testing.assert_allclose(cr[cv][:, 4:6], hr[hv][:, 4:6], atol=1e-5)


@pytest.mark.cuda
def test_yolov5_detect_padded_is_sync_free(pt):
    """A detect on frames already on the card queues its work with no host
    synchronization (the stream's dispatch rule) and launches K1 once a
    chunk of ``max_batch_size`` frames."""
    build.build_all()
    det = TY.YOLOv5(pt, img_size=SIZE, device='cuda', dtype='bfloat16',
                    max_batch_size=2)
    frames = host_to_device(_frames(4), det.device).flip(-1)
    det.detect_padded(frames)  # warm: cuDNN's choices, the cached constants
    torch.cuda.synchronize()
    TN.nms.launches = 0
    torch.cuda.set_sync_debug_mode('error')
    try:
        rows, valid = det.detect_padded(frames)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert TN.nms.launches == 2
    assert rows.shape == (4, 32, 7) and valid.shape == (4, 32)
    assert torch.isfinite(rows).all()


@pytest.mark.cuda
def test_poseresnet_bf16_deconvs_match_plain():
    """The folded bf16 transposed convs on the card against the unfolded
    f32 modules (ConvTranspose2d, BN, ReLU) on the same input."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    model = TP.init(50, 17, seed=0).cuda()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in model.deconv_layers:
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.rand(c, generator=g) * 0.4 - 0.2)
                m.running_mean.copy_(torch.rand(c, generator=g) - 0.5)
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    x = torch.randn((8, 2048, 8, 6), generator=g).cuda()
    with torch.no_grad():
        ref = model.deconv_layers(x)
        TP.prepare_inference(model, torch.bfloat16)
        assert not any(isinstance(m, torch.nn.BatchNorm2d)
                       for m in model.deconv_layers)
        out = model.deconv_layers(
            x.bfloat16().contiguous(memory_format=torch.channels_last))
    assert out.dtype == torch.bfloat16 and out.shape == (8, 256, 64, 48)
    err = (out.float() - ref).abs().max().item()
    assert err <= 2.0 ** -6 * ref.abs().max().item()
