"""The port's int8 facade against the JAX facade, on the CPU.

``SimpleHRNet(16, 17, ..., dtype='int8')`` (c=16: the int8 policy skips
C < 16) against ``JaxSimpleHRNet(..., dtype='int8',
use_fused_kernels=False)``, the same precision mix (every policy-accepted
conv int8, bf16 elsewhere, f32 head) with per-conv bf16 handoffs. Both
calibrate themselves on the same synthetic frames. Detections come from a
fixed-box stub, so the comparison is the pose path's.

Tolerance, from one activation quantum: at c = 16 the port's chains take
the JAX XLA int8 chain's cast points (both handoffs rounded to bf16, as
the JAX plain graph rounds every conv output), but they add each block's
residual to conv2's f32 output where the plain graph adds it to a bf16
one, the two calibrations differ in the last f32 bits, and bf16 convs
round at other places — each moves an int8 input by at most a bin or so.
One bin at the input of the last stage module is ``q`` = its largest
activation scale; through the 1x1 head it moves a heatmap by at most ``q``
times the largest row L1 norm of the head's weights. The heatmaps must
agree within 4 such quanta at every pixel and within 1 on average.
Keypoints are not compared: random-weight heatmaps are near flat, so their
argmax moves with any perturbation (tests/test_quantize.py).
"""

import numpy as np
import pytest

import jax
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu import SimpleHRNet as JaxSimpleHRNet

from simple_hrnet_tpu_torch import SimpleHRNet
from simple_hrnet_tpu_torch.detectors import yolov3 as TY
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.models.layers import QConv2d

from test_torch_api import RES, _JaxStub

KW = dict(resolution=RES, yolo_model_def='yolov3-tiny',
          return_heatmaps=True, return_bounding_boxes=True)


@pytest.fixture(scope='module')
def w16_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('ckpt') / 'pose_hrnet_w16.pth')
    torch.save(TH.init(16, 17, seed=0).state_dict(), path)
    return path


def test_int8_facade_matches_jax_int8(w16_path):
    port = SimpleHRNet(16, 17, w16_path, device='cpu', dtype='int8', **KW)
    ref = JaxSimpleHRNet(16, 17, w16_path, dtype='int8',
                         use_fused_kernels=False, **KW)
    assert all(m.chain_int8 is not None for m in port.model.stage_modules())
    boxes = [np.array([[5, 5, 50, 80], [20, 10, 70, 95], [90, 40, 170, 130]],
                      np.float32)]
    frames = np.random.default_rng(4).integers(
        0, 256, (1, 120, 160, 3)).astype(np.uint8)
    port.detector = _JaxStub(boxes, torch_out=True)
    ref.detector = _JaxStub(boxes, torch_out=False)
    hm, bx, pts = port.predict(frames)
    with jax.enable_x64(True):  # exact PIL crops, as the port's
        rhm, rbx, rpts = ref.predict(frames)
    np.testing.assert_array_equal(bx[0], rbx[0])
    assert hm[0].shape == rhm[0].shape == (3, 17, 32, 24)
    assert pts[0].shape == rpts[0].shape == (3, 17, 3)
    q = port.model.stage4[2].chain_int8['ascales'].max().item()
    gain = port.model.final_layer.weight.abs().sum(dim=1).max().item()
    diff = np.abs(hm[0] - rhm[0])
    assert diff.max() <= 4 * q * gain
    assert diff.mean() <= q * gain


def test_int8_facade_options(w16_path):
    """calibration_images calibrate instead of the synthetic frames;
    int8_exclude keeps a stage in bf16 (its chains on the bf16 kernel)."""
    frames = np.random.default_rng(8).integers(
        0, 256, (2, 90, 70, 3)).astype(np.uint8)
    base = SimpleHRNet(16, 17, w16_path, device='cpu', dtype='int8', **KW)
    port = SimpleHRNet(16, 17, w16_path, device='cpu', dtype='int8',
                       calibration_images=list(frames),
                       int8_exclude=('stage4',), **KW)
    s3 = port.model.stage3[0].chain_int8['ascales']
    assert not torch.equal(s3, base.model.stage3[0].chain_int8['ascales'])
    for m in port.model.stage4:
        assert m.chain_int8 is None and m.chain is not None
        assert not any(isinstance(q, QConv2d) for q in m.modules())
    assert isinstance(port.model.stage3[0].branches[1][0].conv1, QConv2d)
    out = port.predict(frames[0])
    assert out[2].shape[1:] == (17, 3)


def test_yolov3_int8_policy():
    """YOLOv3-tiny (13 convs) resolves int8 to bf16 unless quantize_int8
    says otherwise (detectors/yolov3.py:212-231 of the JAX package)."""
    tiny = TY.YOLOv3('yolov3-tiny', device='cpu', dtype='int8')
    assert tiny.dtype == torch.bfloat16 and not tiny.quantized
    forced = TY.YOLOv3('yolov3-tiny', device='cpu', dtype='int8',
                       quantize_int8=True)
    q = [n for n, m in forced.net.named_modules()
         if getattr(m, 'qconv', None) is not None]
    assert forced.quantized and forced.dtype == torch.bfloat16
    # policy: the 3x3 convs with 16 <= C_in, C_out <= 128
    assert q == ['conv_2', 'conv_4', 'conv_6']
    frames = np.random.default_rng(9).integers(
        0, 256, (1, 120, 160, 3)).astype(np.uint8)
    rows, valid = forced.detect_padded(frames)
    assert rows.shape == (1, 32, 7) and torch.isfinite(rows).all()
    with pytest.raises(ValueError, match='quantize_int8'):
        TY.YOLOv3('yolov3-tiny', device='cpu', quantize_int8=True)
