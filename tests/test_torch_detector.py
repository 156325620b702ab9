"""The port's YOLOv3 detector against the JAX package's, on the CPU.

YOLOv3-tiny with the JAX package's seeded random weights, carried across
by ``convert.from_jax_params``. The JAX detector is built with
``phase_stem=False``: the space-to-depth stem is a TPU layout device the
port does not have. f32 throughout.
"""

import numpy as np
import pytest

import jax
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.detectors import darknet as JD
from simple_hrnet_tpu.detectors import yolov3 as JY

from simple_hrnet_tpu_torch.detectors import darknet as TD
from simple_hrnet_tpu_torch.detectors import yolov3 as TY
from simple_hrnet_tpu_torch.models import convert as TC
from simple_hrnet_tpu_torch.models import quantize as TQ


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    jdet = JY.YOLOv3('yolov3-tiny', phase_stem=False)
    tree = JD.init(jax.random.PRNGKey(0), jdet.blocks)
    path = str(tmp_path_factory.mktemp('det') / 'tiny.pth')
    torch.save(TC.from_jax_params(tree), path)
    tdet = TY.YOLOv3('yolov3-tiny', weights_path=path, device='cpu')
    return jdet, tdet, path


def test_block_lists_match_jax():
    assert TD.yolov3_blocks() == JD.yolov3_blocks()
    assert TD.yolov3_tiny_blocks() == JD.yolov3_tiny_blocks()
    for blocks in (JD.yolov3_blocks(), JD.yolov3_tiny_blocks()):
        assert TD.output_channels(blocks) == JD.output_channels(blocks)


def test_darknet_forward_matches_jax(tiny):
    """Decoded predictions (N, anchors, 85) in the darknet flatten order."""
    jdet, tdet, _ = tiny
    x = np.random.default_rng(1).uniform(0, 1, (2, 416, 416, 3)).astype(
        np.float32)
    ref = np.asarray(JD.apply(jdet.params, jdet.blocks, x, 416))
    with torch.no_grad():
        out = tdet.net(torch.from_numpy(x), 416).numpy()
    assert out.shape == ref.shape == (2, 2535, 85)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=2e-4)


def test_letterbox_matches_jax():
    frames = np.random.default_rng(2).uniform(0, 255, (2, 120, 160, 3)) \
        .astype(np.uint8)
    ref = np.asarray(JY.letterbox_device(frames, 416, 120, 160))
    out = TY.letterbox_device(torch.from_numpy(frames), 416).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_detect_padded_matches_jax(tiny):
    """Same kept boxes, slot for slot; rows within 1e-3 px / 1e-5 score."""
    jdet, tdet, _ = tiny
    frames = np.random.default_rng(3).uniform(0, 255, (2, 120, 160, 3)) \
        .astype(np.uint8)
    jr, jv = (np.asarray(a) for a in jdet.detect_padded(frames))
    tr, tv = (a.numpy() for a in tdet.detect_padded(frames))
    assert tv.dtype == bool and tr.shape == jr.shape == (2, 32, 7)
    np.testing.assert_array_equal(tv, jv)
    assert jv.sum() > 0
    np.testing.assert_allclose(tr[jv][:, :4], jr[jv][:, :4], atol=1e-3)
    np.testing.assert_allclose(tr[jv][:, 4:6], jr[jv][:, 4:6], atol=1e-5)
    np.testing.assert_array_equal(tr[jv][:, 6], jr[jv][:, 6])
    # the reference-compatible API: BGR frames -> per-image arrays
    out = tdet.predict(frames[..., ::-1])
    assert [0 if o is None else len(o) for o in out] == list(jv.sum(1))


def test_darknet_weights_roundtrip_with_jax_loader(tmp_path):
    """A .weights file the port writes is read identically by the port's
    and the JAX package's loaders (original darknet layout)."""
    blocks = TD.yolov3_tiny_blocks()
    net = TD.init(blocks, seed=4)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():  # non-trivial BN statistics
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    path = str(tmp_path / 'tiny.weights')
    TD.save_darknet_weights(net, path)
    back = TD.load_darknet_weights(path, blocks)
    for k, v in net.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            torch.testing.assert_close(back.state_dict()[k], v, rtol=0,
                                       atol=0)
    jtree = TC.from_jax_params(JD.load_darknet_weights(path, blocks))
    for k, v in jtree.items():
        torch.testing.assert_close(back.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError):
        TD.load_darknet_weights(path, TD.yolov3_blocks())


def test_unported_detector_options_raise():
    """A ``.cfg`` name that is no file falls back to the built-in blocks,
    as in the JAX package (``.cfg`` files are parsed now); an unknown
    dtype raises."""
    assert TY.YOLOv3('custom-tiny.cfg', device='cpu').blocks == \
        JD.yolov3_tiny_blocks()
    with pytest.raises(ValueError, match='Unsupported dtype'):
        TY.YOLOv3('yolov3-tiny', device='cpu', dtype='float16')


def test_int8_tiny_detector_matches_jax_quantized_set(tiny):
    """Under dtype='int8' with quantize_int8=True the port quantizes the
    same darknet convs as the JAX YOLOv3 without its phase stem, with the
    same activation scales to 1e-5 (both calibrate the same weights on
    the same smooth frame; f32 sums differ in order)."""
    jq = JY.YOLOv3('yolov3-tiny', phase_stem=False, dtype='int8',
                   quantize_int8=True)
    ref = {k: float(v['ascale']) for k, v in jq.params.items()
           if 'kernel_q' in v}
    assert sorted(ref) == ['conv_2', 'conv_4', 'conv_6']
    det = TY.YOLOv3('yolov3-tiny', weights_path=tiny[2],
                    device='cpu', dtype='int8', quantize_int8=True)
    got = {n: m.qconv.ascale.item() for n, m in det.net.named_modules()
           if getattr(m, 'qconv', None) is not None}
    assert sorted(got) == sorted(ref)
    for k, a in ref.items():
        assert abs(got[k] - a) <= 1e-5 * a, k


def test_int8_yolov3_matches_jax_default_quantized_set(tmp_path):
    """YOLOv3 under dtype='int8' with both packages' defaults: the JAX
    facade turns its phase stem on at an even size, which rewrites
    ``conv_1`` (3, 3, 32, 64) out of the quantize policy, so the port
    leaves ``conv_1`` in bf16 too (it would pass the policy) and
    quantizes the same set with the same activation scales to 1e-5. The
    set does not depend on the size: 64 keeps the test short."""
    jq = JY.YOLOv3('yolov3', dtype='int8', img_size=64)
    assert jq.phase_stem
    ref = {k: float(v['ascale']) for k, v in jq.params.items()
           if 'kernel_q' in v}
    path = str(tmp_path / 'yolov3.pth')
    torch.save(TC.from_jax_params(JD.init(jax.random.PRNGKey(0),
                                          JD.yolov3_blocks())), path)
    det = TY.YOLOv3('yolov3', weights_path=path, device='cpu',
                    dtype='int8', img_size=64)
    got = {n: m.qconv.ascale.item() for n, m in det.net.named_modules()
           if getattr(m, 'qconv', None) is not None}
    assert 'conv_1' not in got and TQ.default_policy(
        TQ.conv_shape(det.net.conv_1))
    assert sorted(got) == sorted(ref) == ['conv_10', 'conv_3', 'conv_5',
                                          'conv_7']
    for k, a in ref.items():
        assert abs(got[k] - a) <= 1e-5 * a, k
