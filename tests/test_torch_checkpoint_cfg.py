"""The port's ``.npz`` checkpoints, darknet ``.cfg`` parsing and YOLOv3
``class_path`` against the JAX package, on the CPU.

Tolerances: heatmaps and decoded detector predictions 2e-4 (f32, the
house tolerance); kept detector rows as ``test_torch_detector.py`` holds
them (the same slots, boxes within 1e-3 px, scores within 1e-5); trees
written by one package and read by the other bitwise.
"""

import numpy as np
import pytest

import jax
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.detectors import darknet as JD
from simple_hrnet_tpu.detectors import yolov3 as JY
from simple_hrnet_tpu.models import convert as JC
from simple_hrnet_tpu.models import hrnet as JH
from simple_hrnet_tpu.models import layers as JL
from simple_hrnet_tpu.utils import checkpoint as jckpt

from simple_hrnet_tpu_torch import SimpleHRNet
from simple_hrnet_tpu_torch.detectors import darknet as TD
from simple_hrnet_tpu_torch.detectors import yolov3 as TY
from simple_hrnet_tpu_torch.models import convert as TC
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.models import poseresnet as TP
from simple_hrnet_tpu_torch.utils import checkpoint as tckpt

# test_detector.py's toy cfg (mish and logistic activations, an absolute
# shortcut, a grouped route), with a relu conv, a size-3 stride-2 maxpool
# (padded by 1), a swish conv with an explicit padding= and a two-layer
# grouped route added
TOY_CFG = """
[net]
width=32
height=32

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=mish

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=logistic

[shortcut]
from=0
activation=linear

[route]
layers=-1
groups=2
group_id=1

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=relu

[maxpool]
size=3
stride=2

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
padding=1
activation=swish

[route]
layers=-1,-2
groups=2
group_id=0

[convolutional]
filters=6
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=0
anchors=10,14, 23,27, 37,58
classes=1
"""


def _randomize_bn(net, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.5, 0.5, generator=gen)
                m.running_mean.uniform_(-0.5, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return net


def test_jax_npz_hrnet_gives_jax_heatmaps(tmp_path):
    """A W4 HRNet tree (seeded weights, non-trivial BN) saved by the JAX
    package's ``ckpt.save``, loaded by the port: its heatmaps within 2e-4
    of the JAX forward, and the port's facade reads the same file."""
    params = JC.state_dict_to_tree(
        _randomize_bn(TH.init(4, 17, seed=5), 6).state_dict())
    path = str(tmp_path / 'w4.npz')
    jckpt.save(path, params)
    model = TC.load_into(TH.HRNet(4, 17), tckpt.load(path))
    model = TH.prepare_inference(model, torch.float32)
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(JH.apply)(JL.fold_batch_norm(params), x))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 17)
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=2e-4)
    facade = SimpleHRNet(4, 17, path, multiperson=False, resolution=(64, 64),
                         device='cpu')
    assert facade.predict(np.zeros((64, 64, 3), np.uint8)).shape == (1, 17, 3)


def test_jax_npz_yolov3_tiny_gives_jax_detections(tmp_path):
    """A YOLOv3-tiny tree saved by ``ckpt.save`` as the detector's
    ``weights_path``: the JAX detector's kept rows, slot for slot."""
    jdet0 = JY.YOLOv3('yolov3-tiny', phase_stem=False)
    path = str(tmp_path / 'tiny.npz')
    jckpt.save(path, JD.init(jax.random.PRNGKey(0), jdet0.blocks))
    jdet = JY.YOLOv3('yolov3-tiny', weights_path=path, phase_stem=False)
    tdet = TY.YOLOv3('yolov3-tiny', weights_path=path, device='cpu',
                     phase_stem=False)
    frames = np.random.default_rng(3).uniform(0, 255, (2, 120, 160, 3)) \
        .astype(np.uint8)
    jr, jv = (np.asarray(a) for a in jdet.detect_padded(frames))
    tr, tv = (a.numpy() for a in tdet.detect_padded(frames))
    np.testing.assert_array_equal(tv, jv)
    assert jv.sum() > 0
    np.testing.assert_allclose(tr[jv][:, :4], jr[jv][:, :4], atol=1e-3)
    np.testing.assert_allclose(tr[jv][:, 4:6], jr[jv][:, 4:6], atol=1e-5)
    np.testing.assert_array_equal(tr[jv][:, 6], jr[jv][:, 6])


@pytest.mark.parametrize('name', ['hrnet_w4', 'poseresnet18', 'yolov3_tiny'])
def test_port_npz_read_by_jax(tmp_path, name):
    """The port's ``save`` read back by the JAX package's ``ckpt.load``
    equals the JAX conversion of the same state_dict leaf for leaf
    (PoseResNet's flipped deconvs and the darknet BN nodes included), and
    the port's ``load`` gives the state_dict back."""
    net = {'hrnet_w4': lambda: TH.init(4, 17, seed=1),
           'poseresnet18': lambda: TP.PoseResNet(18, 17),
           'yolov3_tiny': lambda: TD.init(TD.yolov3_tiny_blocks(), seed=2)
           }[name]()
    _randomize_bn(net, 3)
    path = str(tmp_path / f'{name}.npz')
    tckpt.save(path, net)
    got = jax.tree_util.tree_map(np.asarray, jckpt.load(path))
    want = jax.tree_util.tree_map(np.asarray,
                                  JC.state_dict_to_tree(net.state_dict()))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    back = tckpt.load(path)
    for k, v in net.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match='empty dict'):
        tckpt._flatten({'a': {}})
    with pytest.raises(TypeError, match='nested dicts'):
        tckpt._flatten({'a': [np.zeros(2)]})


def test_cfg_forward_matches_jax(tmp_path):
    """The toy cfg parses to the JAX package's blocks, and the port's
    ``Darknet`` on the JAX ``init`` weights, carried across, gives the
    JAX ``apply``'s predictions within 2e-4; the strided size-3 maxpool
    is padded."""
    cfg = tmp_path / 'toy.cfg'
    cfg.write_text(TOY_CFG)
    blocks = TD.parse_cfg(str(cfg))
    assert blocks == JD.parse_cfg(str(cfg))
    assert TD.output_channels(blocks) == JD.output_channels(blocks)
    assert TD.output_channels(blocks)[7] == 8  # (8 + 8) / 2 groups
    params = JD.init(jax.random.PRNGKey(1), blocks)
    net = TC.load_into(TD.Darknet(blocks),
                       TC.from_jax_params(params)).eval()
    _randomize_bn(net, 4)
    params = JC.state_dict_to_tree(net.state_dict())
    x = np.random.default_rng(2).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    ref = np.asarray(JD.apply(params, blocks, x, img_size=32))
    with torch.no_grad():
        out = net(torch.from_numpy(x), 32).numpy()
    assert out.shape == ref.shape == (2, 16 * 16, 6)  # 32 -> 16 by the pool
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=2e-4)
    folded = TD.fold_weights(net)  # fold keeps the function
    with torch.no_grad():
        np.testing.assert_allclose(folded(torch.from_numpy(x), 32).numpy(),
                                   ref, atol=2e-4, rtol=2e-4)


def test_unknown_activation_raises_at_parse_time(tmp_path):
    bad = tmp_path / 'bad.cfg'
    bad.write_text('[convolutional]\nfilters=4\nsize=3\nstride=1\npad=1\n'
                   'activation=hardswish\n')
    for parse in (TD.parse_cfg, JD.parse_cfg):
        with pytest.raises(ValueError, match='hardswish'):
            parse(str(bad))


def test_cfg_detector_int8_and_missing_cfg(tmp_path):
    """YOLOv3 builds from an existing ``.cfg`` (its int8 policy and fold
    working on the parsed graph), falls back to the built-in blocks for a
    missing one as the JAX detector does, and accepts ``class_path``."""
    cfg = tmp_path / 'toy.cfg'
    cfg.write_text(TOY_CFG.replace('filters=8', 'filters=16'))
    det = TY.YOLOv3(str(cfg), class_path='coco.names', img_size=32,
                    device='cpu', dtype='int8', quantize_int8=True)
    assert det.blocks == JD.parse_cfg(str(cfg)) and det.quantized
    q = [n for n, m in det.net.named_modules()
         if getattr(m, 'qconv', None) is not None]
    assert q == ['conv_1', 'conv_6']  # the policy's 3x3 16 -> 16 convs
    rows, valid = det.detect_padded(np.zeros((1, 40, 30, 3), np.uint8))
    assert rows.shape == (1, 32, 7) and torch.isfinite(rows).all()
    for model_def, blocks in (('my.cfg', JD.yolov3_blocks()),
                              ('my-tiny.cfg', JD.yolov3_tiny_blocks())):
        assert JY.YOLOv3(model_def, phase_stem=False).blocks == blocks
        assert TY.YOLOv3(model_def, device='cpu').blocks == blocks


def test_facade_takes_cfg_and_class_path(tmp_path):
    """The facade's ``yolo_model_def`` (a ``.cfg``) and
    ``yolo_class_path``, which raised before they were ported."""
    cfg = tmp_path / 'toy.cfg'
    cfg.write_text(TOY_CFG)
    path = str(tmp_path / 'w8.pth')
    torch.save(TH.init(8, 17).state_dict(), path)
    model = SimpleHRNet(8, 17, path, resolution=(64, 64), device='cpu',
                        yolo_model_def=str(cfg),
                        yolo_class_path='coco.names')
    assert model.detector.blocks == JD.parse_cfg(str(cfg))
    out = model.predict(np.zeros((2, 40, 30, 3), np.uint8))
    assert len(out) == 2
