"""The port's PoseResNet against the JAX package's, on the CPU.

Weights are carried across with ``convert.from_jax_params`` from a JAX
tree whose BN statistics are randomized, so every mapping (the flipped
transposed-conv kernels included) matters; inputs come from a numpy seed.
Tolerances: f32 forwards 2e-4 (the house tolerance); the folded
transposed-conv weights and the int8 operands bit for bit (the same f32
products, the same quantizer); the f32-compute int8 network 2e-4 (its
int8 convs are exact on the same operands); the int8 facade, bf16 between
its int8 convs, within 4 bf16 quanta of the heatmaps' largest value at
every pixel and 1 on average (the two packages' bf16 convs round the same
sums in another order: the bf16 facades differ by as much).
"""

import functools

import numpy as np
import pytest

import jax
import torch
import torch.nn as nn
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu import SimpleHRNet as JaxSimpleHRNet
from simple_hrnet_tpu.models import convert as JC
from simple_hrnet_tpu.models import layers as JL
from simple_hrnet_tpu.models import poseresnet as JP
from simple_hrnet_tpu.models import quantize as JQ

from simple_hrnet_tpu_torch import SimpleHRNet
from simple_hrnet_tpu_torch.models import convert as TC
from simple_hrnet_tpu_torch.models import layers as TL
from simple_hrnet_tpu_torch.models import poseresnet as TP
from simple_hrnet_tpu_torch.models import quantize as TQ
from simple_hrnet_tpu_torch.models.layers import QConv2d

from test_torch_api import _JaxStub, _assert_same_people
from test_torch_models import _randomize_bn

TOL = 2e-4
RES = (64, 64)
# ResNet-50's convs that the int8 policy takes: the 3x3 convs of layer1
# (64 channels) and layer2 (128 channels)
INT8_CONVS = [f'layer1.{b}.conv2' for b in range(3)] + \
    [f'layer2.{b}.conv2' for b in range(4)]


@functools.lru_cache(maxsize=None)
def _tree(size):
    rng = np.random.default_rng(size)
    return _randomize_bn(JP.init(jax.random.PRNGKey(size), size, 17), rng)


def _x(n=2):
    return np.random.default_rng(1).standard_normal(
        (n, *RES, 3)).astype(np.float32)


def _port(size):
    return TC.load_into(TP.PoseResNet(size, 17),
                        TC.from_jax_params(_tree(size))).eval()


@pytest.mark.parametrize('size', [18, 50])
def test_poseresnet_matches_jax(size):
    """Folded forward (prepare_inference) against poseresnet.apply on the
    JAX package's folded tree."""
    x = _x()
    ref = np.asarray(jax.jit(functools.partial(JP.apply, resnet_size=size))(
        JL.fold_batch_norm(_tree(size)), x))
    model = TP.prepare_inference(_port(size))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 17)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def _within_one_bf16_ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per element: |a - b| <= one bf16 ulp of max(|a|, |b|), the ulp taken
    from the binade's exponent (2 ** (e - 8) for m = f * 2 ** e, f in
    [0.5, 1): bf16 keeps 8 significant bits)."""
    m = np.maximum(np.abs(a), np.abs(b)).astype(np.float64)
    _, e = np.frexp(m)
    ulp = np.ldexp(1.0, e - 8)
    return np.abs(a.astype(np.float64) - b.astype(np.float64)) <= ulp


def test_fold_matches_unfolded_and_jax():
    """BN folding, the transposed convs' included: the folded network
    equals the unfolded one, and each folded transposed-conv weight and
    bias is the JAX package's folded kernel and bias (BN scale on the
    output channels: dim 1 of a ConvTranspose2d weight) within one f32
    ulp (XLA's f32 division may round the BN scale the other way, as in
    the HRNet fold test), their bf16 casts within one bf16 ulp."""
    x = torch.from_numpy(_x())
    model = _port(18)
    with torch.no_grad():
        unfolded = model(x)
        TL.fold_batch_norm(model)
        folded = model(x)
    np.testing.assert_allclose(folded.numpy(), unfolded.numpy(), atol=TOL,
                               rtol=TOL)
    assert not any(isinstance(m, nn.BatchNorm2d) for m in model.modules())
    jfold = JL.fold_batch_norm(_tree(18))['deconv_layers']
    for i in (0, 3, 6):
        deconv = model.deconv_layers[i]
        k = np.asarray(jfold[str(i)]['kernel'])
        want = torch.from_numpy(np.ascontiguousarray(
            np.transpose(k[::-1, ::-1], (2, 3, 0, 1))))
        assert deconv.weight.shape == want.shape
        np.testing.assert_allclose(deconv.weight.numpy(), want.numpy(),
                                   rtol=1e-6, atol=0)
        got16 = deconv.weight.bfloat16().float().numpy()
        want16 = want.bfloat16().float().numpy()
        assert _within_one_bf16_ulp(got16, want16).all()
        # control: a BN scale off by 1% moves the casts by more than that
        off16 = (want * 1.01).bfloat16().float().numpy()
        assert not _within_one_bf16_ulp(got16, off16).all()
        np.testing.assert_allclose(deconv.bias.numpy(),
                                   np.asarray(jfold[str(i)]['bias']),
                                   rtol=1e-6, atol=1e-7)


def test_deconv_conversion_both_directions():
    """JAX tree -> torch state_dict -> JAX tree is the identity (the JAX
    package's state_dict_to_tree reads the port's names and layouts), the
    port's transposed-conv weights are the JAX package's own export, and
    one asymmetric transposed conv computes what ``layers.deconv2d`` does."""
    tree = _tree(50)
    sd = TC.from_jax_params(tree)
    back = JC.state_dict_to_tree({k: v.numpy() for k, v in sd.items()})
    ref_leaves = jax.tree_util.tree_leaves_with_path(tree)
    back_leaves = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in ref_leaves] == [p for p, _ in back_leaves]
    for (_, a), (_, b) in zip(ref_leaves, back_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    export = JC.tree_to_state_dict(tree)
    for i in (0, 3, 6):
        key = f'deconv_layers.{i}.weight'
        assert sd[key].shape == (2048 if i == 0 else 256, 256, 4, 4)
        np.testing.assert_array_equal(sd[key].numpy(), export[key])
    rng = np.random.default_rng(3)
    k = rng.standard_normal((4, 4, 8, 6)).astype(np.float32)
    x = rng.standard_normal((2, 5, 7, 8)).astype(np.float32)
    ref = np.asarray(JL.deconv2d(x, {'kernel': k}))
    deconv = nn.ConvTranspose2d(8, 6, 4, stride=2, padding=1, bias=False)
    TC.load_into(deconv, {'weight': TC.from_jax_params(
        {'deconv_layers': {'0': {'kernel': k}}})['deconv_layers.0.weight']})
    with torch.no_grad():
        out = deconv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               atol=TOL, rtol=TOL)


def test_blocks_stride_and_downsample():
    """The ResNet blocks' strides and downsample branches: layer2-4 start
    at stride 2 with a downsample; the basic blocks' conv2 maps planes to
    planes (the JAX package's correction of the reference)."""
    r18, r50 = TP.PoseResNet(18), TP.PoseResNet(50)
    for model, ds in ((r18, ['layer2.0', 'layer3.0', 'layer4.0']),
                      (r50, ['layer1.0', 'layer2.0', 'layer3.0',
                             'layer4.0'])):
        got = [n for n, m in model.named_modules()
               if isinstance(m, (TL.BasicBlock, TL.Bottleneck))
               and m.downsample is not None]
        assert got == ds
    assert r18.layer2[0].conv1.stride == (2, 2)
    assert r18.layer2[1].conv2.weight.shape == (128, 128, 3, 3)
    assert r50.layer3[0].conv2.stride == (2, 2)
    assert r50.layer3[0].downsample[0].stride == (2, 2)
    assert r50.layer1[0].conv2.stride == (1, 1)
    with torch.no_grad():
        assert r50.layer4(r50.layer3(r50.layer2(r50.layer1(
            torch.zeros((1, 64, 16, 12)))))).shape == (1, 2048, 2, 2)


def test_int8_matches_jax():
    """Calibration, quantization and the quantized network against the JAX
    package's, on ResNet-50: the same amax map over every conv (no
    transposed conv: neither package calibrates one), the same quantized
    set, the same int8 operands bit for bit from the same map, and the
    same heatmaps with f32 between the int8 convs."""
    tree = JL.fold_batch_norm(_tree(50))
    apply = functools.partial(JP.apply, resnet_size=50)
    cal = (TQ.smooth_frames(RES, n=2, lo=0.0, hi=255.0) / 64.0 - 2.0
           ).astype(np.float32)
    jamax = JQ.calibrate_cpu(apply, tree, [cal])
    jq = JQ.quantize_folded(tree, jamax)
    # the folded network, with the JAX package's folded weights (its f32
    # division may round a BN scale one ulp the other way)
    model = TC.load_into(TL.fold_batch_norm(_port(50)),
                         TC.from_jax_params(tree))
    amax = TQ.calibrate(model, [torch.from_numpy(cal)])
    carried = TC.amax_from_jax(tree, jamax)
    assert set(amax) == set(carried) == {
        n for n, m in model.named_modules() if isinstance(m, nn.Conv2d)}
    for p, a in amax.items():
        assert abs(a - carried[p]) <= 1e-5 * carried[p]
    TP.prepare_inference(model, torch.float32, amax=carried)
    q = {n: m for n, m in model.named_modules() if isinstance(m, QConv2d)}
    assert list(q) == INT8_CONVS
    for path, m in q.items():
        node = jq
        for part in path.split('.'):
            node = node[part]
        kq = np.asarray(node['kernel_q'])  # HWIO -> (Co, (ky, kx, ci))
        np.testing.assert_array_equal(
            m.wq.numpy(), np.transpose(kq, (3, 0, 1, 2)).reshape(
                kq.shape[3], -1))
        np.testing.assert_array_equal(m.wscale.numpy(),
                                      np.asarray(node['wscale']))
        assert m.ascale.item() == np.float32(node['ascale'])
    x = _x()
    ref = np.asarray(apply(jq, x))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.fixture(scope='module')
def pth(tmp_path_factory):
    """ResNet-50 with randomized BN statistics as an official-layout
    .pth."""
    path = str(tmp_path_factory.mktemp('ckpt') / 'pose_resnet_50.pth')
    torch.save(TC.from_jax_params(_tree(50)), path)
    return path


KW = dict(model_name='PoseResNet', resolution=RES,
          yolo_model_def='yolov3-tiny', return_heatmaps=True,
          return_bounding_boxes=True)
BOXES = [np.array([[5, 5, 50, 80], [20, 10, 70, 95], [90, 40, 170, 130]],
                  np.float32), np.zeros((0, 4), np.float32)]


def _predict_both(port, ref):
    frames = np.random.default_rng(4).integers(
        0, 256, (2, 120, 160, 3)).astype(np.uint8)
    port.detector = _JaxStub(BOXES, torch_out=True)
    ref.detector = _JaxStub(BOXES, torch_out=False)
    out = port.predict(frames)
    with jax.enable_x64(True):  # exact PIL crops, as the port's
        expect = ref.predict(frames)
    assert [len(p) for p in out[2]] == [3, 0]
    return out, expect


def test_facade_matches_jax(pth):
    """SimpleHRNet(50, 17, pth, model_name='PoseResNet') against the JAX
    facade's multi-person predict, on the same people."""
    out, expect = _predict_both(SimpleHRNet(50, 17, pth, device='cpu', **KW),
                                JaxSimpleHRNet(50, 17, pth, **KW))
    assert np.abs(out[0][0]).max() > 0.05  # heatmaps far from zero
    for i in range(2):
        _assert_same_people([o[i] for o in out], [e[i] for e in expect])


def test_int8_facade_matches_jax(pth):
    """dtype='int8': the policy's convs in int8, bf16 elsewhere, the head
    f32, against the JAX facade's int8 PoseResNet."""
    port = SimpleHRNet(50, 17, pth, device='cpu', dtype='int8', **KW)
    ref = JaxSimpleHRNet(50, 17, pth, dtype='int8', **KW)
    assert [n for n, m in port.model.named_modules()
            if isinstance(m, QConv2d)] == INT8_CONVS
    assert port.model.deconv_layers[0].weight.dtype == torch.bfloat16
    (hm, bx, _), (rhm, rbx, _) = _predict_both(port, ref)
    np.testing.assert_array_equal(bx[0], rbx[0])
    assert hm[0].shape == rhm[0].shape == (3, 17, 16, 16)
    top = np.abs(rhm[0]).max()
    quantum = 2.0 ** (np.floor(np.log2(top)) - 7)  # bf16 spacing at the top
    diff = np.abs(hm[0] - rhm[0])
    assert diff.max() <= 4 * quantum
    assert diff.mean() <= quantum


@pytest.mark.parametrize('name', ['poseresnet', 'ResNet', 'resnet'])
def test_model_name_aliases(tmp_path, name):
    """The JAX facade's other names for PoseResNet; c is the ResNet
    size."""
    path = str(tmp_path / 'pose_resnet_18.pth')
    torch.save(TP.init(18, 17).state_dict(), path)
    port = SimpleHRNet(18, 17, path, model_name=name, resolution=RES,
                       yolo_model_def='yolov3-tiny', device='cpu')
    assert isinstance(port.model, TP.PoseResNet)
    assert port.model.resnet_size == 18
