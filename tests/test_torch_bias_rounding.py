"""The port's biased bf16 convs and the detectors' activations round as the
JAX package's do, on the CPU.

The JAX package's ``layers.conv2d`` and ``deconv2d`` round the conv's
output to bf16 and then add the bf16 bias (two roundings); a bf16
``nn.Conv2d`` with a bias on the CPU (oneDNN) rounds ``sum + bias`` once.
Every biased conv of the port adds its bias through
``models.layers.add_bias``: a folded ``BasicBlock`` conv, the 1x1 head, a
PoseResNet transposed conv, a darknet conv (also with its leaky
activation, whose bf16 slope follows ``jax.nn.leaky_relu``'s) and a YOLOv5
conv are each held against the JAX function on the same numpy inputs,
with drawn BatchNorm
statistics so that every folded bias is non-zero: within one bf16 step
everywhere, and unequal in under 0.1% of the elements (the f32 sums'
order differs). The darknet conv also runs through logistic, mish and
swish, and the YOLOv5 conv through its SiLU: XLA rounds each op of those
chains to bf16, and so does the port (``ops/activation.py``; kernel K4 on
the card). On their own, over 2^20 elements, the port's bf16 sigmoid,
SiLU and mish equal ``jax.nn``'s bit for bit, where ``F.silu`` (one
rounding) differs in a third of them. Also: ``distributed.initialize``
takes the card by default and raises without one.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.detectors import yolov5 as J5
from simple_hrnet_tpu.models import layers as JL

from simple_hrnet_tpu_torch.detectors import darknet as TD
from simple_hrnet_tpu_torch.detectors import yolov5 as T5
from simple_hrnet_tpu_torch.models import layers as L
from simple_hrnet_tpu_torch.ops.cuda import activation as A
from simple_hrnet_tpu_torch.parallel import distributed as D

# the share of elements that may differ by one bf16 step: the f32 sums'
# order differs between oneDNN and XLA, so a few roundings land apart
MAX_DIFFERING = 1e-3

# the JAX package's darknet activations (simple_hrnet_tpu/detectors/
# darknet.py, ``apply``'s convolutional branch)
JAX_DARKNET_ACT = {
    'linear': lambda y: y,
    'leaky': lambda y: jax.nn.leaky_relu(y, 0.1),
    'logistic': jax.nn.sigmoid,
    'mish': lambda y: y * jnp.tanh(jax.nn.softplus(y)),
    'swish': lambda y: y * jax.nn.sigmoid(y),
}


def draw_bn(bn: nn.BatchNorm2d, rng) -> None:
    """BN statistics that fold to a non-zero bias of the conv output's
    order."""
    c = bn.num_features
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
        bn.bias.copy_(torch.from_numpy(rng.uniform(-0.5, 0.5, c)))
        bn.running_mean.copy_(torch.from_numpy(rng.uniform(-0.5, 0.5, c)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))


def draw_conv(conv: nn.Module, rng) -> None:
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.uniform(
            -0.1, 0.1, tuple(conv.weight.shape))))
        if conv.bias is not None:
            conv.bias.copy_(torch.from_numpy(rng.uniform(
                -0.5, 0.5, tuple(conv.bias.shape))))


def port_bf16(conv: nn.Module, x: np.ndarray, fn=None) -> np.ndarray:
    """``fn(conv, x)`` (default ``conv(x)``) in bf16 on NHWC ``x``, the
    output NHWC f32."""
    conv.to(torch.bfloat16)
    t = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    with torch.no_grad():
        out = (fn or (lambda m, v: m(v)))(conv, t)
    return out.float().permute(0, 2, 3, 1).numpy()


def jax_params(weight: torch.Tensor, bias: torch.Tensor,
               transposed: bool = False) -> dict:
    """The JAX package's conv node of a folded f32 port conv: HWIO kernel
    (a transposed conv's spatially flipped, I = C_in, as its converter
    stores it) and bias."""
    w = weight.detach().float().numpy()
    kernel = (np.flip(w, (2, 3)).transpose(2, 3, 0, 1) if transposed
              else w.transpose(2, 3, 1, 0))
    return {'kernel': jnp.asarray(np.ascontiguousarray(kernel)),
            'bias': jnp.asarray(bias.detach().float().numpy())}


def assert_rounds_as_jax(got: np.ndarray, want) -> None:
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    mag = np.maximum(np.abs(got), np.abs(want))
    step = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    diff = np.abs(got - want)
    differing = float(np.mean(diff > 0))
    print(f'{differing:.3e} of {got.size} elements differ, largest '
          f'{float((diff / step).max()):.2f} bf16 steps')
    assert (diff <= step).all()
    assert differing < MAX_DIFFERING


def frame(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize('conv', ['conv1', 'downsample'])
def test_folded_basic_block_conv(conv):
    """A ``BasicBlock``'s folded 3x3 stride-2 conv and its 1x1 stride-2
    downsample against ``layers.conv2d`` in bf16."""
    rng = np.random.default_rng(0)
    blk = L.BasicBlock(32, 32, stride=2, downsample=True)
    for m in blk.modules():
        if isinstance(m, nn.Conv2d):
            draw_conv(m, rng)
        elif isinstance(m, nn.BatchNorm2d):
            draw_bn(m, rng)
    L.fold_batch_norm(blk.eval())
    m = blk.conv1 if conv == 'conv1' else blk.downsample[0]
    assert m.bias is not None and float(m.bias.abs().min()) > 0
    p = jax_params(m.weight, m.bias)
    x = frame((2, 16, 16, 32), 1)
    want = JL.conv2d(jnp.asarray(x), p, stride=2,
                     padding=1 if conv == 'conv1' else 0,
                     dtype=jnp.bfloat16)
    assert_rounds_as_jax(port_bf16(m, x), want)


def test_head_conv():
    """The 1x1 head with its drawn bias."""
    rng = np.random.default_rng(2)
    head = L.Conv2d(32, 17, 1)
    draw_conv(head, rng)
    p = jax_params(head.weight, head.bias)
    x = frame((2, 16, 12, 32), 3)
    want = JL.conv2d(jnp.asarray(x), p, dtype=jnp.bfloat16)
    assert_rounds_as_jax(port_bf16(head, x), want)


def test_poseresnet_deconv():
    """A PoseResNet transposed conv (4x4, stride 2, padding 1) with its BN
    folded, against ``layers.deconv2d``."""
    rng = np.random.default_rng(4)
    seq = nn.Sequential(L.ConvTranspose2d(32, 32, 4, stride=2, padding=1,
                                          bias=False), L.bn(32))
    draw_conv(seq[0], rng)
    draw_bn(seq[1], rng)
    L.fold_batch_norm(seq.eval())
    m = seq[0]
    p = jax_params(m.weight, m.bias, transposed=True)
    x = frame((2, 8, 6, 32), 5)
    want = JL.deconv2d(jnp.asarray(x), p, dtype=jnp.bfloat16)
    assert_rounds_as_jax(port_bf16(m, x), want)


@pytest.mark.parametrize('activation', list(JAX_DARKNET_ACT))
def test_darknet_conv(activation):
    """A darknet convolutional block (BN folded, as ``darknet.fold_weights``
    casts it) through each activation but relu (exact): ``jax.nn.leaky_relu``
    casts its slope 0.1 to bf16 before the product, which the port's slope
    follows; logistic, mish and swish round after each op."""
    rng = np.random.default_rng(6)
    blk = {'type': 'convolutional', 'bn': True, 'filters': 32, 'size': 3,
           'stride': 1, 'pad': 1, 'activation': activation}
    m = TD.DarknetConv(32, blk)
    draw_conv(m, rng)
    draw_bn(m.bn, rng)
    m.eval().fold()
    p = jax_params(m.weight, m.bias)
    x = frame((2, 16, 16, 32), 7)
    want = JAX_DARKNET_ACT[activation](
        JL.conv2d(jnp.asarray(x), p, padding=1, dtype=jnp.bfloat16))
    assert_rounds_as_jax(port_bf16(m, x), want)


def test_yolov5_conv():
    """A YOLOv5 ``Conv``'s folded 3x3 conv, then the whole ``Conv`` through
    its SiLU against the JAX package's ``_conv``."""
    rng = np.random.default_rng(8)
    blk = T5.Conv(32, 32, 3)
    draw_conv(blk.conv, rng)
    draw_bn(blk.bn, rng)
    L.fold_batch_norm(blk.eval())
    p = jax_params(blk.conv.weight, blk.conv.bias)
    x = frame((2, 16, 16, 32), 9)
    want = JL.conv2d(jnp.asarray(x), p, padding=1, dtype=jnp.bfloat16)
    assert_rounds_as_jax(port_bf16(blk.conv, x), want)
    want = J5._conv({'conv': p}, jnp.asarray(x), dtype=jnp.bfloat16)
    assert_rounds_as_jax(port_bf16(blk, x), want)


def test_activations_equal_jax_bit_for_bit():
    """The port's bf16 sigmoid, SiLU and mish on 2^20 seeded elements
    (normal, sd 3) against ``jax.nn.sigmoid``, ``jax.nn.silu`` and the JAX
    package's mish: no element differs. PyTorch's own calls, which round
    once, differ in over 10% (the control)."""
    x = np.random.default_rng(10).normal(0.0, 3.0, 1 << 20).astype(
        np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    cases = (
        ('sigmoid', A.sigmoid, jax.nn.sigmoid, torch.sigmoid),
        ('silu', A.silu, jax.nn.silu, F.silu),
        ('mish', A.mish, JAX_DARKNET_ACT['mish'],
         lambda t: t * torch.tanh(F.softplus(t))),
    )
    for name, port, jax_fn, once in cases:
        want = np.asarray(jax.jit(jax_fn)(xj).astype(jnp.float32))
        got = port(xt).float().numpy()
        control = float(np.mean(once(xt).float().numpy() != want))
        print(f'{name}: {int(np.sum(got != want))} elements differ; '
              f'rounded once, {control:.3f} of them')
        np.testing.assert_array_equal(got, want)
        assert control > 0.1


def test_initialize_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """With ``device`` None ``initialize`` takes the card and raises
    without one, in ``utils/device``'s words; partial coordinator
    arguments still raise ``ValueError`` first."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        D.initialize('127.0.0.1:1', 1, 0)
    with pytest.raises(ValueError, match='together'):
        D.initialize('127.0.0.1:1', None, 0)
    assert not D.is_initialized()
