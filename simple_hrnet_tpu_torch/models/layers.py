"""Conv/BN building blocks of the pose networks, in PyTorch.

Counterpart of ``simple_hrnet_tpu/models/layers.py``. Modules keep the
reference's ``state_dict`` names (``conv1``/``bn1`` siblings, numbered
``nn.Sequential`` children), so official ``pose_hrnet_*`` checkpoints load
with ``load_state_dict``.

Two execution modes, as in the JAX package:
  * unfolded: conv -> BatchNorm2d (eval statistics, eps 1e-5);
  * folded (inference): ``fold_batch_norm`` absorbs every BN into the conv
    before it (weight *= gamma / sqrt(var + eps), bias folded in) and
    replaces the BN by ``nn.Identity``, so the same forward serves both.

Layout: the networks take and return NHWC tensors at their public
functions (like the JAX package); inside, activations are logical NCHW
tensors in ``torch.channels_last`` memory, which is NHWC in memory — so
the CUDA kernels get NHWC views with no copy.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from simple_hrnet_tpu_torch.ops.int8 import int8_conv2d

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention: new = (1 - m) * old + m * batch


def add_bias(out: torch.Tensor, bias: Optional[torch.Tensor]
             ) -> torch.Tensor:
    """A conv's bias epilogue in the JAX package's order
    (``layers.conv2d`` / ``deconv2d``): ``out``, the conv's output already
    rounded to the compute type, plus the bias rounded to that type, so a
    bf16 result is rounded twice. oneDNN would fold the bias into the sum
    and round once; cuDNN's PyTorch path adds it in a separate kernel, as
    here, so the card runs the same launches either way."""
    if bias is None:
        return out
    return out + bias.to(out.dtype).view(1, -1, 1, 1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters and ``state_dict``) whose bias is
    added by ``add_bias``: every biased conv of the port, folded ones
    included, is one of these."""

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
        return add_bias(super()._conv_forward(x, weight, None), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose bias is added by ``add_bias`` (a
    PoseResNet deconv, once its BN is folded)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return add_bias(F.conv_transpose2d(
            x, self.weight, None, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation), self.bias)


def conv3x3(c_in: int, c_out: int, stride: int = 1) -> Conv2d:
    return Conv2d(c_in, c_out, 3, stride=stride, padding=1, bias=False)


def conv1x1(c_in: int, c_out: int, stride: int = 1) -> Conv2d:
    return Conv2d(c_in, c_out, 1, stride=stride, bias=False)


def bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class BasicBlock(nn.Module):
    """3x3 (stride) -> BN -> ReLU -> 3x3 -> BN, residual add (1x1 stride
    ``stride`` downsample + BN when ``downsample``), ReLU. conv2 maps
    ``planes -> planes``: the reference constructs it with
    ``in_channels=inplanes``, which is coherent only when inplanes ==
    planes (every HRNet block) and crashes ResNet-18/34; the JAX package
    corrects it the same way (its ``layers.basic_block``)."""

    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv3x3(c_in, planes, stride)
        self.bn1 = bn(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = bn(planes)
        self.downsample = (nn.Sequential(conv1x1(c_in, planes, stride),
                                         bn(planes))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (expansion 4), residual (optional 1x1
    stride ``stride`` downsample + BN), ReLU."""

    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv1x1(c_in, planes)
        self.bn1 = bn(planes)
        self.conv2 = conv3x3(planes, planes, stride)
        self.bn2 = bn(planes)
        self.conv3 = conv1x1(planes, planes * 4)
        self.bn3 = bn(planes * 4)
        self.downsample = (nn.Sequential(conv1x1(c_in, planes * 4, stride),
                                         bn(planes * 4))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class QConv2d(nn.Module):
    """A post-training-quantized conv (``quantize.quantize_folded`` builds
    it from a folded conv): the counterpart of a ``kernel_q`` node of the
    JAX package's param tree. ``wq`` (Co, k * k * Ci) int8 with columns in
    (ky, kx, ci) order (2-D, so no memory-format conversion touches it);
    ``wscale`` (Co,) per-output-channel and ``ascale`` () static input
    scales and ``bias`` (Co,), all f32. The output has the input's type
    (the compute type); ``ops.int8.int8_conv2d`` gives the arithmetic."""

    def __init__(self, wq: torch.Tensor, k: int, wscale: torch.Tensor,
                 ascale: torch.Tensor, bias: torch.Tensor, stride: int,
                 padding: int):
        super().__init__()
        self.k = k
        self.register_buffer('wq', wq)
        self.register_buffer('wscale', wscale)
        self.register_buffer('ascale', ascale)
        self.register_buffer('bias', bias)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_conv2d(x, self.wq, self.k, self.wscale, self.ascale,
                           self.bias, self.stride, self.padding)


def _fold_pair(conv: nn.Module, norm: nn.BatchNorm2d) -> None:
    """y = (conv(x) - mean) * gamma / sqrt(var + eps) + beta, absorbed into
    ``conv`` in place (same arithmetic as the JAX package's _fold_pair).
    The scale multiplies the output channels: dim 0 of an ``nn.Conv2d``
    weight (C_out, C_in, kh, kw), dim 1 of an ``nn.ConvTranspose2d``
    weight (C_in, C_out, kh, kw)."""
    with torch.no_grad():
        w = conv.weight.float()
        inv = norm.weight.float() / torch.sqrt(norm.running_var.float()
                                               + norm.eps)
        bias = norm.bias.float() - norm.running_mean.float() * inv
        if conv.bias is not None:
            bias = bias + conv.bias.float() * inv
        scale = (inv[None, :, None, None]
                 if isinstance(conv, nn.ConvTranspose2d)
                 else inv[:, None, None, None])
        conv.weight = nn.Parameter(w * scale, requires_grad=False)
        conv.bias = nn.Parameter(bias, requires_grad=False)


def fold_batch_norm(module: nn.Module) -> nn.Module:
    """Fold every (conv or transposed conv, BN) sibling pair below
    ``module`` in place and replace the BN by ``nn.Identity``. Pairing
    rules (as in the JAX package): ``convN``/``bnN`` siblings, and numbered
    children where child i is a conv and child i+1 a BN (PoseResNet's
    ``deconv_layers`` among them). Returns ``module``."""
    for parent in list(module.modules()):
        children = dict(parent.named_children())
        for name, child in children.items():
            if not isinstance(child, (nn.Conv2d, nn.ConvTranspose2d)):
                continue
            if name.startswith('conv'):
                bn_name: Optional[str] = 'bn' + name[len('conv'):]
            elif name.isdigit():
                bn_name = str(int(name) + 1)
            else:
                bn_name = None
            if bn_name is not None and isinstance(children.get(bn_name),
                                                  nn.BatchNorm2d):
                _fold_pair(child, children[bn_name])
                setattr(parent, bn_name, nn.Identity())
    return module


def init_conv_(weight: torch.Tensor, bias: Optional[torch.Tensor],
               gen: torch.Generator) -> None:
    """The torch nn.Conv2d default init (kaiming-uniform, bound
    1/sqrt(fan_in) for weight and bias) of an OIHW weight, from ``gen``."""
    bound = 1.0 / math.sqrt(weight[0].numel())
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=gen)
        if bias is not None:
            bias.uniform_(-bound, bound, generator=gen)


def init_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Seeded torch-default init of every conv and transposed conv below
    ``module``; BNs get identity statistics."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            init_conv_(m.weight, m.bias, gen)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module
