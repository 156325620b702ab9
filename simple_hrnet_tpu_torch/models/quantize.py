"""Post-training int8 quantization of the port's networks.

Counterpart of ``simple_hrnet_tpu/models/quantize.py`` (the TensorRT-int8
analogue), with the same recipe and formulas:

  1. ``calibrate(model, batches)`` runs the FOLDED f32 model on a few
     batches and records ``max|x|`` of every conv's input through forward
     pre-hooks, keyed by module path ('stage4.2.branches.0.0.conv1'). The
     paths equal the JAX package's ``node_paths`` strings, because both
     mirror the ``state_dict``. Calibrate before ``hrnet.prepare_inference``
     packs the chains: a packed chain's convs never run as modules.
  2. ``quantize_folded(model, amax)`` replaces every calibrated conv that
     ``default_policy`` accepts by a ``layers.QConv2d``: per-output-channel
     weights ``ws = max|k| over (kh, kw, ci) / 127`` (0 -> 1), ``round`` /
     ``clip(-127, 127)``, and the static input scale ``amax / 127``. The
     rest keep running in the compute type (a per-layer precision mix).

The policy is the JAX package's, copied as it is: its shape limits were
measured on a TPU and have not been decided again on the H100 (ROADMAP).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from simple_hrnet_tpu_torch.models.layers import QConv2d
from simple_hrnet_tpu_torch.ops.int8 import quantize_weight
from simple_hrnet_tpu_torch.utils.device import true_f32


def default_policy(kernel_shape) -> bool:
    """Quantize 3x3(+) convs with both channel dims in [16, 128] (an HWIO
    kernel shape)."""
    kh, kw, ci, co = kernel_shape
    return kh >= 3 and kw >= 3 and 16 <= ci <= 128 and 16 <= co <= 128


def conv_shape(module: nn.Module) -> Tuple[int, int, int, int]:
    """The HWIO kernel shape of a conv module's OIHW ``weight``."""
    co, ci, kh, kw = module.weight.shape
    return kh, kw, ci, co


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable, forward: Optional[
        Callable] = None, types: tuple = (nn.Conv2d,)) -> Dict[str, float]:
    """Run ``forward(batch)`` (default ``model(batch)``) over ``batches``
    in true f32 (TF32 off) and return {module path: input amax} for every
    module of ``types`` below ``model``."""
    forward = forward or model
    amax: Dict[str, float] = {}

    def record(name):
        def hook(_module, args):
            a = float(args[0].detach().abs().max())
            amax[name] = max(amax.get(name, 0.0), a)
        return hook

    hooks = [m.register_forward_pre_hook(record(name))
             for name, m in model.named_modules() if isinstance(m, types)]
    try:
        with true_f32():
            for b in batches:
                forward(b)
    finally:
        for h in hooks:
            h.remove()
    return amax


def _stride_padding(module: nn.Module) -> Tuple[int, int]:
    stride, padding = module.stride, module.padding
    if not isinstance(stride, int):
        stride = stride[0]
    if not isinstance(padding, int):
        padding = padding[0]
    return stride, padding


def quantize_folded(model: nn.Module, amax: Dict[str, float],
                    types: tuple = (nn.Conv2d,)) -> nn.Module:
    """Quantize, in place, every module of ``types`` below the FOLDED
    ``model`` whose path is calibrated (amax > 0) and whose kernel shape
    ``default_policy`` accepts. An ``nn.Conv2d`` is replaced by its
    ``QConv2d``; any other conv module takes it as its ``qconv`` attribute
    (the darknet blocks, which keep their activation). Returns ``model``."""
    for name, m in list(model.named_modules()):
        if not isinstance(m, types) or amax.get(name, 0.0) <= 0.0 or \
                not default_policy(conv_shape(m)):
            continue
        wq, ws = quantize_weight(m.weight)
        bias = (m.bias.detach().float() if m.bias is not None
                else torch.zeros(m.weight.shape[0], device=m.weight.device))
        ascale = torch.tensor(np.float32(amax[name] / 127.0),
                              device=m.weight.device)
        q = QConv2d(wq, m.weight.shape[2], ws, ascale, bias,
                    *_stride_padding(m))
        if isinstance(m, nn.Conv2d):
            parent, _, leaf = name.rpartition('.')
            setattr(model.get_submodule(parent), leaf, q)
        else:
            m.qconv = q
    return model


def filter_amax(model: nn.Module, amax: Dict[str, float],
                exclude: Iterable[str]) -> Dict[str, float]:
    """Drop the calibration entries under an excluded dotted path prefix
    (matched on component boundaries: ('stage4',) excludes every conv of
    stage4), so those convs stay in the compute type. A prefix that
    matches no conv of ``model`` raises ``ValueError``."""
    exclude = tuple(exclude)
    if not exclude:
        return amax
    paths = [n for n, m in model.named_modules()
             if isinstance(m, nn.Conv2d)]

    def matches(path: str, e: str) -> bool:
        return path == e or path.startswith(e + '.')

    unmatched = [e for e in exclude if not any(matches(p, e) for p in paths)]
    if unmatched:
        groups = sorted({p.split('.')[0] for p in paths})
        raise ValueError(
            f'int8_exclude prefixes {unmatched} match no conv param path '
            f'in this model (top-level groups: {groups})')
    return {p: a for p, a in amax.items()
            if not any(matches(p, e) for e in exclude)}


def smooth_frames(shape_hw, n: int = 1, lo: float = 0.0, hi: float = 1.0,
                  seed: int = 0) -> np.ndarray:
    """Smooth synthetic calibration frames: coarse noise upsampled 8x (a
    copy of the JAX package's, bit for bit)."""
    rng = np.random.default_rng(seed)
    h, w = shape_hw
    coarse = rng.uniform(lo, hi, (n, h // 8, w // 8, 3))
    return np.kron(coarse.transpose(0, 3, 1, 2),
                   np.ones((8, 8))).transpose(0, 2, 3, 1).astype(np.float32)
