"""K3: HRNet's high-resolution fusion output — CUDA kernel and plain version.

Computes ``relu(base + sum_j nearest_up_{f_j}(y_j @ w_j + b_j))``, the
function of ``simple_hrnet_tpu/ops/pallas/fuse_up.py`` (``fuse_up``). The
kernel is ``csrc/fuse_up.cu``; its note gives the bound on the H100 and
the design.

Arguments: ``base`` (B, H, W, C) NHWC; ``ys[j]`` (B, H/f_j, W/f_j, C_j)
with f_j in {2, 4, 8}; ``weights[j]`` the folded 1x1 conv as a (C_j, C)
matrix in the activation type; ``bias_sum`` (C,) f32, the sum of the
sources' folded biases (every output pixel receives exactly one upsampled
value per source, so the biases collapse into the accumulator's start).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from simple_hrnet_tpu_torch.ops.cuda import build
from simple_hrnet_tpu_torch.ops.cuda.fused_block import DTYPE_CODES

MAX_SOURCES = 3
_SHIFTS = {2: 1, 4: 2, 8: 3}


def _factor(base_shape, y_shape) -> int:
    _, h, w, _ = base_shape
    _, hj, wj, _ = y_shape
    if hj == 0 or wj == 0 or h % hj or w % wj or h // hj != w // wj \
            or h // hj not in _SHIFTS:
        raise ValueError(f'fuse_up source {tuple(y_shape)} is not a 2x, 4x '
                         f'or 8x pyramid level of base {tuple(base_shape)}')
    return h // hj


def fuse_up_plain(base: torch.Tensor, ys: Sequence[torch.Tensor],
                  weights: Sequence[torch.Tensor],
                  bias_sum: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 accumulation starting at
    base + bias_sum, f32 products of activation-type inputs, ReLU and one
    cast to the activation type at the end."""
    dt = base.dtype
    acc = base.float() + bias_sum.float()
    for y, w in zip(ys, weights):
        f = _factor(base.shape, y.shape)
        t = torch.matmul(y.float(), w.to(dt).float())
        acc = acc + t.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)
    return torch.relu(acc).to(dt)


def fuse_up(base: torch.Tensor, ys: Sequence[torch.Tensor],
            weights: Sequence[torch.Tensor],
            bias_sum: torch.Tensor) -> torch.Tensor:
    """The fused resize-add: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if base.ndim != 4 or not 1 <= len(ys) <= MAX_SOURCES or \
            len(weights) != len(ys):
        raise ValueError(f'fuse_up wants base (B, H, W, C) and 1..'
                         f'{MAX_SOURCES} sources with one weight each; got '
                         f'{tuple(base.shape)}, {len(ys)} sources, '
                         f'{len(weights)} weights')
    bsz, h, wd, c = base.shape
    factors = [_factor(base.shape, y.shape) for y in ys]
    for y, w in zip(ys, weights):
        if y.shape[0] != bsz or tuple(w.shape) != (y.shape[-1], c):
            raise ValueError(f'fuse_up source {tuple(y.shape)} / weight '
                             f'{tuple(w.shape)} do not match base '
                             f'{tuple(base.shape)}')
    if tuple(bias_sum.shape) != (c,):
        raise ValueError(f'fuse_up bias_sum {tuple(bias_sum.shape)} != ({c},)')
    if base.device.type == 'cpu':
        return fuse_up_plain(base, ys, weights, bias_sum)
    tensors = [base, bias_sum, *ys, *weights]
    if base.device.type != 'cuda' or any(t.device != base.device
                                         for t in tensors):
        raise ValueError('fuse_up: every tensor must lie on one CUDA device')
    if base.dtype not in DTYPE_CODES or bias_sum.dtype != torch.float32 or \
            any(t.dtype != base.dtype for t in (*ys, *weights)):
        raise ValueError('fuse_up kernel takes f32 or bf16 base, sources and '
                         'weights of one type and an f32 bias_sum')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('fuse_up kernel wants contiguous tensors')
    out = torch.empty_like(base)
    if base.numel() == 0:
        return out
    slots = []
    for y, w, f in zip(ys, weights, factors):
        slots += [build.ptr(y), build.ptr(w), y.shape[-1], _SHIFTS[f]]
    for _ in range(MAX_SOURCES - len(ys)):
        slots += [build.ptr(None), build.ptr(None), 0, 0]
    rc = _fn()(build.ptr(base), len(ys), *slots, build.ptr(bias_sum),
               build.ptr(out), bsz, h, wd, c, DTYPE_CODES[base.dtype],
               build.stream_ptr(base.device))
    build.check(rc, 'fuse_up kernel')
    fuse_up.launches += 1
    return out


fuse_up.launches = 0


def _fn():
    fn = build.library('fuse_up').sht_fuse_up
    fn.restype = ctypes.c_int
    src = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + src * MAX_SOURCES + \
        [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    return fn
