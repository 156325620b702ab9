"""K2: HRNet's branch-0 chain of 4 BasicBlocks — CUDA kernel and plain version.

Counterpart of ``simple_hrnet_tpu/ops/pallas/fused_block.py`` (the Pallas
``_chain_kernel`` behind ``chain_pallas_grouped``), computing its
UNPACKED function (G = 1, any width). The kernel is ``csrc/fused_block.cu``;
its note gives the bound on the H100 and the design.

Weights come from ``pack_chain_weights``: the 8 folded conv kernels
stacked (8, 3, 3, C, C) HWIO in the activation type and their biases
(8, C) f32 — ``pack_chain_weights(..., group=1)``'s layout in the JAX
package.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from simple_hrnet_tpu_torch.ops.cuda import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the widths the bf16 (tensor-core) path is compiled for (its registers
# hold all C output channels of 64 pixels a warp); f32 takes any multiple
# of 8 (16-byte accesses, 8 channels at a time)
BF16_WIDTHS = (16, 32, 48, 64)


def takes(c: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes chains of width ``c`` in ``dtype``. The
    wrapper refuses every other width with this same rule, and
    ``StageModule.pack`` leaves such a chain to the plain modules."""
    if dtype == torch.bfloat16:
        return c in BF16_WIDTHS
    return dtype == torch.float32 and c > 0 and c % 8 == 0


def pack_chain_weights(convs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                       dtype: torch.dtype
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack the 8 folded convs (conv1, conv2 of 4 BasicBlocks in order),
    each an (OIHW weight, bias) pair, into (8, 3, 3, C, C) HWIO weights
    in ``dtype`` and (8, C) f32 biases."""
    if len(convs) != 8:
        raise ValueError(f'a chain has 8 convs, got {len(convs)}')
    w = torch.stack([wt.permute(2, 3, 1, 0) for wt, _ in convs])
    b = torch.stack([bs for _, bs in convs])
    return w.to(dtype).contiguous(), b.to(torch.float32).contiguous()


def basic_chain_plain(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 arithmetic on the
    activation-type inputs, rounded to the activation type at the kernel's
    cast points (each conv's output). x (B, H, W, C) NHWC."""
    dt = x.dtype
    wk = w.to(dt).float().permute(0, 4, 3, 1, 2)  # (8, O, I, 3, 3)
    bf = b.float()
    v = x.permute(0, 3, 1, 2).float()
    for blk in range(4):
        mid = F.relu(F.conv2d(v, wk[2 * blk], bf[2 * blk], padding=1))
        mid = mid.to(dt).float()
        y = F.conv2d(mid, wk[2 * blk + 1], bf[2 * blk + 1], padding=1)
        v = F.relu(y + v).to(dt).float()
    return v.to(dt).permute(0, 2, 3, 1).contiguous()


def basic_chain(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """4 BasicBlocks on x (B, H, W, C) NHWC: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x.ndim != 4:
        raise ValueError(f'basic_chain wants x (B, H, W, C), got '
                         f'{tuple(x.shape)}')
    bsz, h, wd, c = x.shape
    if tuple(w.shape) != (8, 3, 3, c, c) or tuple(b.shape) != (8, c):
        raise ValueError(f'basic_chain weights {tuple(w.shape)} / biases '
                         f'{tuple(b.shape)} do not match C = {c}')
    if x.device.type == 'cpu':
        return basic_chain_plain(x, w, b)
    if x.device.type != 'cuda' or w.device != x.device or \
            b.device != x.device:
        raise ValueError(f'basic_chain: x on {x.device}, w on {w.device}, '
                         f'b on {b.device}; want one CUDA device')
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype or \
            b.dtype != torch.float32:
        raise ValueError(f'basic_chain kernel takes f32 or bf16 x with w of '
                         f'the same type and f32 b; got {x.dtype}, '
                         f'{w.dtype}, {b.dtype}')
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError('basic_chain kernel wants contiguous NHWC x, w, b')
    if not takes(c, x.dtype):
        raise ValueError(f'basic_chain kernel takes C in {BF16_WIDTHS} in '
                         f'bf16 and C a multiple of 8 in f32 (HRNet-W32 and '
                         f'W48 branch 0 are 32 and 48); got C = {c} in '
                         f'{x.dtype}')
    if w.data_ptr() % 16:
        raise ValueError('basic_chain kernel wants 16-byte aligned weights')
    if x.data_ptr() % 16:  # the kernel's 16-byte vector loads
        x = x.clone()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    mid = torch.empty_like(x)
    tmp = torch.empty_like(x)
    rc = _fn()(build.ptr(x), build.ptr(w), build.ptr(b), build.ptr(out),
               build.ptr(mid), build.ptr(tmp), bsz, h, wd, c,
               DTYPE_CODES[x.dtype], build.stream_ptr(x.device))
    build.check(rc, 'basic_chain kernel')
    basic_chain.launches += 1
    return out


basic_chain.launches = 0


def _fn():
    fn = build.library('fused_block').sht_basic_chain
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    return fn
