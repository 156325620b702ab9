"""The int8 convolution outside the chains (post-training quantization).

Counterpart of the ``kernel_q`` branch of ``simple_hrnet_tpu/models/
layers.py`` ``conv2d``, in its order:
  1. quantize the input: ``x * (1 / ascale)`` (a multiply by the f32
     reciprocal), round half to even, clip to [-127, 127];
  2. an int8 conv with exact int32 accumulation;
  3. ``acc * (ascale * wscale) + bias`` in f32 with one rounding (a fused
     multiply-add: XLA's CPU lowering contracts the HLO's multiply and add
     into one FMA, ``torch.addcmul`` computes the same on the CPU and the
     card), then a cast to the type of the input (the compute type).

The JAX package runs this conv in XLA, outside any Pallas kernel, so it is a
library call here too: on CUDA ``torch._int_mm`` (the int8 tensor cores)
over the conv's patch matrix; on the CPU an f64 conv of the integer
operands, exact because every partial sum is an integer below 2^53. Both
give the same int32 accumulators, so the two devices agree bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def quantize_weight(weight: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 OIHW weight -> (int8 (Co, k * k * Ci) in (ky, kx, ci) order, f32
    per-output-channel scales): ``ws = max|k| over (kh, kw, ci) / 127``
    (0 -> 1), ``clip(round(k / ws), -127, 127)``, with the JAX package's
    numpy arithmetic on the HWIO kernel."""
    k = weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0)
    ws = np.max(np.abs(k), axis=(0, 1, 2)) / 127.0
    ws = np.where(ws == 0.0, 1.0, ws)
    kq = np.clip(np.round(k / ws), -127, 127).astype(np.int8)
    co = kq.shape[3]
    wq = np.ascontiguousarray(kq.transpose(3, 0, 1, 2).reshape(co, -1))
    return (torch.from_numpy(wq).to(weight.device),
            torch.from_numpy(np.asarray(ws, np.float32)).to(weight.device))


def quantize(x: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """f32 ``x * inv_scale`` rounded half to even and clipped to int8."""
    return torch.clamp(torch.round(x.float() * inv_scale), -127, 127
                       ).to(torch.int8)


def _patches(xq: torch.Tensor, k: int, stride: int, padding: int
             ) -> torch.Tensor:
    """(N, H, W, C) int8 -> (N * Ho * Wo, k * k * C) patch rows, columns in
    (ky, kx, ci) order (an unfold that works on int8)."""
    n, h, w, c = xq.shape
    xp = F.pad(xq, (0, 0, padding, padding, padding, padding))
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    cols = [xp[:, ky:ky + stride * (ho - 1) + 1:stride,
               kx:kx + stride * (wo - 1) + 1:stride]
            for ky in range(k) for kx in range(k)]
    return torch.stack(cols, dim=3).reshape(n * ho * wo, k * k * c)


def int8_conv_acc(xq: torch.Tensor, wq: torch.Tensor, k: int, stride: int,
                  padding: int) -> torch.Tensor:
    """Exact int32 accumulators of a k x k int8 conv. xq (N, H, W, Ci) int8
    NHWC; wq (Co, k * k * Ci) int8, columns in (ky, kx, ci) order. Returns
    (N, Ho, Wo, Co) int32."""
    n, h, w, ci = xq.shape
    co = wq.shape[0]
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    if xq.device.type == 'cpu':
        acc = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                       wq.reshape(co, k, k, ci).permute(0, 3, 1, 2).double(),
                       stride=stride, padding=padding)
        return acc.permute(0, 2, 3, 1).to(torch.int32)
    a = _patches(xq, k, stride, padding)
    m = a.shape[0]
    if m <= 16:  # torch._int_mm takes more than 16 rows
        a = torch.cat([a, a.new_zeros((17 - m, a.shape[1]))])
    # (Co, K) row-major seen as (K, Co) column-major: cuBLASLt's int8 layout
    acc = torch._int_mm(a, wq.t())
    return acc[:m].reshape(n, ho, wo, co)


def int8_conv2d(x: torch.Tensor, wq: torch.Tensor, k: int,
                wscale: torch.Tensor, ascale: torch.Tensor,
                bias: torch.Tensor, stride: int, padding: int
                ) -> torch.Tensor:
    """The quantized k x k conv on x (N, C, H, W) (any memory format):
    returns (N, Co, Ho, Wo) in x's type, NHWC in memory. ``wq`` (Co,
    k * k * Ci) int8 in (ky, kx, ci) order, ``wscale`` (Co,) f32, ``ascale``
    () f32, ``bias`` (Co,) f32."""
    xq = quantize(x.permute(0, 2, 3, 1), 1.0 / ascale)
    acc = int8_conv_acc(xq, wq, k, stride, padding)
    out = torch.addcmul(bias, acc.float(), ascale * wscale)
    return out.to(x.dtype).permute(0, 3, 1, 2)
