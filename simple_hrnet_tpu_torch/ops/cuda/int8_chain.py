"""B4: HRNet's branch-0 chain of 4 BasicBlocks in int8 — CUDA kernel and
plain version.

Counterpart of ``simple_hrnet_tpu/ops/pallas/fused_block.py``'s two int8
chains, computing their UNPACKED function (G = 1): the Pallas
``_chain_kernel_int8`` (behind ``chain_pallas_int8_grouped``) and the XLA
``blockdiag_chain_int8_grouped``. The kernel is ``csrc/int8_chain.cu``;
its note gives the bound on the H100 and the design.

Each conv takes a static per-tensor input scale ``ascales[i]`` and
per-output-channel weight scales ``wscale[i]``. In both formulations:
  * ``inva = 1 / ascale`` and ``alpha = ascale * wscale``, both in f32;
  * the first conv's input is quantized from the block input ``x``:
    ``clip(round(x * inva), -127, 127)`` (round half to even);
  * int8 x int8 -> exact int32 accumulators, then ``acc * alpha + bias``
    in f32;
  * a conv2 output adds the block input as its f32 residual, takes the
    ReLU and is stored in the activation type.
They differ in the two handoffs of every block, the conv1 output (after
its ReLU) that conv2 quantizes and the block output that the next block's
conv1 quantizes:
  * ``round_handoffs=False``, the Pallas kernel's cast points: both are
    requantized FROM f32, never rounded to the activation type first;
  * ``round_handoffs=True``, the XLA chain's: both are rounded to the
    activation type, and the requantization is taken from that value.
The JAX package runs the Pallas kernel only where ``G * c == 128`` and
branch-0 W % 8 == 0 (``chain_pallas_int8_ok``), the XLA chain elsewhere;
``models/hrnet.py`` picks the mode by the same rule. In f32 the two modes
give the same numbers.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from simple_hrnet_tpu_torch.ops.cuda import build
from simple_hrnet_tpu_torch.ops.int8 import quantize, quantize_weight


def pack_chain_weights_int8(convs: Sequence[Tuple[torch.Tensor,
                                                  torch.Tensor]],
                            amax: Sequence[float]) -> Dict[str, torch.Tensor]:
    """Quantize the 8 folded convs (conv1, conv2 of 4 BasicBlocks in order,
    each an f32 (OIHW weight, bias) pair) with their calibrated input amax,
    by the formulas of the JAX package's ``pack_chain_weights_int8`` at
    G = 1. Returns wq (8, 3, 3, C, C) int8 HWIO, wscale (8, C), b (8, C) and
    ascales (8,), all f32."""
    if len(convs) != 8 or len(amax) != 8:
        raise ValueError(f'a chain has 8 convs and 8 amax values, got '
                         f'{len(convs)} and {len(amax)}')
    wqs, wss = [], []
    for wt, _ in convs:
        wq, ws = quantize_weight(wt)
        co, ci = wt.shape[0], wt.shape[1]
        wqs.append(wq.reshape(co, 3, 3, ci).permute(1, 2, 3, 0))
        wss.append(ws)
    dev = convs[0][0].device
    return {'wq': torch.stack(wqs).contiguous(),
            'wscale': torch.stack(wss).contiguous(),
            'b': torch.stack([bs.detach().float() for _, bs in convs]
                             ).contiguous(),
            'ascales': torch.tensor([a / 127.0 for a in amax],
                                    dtype=torch.float32, device=dev)}


# the widest chain the kernel is compiled for: the JAX package's int8
# policy takes 3x3 convs up to 128 channels
MAX_WIDTH = 128


def takes(c: int) -> bool:
    """Whether the kernel takes chains of width ``c``: every multiple of 8
    up to ``MAX_WIDTH``. The wrapper refuses every other width with this
    same rule, and ``StageModule.pack`` keeps such a chain off the int8
    kernel."""
    return 0 < c <= MAX_WIDTH and c % 8 == 0


def int8_chain_plain(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                     b: torch.Tensor, ascales: torch.Tensor,
                     round_handoffs: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch. x (B, H, W, C) NHWC in the
    activation type; the int8 cores are f64 convs of the integer operands
    (exact: every partial sum is an integer below 2^53).
    ``round_handoffs`` picks the cast points (module docstring)."""
    dt = x.dtype
    inva = torch.reciprocal(ascales.float())
    alpha = ascales.float()[:, None] * wscale.float()
    wk = wq.permute(0, 4, 3, 1, 2).double()  # (8, Co, Ci, 3, 3)

    def qconv(vq, i):
        acc = F.conv2d(vq.double(), wk[i], padding=1).float()
        return acc * alpha[i].view(1, -1, 1, 1) + b[i].float().view(1, -1,
                                                                   1, 1)

    v = x.permute(0, 3, 1, 2)
    q = quantize(v, inva[0])
    for blk in range(4):
        mid = torch.relu(qconv(q, 2 * blk))
        if round_handoffs:
            mid = mid.to(dt)
        y = torch.relu(qconv(quantize(mid, inva[2 * blk + 1]), 2 * blk + 1)
                       + v.float())
        v = y.to(dt)
        if blk < 3:
            q = quantize(v if round_handoffs else y, inva[2 * blk + 2])
    return v.permute(0, 2, 3, 1).contiguous()


def int8_chain(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
               b: torch.Tensor, ascales: torch.Tensor,
               round_handoffs: bool = False) -> torch.Tensor:
    """4 int8 BasicBlocks on x (B, H, W, C) NHWC: the CUDA kernel for CUDA
    tensors (bf16 in and out), the plain version for CPU tensors.
    ``round_handoffs`` picks the cast points (module docstring)."""
    if x.ndim != 4:
        raise ValueError(f'int8_chain wants x (B, H, W, C), got '
                         f'{tuple(x.shape)}')
    bsz, h, wd, c = x.shape
    if tuple(wq.shape) != (8, 3, 3, c, c) or tuple(wscale.shape) != (8, c) \
            or tuple(b.shape) != (8, c) or tuple(ascales.shape) != (8,):
        raise ValueError(f'int8_chain operands wq {tuple(wq.shape)}, wscale '
                         f'{tuple(wscale.shape)}, b {tuple(b.shape)}, '
                         f'ascales {tuple(ascales.shape)} do not match C = '
                         f'{c}')
    if x.device.type == 'cpu':
        return int8_chain_plain(x, wq, wscale, b, ascales, round_handoffs)
    operands = (wq, wscale, b, ascales)
    if x.device.type != 'cuda' or any(t.device != x.device
                                      for t in operands):
        raise ValueError('int8_chain: every tensor must lie on one CUDA '
                         'device')
    if x.dtype != torch.bfloat16 or wq.dtype != torch.int8 or \
            any(t.dtype != torch.float32 for t in (wscale, b, ascales)):
        raise ValueError(f'int8_chain kernel takes bf16 x, int8 wq and f32 '
                         f'scales and biases; got {x.dtype}, {wq.dtype}, '
                         f'{wscale.dtype}, {b.dtype}, {ascales.dtype}')
    if not (x.is_contiguous() and all(t.is_contiguous() for t in operands)):
        raise ValueError('int8_chain kernel wants contiguous tensors')
    if not takes(c):
        raise ValueError(f'int8_chain kernel takes C a multiple of 8 up to '
                         f'{MAX_WIDTH}, got {c}')
    if x.data_ptr() % 16:  # the kernel's 16-byte vector loads
        x = x.clone()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    tmp = torch.empty_like(x)
    qa = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    qmid = torch.empty_like(qa)
    rc = _fn()(build.ptr(x), build.ptr(wq), build.ptr(wscale), build.ptr(b),
               build.ptr(ascales), build.ptr(out), build.ptr(tmp),
               build.ptr(qa), build.ptr(qmid), bsz, h, wd, c,
               build.stream_ptr(x.device), int(round_handoffs))
    build.check(rc, 'int8_chain kernel')
    int8_chain.launches += 1
    return out


int8_chain.launches = 0


def _fn():
    fn = build.library('int8_chain').sht_int8_chain
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p, ctypes.c_int]
    return fn
