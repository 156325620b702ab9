"""K1: batched greedy IoU NMS — the CUDA kernel and its plain version.

Counterpart of ``simple_hrnet_tpu/ops/pallas/nms_pallas.py`` (the Pallas
``_nms_kernel`` / ``_nms_kernel_batched``). The kernel is
``csrc/nms.cu``: a bitmask in ranked order spread over (image, 32-row
tile) blocks, then a one-warp scan per image as a programmatic dependent
launch; its note gives the bound on the H100 and the design. One wrapper
call is one launch of the pair.

Contract (``ops/nms.nms_jax`` in the JAX package): per image, ``max_out``
greedy rounds; each keeps the live box with the highest score (lowest
index on ties) and kills every box with IoU > ``iou_threshold`` against
it, IoU = inter / ((area_i + area_j) - inter) with no +1 extent. Scores
<= 0 are padding and never kept. Unused slots hold index 0, valid False.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from simple_hrnet_tpu_torch.ops.cuda import build

# the scan holds an image's "removed" bitmap in one warp's registers (32
# lanes x 32 bits), and the mask kernel ranks with one thread a candidate
MAX_N = 1024


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float, max_out: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, same arithmetic as nms_jax.

    boxes (B, N, 4) f32 xyxy, scores (B, N) f32 -> keep_idx (B, max_out)
    int32, keep_valid (B, max_out) bool.
    """
    bsz, n = scores.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    xx1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    yy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    xx2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    yy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    inter = torch.maximum(zero, xx2 - xx1) * torch.maximum(zero, yy2 - yy1)
    iou = inter / (areas[:, :, None] + areas[:, None, :] - inter)
    suppress = iou > iou_threshold

    alive = scores > 0.0
    neg_inf = torch.full_like(scores, float('-inf'))
    ar = torch.arange(n, device=scores.device)
    rows = torch.arange(bsz, device=scores.device)
    keep_idx = torch.zeros((bsz, max_out), dtype=torch.int32,
                           device=scores.device)
    keep_valid = torch.zeros((bsz, max_out), dtype=torch.bool,
                             device=scores.device)
    for i in range(max_out):
        masked = torch.where(alive, scores, neg_inf)
        best = torch.argmax(masked, dim=1)  # first index among ties
        ok = masked[rows, best] > 0.0
        keep_idx[:, i] = torch.where(ok, best, torch.zeros_like(best)).to(
            torch.int32)
        keep_valid[:, i] = ok
        alive = alive & ~suppress[rows, best] & (ar[None, :] != best[:, None])
        alive = alive & ok[:, None]
    return keep_idx, keep_valid


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy NMS: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. boxes (B, N, 4) f32, scores (B, N) f32."""
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or scores.shape != \
            boxes.shape[:2]:
        raise ValueError(f'nms wants boxes (B, N, 4) and scores (B, N), got '
                         f'{tuple(boxes.shape)} and {tuple(scores.shape)}')
    if boxes.device.type == 'cpu' and scores.device.type == 'cpu':
        return nms_plain(boxes, scores, iou_threshold, max_out)
    if boxes.device.type != 'cuda' or scores.device != boxes.device:
        raise ValueError(f'nms: boxes on {boxes.device}, scores on '
                         f'{scores.device}; want both on one CUDA device')
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise ValueError('nms kernel takes float32 boxes and scores')
    bsz, n = scores.shape
    if n > MAX_N:
        raise ValueError(f'nms kernel holds N <= {MAX_N} boxes in one '
                         f'warp\'s bitmap, got N = {n}')
    if max_out < 0:
        raise ValueError(f'max_out must be >= 0, got {max_out}')
    boxes = boxes.contiguous()
    scores = scores.contiguous()
    if boxes.data_ptr() % 16:  # float4 loads
        boxes = boxes.clone()
    keep_idx = torch.empty((bsz, max_out), dtype=torch.int32,
                           device=boxes.device)
    keep_valid = torch.empty((bsz, max_out), dtype=torch.bool,
                             device=boxes.device)
    if bsz == 0 or max_out == 0:
        return keep_idx, keep_valid
    if n == 0:
        return keep_idx.zero_(), keep_valid.zero_()
    # the ranked masks (B, n_pad, words) and rank -> index orders (B, n_pad)
    words = -(-n // 32)
    scratch = torch.empty((bsz * 32 * words * (words + 1),),
                          dtype=torch.int32, device=boxes.device)
    fn = _fn()
    rc = fn(build.ptr(boxes), build.ptr(scores),
            ctypes.c_float(iou_threshold), bsz, n, max_out,
            build.ptr(keep_idx), build.ptr(keep_valid),
            build.stream_ptr(boxes.device), build.ptr(scratch))
    build.check(rc, 'nms kernel')
    nms.launches += 1
    return keep_idx, keep_valid


nms.launches = 0


def _fn():
    lib = build.library('nms')
    fn = lib.sht_nms
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn
