"""In-graph box NMS for the detector, in PyTorch.

Counterpart of ``nms_ingraph`` in ``simple_hrnet_tpu/ops/nms.py``: the
``nms_jax`` contract (per-image greedy NMS with a static ``max_out``,
scores <= 0 are padding, ties to the lowest index), run by the CUDA
kernel K1 on CUDA tensors and by its plain version on CPU tensors
(``ops/cuda/nms.py``). The host tier (numpy NMS, OKS-NMS) is not ported
yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from simple_hrnet_tpu_torch.ops.cuda.nms import nms, nms_plain

__all__ = ['nms_ingraph', 'nms_plain']


def nms_ingraph(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float, max_out: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes (N, 4) / (B, N, 4) f32 xyxy, scores (N,) / (B, N) -> keep_idx
    int32 and keep_valid bool of shape (max_out,) / (B, max_out)."""
    if boxes.ndim == 2:
        idx, valid = nms(boxes[None], scores[None], iou_threshold, max_out)
        return idx[0], valid[0]
    return nms(boxes, scores, iou_threshold, max_out)
