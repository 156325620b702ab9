"""Heatmap -> keypoint decoding in PyTorch (NHWC heatmaps).

Counterpart of ``get_max_preds`` and ``argmax_decode`` in
``simple_hrnet_tpu/ops/decode.py``. ``torch.argmax`` returns the first
maximal index, like ``jnp.argmax``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def get_max_preds(heatmaps: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, J) -> preds (N, J, 2) xy, maxvals (N, J, 1); predictions
    whose peak is <= 0 are zeroed (reference misc/utils.py:125-151)."""
    n, h, w, j = heatmaps.shape
    flat = heatmaps.permute(0, 3, 1, 2).reshape(n, j, h * w)
    idx = torch.argmax(flat, dim=2)
    maxvals = torch.gather(flat, 2, idx[..., None])
    x = (idx % w).float()
    y = torch.floor(idx.float() / w)
    preds = torch.stack([x, y], dim=-1)
    return preds * (maxvals > 0.0).float(), maxvals


def argmax_decode(heatmaps: torch.Tensor, boxes: torch.Tensor
                  ) -> torch.Tensor:
    """SimpleHRNet.predict decode: (N, H, W, J) + boxes (N, 4) xyxy ->
    (N, J, 3) of (y, x, conf): row / H * (y2 - y1) + y1, col / W *
    (x2 - x1) + x1 (reference SimpleHRNet.py:302-308, no subpixel)."""
    n, h, w, j = heatmaps.shape
    flat = heatmaps.permute(0, 3, 1, 2).reshape(n, j, h * w)
    idx = torch.argmax(flat, dim=2)
    conf = torch.gather(flat, 2, idx[..., None])[..., 0]
    row = torch.floor(idx.float() / w)
    col = (idx % w).float()
    x1, y1, x2, y2 = boxes.float().unbind(1)
    pt_y = row / h * (y2 - y1)[:, None] + y1[:, None]
    pt_x = col / w * (x2 - x1)[:, None] + x1[:, None]
    return torch.stack([pt_y, pt_x, conf], dim=-1)
