"""Heatmap -> keypoint decoding in PyTorch (NHWC heatmaps).

Counterpart of ``simple_hrnet_tpu/ops/decode.py``: ``get_max_preds`` and
``argmax_decode`` (the facade), and the training/eval decode
``subpixel_refine``, ``transform_preds``, ``get_final_preds``,
``flip_back`` and ``flip_test_average``. ``torch.argmax`` returns the
first maximal index, like ``jnp.argmax``. Each function computes on its
input's device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from simple_hrnet_tpu_torch.ops.affine import affine_matrix_batched


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


def subpixel_refine(heatmaps: torch.Tensor, coords: torch.Tensor
                    ) -> torch.Tensor:
    """Shift each (N, J, 2) xy coord by 0.25 * the sign of the local
    heatmap gradient where the rounded peak is strictly inside the border
    (reference utils.py:161-174: ``1 < px < width-1 and 1 < py <
    height-1``)."""
    n, h, w, j = heatmaps.shape
    hm = heatmaps.permute(0, 3, 1, 2).reshape(n, j, h * w)
    px = torch.floor(coords[..., 0] + 0.5).long()
    py = torch.floor(coords[..., 1] + 0.5).long()
    inside = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    pxc = px.clamp(1, w - 2)
    pyc = py.clamp(1, h - 2)

    def at(yy, xx):
        return torch.gather(hm, 2, (yy * w + xx)[..., None])[..., 0]

    dx = at(pyc, pxc + 1) - at(pyc, pxc - 1)
    dy = at(pyc + 1, pxc) - at(pyc - 1, pxc)
    diff = torch.stack([dx, dy], dim=-1)
    return coords + torch.sign(diff) * 0.25 * inside[..., None].float()


def transform_preds(coords: torch.Tensor, center: torch.Tensor,
                    scale: torch.Tensor, pixel_std: float,
                    output_size: Sequence[int]) -> torch.Tensor:
    """Heatmap-space (N, J, 2) coords -> original image coords through the
    rot-0 inverse affine of each box (reference utils.py:116-122)."""
    mats = affine_matrix_batched(center, scale, 0.0, output_size, pixel_std,
                                 inv=True)
    ones = torch.ones(coords.shape[:-1] + (1,), dtype=coords.dtype,
                      device=coords.device)
    homo = torch.cat([coords, ones], dim=-1)
    return torch.einsum('nij,nkj->nki', mats, homo)


def get_final_preds(heatmaps, center, scale, pixel_std: float = 200.0,
                    post_processing: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/eval decode (reference utils.py:154-182): argmax, subpixel
    shift, inverse affine. heatmaps (N, H, W, J) and center/scale (N, 2),
    tensors or arrays; returns preds (N, J, 2) xy in image coords and
    maxvals (N, J, 1) on the heatmaps' device."""
    heatmaps = torch.as_tensor(heatmaps)
    dev = heatmaps.device
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    coords, maxvals = get_max_preds(heatmaps)
    if post_processing:
        coords = subpixel_refine(heatmaps, coords)
    h, w = heatmaps.shape[1], heatmaps.shape[2]
    return transform_preds(coords, center, scale, pixel_std, [w, h]), maxvals


def flip_back(heatmaps: torch.Tensor,
              matched_parts: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Un-flip (N, H, W, J) heatmaps of a horizontally flipped input:
    reverse the width and swap each L/R joint pair (reference
    utils.py:19-29)."""
    flipped = torch.flip(heatmaps, dims=[2])
    perm = list(range(flipped.shape[-1]))
    for a, b in matched_parts:
        perm[a], perm[b] = perm[b], perm[a]
    return flipped[..., perm]


def flip_test_average(heatmaps: torch.Tensor, heatmaps_flipped: torch.Tensor,
                      matched_parts: Sequence[Tuple[int, int]],
                      shift: bool = False) -> torch.Tensor:
    """Average the heatmaps and the un-flipped heatmaps of the flipped
    input (reference testing/Test.py:134-141). ``shift=True`` adds the
    official implementation's one-pixel shift, which the reference leaves
    out."""
    back = flip_back(heatmaps_flipped, matched_parts)
    if shift:
        back = torch.cat([back[:, :, :1, :], back[:, :, :-1, :]], dim=2)
    return (heatmaps + back) * 0.5
