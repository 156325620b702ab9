"""Affine transforms of the reference's center/scale/rotation geometry.

Counterpart of ``simple_hrnet_tpu/ops/affine.py``. The reference builds a
2x3 warp from three point correspondences with ``cv2.getAffineTransform``
(misc/utils.py:46-75):
  src0 = center + scale_tmp * shift
  src1 = src0 + R(rot) @ [0, -src_w/2]
  src2 = src1 + perp(src0 - src1)
  dst0 = [dst_w/2, dst_h/2]; dst1 = dst0 + [0, -dst_w/2]; dst2 likewise.
``affine_matrix`` solves that system in numpy (the data pipeline's warp);
``affine_matrix_batched`` is the closed form of the same similarity
transform in torch, batched over boxes, for the decode.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _three_points(center, scale, rot, output_size, pixel_std, shift):
    """The three src/dst points the reference feeds cv2 (utils.py:56-68)."""
    scale_tmp = np.asarray(scale, np.float32) * float(pixel_std)
    src_w = scale_tmp[0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    src_dir = np.array([src_w * 0.5 * sn, src_w * -0.5 * cs], np.float32)
    dst_dir = np.array([0.0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = (np.asarray(center, np.float32)
              + scale_tmp * np.asarray(shift, np.float32))
    src[1] = src[0] + src_dir
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    d = src[0] - src[1]
    src[2] = src[1] + np.array([-d[1], d[0]], np.float32)
    d = dst[0] - dst[1]
    dst[2] = dst[1] + np.array([-d[1], d[0]], np.float32)
    return src, dst


def affine_matrix(center, scale, rot, output_size, pixel_std=200.0,
                  shift=(0.0, 0.0), inv=False) -> np.ndarray:
    """2x3 f32 matrix of the reference's ``get_affine_transform``, solved
    exactly from the three-point correspondence."""
    src, dst = _three_points(center, scale, rot, output_size, pixel_std,
                             shift)
    if inv:
        src, dst = dst, src
    m = np.concatenate([src, np.ones((3, 1), np.float32)], axis=1)
    sol = np.linalg.solve(m, dst)  # (3, 2)
    return sol.T.astype(np.float32)


def affine_matrix_batched(center: torch.Tensor, scale: torch.Tensor,
                          rot, output_size, pixel_std: float = 200.0,
                          inv: bool = False) -> torch.Tensor:
    """(N, 2, 3) f32 matrices in closed form (shift 0), on ``center``'s
    device: the forward map is dst = k R(-rot) (p - c) + dst0 with
    k = dst_w / src_w, the inverse p = R(rot) (dst - dst0) / k + c."""
    center = torch.as_tensor(center, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32,
                            device=center.device)
    rot = torch.as_tensor(rot, dtype=torch.float32,
                          device=center.device).expand(center.shape[0])
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    k = dst_w / (scale[:, 0] * pixel_std)
    rad = rot * (math.pi / 180.0)
    sn, cs = torch.sin(rad), torch.cos(rad)
    dst0 = torch.tensor([dst_w * 0.5, dst_h * 0.5], device=center.device)
    if inv:
        rm = torch.stack([torch.stack([cs, -sn], -1),
                          torch.stack([sn, cs], -1)], 1) / k[:, None, None]
        t = center - torch.einsum('nij,j->ni', rm, dst0)
    else:
        rm = torch.stack([torch.stack([cs, sn], -1),
                          torch.stack([-sn, cs], -1)], 1) * k[:, None, None]
        t = dst0 - torch.einsum('nij,nj->ni', rm, center)
    return torch.cat([rm, t[:, :, None]], dim=2)


def apply_affine(points: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Apply a 2x3 matrix to (..., 2) points (reference utils.py:78-81)."""
    pts = np.asarray(points, np.float32)
    return pts @ mat[:, :2].T + mat[:, 2]
