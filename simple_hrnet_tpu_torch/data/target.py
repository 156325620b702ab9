"""Gaussian heatmap targets (reference datasets/COCO.py:460-515).

Counterpart of ``simple_hrnet_tpu/data/target.py``, with the same two
implementations:
  * ``generate_target``: host numpy, the reference's stamping (the data
    pipeline's workers run it);
  * ``generate_target_device``: batched torch on the joints' device, for
    the train step's ``device_targets`` mode.

An unnormalized gaussian (peak 1) of sigma ``heatmap_sigma`` is stamped at
the stride-quantized joint position; joints whose gaussian window falls
wholly outside the heatmap get weight 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

COCO_JOINTS_WEIGHT = np.asarray(
    [1., 1., 1., 1., 1., 1., 1., 1.2, 1.2, 1.5, 1.5, 1., 1., 1.2, 1.2,
     1.5, 1.5], np.float32).reshape(17, 1)


def generate_target(joints: np.ndarray, joints_vis: np.ndarray,
                    heatmap_size: Tuple[int, int],
                    image_size: Tuple[int, int],
                    heatmap_sigma: float = 3,
                    joints_weight: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """COCODataset._generate_target: joints (J, 2) xy in image coords,
    joints_vis (J, 2), sizes as (width, height) (COCO.py:105-107).
    Returns target (J, hm_h, hm_w) f32 and target_weight (J, 1)."""
    nof_joints = joints.shape[0]
    target_weight = np.ones((nof_joints, 1), np.float32)
    target_weight[:, 0] = joints_vis[:, 0]

    target = np.zeros((nof_joints, heatmap_size[1], heatmap_size[0]),
                      np.float32)
    tmp_size = heatmap_sigma * 3

    for joint_id in range(nof_joints):
        feat_stride = np.asarray(image_size) / np.asarray(heatmap_size)
        mu_x = int(joints[joint_id][0] / feat_stride[0] + 0.5)
        mu_y = int(joints[joint_id][1] / feat_stride[1] + 0.5)
        ul = [int(mu_x - tmp_size), int(mu_y - tmp_size)]
        br = [int(mu_x + tmp_size + 1), int(mu_y + tmp_size + 1)]
        if ul[0] >= heatmap_size[0] or ul[1] >= heatmap_size[1] \
                or br[0] < 0 or br[1] < 0:
            target_weight[joint_id] = 0
            continue

        size = int(2 * tmp_size + 1)
        x = np.arange(0, size, 1, np.float32)
        y = x[:, np.newaxis]
        x0 = y0 = size // 2
        g = np.exp(- ((x - x0) ** 2 + (y - y0) ** 2)
                   / (2 * heatmap_sigma ** 2))

        g_x = max(0, -ul[0]), min(br[0], heatmap_size[0]) - ul[0]
        g_y = max(0, -ul[1]), min(br[1], heatmap_size[1]) - ul[1]
        img_x = max(0, ul[0]), min(br[0], heatmap_size[0])
        img_y = max(0, ul[1]), min(br[1], heatmap_size[1])

        if target_weight[joint_id] > 0.5:
            target[joint_id][img_y[0]:img_y[1], img_x[0]:img_x[1]] = \
                g[g_y[0]:g_y[1], g_x[0]:g_x[1]]

    if joints_weight is not None:
        target_weight = np.multiply(target_weight, joints_weight)

    return target, target_weight


def generate_target_device(joints: torch.Tensor, joints_vis: torch.Tensor,
                           heatmap_size: Tuple[int, int],
                           image_size: Tuple[int, int],
                           heatmap_sigma: float = 3
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched (N, J, 2) joints -> target (N, hm_h, hm_w, J) NHWC and
    weight (N, J, 1), on the joints' device: the host version's stride
    quantization (truncation of x / stride + 0.5) and out-of-window
    weighting, computed densely as a product of two 1-D gaussians."""
    hm_w, hm_h = heatmap_size
    dev = joints.device
    stride = (torch.tensor(image_size, dtype=torch.float32, device=dev)
              / torch.tensor(heatmap_size, dtype=torch.float32, device=dev))
    tmp_size = heatmap_sigma * 3
    if tmp_size != int(tmp_size):
        # int() truncation moves the host stamp window by one near the
        # top/left edge for a fractional window, and a narrower gaussian
        # than the window crashes the host slice assignment: no dense form
        # reproduces it
        raise ValueError(
            f'generate_target_device requires heatmap_sigma*3 to be an '
            f'integer (got sigma={heatmap_sigma!r}); the reference '
            f'stamping (COCO.py:460-515) is ill-defined for fractional '
            f'windows: use host-side targets (device_targets=False).')

    mu = torch.trunc(joints / stride + 0.5).to(torch.int32)  # (N, J, 2)
    ul = mu - int(tmp_size)
    br = mu + int(tmp_size + 1)
    oob = ((ul[..., 0] >= hm_w) | (ul[..., 1] >= hm_h) |
           (br[..., 0] < 0) | (br[..., 1] < 0))
    weight = joints_vis[..., 0] * (~oob).float()  # (N, J)

    xs = torch.arange(hm_w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(hm_h, dtype=torch.float32, device=dev)[None, None, :]
    mx = mu[..., 0:1].float()
    my = mu[..., 1:2].float()
    gx = torch.exp(-torch.square(xs - mx) / (2 * heatmap_sigma ** 2))
    gy = torch.exp(-torch.square(ys - my) / (2 * heatmap_sigma ** 2))
    # cut to the reference's stamp window (3 sigma)
    gx = gx * (torch.abs(xs - mx) <= tmp_size)
    gy = gy * (torch.abs(ys - my) <= tmp_size)
    target = gy[:, :, :, None] * gx[:, :, None, :]          # (N, J, H, W)
    target = target * (weight[..., None, None] > 0.5)
    return target.permute(0, 2, 3, 1), weight[..., None]
