"""Training losses: JointsMSE and OHKM-MSE (reference losses/loss.py).

Counterpart of ``simple_hrnet_tpu/train/losses.py``:
  * ``joints_mse_loss``: per-joint 0.5 * MSE of the flattened heatmaps,
    masked by target_weight, averaged (loss.py:20-54);
  * ``joints_ohkm_mse_loss``: per-sample top-k (k = 8) hardest joints
    (loss.py:58-94). The reference's forward calls ``self.ohkm``, which
    does not exist (an AttributeError); this is the intended behaviour.

Heatmaps are NHWC (N, H, W, J); target_weight is (N, J, 1).
"""

from __future__ import annotations

from typing import Optional

import torch


def _per_joint_mse(output: torch.Tensor, target: torch.Tensor,
                   target_weight: Optional[torch.Tensor]) -> torch.Tensor:
    """0.5 * mean((w*pred - w*gt)^2) per (sample, joint) -> (N, J)."""
    n, j = output.shape[0], output.shape[3]
    pred = output.permute(0, 3, 1, 2).reshape(n, j, -1)
    gt = target.permute(0, 3, 1, 2).reshape(n, j, -1)
    if target_weight is not None:
        w = target_weight.reshape(n, j, 1)
        pred = pred * w
        gt = gt * w
    return 0.5 * torch.mean(torch.square(pred - gt), dim=2)


def joints_mse_loss(output: torch.Tensor, target: torch.Tensor,
                    target_weight: Optional[torch.Tensor] = None,
                    use_target_weight: bool = True) -> torch.Tensor:
    """JointsMSELoss.forward (loss.py:34-54): the sum over joints of the
    batch-mean MSE over the joint count is the mean over everything."""
    if use_target_weight and target_weight is None:
        raise NameError('target_weight is required when use_target_weight')
    tw = target_weight if use_target_weight else None
    return torch.mean(_per_joint_mse(output, target, tw))


def joints_ohkm_mse_loss(output: torch.Tensor, target: torch.Tensor,
                         target_weight: Optional[torch.Tensor] = None,
                         use_target_weight: bool = True,
                         topk: int = 8) -> torch.Tensor:
    """JointsOHKMMSELoss (loss.py:58-94, 6-16): per sample the mean of the
    top-k per-joint losses, then the batch mean."""
    tw = target_weight if use_target_weight else None
    per_joint = _per_joint_mse(output, target, tw)
    topk_vals, _ = torch.topk(per_joint, topk, dim=1)
    return torch.mean(torch.sum(topk_vals, dim=1) / topk)


def get_loss(name: str):
    """The reference's loss selection (training/Train.py:166-171)."""
    if name in ('JointsMSELoss', 'mse'):
        return joints_mse_loss
    if name in ('JointsOHKMMSELoss', 'ohkm'):
        return joints_ohkm_mse_loss
    raise NotImplementedError(f'Unknown loss {name!r}')
