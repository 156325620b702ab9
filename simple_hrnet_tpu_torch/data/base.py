"""Abstract human-pose-estimation dataset (reference
datasets/HumanPoseEstimation.py:4-19).

Counterpart of ``simple_hrnet_tpu/data/base.py``: the map-style protocol
that ``data/loader.DataLoader`` and the train/test harnesses consume,
``__len__`` and ``__getitem__`` -> (image HWC f32, target (h, w, J),
target_weight (J, 1), metadata dict), plus PCK evaluation.
"""

from __future__ import annotations


class HumanPoseEstimationDataset:
    """Generic base class for HPE datasets."""

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, item):
        raise NotImplementedError

    def evaluate_accuracy(self, output, target, params=None):
        """PCK accuracy on (N, H, W, J) heatmaps, on ``output``'s device."""
        from simple_hrnet_tpu_torch.utils import metrics
        kw = {}
        if params is not None:
            kw = {'thr': params['thr']}
        return metrics.evaluate_pck_accuracy(output, target, **kw)
