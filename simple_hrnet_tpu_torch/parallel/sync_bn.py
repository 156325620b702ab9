"""Batch normalization with the statistics of the global batch.

JAX's data-parallel step normalizes with the statistics of the whole
global batch: they are one jit program's reductions (its
``layers.batch_norm``, ``lax.pmean`` of each channel's mean and mean
square). ``nn.SyncBatchNorm`` refuses CPU tensors, so it cannot be the
one path that the gloo CPU tests and the card share. ``GlobalBatchNorm2d``
is: in train mode it sums each channel's values, squares and count over
this process's rows in f32, all-reduces the three with the differentiable
``torch.distributed.nn.functional.all_reduce`` (its backward all-reduces
the gradients, so each process's input gradient carries every process's
loss), and normalizes as the JAX package does: var = E[x^2] - E[x]^2,
``(x - mean) * rsqrt(var + eps) * scale + bias`` in f32, returned in the
input's type. The running statistics take torch's momentum rule with the
global unbiased variance. In eval mode it is ``nn.BatchNorm2d``.

``convert`` swaps it in place of every ``BatchNorm2d`` of a model, keeping
the parameter and buffer objects (an optimizer built before keeps them)
and the state-dict names. ``train/steps.make_train_step`` does so where
the mesh spans more than one process: on one rank ``BatchNorm2d``'s
statistics are the global ones already, and its fused kernels are several
times cheaper than this module's separate reductions (PERF.md §5).
"""

from __future__ import annotations

import torch
import torch.nn as nn


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode statistics span ``self.group``."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        from torch.distributed.nn.functional import all_reduce

        c = x.shape[1]
        x32 = x.float()
        n_local = x.numel() // c
        stats = torch.cat([x32.sum(dim=(0, 2, 3)),
                           (x32 * x32).sum(dim=(0, 2, 3)),
                           x32.new_full((1,), float(n_local))])
        stats = all_reduce(stats, group=self.group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = stats[c:2 * c] / n - mean * mean
        if self.track_running_stats:
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (n / (n - 1))
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(unbiased, alpha=m)
                self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[None, :, None, None]) * inv[None, :, None, None] \
            + self.bias[None, :, None, None]
        return y.to(x.dtype)


def convert(model: nn.Module, group) -> nn.Module:
    """Every ``nn.BatchNorm2d`` of ``model`` becomes a
    ``GlobalBatchNorm2d`` over ``group``, in place (the same parameters,
    buffers and state-dict names); returns ``model``."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.__class__ = GlobalBatchNorm2d
            m.group = group
    return model
