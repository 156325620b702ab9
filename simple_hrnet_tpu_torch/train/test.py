"""Checkpoint evaluation harness (reference testing/Test.py:16-178).

Counterpart of ``simple_hrnet_tpu/train/test.py``: loads a checkpoint
(``.npz`` in the JAX package's layout, or ``.pth``), runs the no-grad
eval loop with the optional flip-test average, and reports the mean loss
and PCK accuracy.

``mesh`` evaluates data-parallel (JAX test.py's sharded eval): one
process over the mesh's devices (each batch padded to a multiple of
them by repeating its last row and split, one model replica a device),
or one process a device in a distributed job (each process its rows of
the padded global batch); the outputs are gathered and the padding
dropped before the metrics.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from simple_hrnet_tpu_torch.models.convert import load_into
from simple_hrnet_tpu_torch.parallel import distributed
from simple_hrnet_tpu_torch.train import losses as losses_mod
from simple_hrnet_tpu_torch.train import steps as steps_mod
from simple_hrnet_tpu_torch.train.trainer import build_model
from simple_hrnet_tpu_torch.utils import checkpoint as ckpt
from simple_hrnet_tpu_torch.utils.device import resolve_device


class Test:
    def __init__(self,
                 ds_test,
                 batch_size: int = 1,
                 num_workers: int = 4,
                 loss: str = 'JointsMSELoss',
                 checkpoint_path: Optional[str] = None,
                 model_c: int = 48,
                 model_nof_joints: int = 17,
                 model_bn_momentum: float = 0.1,
                 flip_test_images: bool = True,
                 model_name: str = 'HRNet',
                 mesh=None,
                 device=None):
        self.mesh = mesh
        self.multi = mesh is not None and mesh.group is not None
        self.device = mesh.devices[0] if mesh is not None \
            else resolve_device(device)
        self.ds_test = ds_test
        self.flip_test_images = flip_test_images

        self.model = build_model(model_name, model_c, model_nof_joints, 0,
                                 self.device)
        if checkpoint_path is not None:
            load_into(self.model, ckpt.load(checkpoint_path))

        self.loss_fn = losses_mod.get_loss(loss)
        flip_pairs = getattr(ds_test, 'flip_pairs', None) \
            if flip_test_images else None
        self._eval_step = steps_mod.make_eval_step(
            self.model, self.loss_fn, flip_pairs=flip_pairs, mesh=mesh)

        from simple_hrnet_tpu_torch.data.loader import DataLoader
        shard = (mesh.process_index, mesh.process_count) if self.multi \
            else None
        self.dl_test = DataLoader(ds_test, batch_size=batch_size,
                                  shuffle=False, num_workers=num_workers,
                                  shard=shard)
        self.len_dl_test = len(self.dl_test)
        self.mean_loss_test = 0.
        self.mean_acc_test = 0.

    def _test(self):
        self.mean_loss_test = 0.
        self.mean_acc_test = 0.
        for step, (image, target, target_weight, joints_data) in enumerate(
                self.dl_test):
            true_n = self.dl_test.batch_rows(step)
            batch = {'image': image, 'target': target,
                     'target_weight': target_weight}
            if self.mesh is not None and not self.multi:
                pad = (-len(image)) % self.mesh.local_size
                batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)])
                         for k, v in batch.items()}
            loss, output = self._eval_step(batch)
            if self.multi:
                target = distributed.all_gather_rows(
                    torch.as_tensor(np.asarray(target), device=self.device),
                    self.mesh)
            output, target = output[:true_n], target[:true_n]
            accs, avg_acc, cnt, joints_preds, joints_target = \
                self.ds_test.evaluate_accuracy(output, target)
            self.mean_loss_test += float(loss)
            self.mean_acc_test += float(avg_acc)
        self.mean_loss_test /= self.len_dl_test
        self.mean_acc_test /= self.len_dl_test
        print(f'\nTest: Loss {self.mean_loss_test:f} - '
              f'Accuracy {self.mean_acc_test:f}')

    def run(self):
        self._test()
        return self.mean_loss_test, self.mean_acc_test
