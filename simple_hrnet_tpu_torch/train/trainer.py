"""Training harness: ``Train`` and ``COCOTrain`` (reference
training/Train.py:19-372, training/COCO.py:11-262).

Counterpart of ``simple_hrnet_tpu/train/trainer.py``, with its constructor
surface plus ``device``. Per epoch: the train step over the prefetching
loader, PCK and COCO AP (OKS-NMS and the evaluator), flip-test
validation, the multi-step LR stepped per step, tensorboard scalars and
image grids, and checkpoints: ``checkpoint_last`` (``save_train``) and
``params_{last,best_loss,best_acc,best_mAP}.npz`` in the JAX package's
layout. The model trains unfolded, in ``train()`` mode, through autograd
over cuDNN convs; it is never packed for the inference kernels.

``mesh`` trains data-parallel, one process a device (``torchrun
--nproc_per_node=N``, then ``parallel/distributed.initialize()`` and
``parallel.make_mesh()``), as the JAX trainer shards its batches over a
mesh (its trainer.py:206-218, 251-253, 290-296): the loaders give each
process its rows of the same shuffled global batches (``DataLoader``'s
``shard``), the steps return the global loss and heatmaps
(``train/steps.py``), the batches' metadata is gathered, the evaluation
batch is padded to a multiple of the data axis and the padding dropped
before the metrics, and only process 0 writes logs and checkpoints. A
mesh over more local devices than one raises: training takes one process
a device.
"""

from __future__ import annotations

import contextlib
import os
from datetime import datetime
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from simple_hrnet_tpu_torch.models import hrnet, poseresnet
from simple_hrnet_tpu_torch.ops import decode as D
from simple_hrnet_tpu_torch.parallel import distributed as dist_mod
from simple_hrnet_tpu_torch.train import losses as losses_mod
from simple_hrnet_tpu_torch.train import steps as steps_mod
from simple_hrnet_tpu_torch.utils import checkpoint as ckpt
from simple_hrnet_tpu_torch.utils.device import resolve_device


def build_model(model_name: str, model_c: int, model_nof_joints: int,
                seed: int, device: torch.device) -> nn.Module:
    """A fresh HRNet-W``model_c`` or PoseResNet-``model_c`` on ``device``
    (seeded torch-default init), channels_last on a card."""
    if model_name in ('HRNet', 'hrnet'):
        model = hrnet.init(model_c, model_nof_joints, seed=seed)
    else:
        model = poseresnet.init(model_c, model_nof_joints, seed=seed)
    model.to(device)
    if device.type == 'cuda':
        model.to(memory_format=torch.channels_last)
    return model


def _merge_matching(model: nn.Module, state_dict) -> nn.Module:
    """Load the entries of ``state_dict`` whose name and shape match the
    model's (the reference's ``strict=False`` load, Train.py:183-191)."""
    own = model.state_dict()
    keep = {k: v for k, v in state_dict.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict(keep, strict=False)
    return model


class Train:
    """Generic trainer with the reference's constructor surface
    (Train.py:29-57), the JAX package's additions, and ``device``
    (``None``: the card; ``'cpu'`` only when asked)."""

    def __init__(self,
                 exp_name: str,
                 ds_train,
                 ds_val,
                 epochs: int = 210,
                 batch_size: int = 16,
                 num_workers: int = 4,
                 loss: str = 'JointsMSELoss',
                 lr: float = 0.001,
                 lr_decay: bool = True,
                 lr_decay_steps=(170, 200),
                 lr_decay_gamma: float = 0.1,
                 optimizer: str = 'Adam',
                 weight_decay: float = 0.,
                 momentum: float = 0.9,
                 nesterov: bool = False,
                 pretrained_weight_path: Optional[str] = None,
                 checkpoint_path: Optional[str] = None,
                 log_path: str = './logs',
                 use_tensorboard: bool = True,
                 model_c: int = 48,
                 model_nof_joints: int = 17,
                 model_bn_momentum: float = 0.1,
                 flip_test_images: bool = True,
                 model_name: str = 'HRNet',
                 mesh=None,
                 seed: int = 0,
                 resume_dir: Optional[str] = None,
                 debug_nans: bool = False,
                 dtype: Optional[str] = None,
                 use_grouped_trunk: bool = False,
                 use_process_workers: bool = False,
                 device_targets: bool = False,
                 device=None):
        steps_mod.check_train_mesh(mesh)
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None \
            else resolve_device(device)
        # only process 0 writes logs and checkpoints
        self.is_writer = mesh is None or mesh.process_index == 0
        self.exp_name = exp_name
        self.ds_train = ds_train
        self.ds_val = ds_val
        self.epochs = epochs
        self.batch_size = batch_size
        self.loss_name = loss
        self.model_c = model_c
        self.model_nof_joints = model_nof_joints
        self.model_bn_momentum = model_bn_momentum
        self.flip_test_images = flip_test_images
        self.debug_nans = debug_nans
        self.epoch = 0

        ts = datetime.now().strftime('%Y%m%d_%H%M')
        if mesh is not None:  # one experiment directory for every process
            ts = dist_mod.all_gather_objects(ts, mesh)[0]
        self.log_path = os.path.join(log_path, f'{ts}_{exp_name}')

        self.use_tensorboard = use_tensorboard
        self.summary_writer = None
        if self.is_writer:
            os.makedirs(self.log_path, exist_ok=True)
            if use_tensorboard:
                import tensorboardX
                self.summary_writer = tensorboardX.SummaryWriter(
                    self.log_path)
            parameters = {k: v for k, v in locals().items()
                          if k not in ('self', 'ds_train', 'ds_val')}
            with open(os.path.join(self.log_path, 'parameters.txt'),
                      'w') as fd:
                fd.write(str(parameters))
            if self.summary_writer is not None:
                self.summary_writer.add_text('parameters', str(parameters))

        if use_grouped_trunk and model_name in ('HRNet', 'hrnet'):
            # the JAX package packs ``group`` images of the batch
            # block-diagonally on the channels, with BN statistics pooled
            # over the whole batch (its train/grouped.py): a layout for the
            # TPU's 128 lanes that computes the plain trunk's function.
            # The port keeps its batch rule and trains the plain trunk.
            group = min(4, max(2, 128 // model_c))
            if batch_size % group:
                raise ValueError(
                    f'use_grouped_trunk needs batch_size divisible by '
                    f'{group} (got {batch_size})')
        self.model = build_model(model_name, model_c, model_nof_joints, seed,
                                 self.device)
        self.loss_fn = losses_mod.get_loss(loss)

        if pretrained_weight_path is not None:
            _merge_matching(self.model, ckpt.load(pretrained_weight_path))
            print(f'Pre-trained weights loaded from {pretrained_weight_path}')

        from simple_hrnet_tpu_torch.data.loader import DataLoader
        # data parallel: each process its rows of the same global batches
        self.multi = mesh is not None and mesh.group is not None
        shard = (mesh.process_index, mesh.process_count) if self.multi \
            else None
        self.dl_train = DataLoader(ds_train, batch_size=batch_size,
                                   shuffle=True, num_workers=num_workers,
                                   drop_last=True, seed=seed,
                                   use_processes=use_process_workers,
                                   shard=shard)
        self.dl_val = DataLoader(ds_val, batch_size=batch_size,
                                 shuffle=False, num_workers=num_workers,
                                 use_processes=use_process_workers,
                                 shard=shard)
        self.len_dl_train = len(self.dl_train)
        self.len_dl_val = len(self.dl_val)

        self.optimizer, self.scheduler = steps_mod.make_optimizer(
            self.model, optimizer, lr=lr, momentum=momentum,
            nesterov=nesterov, weight_decay=weight_decay, lr_decay=lr_decay,
            lr_decay_steps=lr_decay_steps, lr_decay_gamma=lr_decay_gamma,
            steps_per_epoch=self.len_dl_train)

        # resume (Train.py:195-204); ``resume_dir`` continues from a
        # checkpoint_last that an earlier run of the experiment left
        if checkpoint_path is None and resume_dir is not None:
            cand = os.path.join(resume_dir, 'checkpoint_last')
            if os.path.isdir(cand):
                checkpoint_path = cand
        resumed = {}
        if checkpoint_path is not None:
            print(f'Loading checkpoint {checkpoint_path} ...')
            step, state, cfg = ckpt.load_train(checkpoint_path)
            self.model.load_state_dict(state['model'])
            self.optimizer.load_state_dict(state['optimizer'])
            if state['scheduler'] is not None:
                self.scheduler.load_state_dict(state['scheduler'])
            resumed = cfg or state['config'] or {}
            self.epoch = resumed.get('epoch', state['epoch'])
            print(f'Resuming from epoch {self.epoch}')

        # device_targets: the datasets emit the raw pipeline tail and the
        # steps normalize and stamp the targets on the device
        self.device_targets = device_targets
        dt_cfg = dt_cfg_val = None
        if device_targets:
            if not getattr(ds_train, 'device_targets', False) or (
                    ds_val is not None
                    and not getattr(ds_val, 'device_targets', False)):
                raise ValueError(
                    'Train(device_targets=True) needs BOTH datasets built '
                    'with device_targets=True (they must emit the raw '
                    'pipeline tail)')

            def _dt_cfg(ds):
                # each step stamps with its own dataset's geometry
                jw = ds.joints_weight \
                    if getattr(ds, 'use_different_joints_weight', False) \
                    else None
                return {'heatmap_size': tuple(ds.heatmap_size),
                        'image_size': tuple(ds.image_size),
                        'heatmap_sigma': ds.heatmap_sigma,
                        'joints_weight': None if jw is None
                        else np.asarray(jw, np.float32)}

            dt_cfg = _dt_cfg(ds_train)
            dt_cfg_val = _dt_cfg(ds_val) if ds_val is not None else dt_cfg

        self._train_step = steps_mod.make_train_step(
            self.model, self.loss_fn, self.optimizer, self.scheduler,
            dtype=dtype, device_targets=dt_cfg,
            bn_momentum=model_bn_momentum, mesh=mesh)
        flip_pairs = getattr(ds_val, 'flip_pairs', None) \
            if flip_test_images else None
        self._eval_step = steps_mod.make_eval_step(
            self.model, self.loss_fn, flip_pairs=flip_pairs, dtype=dtype,
            device_targets=dt_cfg_val, mesh=mesh)

        # the bests come back with a resume, so that a later epoch cannot
        # overwrite params_best_*.npz with a worse model
        self.best_loss = resumed.get('best_loss')
        self.best_acc = resumed.get('best_acc')
        self.best_mAP = resumed.get('best_mAP')
        self.mean_loss_train = 0.
        self.mean_acc_train = 0.
        self.mean_loss_val = 0.
        self.mean_acc_val = 0.
        # None until a subclass computes an overall metric
        self.mean_mAP_val = None

    def _make_batch(self, image, second, third):
        """The step's batch dict: (image, target, target_weight), or with
        device_targets (raw [0, 255] image, joints, joints_vis)."""
        keys = (('image', 'joints', 'joints_vis') if self.device_targets
                else ('image', 'target', 'target_weight'))
        return dict(zip(keys, (image, second, third)))

    def _global(self, res, batch, joints_data, true_n=None):
        """(loss, heatmaps, targets, metadata) of the global batch from a
        step's result on this process's rows: the steps gather the
        heatmaps and targets, the metadata is gathered here; with
        ``true_n``, the padding rows past it are dropped."""
        loss, output = res[0], res[1]
        if self.device_targets:
            target = res[2]
        else:
            target = batch['target']
            if self.multi:
                target = dist_mod.all_gather_rows(torch.as_tensor(
                    np.asarray(target), device=self.device), self.mesh)
        if self.multi:
            joints_data = dist_mod.all_gather_meta(joints_data, self.mesh)
        if true_n is not None and output.shape[0] > true_n:
            output, target = output[:true_n], target[:true_n]
            joints_data = _trim_meta(joints_data, true_n)
        return loss, output, target, joints_data

    def _train(self):
        self.mean_loss_train = 0.
        self.mean_acc_train = 0.
        # epoch e shuffles with seed + e however the run got to it, so a
        # resumed run sees the batches a straight run would
        self.dl_train.set_epoch(self.epoch)
        anomaly = (torch.autograd.detect_anomaly(check_nan=True)
                   if self.debug_nans else contextlib.nullcontext())
        for step, (image, second, third, joints_data) in enumerate(
                self.dl_train):
            batch = self._make_batch(image, second, third)
            with anomaly:
                res = self._train_step(batch)
            loss, output, target, joints_data = self._global(
                res, batch, joints_data)
            accs, avg_acc, cnt, joints_preds, joints_target = \
                self.ds_train.evaluate_accuracy(output, target)
            loss = float(loss)
            avg_acc = float(avg_acc)
            self.mean_loss_train += loss
            self.mean_acc_train += avg_acc
            self._log_step('train', step, loss, avg_acc, image, target,
                           joints_target, output, joints_preds, joints_data)
        self.mean_loss_train /= self.len_dl_train
        self.mean_acc_train /= self.len_dl_train
        print(f'\nTrain: Loss {self.mean_loss_train:f} - '
              f'Accuracy {self.mean_acc_train:f}')

    def _val(self):
        self.mean_loss_val = 0.
        self.mean_acc_val = 0.
        for step, (image, second, third, joints_data) in enumerate(
                self.dl_val):
            batch = self._make_batch(image, second, third)
            res = self._eval_step(batch)
            loss, output, target, joints_data = self._global(
                res, batch, joints_data, self.dl_val.batch_rows(step))
            accs, avg_acc, cnt, joints_preds, joints_target = \
                self.ds_val.evaluate_accuracy(output, target)
            self.mean_loss_val += float(loss)
            self.mean_acc_val += float(avg_acc)
            self._log_step('val', step, float(loss), float(avg_acc), image,
                           target, joints_target, output, joints_preds,
                           joints_data)
        self.mean_loss_val /= self.len_dl_val
        self.mean_acc_val /= self.len_dl_val
        print(f'\nValidation: Loss {self.mean_loss_val:f} - '
              f'Accuracy {self.mean_acc_val:f}')

    def _log_step(self, prefix, step, loss, acc, image, target,
                  joints_target, output, joints_preds, joints_data):
        if self.summary_writer is None:
            return
        steps_per = self.len_dl_train if prefix == 'train' else self.len_dl_val
        global_step = step + self.epoch * steps_per
        self.summary_writer.add_scalar(f'{prefix}_loss', loss, global_step)
        self.summary_writer.add_scalar(f'{prefix}_acc', acc, global_step)
        if step == 0:
            from simple_hrnet_tpu_torch.utils.visualization import save_images
            image = np.asarray(image)
            if self.device_targets:
                # save_images denormalizes an ImageNet-normalized image
                from simple_hrnet_tpu_torch.data.coco import (INV255_STD,
                                                              MEAN255)
                image = (image - MEAN255) * INV255_STD

            def host(t):
                return t.detach().cpu().numpy() if isinstance(
                    t, torch.Tensor) else np.asarray(t)

            # under a mesh the image is this process's (the first) rows
            n = len(image)
            save_images(image, host(target)[:n], host(joints_target)[:n],
                        host(output)[:n], host(joints_preds)[:n],
                        joints_data['joints_visibility'][:n],
                        self.summary_writer, step=global_step,
                        prefix=f'{prefix}_')

    def _checkpoint(self):
        """last and best loss/acc/mAP (Train.py:313-332), by process 0."""
        if not self.is_writer:
            return
        if self.best_loss is None or self.best_loss > self.mean_loss_val:
            self.best_loss = self.mean_loss_val
            print(f'best_loss {self.best_loss:f} at epoch {self.epoch + 1}')
            ckpt.save(os.path.join(self.log_path, 'params_best_loss.npz'),
                      self.model)
        if self.best_acc is None or self.best_acc < self.mean_acc_val:
            self.best_acc = self.mean_acc_val
            print(f'best_acc {self.best_acc:f} at epoch {self.epoch + 1}')
            ckpt.save(os.path.join(self.log_path, 'params_best_acc.npz'),
                      self.model)
        # a best mAP only where the trainer computed the metric
        if self.mean_mAP_val is not None and (
                self.best_mAP is None or self.best_mAP < self.mean_mAP_val):
            self.best_mAP = self.mean_mAP_val
            print(f'best_mAP {self.best_mAP:f} at epoch {self.epoch + 1}')
            ckpt.save(os.path.join(self.log_path, 'params_best_mAP.npz'),
                      self.model)

        # checkpoint_last carries the updated bests for a resume
        ckpt.save_train(os.path.join(self.log_path, 'checkpoint_last'),
                        self.epoch + 1, self.model, self.optimizer,
                        self.scheduler,
                        config={'epoch': self.epoch + 1,
                                'model_c': self.model_c,
                                'nof_joints': self.model_nof_joints,
                                'best_loss': self.best_loss,
                                'best_acc': self.best_acc,
                                'best_mAP': self.best_mAP})
        ckpt.save(os.path.join(self.log_path, 'params_last.npz'), self.model)

    def run(self):
        """Epoch loop (Train.py:334-370)."""
        for self.epoch in range(self.epoch, self.epochs):
            print(f'\nEpoch {self.epoch + 1} of {self.epochs} '
                  f'@ {datetime.now().strftime("%Y-%m-%d %H:%M:%S")}')
            self._train()
            self._val()
            self._checkpoint()


class COCOTrain(Train):
    """COCO trainer adding the per-epoch COCO AP (training/COCO.py:11)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._reset_epoch_preds()

    def _reset_epoch_preds(self):
        self._all_preds = []
        self._all_boxes = []
        self._image_paths = []

    def _accumulate(self, output, joints_data):
        c = np.asarray(joints_data['center'])
        s = np.asarray(joints_data['scale'])
        score = np.asarray(joints_data['score'])
        preds, maxvals = D.get_final_preds(output, c, s, 200.0)
        preds = preds.cpu().numpy()
        maxvals = maxvals.cpu().numpy()
        n = preds.shape[0]
        boxes = np.zeros((n, 6), np.float32)
        boxes[:, 0:2] = c
        boxes[:, 2:4] = s
        boxes[:, 4] = np.prod(s * 200.0, axis=1)
        boxes[:, 5] = score
        self._all_preds.append(
            np.concatenate([preds, maxvals], axis=2).astype(np.float32))
        self._all_boxes.append(boxes)
        self._image_paths.extend(list(joints_data['imgPath']))

    def _log_step(self, prefix, step, loss, acc, image, target,
                  joints_target, output, joints_preds, joints_data):
        super()._log_step(prefix, step, loss, acc, image, target,
                          joints_target, output, joints_preds, joints_data)
        self._accumulate(output, joints_data)

    def _train(self):
        self._reset_epoch_preds()
        super()._train()
        print('\nTrain AP/AR')
        self.train_accs, self.mean_mAP_train = self._overall(self.ds_train)

    def _val(self):
        self._reset_epoch_preds()
        super()._val()
        print('\nVal AP/AR')
        self.val_accs, self.mean_mAP_val = self._overall(self.ds_val)

    def _overall(self, ds):
        if not self._all_preds or not self.is_writer:
            return {}, 0.0
        preds = np.concatenate(self._all_preds)
        boxes = np.concatenate(self._all_boxes)
        return ds.evaluate_overall_accuracy(
            preds, boxes, self._image_paths, output_dir=self.log_path)


class MPIITrain(COCOTrain):
    """MPII trainer (the JAX package's trainer.py:446-490): the COCO
    trainer's per-epoch accumulation of final predictions in original image
    coordinates, with PCKh@0.5 (``data/mpii.py``) as the overall metric.
    Predictions are matched to their annotations by the dataset row each
    batch carries (``joints_data['index']``), so the metric holds off the
    shuffled ``drop_last`` train loader; the train-mode PCKh stays
    approximate for flipped or rotated samples (the un-warp ignores the
    augmentation, as the reference's train AP does): the val number is the
    one to read."""

    def _reset_epoch_preds(self):
        super()._reset_epoch_preds()
        self._indices = []

    def _accumulate(self, output, joints_data):
        super()._accumulate(output, joints_data)
        if 'index' in joints_data:
            self._indices.extend(
                int(i) for i in np.asarray(joints_data['index']).ravel())

    def _overall(self, ds):
        if not self._all_preds or not self.is_writer:
            return {}, 0.0
        preds = np.concatenate(self._all_preds)
        boxes = np.concatenate(self._all_boxes)
        idx = self._indices if len(self._indices) == len(preds) else None
        return ds.evaluate_overall_accuracy(
            preds, boxes, self._image_paths, output_dir=self.log_path,
            indices=idx)

    def _train(self):
        self._reset_epoch_preds()
        Train._train(self)
        print('\nTrain PCKh@0.5')
        self.train_accs, self.mean_mAP_train = self._overall(self.ds_train)

    def _val(self):
        self._reset_epoch_preds()
        Train._val(self)
        print('\nVal PCKh@0.5')
        self.val_accs, self.mean_mAP_val = self._overall(self.ds_val)


def _trim_meta(meta: dict, n: int) -> dict:
    """A gathered ``joints_data`` without its rows past ``n``."""
    return {k: v[:n] if isinstance(v, (np.ndarray, list)) else v
            for k, v in meta.items()}
