"""MPII training entry point — same flag surface as cli/train_coco.py
(reference scripts/train_coco.py:114-153) with MPII-specific data flags.

Counterpart of ``simple_hrnet_tpu/cli/train_mpii.py``, with its flags and
defaults (HRNet-W32, 16 joints, 256x256, 210 epochs):

    python -m simple_hrnet_tpu_torch.cli.train_mpii -n EXP \
        --mpii_root_path ./datasets/MPII [--device cpu] [--dtype bfloat16]

or one process a card, ``torchrun --nproc_per_node=N -m
simple_hrnet_tpu_torch.cli.train_mpii --n_devices N -n EXP ...``
(``--n_devices`` above 1 without a launcher raises, naming that line).

The reference has no MPII trainer at all (datasets/ ships COCO only); this
mirrors its COCO script so the official ``pose_hrnet_*_mpii`` family can
be trained/fine-tuned here. 16 joints, PCKh@0.5 per epoch.
"""

from __future__ import annotations

import argparse
import ast
import random

import numpy as np


def main(exp_name,
         epochs=210,
         batch_size=16,
         num_workers=4,
         lr=0.001,
         disable_lr_decay=False,
         lr_decay_steps='(170, 200)',
         lr_decay_gamma=0.1,
         optimizer='Adam',
         weight_decay=0.,
         momentum=0.9,
         nesterov=False,
         pretrained_weight_path=None,
         checkpoint_path=None,
         log_path='./logs',
         disable_tensorboard_log=False,
         model_c=32,
         model_nof_joints=16,
         model_bn_momentum=0.1,
         disable_flip_test_images=False,
         image_resolution='(256, 256)',
         mpii_root_path='./datasets/MPII',
         seed=1,
         device=None,
         n_devices=None,
         dtype=None,
         device_targets=False):
    from simple_hrnet_tpu_torch.data.mpii import MPIIDataset
    from simple_hrnet_tpu_torch.parallel.distributed import cli_mesh
    from simple_hrnet_tpu_torch.train.trainer import MPIITrain

    mesh = cli_mesh(n_devices, device,
                    module='simple_hrnet_tpu_torch.cli.train_mpii')

    random.seed(seed)
    np.random.seed(seed)

    if isinstance(image_resolution, str):
        image_resolution = ast.literal_eval(image_resolution)
    if isinstance(lr_decay_steps, str):
        lr_decay_steps = ast.literal_eval(lr_decay_steps)

    print('\nLoading train and validation datasets...')
    ds_train = MPIIDataset(
        root_path=mpii_root_path, data_version='train', is_train=True,
        image_width=image_resolution[1], image_height=image_resolution[0],
        device_targets=device_targets)
    ds_val = MPIIDataset(
        root_path=mpii_root_path, data_version='valid', is_train=False,
        image_width=image_resolution[1], image_height=image_resolution[0],
        device_targets=device_targets)

    train = MPIITrain(
        exp_name=exp_name, ds_train=ds_train, ds_val=ds_val, epochs=epochs,
        batch_size=batch_size, num_workers=num_workers, loss='JointsMSELoss',
        lr=lr, lr_decay=not disable_lr_decay, lr_decay_steps=lr_decay_steps,
        lr_decay_gamma=lr_decay_gamma, optimizer=optimizer,
        weight_decay=weight_decay, momentum=momentum, nesterov=nesterov,
        pretrained_weight_path=pretrained_weight_path,
        checkpoint_path=checkpoint_path, log_path=log_path,
        use_tensorboard=not disable_tensorboard_log, model_c=model_c,
        model_nof_joints=model_nof_joints,
        model_bn_momentum=model_bn_momentum,
        flip_test_images=not disable_flip_test_images, mesh=mesh, seed=seed,
        dtype=dtype, device_targets=device_targets, device=device)
    train.run()
    return train


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('--exp_name', '-n', type=str, required=True)
    parser.add_argument('--epochs', '-e', type=int, default=210)
    parser.add_argument('--batch_size', '-b', type=int, default=16)
    parser.add_argument('--num_workers', '-w', type=int, default=4)
    parser.add_argument('--lr', '-l', type=float, default=0.001)
    parser.add_argument('--disable_lr_decay', action='store_true')
    parser.add_argument('--lr_decay_steps', type=str, default='(170, 200)')
    parser.add_argument('--lr_decay_gamma', type=float, default=0.1)
    parser.add_argument('--optimizer', '-o', type=str, default='Adam')
    parser.add_argument('--weight_decay', type=float, default=0.)
    parser.add_argument('--momentum', '-m', type=float, default=0.9)
    parser.add_argument('--nesterov', action='store_true')
    parser.add_argument('--pretrained_weight_path', '-p', type=str,
                        default=None)
    parser.add_argument('--checkpoint_path', '-c', type=str, default=None)
    parser.add_argument('--log_path', type=str, default='./logs')
    parser.add_argument('--disable_tensorboard_log', '-u',
                        action='store_true')
    parser.add_argument('--model_c', type=int, default=32)
    parser.add_argument('--model_nof_joints', type=int, default=16)
    parser.add_argument('--model_bn_momentum', type=float, default=0.1)
    parser.add_argument('--disable_flip_test_images', action='store_true')
    parser.add_argument('--image_resolution', '-r', type=str,
                        default='(256, 256)')
    parser.add_argument('--mpii_root_path', type=str,
                        default='./datasets/MPII')
    parser.add_argument('--seed', '-s', type=int, default=1)
    parser.add_argument('--device', '-d', type=str, default=None,
                        help="'cuda' (the default) or 'cpu'")
    parser.add_argument('--n_devices', type=int, default=None,
                        help='data-parallel devices: more than 1 runs under '
                             'torchrun --nproc_per_node=N, one process a '
                             'device')
    parser.add_argument('--device_targets', action='store_true',
                        help='run the ImageNet normalize and the gaussian '
                             'targets in the step on the device; the host '
                             'pipeline stops at the warp')
    parser.add_argument('--dtype', type=str, default=None,
                        choices=[None, 'bfloat16', 'float32'],
                        help='bfloat16 = mixed-precision step '
                             '(f32 master params, bf16 conv compute)')
    return parser


if __name__ == '__main__':
    main(**build_parser().parse_args().__dict__)
