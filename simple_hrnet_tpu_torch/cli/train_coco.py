"""COCO training entry point (reference scripts/train_coco.py:16-153).

Counterpart of ``simple_hrnet_tpu/cli/train_coco.py``, with its flags:

    python -m simple_hrnet_tpu_torch.cli.train_coco -n EXP \\
        --coco_root_path ./datasets/COCO [--device cpu] [--dtype bfloat16]

Training runs on one device, the card unless ``--device cpu``. Data
parallelism runs one process a card:

    torchrun --nproc_per_node=N -m simple_hrnet_tpu_torch.cli.train_coco \
        --n_devices N -n EXP ...

Under such a launch the CLI joins the process group and trains over the
mesh of all processes; ``--n_devices`` above 1 without one raises, naming
that line.
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
         model_c=48,
         model_nof_joints=17,
         model_bn_momentum=0.1,
         disable_flip_test_images=False,
         image_resolution='(384, 288)',
         coco_root_path='./datasets/COCO',
         coco_bbox_path=None,
         seed=1,
         device=None,
         n_devices=None,
         dtype=None,
         use_native_decode=False,
         use_grouped_trunk=False,
         device_targets=False):
    from simple_hrnet_tpu_torch.data.coco import COCODataset
    from simple_hrnet_tpu_torch.parallel.distributed import cli_mesh
    from simple_hrnet_tpu_torch.train.trainer import COCOTrain

    mesh = cli_mesh(n_devices, device)

    random.seed(seed)
    np.random.seed(seed)

    if isinstance(image_resolution, str):
        image_resolution = ast.literal_eval(image_resolution)
    if isinstance(lr_decay_steps, str):
        lr_decay_steps = ast.literal_eval(lr_decay_steps)

    print('\nLoading train and validation datasets...')
    ds_train = COCODataset(
        root_path=coco_root_path, data_version='train2017', is_train=True,
        use_gt_bboxes=(coco_bbox_path is None), bbox_path=coco_bbox_path,
        image_width=image_resolution[1], image_height=image_resolution[0],
        color_rgb=True, use_native_decode=use_native_decode,
        device_targets=device_targets)
    ds_val = COCODataset(
        root_path=coco_root_path, data_version='val2017', is_train=False,
        use_gt_bboxes=(coco_bbox_path is None), bbox_path=coco_bbox_path,
        image_width=image_resolution[1], image_height=image_resolution[0],
        color_rgb=True, use_native_decode=use_native_decode,
        device_targets=device_targets)

    train = COCOTrain(
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
        flip_test_images=not disable_flip_test_images, mesh=mesh,
        seed=seed, dtype=dtype, use_grouped_trunk=use_grouped_trunk,
        device_targets=device_targets, device=device)
    train.run()
    return train


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('--exp_name', '-n', type=str, required=True)
    parser.add_argument('--epochs', '-e', type=int, default=200)
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
    parser.add_argument('--model_c', type=int, default=48)
    parser.add_argument('--model_nof_joints', type=int, default=17)
    parser.add_argument('--model_bn_momentum', type=float, default=0.1)
    parser.add_argument('--disable_flip_test_images', action='store_true')
    parser.add_argument('--image_resolution', '-r', type=str,
                        default='(384, 288)')
    parser.add_argument('--coco_root_path', type=str,
                        default='./datasets/COCO')
    parser.add_argument('--coco_bbox_path', type=str, default=None)
    parser.add_argument('--seed', '-s', type=int, default=1)
    parser.add_argument('--device', '-d', type=str, default=None,
                        help="'cuda' (the default) or 'cpu'")
    parser.add_argument('--n_devices', type=int, default=None,
                        help='data-parallel devices: more than 1 runs under '
                             'torchrun --nproc_per_node=N, one process a '
                             'device')
    parser.add_argument('--use_grouped_trunk', action='store_true',
                        help='the JAX package\'s grouped trunk (a TPU '
                             'layout): the same function, so the port '
                             'trains its plain trunk; batch_size must be '
                             'divisible by min(4, max(2, 128 // model_c))')
    parser.add_argument('--dtype', type=str, default=None,
                        choices=[None, 'bfloat16', 'float32'],
                        help='bfloat16 = mixed-precision step '
                             '(f32 master params, bf16 conv compute)')
    parser.add_argument('--use_native_decode', action='store_true',
                        help='fused native JPEG->warp->normalize data '
                             'loading (the host library, built with g++ '
                             'and libjpeg at first use)')
    parser.add_argument('--device_targets', action='store_true',
                        help='run the ImageNet normalize and the gaussian '
                             'targets in the step on the device; the host '
                             'pipeline stops at the warp')
    return parser


if __name__ == '__main__':
    main(**build_parser().parse_args().__dict__)
