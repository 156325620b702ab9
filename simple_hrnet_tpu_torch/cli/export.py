"""Engine export CLI (the JAX package's ``cli/export.py``; reference
scripts/export-tensorrt-model.py:31-53).

Writes a ``.torchpose`` engine (``utils/export.py``) that
``SimpleHRNet(..., enable_tensorrt=True, checkpoint_path='<engine>')``
serves; the flag keeps the reference's name, the artifact is a
``torch.export``ed program with its folded parameters, not a TensorRT
engine. Same flags as the JAX package's, plus ``--device`` (default
'cuda'): the engine serves on the device type it was exported on.

    python -m simple_hrnet_tpu_torch.cli.export -w pose_hrnet_w48.pth \\
        --half --fused
"""

from __future__ import annotations

import argparse
import ast


def parse_int8_exclude(int8_exclude):
    """'stage4, transition3' -> ('stage4', 'transition3'): comma-split
    with whitespace stripped, so space-separated lists don't silently
    produce never-matching prefixes."""
    if isinstance(int8_exclude, str):
        return tuple(p.strip() for p in int8_exclude.split(',')
                     if p.strip())
    return tuple(int8_exclude)


def main(weights='./weights/pose_hrnet_w48_384x288.pth', half=False,
         int8=False, fused=False, output=None, batch_size=16, hrnet_c=48,
         hrnet_j=17, hrnet_m='HRNet', image_resolution='(384, 288)',
         int8_exclude='', device='cuda'):
    from simple_hrnet_tpu_torch.utils.export import SUFFIX, export_engine

    if isinstance(image_resolution, str):
        image_resolution = ast.literal_eval(image_resolution)
    if output is None:
        suffix = '_int8' if int8 else ('_half' if half else '')
        output = weights.rsplit('.', 1)[0] + suffix + SUFFIX
    exclude = parse_int8_exclude(int8_exclude)
    if exclude and not int8:
        raise ValueError('--int8_exclude only applies with --int8 '
                         '(nothing is quantized otherwise)')
    path = export_engine(output, weights, c=hrnet_c, nof_joints=hrnet_j,
                         model_name=hrnet_m, resolution=image_resolution,
                         batch_size=batch_size, half=half, int8=int8,
                         fused=fused, int8_exclude=exclude, device=device)
    print(f'Engine written to {path}')


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('--weights', '-w', type=str,
                        default='./weights/pose_hrnet_w48_384x288.pth')
    parser.add_argument('--half', help='bf16 compute (fp16 analogue)',
                        action='store_true')
    parser.add_argument('--int8', help='TRT-style int8 post-training '
                        'quantization (calibrated; implies bf16 elsewhere)',
                        action='store_true')
    parser.add_argument('--fused', help="HRNet's kernel graph: the branch-0 "
                        'chains and high-resolution fusions as the CUDA '
                        'kernels (custom ops in the exported graph)',
                        action='store_true')
    parser.add_argument('--int8_exclude', type=str, default='',
                        help='comma-separated param-path prefixes kept '
                             'bf16 under --int8 (accuracy knob, e.g. '
                             '"stage4")')
    parser.add_argument('--output', '-o', type=str, default=None)
    parser.add_argument('--batch_size', '-b', type=int, default=16)
    parser.add_argument('--hrnet_c', '-c', type=int, default=48)
    parser.add_argument('--hrnet_j', '-j', type=int, default=17)
    parser.add_argument('--hrnet_m', '-m', type=str, default='HRNet')
    parser.add_argument('--image_resolution', '-r', type=str,
                        default='(384, 288)')
    parser.add_argument('--device', type=str, default='cuda',
                        help="'cuda' (default) or 'cpu': the device type "
                             'the engine is traced on and serves on')
    return parser


if __name__ == '__main__':
    main(**build_parser().parse_args().__dict__)
