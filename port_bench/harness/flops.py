"""Model FLOPs and the detector's activation sizes, counted on the
reference networks with ``torch.utils.flop_counter`` on the meta device
(nothing is computed). The configuration files hold the results; the
benchmark's CPU tests count them again."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference import nets


def _input(recipe: dict) -> tuple:
    if recipe['kind'] in ('yolov3', 'yolov5'):
        s = recipe['img_size']
        return (torch.zeros((1, 3, s, s), device='meta'), s)
    h, w = recipe['res']
    return (torch.zeros((1, 3, h, w), device='meta'),)


def per_item(recipe: dict) -> int:
    """FLOPs (2 per multiply-add) of one frame (a detector) or one crop (a
    pose model) through the plain network."""
    with torch.device('meta'):
        net = nets.build(recipe).eval()
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        net(*_input(recipe))
    return int(counter.get_total_flops())


def silu_sizes(recipe: dict) -> list:
    """Elements a frame of each SiLU of a YOLOv5 network, in forward
    order (one activation-kernel launch each in the program)."""
    with torch.device('meta'):
        net = nets.build(recipe).eval()
    sizes = []
    for m in net.modules():
        if isinstance(m, nets.Conv):
            m.register_forward_hook(
                lambda mod, a, out: sizes.append(out[0].numel()))
    with torch.no_grad():
        net(*_input(recipe))
    return sizes
