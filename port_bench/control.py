"""Readings for the limits of ``correct``: the program, and its
lower-precision control, on many seeds, at the cell's own size.

    python3 port_bench/control.py --workload <cell> --seeds 1 2 3 \\
        --seconds 4 --arm program|fp8

Each seed is one short run of the cell (set-up, a short window at the
cell's own load, the check against the reference), all in one process;
one JSON line a seed gives the compared numbers. ``--arm program`` runs
the program as the configuration states it (the lower readings); ``fp8``
the reference itself in the program's place, its convolutions computed on
float8 (e4m3) inputs and weights: the detector's network (the program
then letterboxes with its plain stem) and the pose network, each fed
and read in the program's layout. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.nn as nn  # noqa: E402

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dims=None) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a scale that maps its largest
    magnitude (over ``dims``, or the whole tensor) to the format's
    largest, and back."""
    amax = x.abs().amax(dim=dims, keepdim=True) if dims else x.abs().max()
    scale = torch.clamp(amax, min=1e-12) / FP8_MAX
    return (x / scale).to(FP8).float() * scale


@torch.no_grad()
def fp8_convs(net: nn.Module) -> nn.Module:
    """Every conv of ``net`` computed on float8 inputs (a scale a tensor)
    and float8 weights (a scale an output channel), accumulating in
    float32."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) or \
                type(m).__name__ == 'DarknetConv':
            dims = (0, 2, 3) if isinstance(m, nn.ConvTranspose2d) \
                else (1, 2, 3)
            m.weight.copy_(_fp8(m.weight, dims))
            m.register_forward_pre_hook(
                lambda mod, args: (_fp8(args[0]),) + tuple(args[1:]))
    return net


class NHWCPose(nn.Module):
    """A reference pose network in the program's layout: NHWC in, NHWC
    heatmaps out."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        return self.net(x.permute(0, 3, 1, 2).float()).permute(0, 2, 3, 1)


class NHWCDetector(nn.Module):
    """A reference detector network in the program's layout (NHWC in
    [0, 1], the plain stem)."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x, img_size, phase_stem=False):
        return self.net(x.permute(0, 3, 1, 2).float(), img_size)


def fp8_reference(model, refs: dict) -> None:
    """Put the float8 reference in the program's place (``run_cell``'s
    ``fault`` hook)."""
    dev = model.device
    pose = fp8_convs(copy.deepcopy(refs['pose']).to(dev))
    det = fp8_convs(copy.deepcopy(refs['detector']).to(dev))
    model.model = NHWCPose(pose).eval()
    model._models = [model.model]
    model.detector.net = NHWCDetector(det).eval()
    model.detector.phase_stem = False
    model._fused_runs.clear()
    model._gather_runs.clear()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--seconds', type=float, default=4.0)
    p.add_argument('--arm', choices=('program', 'fp8'), default='program')
    args = p.parse_args(argv)
    from port_bench.harness import runner
    for seed in args.seeds:
        t = time.perf_counter()
        line = runner.run_cell(
            args.workload, seed, args.seconds, False, device='cuda',
            fault=fp8_reference if args.arm == 'fp8' else None)
        extras = line.pop('_extras')
        print(json.dumps({'workload': args.workload, 'arm': args.arm,
                          'seed': seed, 'correct': line['correct'],
                          'numbers': extras['numbers'],
                          'people_a_frame': extras['people_a_frame'],
                          'metrics': line['metrics'],
                          'seconds': time.perf_counter() - t}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
