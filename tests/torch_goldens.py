"""Production-geometry goldens: the JAX package's answers that the port is
held to, at the full width and resolution of BASELINE.json's five configs,
the scoreboard path and the W32 multi-person path, in every dtype the card
times (JAX-free to import).

``python tests/torch_goldens.py`` regenerates ``tests/goldens/port_*.json``
from the JAX package on the CPU (JAX imported inside ``main``; about 22
minutes on 8 cores, half of it the int8 configs' JAX runs, the JAX
facade's Pallas kernels interpreted as on its TPU, and a rerun writes the
same bytes); ``--only CONFIG ...`` regenerates some; ``--cpu-check
CONFIG DTYPE`` holds the port on the CPU against one pair (torch only),
for the pairs the CPU tests leave to the card. Each golden records
the commit of the JAX package it came from (the last commit touching
``simple_hrnet_tpu/``). A deliberate numeric change to the JAX package or
to the port must regenerate them; a change that moves a golden otherwise
is a fault.

The weights are seeded, not downloaded: every parameter is drawn with
numpy (``np.random.default_rng(seed)``, in ``state_dict`` order, torch's
default kaiming-uniform bound ``gain / sqrt(fan_in)`` for convs), and the
files are written by the port's own writers (``torch.save``,
``darknet.save_darknet_weights``, an ultralytics-style ``{'model': net}``
pickle). Each BatchNorm's statistics are drawn so that its folded bias is
non-zero and about ``bn_shift`` of its conv's output spread: the spreads
come from ``tests/goldens/port_bn_spreads.json``, which
``--bn-spreads`` measures once with the port (torch, no JAX) and which
changes every fingerprint when remade. numpy draws the same values on every
host and torch version, and ``fingerprint`` (a sha256 over the
parameters' bytes, not the file's) proves it. Gains above 1 are for the
networks whose activations torch's default bound shrinks to nothing
(PoseResNet's deconvolutions, the detectors' deep stacks). Each detector's
box rows are scaled to boxes of tens to hundreds of pixels, its
objectness rows scaled and its person logit raised, so that it keeps a
few separate people a frame (the ``score_gap`` and ``cut_gap`` each
golden records).

A golden records, for each frame and person: the box, the keypoints
``(y, x, conf)``, and for each joint the argmax cell, the 3x3 heatmap
neighbourhood around it, the channel's mean, L2 norm and max magnitude,
the argmax margin over the runner-up and the two neighbour differences
that set the subpixel shift; for the detector configs the detector's
rows; for bf16 and int8 the JAX package's own distances between that
dtype and f32 (heatmaps, and boxes where there is a detector), and for
int8 its own spread between two computations of the int8 function.
``compare`` holds a run against a golden with the limits below, written
once here for the CPU test (``tests/test_torch_goldens.py``) and the card
(``chip_smoke.py`` phase 11).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN_DIR = os.path.join(HERE, 'goldens')
JOINTS = 17

# The limits (relative ones are fractions of the golden channel's max
# |value|). f32 on the CPU is the port's plain path: the house tolerance
# (tests/test_torch_single.py). f32 on the card has the kernels on:
# phase 3's limit for the same depth. Boxes and decisive keypoints to
# 1e-3 px, the gate of scripts/validate_goldens.py.
LIMITS = {'cpu': {'heatmap': 2e-4, 'box_px': 1e-3, 'keypoint_px': 1e-3},
          'card': {'heatmap': 1e-3, 'box_px': 1e-3, 'keypoint_px': 1e-3}}
# a joint is decisive where its argmax margin and both neighbour
# differences exceed this many heatmap limits
DECISIVE_FACTOR = 10.0
# the share of decisive joints each config's frame seed aims for
DECISIVE_SHARE = 0.8
# bf16: the heatmap distance to the JAX golden in the same dtype may be
# this many times the JAX package's own distance between that dtype and
# f32 (``jax_vs_f32``). By the triangle inequality two graphs whose
# low-precision error is each no larger than the JAX package's lie within
# twice that error of each other.
LOW_PRECISION_FACTOR = 2.0
# int8 (ROADMAP C9): the heatmap distance may be this many times
# ``jax_int8_spread``, the largest distance the JAX package itself shows
# between its int8 golden and another computation of the same int8
# function on the same weights and frames: its other graph
# (``use_fused_kernels=False``, HRNet only: ROADMAP C8) and its own graph
# with every calibration amax of the pose model moved by a seeded
# whole number of f32 ulps in [-25, 25] (the spread C9's trace measured
# between the card's and the CPU's calibrations). The port on any host is
# one more such reordering: its requantizations flip where the sums'
# order differs, and the flips cascade, so its distance scales with this
# spread and not with the int8 function's distance to f32 (which the
# old rule, 2 x ``jax_vs_f32``, used; ``compare`` still reports it as
# ``bound_old``). The spread samples the distance between two
# reorderings; two reorderings that each lie within it of the function's
# centre lie within twice it of each other, hence the factor 2.
INT8_SPREAD_FACTOR = 2.0
# the amax moves of the int8 spread: at most this many f32 ulps, drawn
# from this seed
INT8_AMAX_ULPS = 25
INT8_AMAX_SEED = 9
# Detector configs in bf16 and int8: a low-precision detector moves its
# boxes and reorders near-equal scores, so the run's people are matched
# to the golden's by box (each golden person in order takes the nearest
# unmatched one) and then held in the golden's order. The people must be
# the same (as many, and every matched box within the box bound); the
# generator keeps only frames where the JAX package's own dtype run keeps
# its f32 people so. The detector's boxes are held to LOW_PRECISION_FACTOR
# times the JAX package's own matched distance between that dtype and f32
# (``jax_vs_f32_det_px``), by the heatmaps' triangle argument, and never
# below the f32 limit. The facade's boxes take the same rule on
# ``jax_vs_f32_box_px`` with a floor of LOW_PRECISION_BOX_FLOOR_PX: they
# are whole pixels, so a sub-pixel move of a detector box shows there only
# as a one-pixel rounding flip.
LOW_PRECISION_BOX_FLOOR_PX = 1.0
# int8: the port's quantized convs, per network, are the JAX package's:
# as many, and their activation scales (sorted) within this relative
# distance (both calibrate the same folded weights on the same frames; the
# f32 sums differ in order, by up to 25 ulps between the card and the CPU,
# ROADMAP C9). The heatmaps cannot tell every int8 facade from a bf16 one
# (PoseResNet-50's int8 and bf16 runs lie about as far from either golden),
# so this is what holds the quantized set.
INT8_SCALE_REL = 1e-5

# The seeded weight files: (network kind, seed, gain of the default bound,
# the folded BN bias over its conv's output spread, detector head edits).
# Detector edits: the box size rows of each head's weights times
# ``wh_gain`` and ``wh_logit`` added to their bias (boxes of tens to
# hundreds of pixels, which NMS merges into separate people), the
# objectness rows times ``obj_gain``, ``obj_logit`` added to the
# objectness bias and ``person_logit`` to the person class's.
BN_SHIFT = 0.3
WEIGHTS = {
    'pose_hrnet_w32': dict(kind='hrnet', c=32, seed=1032, gain=1.0,
                           bn_shift=BN_SHIFT),
    'pose_hrnet_w48': dict(kind='hrnet', c=48, seed=1048, gain=1.0,
                           bn_shift=BN_SHIFT),
    'pose_resnet_50': dict(kind='poseresnet', c=50, seed=1050,
                           gain=6 ** 0.5, bn_shift=BN_SHIFT),
    'yolov3-tiny': dict(kind='darknet', tiny=True, seed=1003,
                        gain=6 ** 0.5, bn_shift=BN_SHIFT, wh_gain=0.3,
                        wh_logit=0.0, obj_gain=10.0, obj_logit=-11.0,
                        person_logit=4.0),
    'yolov3': dict(kind='darknet', tiny=False, seed=1004, gain=1.7,
                   bn_shift=BN_SHIFT, wh_gain=0.3, wh_logit=0.0,
                   obj_gain=6.0, obj_logit=-26.5, person_logit=4.0),
    'yolov5m': dict(kind='yolov5', seed=1005, gain=2.2, bn_shift=BN_SHIFT,
                    wh_gain=1.0, wh_logit=3.0, obj_gain=100.0,
                    obj_logit=-26.0, person_logit=4.0),
}
# each BN's input spread, per weight file (``--bn-spreads`` measures them
# on the frame of this seed)
BN_SPREADS_FILE = os.path.join(GOLDEN_DIR, 'port_bn_spreads.json')
SPREAD_FRAME_SEED = 0
FILE_NAMES = {'pose_hrnet_w32': 'pose_hrnet_w32_256x192.pth',
              'pose_hrnet_w48': 'pose_hrnet_w48_384x288.pth',
              'pose_resnet_50': 'pose_resnet_50_256x192.pth',
              'yolov3-tiny': 'yolov3-tiny.weights',
              'yolov3': 'yolov3.weights', 'yolov5m': 'yolov5m.pt'}

# The golden configs: BASELINE.json's five (scripts/validate_goldens.py),
# the scoreboard path and phase 4's W32 multi-person path. ``dtypes``: the
# goldens the generator writes; ``cpu`` / ``card``: the dtypes each place
# checks, with the frames (None: all) each dtype runs on. Each dtype is
# one the card times (``chip_smoke.py`` phases 4-7).
CONFIGS = {
    'w32_256x192_single': dict(
        pose='pose_hrnet_w32', c=32, res=(256, 192), detector=None,
        frames=1, frame_seed=11, call='predict_one',
        dtypes={'f32': None, 'bfloat16': None, 'int8': None},
        cpu={'f32': None, 'bfloat16': None, 'int8': None},
        card={'f32': None, 'bfloat16': None, 'int8': None}),
    'res50_256x192_batch4': dict(
        pose='pose_resnet_50', c=50, model_name='PoseResNet',
        res=(256, 192), detector=None, frames=4, frame_seed=21,
        call='predict', dtypes={'f32': None, 'bfloat16': None, 'int8': None},
        cpu={'f32': None},
        card={'f32': None, 'bfloat16': None, 'int8': None}),
    'w48_384x288_batch16': dict(
        pose='pose_hrnet_w48', c=48, res=(384, 288), detector=None,
        frames=16, frame_seed=31, call='predict', max_batch_size=16,
        dtypes={'f32': None, 'bfloat16': 2},
        cpu={'f32': 2}, card={'f32': None, 'bfloat16': 2}),
    'multiperson_yolov3tiny_w32': dict(
        pose='pose_hrnet_w32', c=32, res=(256, 192), detector='yolov3-tiny',
        frames=1, frame_seed=41, call='predict_one', dtypes={'f32': None},
        cpu={'f32': None}, card={'f32': None}),
    'video_yolov5m_w48': dict(
        pose='pose_hrnet_w48', c=48, res=(384, 288), detector='yolov5m',
        frames=8, frame_seed=87, call='stream', max_people=8,
        dtypes={'f32': None, 'bfloat16': 5}, cpu={'f32': None},
        card={'f32': None, 'bfloat16': 5}),
    'scoreboard_yolov3_w48': dict(
        pose='pose_hrnet_w48', c=48, res=(384, 288), detector='yolov3',
        frames=1, frame_seed=64, call='predict_one',
        dtypes={'f32': None, 'bfloat16': None}, cpu={'f32': None},
        card={'f32': None, 'bfloat16': None}),
    'multiperson_yolov3_w32': dict(
        pose='pose_hrnet_w32', c=32, res=(256, 192), detector='yolov3',
        frames=2, frame_seed=139, call='predict',
        dtypes={'f32': None, 'bfloat16': None, 'int8': None},
        cpu={}, card={'f32': None, 'bfloat16': None, 'int8': None}),
}


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _network(name: str) -> torch.nn.Module:
    """The port's module for weight file ``name``, at torch's init."""
    spec = WEIGHTS[name]
    if spec['kind'] == 'hrnet':
        from simple_hrnet_tpu_torch.models.hrnet import HRNet
        return HRNet(spec['c'], JOINTS)
    if spec['kind'] == 'poseresnet':
        from simple_hrnet_tpu_torch.models.poseresnet import PoseResNet
        return PoseResNet(spec['c'], JOINTS)
    if spec['kind'] == 'darknet':
        from simple_hrnet_tpu_torch.detectors import darknet
        return darknet.Darknet(darknet.yolov3_tiny_blocks() if spec['tiny']
                               else darknet.yolov3_blocks())
    from simple_hrnet_tpu_torch.detectors import yolov5
    return yolov5.YOLOv5Net(yolov5.build_config('yolov5m'))


def _heads(net: torch.nn.Module) -> list:
    """A detector's output convs (weight, bias), anchor-major channels."""
    if hasattr(net, 'blocks'):
        return [(m.weight, m.bias) for m in
                (getattr(net, f'conv_{i}') for i, b in enumerate(net.blocks)
                 if b['type'] == 'convolutional' and not b['bn'])]
    return [(m.weight, m.bias) for m in net.model['24'].m]


def _bn_modules(net: torch.nn.Module) -> list:
    """(path, module) of every BatchNorm below ``net``, in module order."""
    return [(n, m) for n, m in net.named_modules()
            if isinstance(m, torch.nn.BatchNorm2d)]


def load_bn_spreads() -> dict:
    """``BN_SPREADS_FILE``: per weight file, the spread of each BN's input
    in ``_bn_modules`` order (``measure_bn_spreads`` wrote them)."""
    with open(BN_SPREADS_FILE) as f:
        return json.load(f)


def seeded_network(name: str, measure: bool = False) -> torch.nn.Module:
    """Weight file ``name``'s network with its numpy-drawn parameters.

    Conv weights and biases: uniform within ``gain`` times torch's default
    bound. Each BN: ``weight`` and ``running_var`` uniform in [0.8, 1.25],
    ``bias`` and ``running_mean`` uniform in [-1, 1] times ``bn_shift``
    times the spread (standard deviation) of that BN's input on the
    weight file's frame, so that the folded bias is non-zero and about
    ``bn_shift`` of its conv's output spread at every depth: the spreads
    of ``load_bn_spreads()[name]``, or with ``measure`` each taken from
    the forward pass that runs next and recorded in ``net.bn_spreads``,
    with the RMS of each folded bias over the spread of its folded conv's
    output in ``net.bias_ratios`` (``measure_bn_spreads``). Everything is
    drawn and scaled in numpy; torch only holds the values."""
    spec = WEIGHTS[name]
    net = _network(name).eval()
    rng = np.random.default_rng(spec['seed'])
    modules = dict(net.named_modules())
    shifts = {}
    with torch.no_grad():
        for key, t in net.state_dict(keep_vars=True).items():
            owner, _, leaf = key.rpartition('.')
            m = modules[owner]
            w = getattr(m, 'weight', None)
            if isinstance(m, torch.nn.BatchNorm2d):
                if leaf == 'num_batches_tracked':
                    t.zero_()
                    continue
                if leaf in ('weight', 'running_var'):
                    v = rng.uniform(0.8, 1.25, tuple(t.shape))
                else:
                    v = rng.uniform(-1.0, 1.0, tuple(t.shape))
                    shifts[key] = (v * spec['bn_shift']).astype(np.float32)
                t.copy_(torch.from_numpy(v.astype(np.float32)))
            elif leaf in ('weight', 'bias') and w is not None and w.dim() == 4:
                bound = spec['gain'] / math.sqrt(w[0].numel())
                t.copy_(torch.from_numpy(rng.uniform(
                    -bound, bound, tuple(t.shape)).astype(np.float32)))
            else:
                raise ValueError(f'{name}: no draw rule for {key}')
        if 'obj_gain' in spec:
            for weight, bias in _heads(net):
                rows = weight.view(3, -1, *weight.shape[1:])
                rows[:, 2:4] *= spec['wh_gain']
                rows[:, 4] *= spec['obj_gain']
                bias.view(3, -1)[:, 2:4] += spec['wh_logit']
                bias.view(3, -1)[:, 4] += spec['obj_logit']
                bias.view(3, -1)[:, 5] += spec['person_logit']

        def scale(path, bn, spread):
            s = np.float32(spread)
            for leaf in ('bias', 'running_mean'):
                getattr(bn, leaf).copy_(torch.from_numpy(
                    shifts[f'{path}.{leaf}'] * s))

        bns = _bn_modules(net)
        if not measure:
            spreads = load_bn_spreads()[name]
            if len(spreads) != len(bns):
                raise ValueError(f'{name}: {len(spreads)} BN spreads for '
                                 f'{len(bns)} BNs')
            for (path, bn), spread in zip(bns, spreads):
                scale(path, bn, spread)
            return net
    net.bn_spreads, net.bias_ratios = {}, {}

    def record(path):
        def hook(bn, args):
            x = args[0].detach().double()
            spread = _f(x.std())
            net.bn_spreads[path] = spread
            scale(path, bn, spread)
            inv = (bn.weight / torch.sqrt(bn.running_var + bn.eps)).double()
            bias = bn.bias.double() - bn.running_mean.double() * inv
            net.bias_ratios[path] = float(bias.pow(2).mean().sqrt()
                                          / (x * inv.view(1, -1, 1, 1)).std())
        return hook

    for path, bn in bns:
        bn.register_forward_pre_hook(record(path))
    return net


def network_input(name: str) -> torch.Tensor:
    """The input of weight file ``name``'s network on the frame the BN
    spreads are measured on (``smooth_frames(1, SPREAD_FRAME_SEED)``):
    resized (bilinear) to the resolution of the first config that runs it
    and normalized, or letterboxed for a detector."""
    rgb = torch.from_numpy(np.ascontiguousarray(
        smooth_frames(1, SPREAD_FRAME_SEED)[..., ::-1]))
    kind = WEIGHTS[name]['kind']
    if kind in ('darknet', 'yolov5'):
        from simple_hrnet_tpu_torch.detectors.yolov3 import letterbox_device
        return letterbox_device(rgb, 640 if kind == 'yolov5' else 416)
    from simple_hrnet_tpu_torch.ops.image import INV255_STD, MEAN255
    res = next(cfg['res'] for cfg in CONFIGS.values()
               if cfg['pose'] == name)
    x = torch.nn.functional.interpolate(
        rgb.permute(0, 3, 1, 2).float(), size=tuple(res), mode='bilinear',
        align_corners=False).permute(0, 2, 3, 1)
    return (x - torch.from_numpy(MEAN255)) * torch.from_numpy(INV255_STD)


def measure_bn_spreads(name: str) -> tuple:
    """The spread of each BN's input (in ``_bn_modules`` order) in one
    forward pass of the network on ``network_input(name)``, each BN's
    statistics drawn from the spreads before it; and in the same order
    each folded bias's RMS over its folded conv's output spread."""
    net = seeded_network(name, measure=True)
    x = network_input(name)
    with torch.no_grad():
        if WEIGHTS[name]['kind'] in ('darknet', 'yolov5'):
            net(x, x.shape[1])
        else:
            net(x)
    paths = [p for p, _ in _bn_modules(net)]
    missing = [p for p in paths if p not in net.bn_spreads]
    if missing:
        raise ValueError(f'{name}: BNs that never ran: {missing[:4]}')
    return ([net.bn_spreads[p] for p in paths],
            np.asarray([net.bias_ratios[p] for p in paths]))


def fingerprint(net: torch.nn.Module) -> str:
    """sha256 over the little-endian bytes of every ``state_dict`` entry,
    in order."""
    h = hashlib.sha256()
    for t in net.state_dict().values():
        a = t.detach().cpu().contiguous().numpy()
        h.update(a.astype(a.dtype.newbyteorder('<'), copy=False).tobytes())
    return h.hexdigest()


def write_weights(tmp: str, names=None) -> dict:
    """Write the seeded files to ``tmp``: {name: (path, fingerprint)}."""
    out = {}
    for name in names or WEIGHTS:
        net = seeded_network(name)
        path = os.path.join(tmp, FILE_NAMES[name])
        kind = WEIGHTS[name]['kind']
        if kind == 'darknet':
            from simple_hrnet_tpu_torch.detectors import darknet
            darknet.save_darknet_weights(net, path)
        elif kind == 'yolov5':
            torch.save({'model': net}, path)
        else:
            torch.save(net.state_dict(), path)
        out[name] = (path, fingerprint(net))
    return out


def config_weights(config: str) -> list:
    cfg = CONFIGS[config]
    return [cfg['pose']] + ([cfg['detector']] if cfg['detector'] else [])


# ---------------------------------------------------------------------------
# frames and facades
# ---------------------------------------------------------------------------

def smooth_frames(n: int, seed: int, h: int = 480, w: int = 640
                  ) -> np.ndarray:
    """Synthetic BGR uint8 frames: smooth blobs over noise (as
    ``chip_smoke.smooth_frames``)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = rng.uniform(0, 60, (n, h, w, 3)).astype(np.float32)
    for f in frames:
        for _ in range(6):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(30, 120)
            f += (rng.uniform(60, 190, 3) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None])
    return np.clip(frames, 0, 255).astype(np.uint8)


def config_frames(config: str, seed=None) -> np.ndarray:
    cfg = CONFIGS[config]
    return smooth_frames(cfg['frames'],
                         cfg['frame_seed'] if seed is None else seed)


def facade_kwargs(config: str, paths: dict, dtype: str) -> dict:
    """The facade's arguments, the same for both packages."""
    cfg = CONFIGS[config]
    kw = dict(model_name=cfg.get('model_name', 'HRNet'),
              resolution=cfg['res'], return_heatmaps=True,
              return_bounding_boxes=True,
              dtype=None if dtype == 'f32' else dtype)
    if 'max_batch_size' in cfg:
        kw['max_batch_size'] = cfg['max_batch_size']
    det = cfg['detector']
    if det is None:
        kw['multiperson'] = False
    elif det == 'yolov5m':
        kw.update(yolo_version='v5', yolo_model_def=paths[det])
    else:
        kw.update(yolo_model_def=det, yolo_weights_path=paths[det])
    return kw


def port_facade(config: str, paths: dict, dtype: str = 'f32',
                device: str = 'cpu', **extra):
    from simple_hrnet_tpu_torch import SimpleHRNet
    cfg = CONFIGS[config]
    kw = facade_kwargs(config, paths, dtype)
    kw.update(extra)
    return SimpleHRNet(cfg['c'], JOINTS, paths[cfg['pose']], device=device,
                       **kw)


def run_facade(model, config: str, frames: np.ndarray) -> list:
    """The config's call on ``frames``: per frame (heatmaps (P, J, h, w),
    boxes (P, 4), keypoints (P, J, 3)) as float arrays."""
    cfg = CONFIGS[config]
    if cfg['call'] == 'predict_one':
        outs = [model.predict(f) for f in frames]
    elif cfg['call'] == 'stream':
        outs = list(model.predict_stream(list(frames),
                                         max_people=cfg['max_people']))
    else:
        hm, bx, pts = model.predict(frames)
        if cfg['detector'] is None:   # a stack: keypoints (n, 1, J, 3)
            outs = [(hm[i:i + 1], bx[i:i + 1], pts[i]) for i in
                    range(len(frames))]
        else:
            outs = list(zip(hm, bx, pts))
    return [tuple(np.asarray(a, np.float32) for a in o) for o in outs]


def zero_chain(hrnet: torch.nn.Module, stage: str = 'stage3'):
    """The controls' wrong input: the first module of ``stage`` puts out
    zeros for its branch-0 chain (a hook on the plain modules, so on a
    facade built with ``use_fused_kernels=False``). Returns the hook."""
    return getattr(hrnet, stage)[0].branches[0].register_forward_hook(
        lambda _m, _args, out: torch.zeros_like(out))


@contextlib.contextmanager
def plain_stem_int8():
    """Inside, a port YOLOv3 built with ``dtype='int8'`` also quantizes
    the convs that the JAX package's phase stem keeps out of its int8
    policy (``darknet.phase_stem_convs`` names none): YOLOv3-416's
    ``conv_1``, the port's set before ROADMAP C11's repair. A control."""
    from simple_hrnet_tpu_torch.detectors import darknet
    real = darknet.phase_stem_convs
    darknet.phase_stem_convs = lambda blocks: []
    try:
        yield
    finally:
        darknet.phase_stem_convs = real


def detector_rows(detector, frames: np.ndarray) -> list:
    """Per frame the detector's valid rows (x1, y1, x2, y2, score), in its
    score order."""
    rgb = np.ascontiguousarray(frames[..., ::-1])
    rows, valid = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                   for a in detector.detect_padded(rgb))
    return [rows[i][valid[i]][:, :5] for i in range(len(frames))]


def quantized_scales(model) -> dict:
    """A port facade's quantized convs: per network ('pose', and
    'detector' where there is one) the sorted activation scales of its
    ``QConv2d`` modules."""
    from simple_hrnet_tpu_torch.models.layers import QConv2d
    nets = {'pose': model.model}
    if model.detector is not None:
        nets['detector'] = model.detector.net
    return {k: sorted(float(m.ascale) for m in net.modules()
                      if isinstance(m, QConv2d)) for k, net in nets.items()}


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------

def _f(a) -> list:
    """float32 values as the shortest decimals that read back exactly."""
    a = np.asarray(a, np.float32)
    if a.ndim == 0:
        return float(str(a))
    return [_f(x) for x in a]


def _neighbourhood(hm: np.ndarray, r: int, c: int) -> list:
    """The 3x3 values around (r, c) of one (H, W) channel, row-major;
    None outside the map."""
    h, w = hm.shape
    return [float(hm[y, x]) if 0 <= y < h and 0 <= x < w else None
            for y in (r - 1, r, r + 1) for x in (c - 1, c, c + 1)]


def summarize_person(hm: np.ndarray) -> dict:
    """One person's (J, H, W) heatmaps as the golden records them."""
    j, h, w = hm.shape
    flat = hm.reshape(j, -1)
    idx = flat.argmax(axis=1)
    top2 = np.sort(flat, axis=1)[:, -2:]
    cells, nbs, stats = [], [], []
    for k in range(j):
        r, c = int(idx[k] // w), int(idx[k] % w)
        ch = hm[k]
        dx = float(ch[r, c + 1] - ch[r, c - 1]) if 0 < c < w - 1 else None
        dy = float(ch[r + 1, c] - ch[r - 1, c]) if 0 < r < h - 1 else None
        cells.append([r, c])
        nbs.append(_neighbourhood(ch, r, c))
        stats.append([float(ch.mean(dtype=np.float64)),
                      float(np.sqrt((ch.astype(np.float64) ** 2).sum())),
                      float(np.abs(ch).max()),
                      float(top2[k, 1] - top2[k, 0]), dx, dy])
    return {'cell': cells,
            'nb': [[None if v is None else _f(v) for v in n] for n in nbs],
            'stats': [[None if v is None else _f(v) for v in s]
                      for s in stats]}


def summarize(outs: list, rows=None, cut_scores=None) -> list:
    """Golden frame records from ``run_facade``'s outputs (and the
    detector's rows; ``cut_scores``: per frame the score of the first
    candidate past the people's cut, or the detector's threshold)."""
    frames = []
    for i, (hm, bx, pts) in enumerate(outs):
        rec = {'people': int(pts.shape[0]), 'boxes': _f(bx),
               'keypoints': _f(pts),
               'joints': [summarize_person(h) for h in hm]}
        if rows is not None:
            kept = rows[i][:rec['people']]
            rec['det'] = _f(kept)
            s = kept[:, 4].astype(np.float64)
            rec['score_gap'] = _f(np.diff(-s).min()) if len(s) > 1 else None
            rec['cut_gap'] = _f(s.min() - cut_scores[i]) if len(s) else None
        frames.append(rec)
    return frames


def load_golden(config: str) -> dict:
    with open(os.path.join(GOLDEN_DIR, f'port_{config}.json')) as f:
        return json.load(f)


def decisive(stats: np.ndarray, limit: float) -> np.ndarray:
    """Which joints (rows of golden ``stats``) are decisive at heatmap
    limit ``limit``: margin and both neighbour differences (where the
    neighbours exist) above ``DECISIVE_FACTOR`` limits of max."""
    s = np.asarray([[np.nan if v is None else v for v in r] for r in stats],
                   np.float64)
    gate = DECISIVE_FACTOR * limit * s[:, 2]
    ok = s[:, 3] > gate
    for col in (4, 5):
        ok &= np.isnan(s[:, col]) | (np.abs(s[:, col]) > gate)
    return ok


def decisive_share(frames: list, place: str) -> float:
    limit = LIMITS[place]['heatmap']
    flags = [decisive(p['stats'], limit) for f in frames for p in f['joints']]
    return float(np.concatenate(flags).mean()) if flags else 0.0


def _values(hm: np.ndarray, person: dict) -> np.ndarray:
    """(J, 11): the 3x3 neighbourhood at the golden's cells, the channel
    mean and its RMS (L2 over sqrt(H W)), from (J, H, W) heatmaps; NaN
    where the golden has no neighbour."""
    _, h, w = hm.shape
    out = []
    for k, (r, c) in enumerate(person['cell']):
        ch = hm[k].astype(np.float64)
        nb = _neighbourhood(hm[k], r, c)
        out.append([np.nan if v is None else v for v in nb]
                   + [ch.mean(), np.sqrt((ch ** 2).sum() / (h * w))])
    return np.asarray(out, np.float64)


def _golden_values(person: dict, hw: tuple) -> np.ndarray:
    n = math.sqrt(hw[0] * hw[1])
    return np.asarray([[np.nan if v is None else v for v in nb]
                       + [st[0], st[1] / n]
                       for nb, st in zip(person['nb'], person['stats'])],
                      np.float64)


def heatmap_distance(outs: list, frames: list) -> tuple:
    """(max, mean) over every person and joint of |run - golden| over the
    recorded values, each over the golden channel's max magnitude; and
    the absolute (max, mean) differences."""
    rel, ab = [], []
    for (hm, _, _), f in zip(outs, frames):
        for p, person in enumerate(f['joints']):
            d = np.abs(_values(hm[p], person)
                       - _golden_values(person, hm.shape[2:]))
            scale = np.asarray([s[2] for s in person['stats']])[:, None]
            rel.append((d / scale)[~np.isnan(d)])
            ab.append(d[~np.isnan(d)])
    if not rel:
        return 0.0, 0.0, 0.0, 0.0
    rel, ab = np.concatenate(rel), np.concatenate(ab)
    return (float(rel.max()), float(rel.mean()), float(ab.max()),
            float(ab.mean()))


def _nearest_order(golden_boxes, boxes: np.ndarray) -> list:
    """Each golden box in order takes the unmatched run box nearest to it
    (largest corner difference): the run indices in golden order."""
    g = np.asarray(golden_boxes, np.float64).reshape(-1, 4)
    d = np.abs(g[:, None, :] - np.asarray(boxes, np.float64)[None, :, :4]
               ).max(axis=-1)
    order = []
    for row in d:
        row = row.copy()
        row[order] = np.inf
        order.append(int(row.argmin()))
    return order


def match_people(outs: list, gframes: list, rows=None) -> tuple:
    """``outs`` (and the detector's ``rows``) with each frame's people in
    the golden's order by ``_nearest_order`` on the facade boxes (the
    detector rows on their own boxes); frames whose people counts differ
    are left as they are (``compare`` fails them first)."""
    new_outs, new_rows = [], None if rows is None else []
    for i, ((hm, bx, pts), f) in enumerate(zip(outs, gframes)):
        if f['people'] and pts.shape[0] == f['people']:
            o = _nearest_order(f['boxes'], bx)
            hm, bx, pts = hm[o], bx[o], pts[o]
        new_outs.append((hm, bx, pts))
        if rows is not None:
            r = rows[i]
            if f['people'] and len(r) >= f['people']:
                kept = r[:f['people']]
                r = np.concatenate([kept[_nearest_order(
                    np.asarray(f['det'])[:, :4], kept)], r[f['people']:]])
            new_rows.append(r)
    return new_outs, new_rows


def distances(outs: list, gframes: list, limit: float, rows=None) -> dict:
    """A run's distances to golden frames ``gframes`` (people in the same
    order): people, box and detector-box px, heatmap distances (of max
    and absolute), decisive joints at heatmap limit ``limit`` and their
    keypoint px, confidences (of max), the within-1 px share."""
    out = {'people': [int(o[2].shape[0]) for o in outs]}
    if out['people'] != [f['people'] for f in gframes]:
        return out
    out['box_err_px'] = max([float(np.abs(
        o[1] - np.asarray(f['boxes'])).max())
        for o, f in zip(outs, gframes) if f['people']] or [0.0])
    if rows is not None:
        out['det_box_err_px'] = max([float(np.abs(
            r[:f['people'], :4] - np.asarray(f['det'])[:, :4]).max())
            for r, f in zip(rows, gframes) if f['people']] or [0.0])
    hm_max, hm_mean, abs_max, abs_mean = heatmap_distance(outs, gframes)
    out.update(heatmap_rel_max=hm_max, heatmap_rel_mean=hm_mean,
               heatmap_abs_max=abs_max, heatmap_abs_mean=abs_mean)
    xy, conf, dec, near = [], [], [], []
    for (_, _, pts), f in zip(outs, gframes):
        g = np.asarray(f['keypoints'], np.float64).reshape(pts.shape)
        for p, person in enumerate(f['joints']):
            d = decisive(person['stats'], limit)
            dxy = np.abs(pts[p, :, :2] - g[p, :, :2]).max(axis=1)
            xy.append(dxy[d])
            near.append(dxy <= 1.0)
            scale = np.asarray([s[2] for s in person['stats']])
            conf.append(np.abs(pts[p, :, 2] - g[p, :, 2]) / scale)
            dec.append(d)
    dec = np.concatenate(dec) if dec else np.zeros(0, bool)
    out.update(joints=int(dec.size), decisive=int(dec.sum()),
               within_1px=float(np.concatenate(near).mean()) if near
               else 1.0,
               keypoint_err_px=float(np.concatenate(xy).max())
               if dec.any() else 0.0,
               conf_rel_err=float(np.concatenate(conf).max())
               if conf else 0.0)
    return out


def compare(outs: list, golden: dict, dtype: str, place: str,
            rows=None, quantum=None, frames=None, scales=None) -> dict:
    """Hold ``run_facade`` outputs (and the detector's ``rows``) against
    ``golden``'s ``dtype`` entry, frames ``frames`` (a slice; None: all).
    f32: same people in order, boxes and detector boxes within
    ``box_px``, heatmap values within the place's limit of max, decisive
    keypoints within ``keypoint_px`` and every confidence within the
    heatmap limit. bf16 / int8: people matched by box to the golden's
    (``match_people``) where there is a detector, their boxes within the
    box bound; the heatmap distance within LOW_PRECISION_FACTOR times the
    JAX package's own dtype-to-f32 distance (bf16) or INT8_SPREAD_FACTOR
    times its int8 spread (int8; ``bound_old`` is the bf16 rule's bound);
    with ``quantum`` (int8 on the CPU) every value also within 4 quanta
    and the mean within one; with ``scales`` (int8, ``quantized_scales``
    of the run's facade) the quantized set that of the JAX package's
    (``INT8_SCALE_REL``). Returns the distances and ``ok``; ``failures``
    says which gates failed."""
    lim = LIMITS[place]
    entry = golden['dtypes'][dtype]
    gframes = entry['frames'][frames or slice(None)]
    out = {'config': golden['config'], 'dtype': dtype, 'place': place,
           'frames': len(gframes), 'failures': []}
    fails = out['failures']
    if len(outs) != len(gframes):
        fails.append(f'{len(outs)} frames against {len(gframes)}')
        out['ok'] = False
        return out
    low = dtype != 'f32'
    if low and any('det' in f for f in gframes):
        outs, rows = match_people(outs, gframes, rows)
    out.update(distances(outs, gframes, lim['heatmap'], rows))
    want = [f['people'] for f in gframes]
    if out['people'] != want:
        fails.append(f'people {out["people"]} against {want}')
        out['ok'] = False
        return out
    box_bound = det_bound = lim['box_px']
    if low and 'jax_vs_f32_box_px' in entry:
        box_bound = max(LOW_PRECISION_BOX_FLOOR_PX, LOW_PRECISION_FACTOR
                        * entry['jax_vs_f32_box_px'])
        det_bound = max(lim['box_px'], LOW_PRECISION_FACTOR
                        * entry['jax_vs_f32_det_px'])
        out.update(box_bound_px=box_bound, det_bound_px=det_bound)
    if scales is not None:
        for net, want in entry['jax_scales'].items():
            got = scales.get(net, [])
            out[f'quantized_{net}'] = f'{len(got)}/{len(want)}'
            if len(got) != len(want):
                fails.append(f'{net}: {len(got)} quantized convs against '
                             f'the JAX package\'s {len(want)}')
                continue
            err = max([abs(a - b) / b for a, b in zip(got, want)] or [0.0])
            out[f'scale_rel_err_{net}'] = err
            if err > INT8_SCALE_REL:
                fails.append(f'{net}: activation scales differ by {err} '
                             f'> {INT8_SCALE_REL}')
    if out['box_err_px'] > box_bound:
        fails.append(f'boxes differ by {out["box_err_px"]} px '
                     f'> {box_bound}')
    if rows is not None and out['det_box_err_px'] > det_bound:
        fails.append(f'detector boxes differ by {out["det_box_err_px"]} '
                     f'px > {det_bound}')
    hm_max = out['heatmap_rel_max']
    if not low:
        if hm_max > lim['heatmap']:
            fails.append(f'heatmaps differ by {hm_max} of max '
                         f'> {lim["heatmap"]}')
        if out['keypoint_err_px'] > lim['keypoint_px']:
            fails.append(f'decisive keypoints differ by '
                         f'{out["keypoint_err_px"]} px')
        if out['conf_rel_err'] > lim['heatmap']:
            fails.append(f'confidences differ by {out["conf_rel_err"]} of '
                         f'max')
    else:
        del out['keypoint_err_px'], out['conf_rel_err']
        old = LOW_PRECISION_FACTOR * entry['jax_vs_f32']
        if dtype == 'int8':
            bound = INT8_SPREAD_FACTOR * entry['jax_int8_spread']
            out['bound_old'] = old
            rule = (f'{INT8_SPREAD_FACTOR} times the JAX package\'s own '
                    f'int8 spread')
        else:
            bound = old
            rule = (f'{LOW_PRECISION_FACTOR} times the JAX package\'s own '
                    f'{dtype}-to-f32 distance')
        out['bound'] = bound
        if hm_max > bound:
            fails.append(f'heatmap distance {hm_max} > {bound}, {rule}')
        if quantum is not None:
            out['quanta_max'] = out['heatmap_abs_max'] / quantum
            out['quanta_mean'] = out['heatmap_abs_mean'] / quantum
            if out['heatmap_abs_max'] > 4 * quantum or \
                    out['heatmap_abs_mean'] > quantum:
                fails.append(f'int8 heatmaps differ by {out["quanta_max"]} '
                             f'quanta (mean {out["quanta_mean"]})')
    out['ok'] = not fails
    return out


def report(r: dict) -> str:
    """One line of a comparison's distances."""
    keys = ('people', 'box_err_px', 'box_bound_px', 'det_box_err_px',
            'det_bound_px', 'heatmap_rel_max', 'heatmap_rel_mean', 'bound',
            'bound_old', 'keypoint_err_px', 'conf_rel_err', 'decisive',
            'joints', 'within_1px', 'quanta_max', 'quanta_mean',
            'quantized_pose', 'scale_rel_err_pose', 'quantized_detector',
            'scale_rel_err_detector')
    parts = [f'{k}={r[k]:.3e}' if isinstance(r[k], float) else f'{k}={r[k]}'
             for k in keys if k in r]
    return (f'[{r["config"]} {r["dtype"]} {r["place"]}] '
            f'{"ok" if r["ok"] else "FAIL " + "; ".join(r["failures"])}: '
            + ' '.join(parts))


# ---------------------------------------------------------------------------
# the int8 trace: where two runs of one int8 facade part
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def int8_calibration(record=None, replace=None):
    """Inside, every port facade built with ``dtype='int8'`` copies its
    calibration map (module path -> input amax, ``api._calibrate_int8``)
    into the dict ``record``, or takes the map ``replace`` instead of
    calibrating; the rest of its build (``quantize_folded``,
    ``prepare_inference``) is unchanged."""
    from simple_hrnet_tpu_torch.api import SimpleHRNet
    real = SimpleHRNet._calibrate_int8

    def calibrate(self, model):
        amax = dict(replace) if replace is not None else real(self, model)
        if record is not None:
            record.update(amax)
        return amax

    SimpleHRNet._calibrate_int8 = calibrate
    try:
        yield record
    finally:
        SimpleHRNet._calibrate_int8 = real


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t if t.dtype == torch.int8 else t.float()).cpu().numpy()


def int8_trace(model, frames: np.ndarray, inject=None) -> tuple:
    """Run the port facade ``model``'s ``predict`` once on each of
    ``frames`` with hooks on its pose model; returns (trace, outputs), the
    outputs as ``run_facade`` gives them.

    The trace lists, in forward order, (name, kind, array): the frame the
    pose model receives (kind 'frame', in counts: the rounded [0, 255]
    values its normalized input came from), every ``QConv2d``'s quantized
    input ('int8': ``quantize(x, 1 / ascale)``, recomputed from the
    module's input and scale), every conv's output ('float'), each
    packed branch-0 chain's input, quantized input under int8 and output
    (a chain kernel is one launch: its inner requantizations cannot be
    seen), each stage module's branch outputs and fuse outputs, and the
    heatmaps. ``trace['input']`` keeps the normalized input itself;
    ``inject`` (such an input) replaces the pose model's input, on the
    model's device."""
    from simple_hrnet_tpu_torch.models.hrnet import StageModule
    from simple_hrnet_tpu_torch.models.layers import QConv2d
    from simple_hrnet_tpu_torch.ops.image import INV255_STD, MEAN255
    from simple_hrnet_tpu_torch.ops.int8 import quantize

    net = model.model
    entries, hooks, chains = [], [], []
    kept = {}

    def add(name, kind, t):
        entries.append((name, kind, _host(t)))

    def on_input(_m, args):
        x = args[0]
        if inject is not None:
            x = torch.as_tensor(inject).to(x.device)
        kept['input'] = _host(x)
        counts = torch.round(x.float() / torch.as_tensor(INV255_STD).to(
            x.device) + torch.as_tensor(MEAN255).to(x.device))
        add('frame', 'frame', counts)
        return (x,) + tuple(args[1:])

    def on_qconv(name):
        def hook(m, args):
            add(f'{name}:q', 'int8', quantize(args[0].permute(0, 2, 3, 1),
                                              1.0 / m.ascale))
        return hook

    def on_output(name):
        def hook(_m, _args, out):
            if isinstance(out, (list, tuple)):
                for i, o in enumerate(out):
                    add(f'{name}:fuse{i}', 'float', o)
            else:
                add(name, 'float', out)
        return hook

    def on_chain(name, m):
        real = m._run_chain

        def run(x):
            add(f'{name}.chain:in', 'float', x)
            if m.chain_int8 is not None:
                add(f'{name}.chain:in:q', 'int8',
                    quantize(x, 1.0 / m.chain_int8['ascales'][0]))
            y = real(x)
            add(f'{name}.branches.0', 'float', y)
            return y
        m._run_chain = run
        chains.append(m)

    hooks.append(net.register_forward_pre_hook(on_input))
    for name, m in net.named_modules():
        if isinstance(m, QConv2d):
            hooks.append(m.register_forward_pre_hook(on_qconv(name)))
        if isinstance(m, (QConv2d, torch.nn.Conv2d)):
            hooks.append(m.register_forward_hook(on_output(name)))
        elif isinstance(m, StageModule):
            on_chain(name, m)
            for b, branch in enumerate(m.branches):
                hooks.append(branch.register_forward_hook(
                    on_output(f'{name}.branches.{b}')))
            hooks.append(m.register_forward_hook(on_output(name)))
    hooks.append(net.register_forward_hook(
        lambda _m, _args, out: add('heatmaps', 'float', out)))
    try:
        outs = [tuple(np.asarray(a, np.float32) for a in model.predict(f))
                for f in frames]
    finally:
        for h in hooks:
            h.remove()
        for m in chains:
            del m._run_chain
    return {'entries': entries, 'input': kept.get('input')}, outs


def first_departure(a: dict, b: dict) -> dict:
    """Hold trace ``a`` against trace ``b`` entry by entry (``int8_trace``
    traces of the same facade configuration). Each row: the entry's name,
    kind, elements, how many differ and the largest difference: in counts
    for the frame, in quanta for int8 entries, and as a share of ``b``'s
    largest magnitude for float entries. ``first`` is the first row that
    differs (None when none does)."""
    ea, eb = a['entries'], b['entries']
    if [(n, k) for n, k, _ in ea] != [(n, k) for n, k, _ in eb]:
        raise ValueError('the traces hold other entries: not the same '
                         'configuration')
    rows = []
    for (name, kind, x), (_, _, y) in zip(ea, eb):
        if x.shape != y.shape:
            raise ValueError(f'{name}: shapes {x.shape} and {y.shape}')
        d = np.abs(x.astype(np.float64) - y.astype(np.float64))
        top = float(np.abs(y).max()) if kind == 'float' and y.size else 1.0
        rows.append({'name': name, 'kind': kind, 'elements': int(d.size),
                     'differ': int(np.count_nonzero(d)),
                     'max_diff': float(d.max() / (top or 1.0))
                     if d.size else 0.0,
                     'unit': {'frame': 'counts', 'int8': 'quanta'}.get(
                         kind, 'of max')})
    first = next((r for r in rows if r['differ']), None)
    return {'rows': rows, 'first': first}


def amax_departure(a: dict, b: dict) -> dict:
    """Two calibration maps key by key, in f32 ulps: how many keys, how
    many differ, the largest distance and its key; keys in one map only
    are listed."""
    keys = sorted(set(a) & set(b))
    ia = np.asarray([a[k] for k in keys], np.float32).view(np.int32)
    ib = np.asarray([b[k] for k in keys], np.float32).view(np.int32)
    ulps = np.abs(ia.astype(np.int64) - ib.astype(np.int64))
    worst = int(ulps.argmax()) if len(keys) else 0
    return {'keys': len(keys), 'differ': int(np.count_nonzero(ulps)),
            'max_ulps': int(ulps.max()) if len(keys) else 0,
            'worst': keys[worst] if len(keys) else None,
            'only_in_one': sorted(set(a) ^ set(b))}


def departure_line(d: dict) -> str:
    """One line of ``first_departure``'s first row and of what follows
    it."""
    r = d['first']
    if r is None:
        return f'no departure over {len(d["rows"])} entries'
    i = d['rows'].index(r)
    later = d['rows'][i:]
    return (f'first departure at entry {i} of {len(d["rows"])}, {r["name"]} '
            f'({r["kind"]}): {r["differ"]} of {r["elements"]} elements, '
            f'largest {r["max_diff"]:.3e} {r["unit"]}; from there '
            f'{sum(1 for x in later if x["differ"])} of {len(later)} '
            f'entries differ')


# ---------------------------------------------------------------------------
# the generator (JAX, on the CPU)
# ---------------------------------------------------------------------------

def _jax_commit() -> str:
    try:
        return subprocess.run(
            ['git', 'log', '-1', '--format=%H', '--', 'simple_hrnet_tpu'],
            cwd=REPO, capture_output=True, text=True,
            timeout=30).stdout.strip() or 'unknown'
    except OSError:
        return 'unknown'


def _jax_cut_scores(config, paths, frames, rows, jax_facade):
    """Per frame the score of the first candidate past the people's cut:
    the (people+1)-th row of a detector with a larger cap where the cut
    is a cap, else the detector's threshold."""
    cfg = CONFIGS[config]
    cap = cfg.get('max_people', jax_facade.detector.max_detections)
    thresh = jax_facade.detector.conf_thres
    if not any(len(r) >= cap for r in rows):
        return [thresh] * len(rows)
    if len(rows[0]) >= jax_facade.detector.max_detections:
        from simple_hrnet_tpu.detectors.yolov3 import YOLOv3
        wide = YOLOv3(model_def=cfg['detector'],
                      weights_path=paths[cfg['detector']],
                      max_detections=2 * cap)
        rows = detector_rows(wide, frames)
    return [float(r[cap, 4]) if len(r) > cap else thresh for r in rows]


@contextlib.contextmanager
def _jax_amax_moved():
    """Inside, every JAX facade built with ``dtype='int8'`` moves each
    calibration amax of its pose model by a whole number of f32 ulps in
    [-INT8_AMAX_ULPS, INT8_AMAX_ULPS], drawn in calibration order from
    INT8_AMAX_SEED."""
    from simple_hrnet_tpu import SimpleHRNet as JaxSimpleHRNet
    real = JaxSimpleHRNet._calibrate_int8

    def moved(self, apply_fn, params):
        amax = real(self, apply_fn, params)
        keys = list(amax)
        bits = np.asarray([amax[k] for k in keys], np.float32).view(np.int32)
        step = np.random.default_rng(INT8_AMAX_SEED).integers(
            -INT8_AMAX_ULPS, INT8_AMAX_ULPS + 1, len(keys))
        vals = (bits + step.astype(np.int32)).view(np.float32)
        return {k: float(v) for k, v in zip(keys, vals)}

    JaxSimpleHRNet._calibrate_int8 = moved
    try:
        yield
    finally:
        JaxSimpleHRNet._calibrate_int8 = real


def _jax_scales(model) -> dict:
    """``quantized_scales`` of a JAX facade: the sorted ``ascale`` of every
    ``kernel_q`` node of its pose params (the plain tree beside a packed
    one) and its detector's."""
    def walk(tree, out):
        if isinstance(tree, dict):
            if 'kernel_q' in tree:
                out.append(float(np.asarray(tree['ascale'])))
            for v in tree.values():
                walk(v, out)
        return out

    params = model.params
    nets = {'pose': params['p'] if 'packed' in params else params}
    if model.detector is not None:
        nets['detector'] = model.detector.params
    return {k: _f(sorted(walk(t, []))) for k, t in nets.items()}


def _jax_run(config, paths, dtype, frames, **extra):
    """The JAX facade's outputs, detector rows and the facade."""
    import jax
    from simple_hrnet_tpu import SimpleHRNet as JaxSimpleHRNet
    cfg = CONFIGS[config]
    kw = facade_kwargs(config, paths, dtype)
    kw.update(extra)
    model = JaxSimpleHRNet(cfg['c'], JOINTS, paths[cfg['pose']], **kw)
    with jax.enable_x64(True):
        outs = run_facade(model, config, frames)
        rows = detector_rows(model.detector, frames) if cfg['detector'] \
            else None
    return outs, rows, model


def _matched_distances(outs, rows, gframes) -> dict:
    """``distances`` of a JAX run to JAX golden frames of the same
    function, people matched by box where there is a detector."""
    if rows is not None:
        outs, rows = match_people(outs, gframes, rows)
    return distances(outs, gframes, LIMITS['cpu']['heatmap'], rows)


def generate(config: str, paths: dict, fps: dict, commit: str,
             seed=None, dtypes=None) -> dict:
    """The golden of ``config`` (its ``dtypes``, default all) from the JAX
    facade (CPU, x64 for the PIL-exact crops, as the port's tests run
    it)."""
    import jax

    cfg = CONFIGS[config]
    frames = config_frames(config, seed)
    golden = {'config': config, 'jax_commit': commit,
              'frame_seed': cfg['frame_seed'] if seed is None else seed,
              'frame_shape': list(frames.shape),
              'weights': {n: {'file': FILE_NAMES[n],
                              'seed': WEIGHTS[n]['seed'], 'sha256': fps[n]}
                          for n in config_weights(config)},
              'limits': LIMITS, 'decisive_factor': DECISIVE_FACTOR,
              'dtypes': {}}
    f32 = None
    for dtype, n in cfg['dtypes'].items():
        if dtypes is not None and dtype not in dtypes:
            continue
        t0 = time.perf_counter()
        fr = frames[:n] if n else frames
        outs, rows, model = _jax_run(config, paths, dtype, fr)
        cuts = None
        if rows is not None:
            with jax.enable_x64(True):
                cuts = _jax_cut_scores(config, paths, fr, rows, model)
        entry = {'frames': summarize(outs, rows, cuts)}
        note = ''
        if dtype == 'f32':
            f32 = entry
            entry['decisive_share'] = {p: decisive_share(entry['frames'], p)
                                       for p in LIMITS}
            note = f'decisive share {entry["decisive_share"]}'
        else:
            d = _matched_distances(outs, rows, f32['frames'][:len(fr)])
            if 'heatmap_rel_max' not in d:
                raise ValueError(
                    f'[{config} {dtype}] the JAX package\'s {dtype} run '
                    f'keeps people {d["people"]}, its f32 run '
                    f'{[f["people"] for f in f32["frames"][:len(fr)]]}: '
                    f'choose another frame seed')
            entry['jax_vs_f32'] = d['heatmap_rel_max']
            entry['jax_vs_f32_mean'] = d['heatmap_rel_mean']
            entry['jax_vs_f32_within_1px'] = d['within_1px']
            if rows is not None:
                entry['jax_vs_f32_box_px'] = d['box_err_px']
                entry['jax_vs_f32_det_px'] = d['det_box_err_px']
            note = (f'JAX {dtype} vs f32 {entry["jax_vs_f32"]:.3e} of max, '
                    f'{entry["jax_vs_f32_within_1px"]:.3f} within 1 px'
                    + (f', boxes {d["box_err_px"]:.3f} px, detector boxes '
                       f'{d["det_box_err_px"]:.3f} px' if rows is not None
                       else ''))
        if dtype == 'int8':
            entry['jax_scales'] = _jax_scales(model)
            spreads = {}
            if cfg.get('model_name', 'HRNet') == 'HRNet':
                o, r, _ = _jax_run(config, paths, dtype, fr,
                                   use_fused_kernels=False)
                spreads['plain_graph'] = _matched_distances(
                    o, r, entry['frames'])
            with _jax_amax_moved():
                o, r, _ = _jax_run(config, paths, dtype, fr)
            spreads['amax_moved'] = _matched_distances(o, r,
                                                       entry['frames'])
            for k, d in spreads.items():
                if 'heatmap_rel_max' not in d:
                    raise ValueError(f'[{config} int8] {k}: people '
                                     f'{d["people"]}: choose another frame '
                                     f'seed')
            entry['jax_int8_spreads'] = {k: d['heatmap_rel_max']
                                         for k, d in spreads.items()}
            entry['jax_int8_spread'] = max(
                entry['jax_int8_spreads'].values())
            counts = {k: len(v) for k, v in entry['jax_scales'].items()}
            note += (f'; int8 spread {entry["jax_int8_spreads"]}; '
                     f'quantized convs {counts}')
        golden['dtypes'][dtype] = entry
        print(f'[{config} {dtype}] {len(fr)} frames, people '
              f'{[f["people"] for f in entry["frames"]]}, '
              f'{time.perf_counter() - t0:.1f} s; {note}', flush=True)
        if dtype == 'f32' and min(entry['decisive_share'].values()) < \
                DECISIVE_SHARE:
            print(f'[{config}] fewer than {DECISIVE_SHARE:.0%} of the '
                  f'joints are decisive at some limit: --seed-search K '
                  f'tries other frame seeds', flush=True)
    return golden


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--only', nargs='*', default=None,
                    help='configs to regenerate (default: all)')
    ap.add_argument('--seed-search', type=int, default=0, metavar='K',
                    help='print each config\'s decisive share at its frame '
                    'seed and the next K-1 seeds (f32 only); write nothing')
    ap.add_argument('--bn-spreads', action='store_true',
                    help='measure every BN\'s input spread (torch, no JAX), '
                    'write them to port_bn_spreads.json and print each '
                    'network\'s folded bias over its conv output spread; '
                    'a new set changes every fingerprint, so regenerate '
                    'the goldens after it')
    ap.add_argument('--cpu-check', nargs=2, metavar=('CONFIG', 'DTYPE'),
                    help='hold the port on the CPU against one golden pair '
                    '(its frames, the CPU limits; torch, no JAX) and print '
                    'the comparison: for the pairs the CPU tests leave to '
                    'the card')
    args = ap.parse_args(argv)

    if args.cpu_check:
        config, dtype = args.cpu_check
        n = CONFIGS[config]['dtypes'][dtype]
        frames = config_frames(config)[:n]
        with tempfile.TemporaryDirectory() as tmp:
            paths = {k: v[0] for k, v in
                     write_weights(tmp, config_weights(config)).items()}
            model = port_facade(config, paths, dtype)
            outs = run_facade(model, config, frames)
            rows = (detector_rows(model.detector, frames)
                    if model.detector is not None else None)
        r = compare(outs, load_golden(config), dtype, 'cpu', rows=rows,
                    frames=slice(0, len(frames)),
                    scales=quantized_scales(model) if dtype == 'int8'
                    else None)
        print(report(r), flush=True)
        return 0 if r['ok'] else 1

    if args.bn_spreads:
        spreads = {}
        for name in WEIGHTS:
            spreads[name], r = measure_bn_spreads(name)
            print(f'{name}: {len(r)} folded convs, bias RMS over output '
                  f'spread: min {r.min():.3f}, median {np.median(r):.3f}, '
                  f'max {r.max():.3f}', flush=True)
        with open(BN_SPREADS_FILE, 'w') as f:
            json.dump(spreads, f, separators=(',', ':'))
            f.write('\n')
        return 0

    # the JAX facade's Pallas kernels run (interpreted), as on its TPU and
    # as the JAX package's kernel tests run them, not their XLA fallbacks
    os.environ['SHT_PALLAS_CPU_INTERPRET'] = '1'
    import jax
    jax.config.update('jax_platforms', 'cpu')
    commit = _jax_commit()
    names = args.only or list(CONFIGS)
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        need = sorted({w for c in names for w in config_weights(c)})
        files = write_weights(tmp, need)
        paths = {k: v[0] for k, v in files.items()}
        fps = {k: v[1] for k, v in files.items()}
        for config in names:
            if args.seed_search:
                base = CONFIGS[config]['frame_seed']
                for s in range(base, base + args.seed_search):
                    g = generate(config, paths, fps, commit, seed=s,
                                 dtypes=('f32',))
                    print(f'[{config}] frame seed {s}: decisive share '
                          f'{g["dtypes"]["f32"]["decisive_share"]}')
                continue
            golden = generate(config, paths, fps, commit)
            path = os.path.join(GOLDEN_DIR, f'port_{config}.json')
            with open(path, 'w') as f:
                json.dump(golden, f, separators=(',', ':'))
                f.write('\n')
            print(f'wrote {path} ({os.path.getsize(path)} bytes)',
                  flush=True)
    print(f'goldens: {time.perf_counter() - t_all:.1f} s', flush=True)
    return 0


if __name__ == '__main__':
    sys.path.insert(0, REPO)
    sys.exit(main())
