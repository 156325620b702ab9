"""Seeded weights, drawn on the device, and the checkpoint files the
program reads.

The recipe is the repository's seeded-weight recipe for its production
goldens (``tests/torch_goldens.py`` ``WEIGHTS``, ``seeded_network``):
every conv weight and bias uniform within ``gain`` times torch's default
bound ``1 / sqrt(fan_in)``; every BatchNorm's ``weight`` and
``running_var`` uniform in [0.8, 1.25], its ``bias`` and
``running_mean`` uniform in [-1, 1] times ``bn_shift`` times the spread
of that BN's input on the goldens' frame (``bn_spreads.json``, a frozen
copy of ``tests/goldens/port_bn_spreads.json``), so that every folded
bias is non-zero; a detector's head rows scaled and offset (``wh_gain``,
``wh_logit``, ``obj_gain``, ``person_logit``) so that it keeps separate
people of tens to hundreds of pixels. Here the draws come from a
``torch.Generator`` on the device, seeded from the run's seed, one draw
a network, and the detector's objectness offset is set from the run's
own frames so that the reference detector keeps the mix's people a frame
(``people_offset``). The weights are kept in bfloat16, the type the
program serves them in; the reference computes with the same values in
float32.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from port_bench.reference import nets
from port_bench.reference import pipeline as R

SPREADS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'bn_spreads.json')
SERVE_DTYPE = torch.bfloat16


def sub_seed(seed: int, salt: int) -> int:
    """A generator seed for one use of the run's seed (any whole number)."""
    return (int(seed) * 1_000_003 + salt * 7_919) % (1 << 62)


def _leaves(net: nn.Module):
    """(name, kind, shape, fan-in) of every drawn state-dict entry, in
    ``state_dict`` order; kind is 'conv', 'bn_unit' (weight, running_var)
    or 'bn_shift' (bias, running_mean). BN counters are skipped."""
    modules = dict(net.named_modules())
    out = []
    for key, t in net.state_dict(keep_vars=True).items():
        owner, _, leaf = key.rpartition('.')
        m = modules[owner]
        if isinstance(m, nn.BatchNorm2d):
            if leaf == 'num_batches_tracked':
                continue
            kind = 'bn_unit' if leaf in ('weight', 'running_var') \
                else 'bn_shift'
            out.append((key, kind, tuple(t.shape), 0))
        else:
            w = getattr(m, 'weight', None)
            if w is None or w.dim() != 4:
                raise ValueError(f'no draw rule for {key}')
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            out.append((key, 'conv', tuple(t.shape), fan_in))
    return out


@torch.no_grad()
def people_offset(net: nn.Module, recipe: dict, frames_rgb: torch.Tensor,
                  target: float) -> Tuple[float, float]:
    """The objectness-logit offset at which the reference detector keeps
    ``target`` people a frame (the median over ``frames_rgb``): the
    smallest offset, among those that let one more candidate past the
    score threshold, whose median count after NMS reaches the target (or
    the largest, where none does). Returns it and that median count.
    Counted with the reference's own NMS (``pipeline.greedy_nms``)."""
    raw = []
    heads = [net.get_submodule(w.rsplit('.', 1)[0])
             for w, _ in net.head_names()]
    hooks = [h.register_forward_hook(lambda m, a, out: raw.append(out))
             for h in heads]
    size = recipe['img_size']
    try:
        preds = net(R.letterbox(frames_rgb, size), size)
    finally:
        for h in hooks:
            h.remove()
    n = frames_rgb.shape[0]
    obj = torch.cat([r.reshape(n, 3, -1, *r.shape[2:])[:, :, 4].reshape(n, -1)
                     for r in raw], 1)
    cls_conf, cls_pred = preds[..., 5:].max(-1)
    person = (cls_pred == 0).cpu().numpy()
    factor = (cls_conf if recipe['kind'] == 'yolov5'
              else torch.ones_like(cls_conf)).double().cpu().numpy()
    xywh = preds[..., :4].double().cpu().numpy()
    boxes = np.concatenate([xywh[..., :2] - xywh[..., 2:] / 2,
                            xywh[..., :2] + xywh[..., 2:] / 2], -1)
    obj = obj.double().cpu().numpy()
    thres = recipe['conf_thres']
    boxes = torch.from_numpy(boxes)

    def median_count(delta: float) -> float:
        counts = []
        for f in range(n):
            s = factor[f] / (1.0 + np.exp(-(obj[f] + delta)))
            s = np.where((s >= thres) & person[f], s, 0.0)
            order = np.argsort(-s, kind='stable')[:R.TOP_K]
            counts.append(len(R.greedy_nms(
                boxes[f, order], torch.from_numpy(s[order]),
                recipe['nms_thres'], recipe['max_detections'])))
        return float(np.median(counts))

    # the offset at which each person candidate reaches the threshold
    q = thres / np.maximum(factor, 1e-12)
    ok = person & (q < 1.0)
    cands = np.unique(np.log(q[ok] / (1.0 - q[ok])) - obj[ok]) + 1e-6
    if len(cands) == 0:
        raise ValueError('no person candidate can reach the threshold')
    lo, hi = 0, len(cands) - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if median_count(cands[mid]) >= target:
            hi = mid
        else:
            lo = mid + 1
    return float(cands[lo]), median_count(cands[lo])


def spreads() -> dict:
    """Each goldens network's BN input spreads, in BN module order."""
    with open(SPREADS_FILE) as f:
        return json.load(f)


@torch.no_grad()
def draw(recipe: dict, scene: dict, seed: int, salt: int,
         device: torch.device, frames_rgb: Optional[torch.Tensor] = None
         ) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """One network's weights from ``recipe`` (a configuration's ``pose`` or
    ``detector`` entry) and, for a detector, the mix's ``scene`` for its
    head: the person-class logit raised by ``person_logit`` and the
    objectness offset found on ``frames_rgb`` for ``people_per_frame``.
    Returns the reference network on ``device`` (float32, eval) and the
    state dict in ``SERVE_DTYPE``, every entry a view of one flat
    buffer; the reference holds exactly the served values."""
    with torch.device('meta'):
        net = nets.build(recipe)
    leaves = _leaves(net)
    sizes = [math.prod(s) for _, _, s, _ in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, salt))
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    views = [v.view(s) for v, (_, _, s, _) in
             zip(torch.split(flat, sizes), leaves)]
    conv = [(v, recipe['gain'] / math.sqrt(k)) for v, (_, kind, _, k) in
            zip(views, leaves) if kind == 'conv']
    unit = [v for v, (_, kind, _, _) in zip(views, leaves)
            if kind == 'bn_unit']
    torch._foreach_mul_([v for v, _ in conv], [s for _, s in conv])
    torch._foreach_mul_(unit, 0.225)      # [-1, 1] -> [0.8, 1.25]
    torch._foreach_add_(unit, 1.025)
    state = {name: v for v, (name, _, _, _) in zip(views, leaves)}
    # bias and running mean: bn_shift times the BN's input spread
    bn_names = [n for n, m in net.named_modules()
                if isinstance(m, nn.BatchNorm2d)]
    spread = spreads()[recipe['spreads']]
    if len(spread) != len(bn_names):
        raise ValueError(f"{recipe['spreads']}: {len(spread)} BN spreads "
                         f'for {len(bn_names)} BNs')
    shift = [state[f'{n}.{leaf}'] for n in bn_names
             for leaf in ('bias', 'running_mean')]
    torch._foreach_mul_(shift, [recipe['bn_shift'] * sp for sp in spread
                                for _ in range(2)])
    ref = net.to_empty(device=device).eval()
    for m in ref.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.num_batches_tracked.zero_()
    biases = []
    if 'obj_gain' in recipe:
        edits = dict(recipe, **scene[recipe['kind']])
        for wname, bname in ref.head_names():
            w, b = state[wname], state[bname]
            rows = w.view(3, -1, *w.shape[1:])
            rows[:, 2:4] *= edits['wh_gain']
            rows[:, 4] *= edits['obj_gain']
            b = b.view(3, -1)
            b[:, 2:4] += edits['wh_logit']
            b[:, 5] += edits['person_logit']
            biases.append(b)
    ref.load_state_dict(state, strict=False)
    # the served values: rounded once to the serving type, and the
    # reference computes with exactly those values
    flat.copy_(flat.to(SERVE_DTYPE))
    ref.load_state_dict(state, strict=False)
    if biases:
        # the reference's own work, timed apart: not the program's set-up
        if flat.is_cuda:
            torch.cuda.synchronize(flat.device)
        t = time.perf_counter()
        with R.true_f32():
            delta, people = people_offset(ref, recipe, frames_rgb,
                                          edits['people_per_frame'])
        ref.calibration = {'objectness_offset': delta,
                           'median_people': people,
                           'reference_s': time.perf_counter() - t}
        for b in biases:
            b[:, 4] = (b[:, 4] + delta).to(SERVE_DTYPE).float()
        ref.load_state_dict(state, strict=False)
    served = {name: v.to(SERVE_DTYPE) for name, v in state.items()}
    return ref.eval(), served


def _module_tree(state: Dict[str, torch.Tensor]) -> nn.Module:
    """Plain ``nn.Module`` containers holding ``state`` under its dotted
    names: the layout of an ultralytics ``.pt`` (a pickled module tree)
    that any loader walking ``_parameters`` and ``_buffers`` reads."""
    root = nn.Module()
    for key, t in state.items():
        node = root
        *path, leaf = key.split('.')
        for part in path:
            if part not in node._modules:
                node.add_module(part, nn.Module())
            node = node._modules[part]
        node.register_buffer(leaf, t)
    return root


def write(state: Dict[str, torch.Tensor], kind: str, directory: str,
          name: str) -> str:
    """The checkpoint the program's facade reads: a ``.pth`` state dict, or
    for YOLOv5 an ultralytics-style ``.pt`` (``{'model': module}``)."""
    sizes = [v.numel() for v in state.values()]
    flat = torch.cat([v.reshape(-1) for v in state.values()]).to('cpu')
    cpu = {k: f.view(v.shape) for (k, v), f in
           zip(state.items(), torch.split(flat, sizes))}
    if kind == 'yolov5':
        path = os.path.join(directory, f'{name}.pt')
        torch.save({'model': _module_tree(cpu)}, path)
    else:
        path = os.path.join(directory, f'{name}.pth')
        torch.save(cpu, path)
    return path
