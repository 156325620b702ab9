"""YOLOv5 person detector in PyTorch.

Counterpart of ``simple_hrnet_tpu/detectors/yolov5.py``: the v6.x graph
(CSPDarknet C3 backbone, SPPF, PANet head, anchor Detect) with the
standard depth/width multiples (n/s/m/l/x). Module names are the
ultralytics ``state_dict`` names (``model.0.conv.weight`` ...
``model.24.m.{0,1,2}.weight``), and original ultralytics ``.pt``
checkpoints load through a stub-unpickler that needs no ultralytics
install. The detect is the JAX package's, all on the device: letterbox ->
network -> v5 decode -> score ``obj * cls_conf`` kept for the person
class -> top-K candidates -> class-agnostic greedy NMS (CUDA kernel K1 on
the card) -> rescale, with static-shape (max_det, 7) rows per frame and a
validity mask, in the reference's row format (x1, y1, x2, y2, conf,
cls_conf, cls_pred).

The 6x6 stride-2 stem (``model.0``) runs, by default at an even
``img_size`` as in the JAX package, as its exact phase-space rewrite
(``ops/phase.py``; ``stem_phaseable``, ``phase_stem_params``): a 3x3
stride-1 conv over the (N, S/2, S/2, 12) phase tensor that the letterbox
emits; ``phase_stem=False`` keeps the one 6x6 conv.
"""

from __future__ import annotations

import functools
import math
import os
import pickle
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from simple_hrnet_tpu_torch.detectors.yolov3 import (
    PersonDetector, _resolve_dtype, kept_rows, resolve_phase_stem,
    top_candidates)
from simple_hrnet_tpu_torch.models import layers as L
from simple_hrnet_tpu_torch.models import quantize as Q
from simple_hrnet_tpu_torch.models.convert import load_into
from simple_hrnet_tpu_torch.ops import phase as P
from simple_hrnet_tpu_torch.ops.cuda import activation as A
from simple_hrnet_tpu_torch.ops.nms import nms_ingraph
from simple_hrnet_tpu_torch.utils.device import host_to_device, resolve_device

# depth_multiple, width_multiple per variant (ultralytics yolov5*.yaml)
VARIANTS = {
    'yolov5n': (0.33, 0.25),
    'yolov5s': (0.33, 0.50),
    'yolov5m': (0.67, 0.75),
    'yolov5l': (1.00, 1.00),
    'yolov5x': (1.33, 1.25),
}

ANCHORS = np.asarray([
    [[10, 13], [16, 30], [33, 23]],        # P3/8
    [[30, 61], [62, 45], [59, 119]],       # P4/16
    [[116, 90], [156, 198], [373, 326]],   # P5/32
], np.float32)


def _divisible(x: float, d: int = 8) -> int:
    return max(d, int(math.ceil(x / d) * d)) if x > 0 else 0


def _depth(n: int, d: float) -> int:
    return max(round(n * d), 1)


def build_config(variant: str = 'yolov5m', num_classes: int = 80) -> dict:
    """Static layer plan: channels and repeat counts for a variant."""
    d, w = VARIANTS[variant]
    ch = {k: _divisible(v * w) for k, v in
          {'64': 64, '128': 128, '256': 256, '512': 512, '1024': 1024}.items()}
    return {
        'variant': variant, 'num_classes': num_classes,
        'c64': ch['64'], 'c128': ch['128'], 'c256': ch['256'],
        'c512': ch['512'], 'c1024': ch['1024'],
        'n3': _depth(3, d), 'n6': _depth(6, d), 'n9': _depth(9, d),
    }


class Conv(nn.Module):
    """ultralytics Conv: conv -> BN -> SiLU. After folding, ``bn`` is an
    ``nn.Identity``; after int8 quantization ``conv`` is a
    ``layers.QConv2d`` and SiLU stays outside it, in the compute type.
    The SiLU is ``x * (1 / (exp(-x) + 1))`` rounded to the compute type
    after each op, as the JAX package's ``jax.nn.silu`` rounds in bf16
    (``ops/activation.py``); on the card it is kernel K4
    (``ops/cuda/activation.py``), one launch a Conv."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 pad: Optional[int] = None):
        super().__init__()
        self.conv = L.Conv2d(c_in, c_out, k, stride=stride,
                             padding=k // 2 if pad is None else pad,
                             bias=False)
        self.bn = L.bn(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return A.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """1x1 Conv -> 3x3 Conv, plus the input when ``shortcut``."""

    def __init__(self, c: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = Conv(c, c, 1)
        self.cv2 = Conv(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs: cv3(cat(m(cv1(x)), cv2(x)))."""

    def __init__(self, c_in: int, c_out: int, n: int,
                 shortcut: bool = True):
        super().__init__()
        c_ = c_out // 2
        self.cv1 = Conv(c_in, c_, 1)
        self.cv2 = Conv(c_in, c_, 1)
        self.cv3 = Conv(2 * c_, c_out, 1)
        self.m = nn.Sequential(*[Bottleneck(c_, shortcut) for _ in range(n)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: three chained 5x5 stride-1 max pools
    (padding counts as -inf, as the JAX package's max_pool pads)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.cv1 = Conv(c_in, c_in // 2, 1)
        self.cv2 = Conv(c_in * 2, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        y1 = F.max_pool2d(x, 5, stride=1, padding=2)
        y2 = F.max_pool2d(y1, 5, stride=1, padding=2)
        y3 = F.max_pool2d(y2, 5, stride=1, padding=2)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


class Detect(nn.Module):
    """The three 1x1 output convs (with bias), run in f32."""

    def __init__(self, channels: Tuple[int, int, int], n_out: int):
        super().__init__()
        self.m = nn.ModuleList([L.Conv2d(c, n_out, 1) for c in channels])


@functools.lru_cache(maxsize=None)
def _anchors_on(level: int, device: torch.device) -> torch.Tensor:
    """One level's (3, 2) anchors as f32 on ``device``, copied once."""
    return host_to_device(ANCHORS[level], device)


def _detect_decode(y: torch.Tensor, level: int, img_size: int
                   ) -> torch.Tensor:
    """v5 Detect decode of one level: (N, 3*(5+C), gh, gw) NCHW f32 ->
    (N, 3*gh*gw, 5+C) with xy = (2 s(t) - 0.5 + grid) * stride and wh =
    (2 s(t))^2 * anchor, flattened (anchor, gy, gx) as the JAX package
    flattens its (gh, gw, 3, 5+C) split: output channel ``a * (5+C) + k``
    is anchor a's entry k."""
    n, ch, gh, gw = y.shape
    stride = img_size / gw
    y = torch.sigmoid(y.reshape(n, 3, ch // 3, gh, gw).permute(0, 1, 3, 4, 2))
    cy = torch.arange(gh, dtype=torch.float32, device=y.device)[:, None]
    cx = torch.arange(gw, dtype=torch.float32, device=y.device)[None, :]
    anchors = _anchors_on(level, y.device)
    bx = (y[..., 0] * 2 - 0.5 + cx) * stride
    by = (y[..., 1] * 2 - 0.5 + cy) * stride
    bw = torch.square(y[..., 2] * 2) * anchors[None, :, None, None, 0]
    bh = torch.square(y[..., 3] * 2) * anchors[None, :, None, None, 1]
    out = torch.cat([torch.stack([bx, by, bw, bh, y[..., 4]], dim=-1),
                     y[..., 5:]], dim=-1)
    return out.reshape(n, 3 * gh * gw, ch // 3)


class YOLOv5Net(nn.Module):
    """The v6.x network of one variant; layers 11/15 (upsample) and
    12/16/19/22 (concat) hold no weights and have no module."""

    def __init__(self, cfg: dict):
        super().__init__()
        c64, c128, c256 = cfg['c64'], cfg['c128'], cfg['c256']
        c512, c1024 = cfg['c512'], cfg['c1024']
        n3, n6, n9 = cfg['n3'], cfg['n6'], cfg['n9']
        self.model = nn.ModuleDict({
            '0': Conv(3, c64, 6, 2, pad=2),                  # P1/2
            '1': Conv(c64, c128, 3, 2),                      # P2/4
            '2': C3(c128, c128, n3),
            '3': Conv(c128, c256, 3, 2),                     # P3/8
            '4': C3(c256, c256, n6),
            '5': Conv(c256, c512, 3, 2),                     # P4/16
            '6': C3(c512, c512, n9),
            '7': Conv(c512, c1024, 3, 2),                    # P5/32
            '8': C3(c1024, c1024, n3),
            '9': SPPF(c1024, c1024),
            '10': Conv(c1024, c512, 1),
            '13': C3(c1024, c512, n3, shortcut=False),
            '14': Conv(c512, c256, 1),
            '17': C3(c512, c256, n3, shortcut=False),        # P3 head
            '18': Conv(c256, c256, 3, 2),
            '20': C3(c512, c512, n3, shortcut=False),        # P4 head
            '21': Conv(c512, c512, 3, 2),
            '23': C3(c1024, c1024, n3, shortcut=False),      # P5 head
            '24': Detect((c256, c512, c1024),
                         3 * (cfg['num_classes'] + 5)),
        })
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor, img_size: int) -> torch.Tensor:
        """(N, S, S, 3) in [0, 1] NHWC -> (N, anchors, 5 + classes) f32;
        after ``phase_stem_params``, x is the (N, S/2, S/2, 12) phase
        tensor and ``model.0`` the 3x3 stride-1 rewrite of the stem."""
        m = self.model
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = m['1'](m['0'](x))
        x = m['2'](x)
        p3 = x = m['4'](m['3'](x))
        p4 = x = m['6'](m['5'](x))
        x = m['9'](m['8'](m['7'](x)))
        x = h10 = m['10'](x)
        x = torch.cat([F.interpolate(x, scale_factor=2, mode='nearest'), p4],
                      1)
        x = h14 = m['14'](m['13'](x))
        x = torch.cat([F.interpolate(x, scale_factor=2, mode='nearest'), p3],
                      1)
        out3 = x = m['17'](x)
        out4 = x = m['20'](torch.cat([m['18'](x), h14], 1))
        out5 = m['23'](torch.cat([m['21'](x), h10], 1))
        return torch.cat([
            _detect_decode(head(feat.float()), li, img_size)
            for li, (head, feat) in enumerate(zip(m['24'].m,
                                                  (out3, out4, out5)))], 1)


def stem_phaseable(net: YOLOv5Net) -> bool:
    """True when ``model.0`` is the 6x6 stride-2 stem over 3 channels (the
    JAX package's ``yolov5.stem_phaseable``)."""
    return tuple(net.model['0'].conv.weight.shape[1:]) == (3, 6, 6)


@torch.no_grad()
def phase_stem_params(net: YOLOv5Net) -> YOLOv5Net:
    """Rewrite, in place, the FOLDED ``model.0`` 6x6 stride-2 pad-2 conv
    into its exact phase-space form (``ops/phase.py`` ``phase_kernel_s2``):
    (c, 3, 6, 6) -> (c, 12, 3, 3), stride 1, pad 1 all round, its output
    already in the standard layout. Run it before int8 calibration; the
    12-channel kernel falls outside the policy, as the 3-channel one does.
    Returns ``net``."""
    if not stem_phaseable(net):
        raise ValueError('phase_stem needs model.0 to be the 6x6 stride-2 '
                         'stem over 3 channels')
    old = net.model['0'].conv
    kp, ((top, _), (left, _)) = P.phase_kernel_s2(P.hwio(old.weight), pad=2)
    conv = L.Conv2d(kp.shape[2], kp.shape[3], kp.shape[0],
                    padding=(top, left), bias=old.bias is not None)
    conv.weight = nn.Parameter(P.oihw(kp).to(old.weight.device),
                               requires_grad=False)
    conv.bias = old.bias
    net.model['0'].conv = conv
    return net


def init(cfg: dict, seed: int = 0) -> YOLOv5Net:
    """Random weights (torch-default kaiming-uniform bounds, drawn from a
    generator seeded with ``seed``), identity BN statistics."""
    net = YOLOv5Net(cfg)
    L.init_(net, torch.Generator().manual_seed(seed))
    return net.eval()


def load_ultralytics_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A flat f32 state_dict from an ultralytics YOLOv5 ``.pt``.

    These checkpoints pickle whole nn.Module objects of the yolov5 repo; a
    stub unpickler materializes classes it cannot import as attribute bags,
    and the module tree is walked for its ``_parameters``/``_buffers``
    (fp16 tensors cast to f32). No ultralytics install needed; unpickling
    runs whatever code the file names, so load trusted files only. The BN
    ``eps`` the modules carry (1e-3 in ultralytics' own) is not read: the
    weights fold with 1e-5, as the JAX package's loader folds them."""

    class _Stub:
        def __setstate__(self, state):
            if isinstance(state, dict):
                self.__dict__.update(state)
            else:
                self.__dict__['_state'] = state

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except Exception:
                return type(name, (_Stub,), {'__module__': module})

    shim = type(pickle)('shim_pickle')
    shim.Unpickler = _Unpickler
    shim.load = lambda f, **kw: _Unpickler(f).load()

    ckpt = torch.load(path, map_location='cpu', pickle_module=shim,
                      weights_only=False)
    model = ckpt.get('model', ckpt) if isinstance(ckpt, dict) else ckpt

    flat: Dict[str, torch.Tensor] = {}

    def walk(obj, prefix=''):
        d = getattr(obj, '__dict__', {})
        for group in ('_parameters', '_buffers'):
            for name, t in (d.get(group) or {}).items():
                if t is not None:
                    flat[prefix + name] = t.detach().float()
        for name, child in (d.get('_modules') or {}).items():
            if child is not None:
                walk(child, f'{prefix}{name}.')

    walk(model)
    if not flat:
        raise ValueError(f'no parameters found in {path}')
    return {k: v for k, v in flat.items()
            if not k.endswith(('anchor_grid', 'anchors'))}


def _variant(model_def: str) -> str:
    """The variant a checkpoint's basename names (the last match in
    VARIANTS order), yolov5m otherwise — the JAX package's rule."""
    base = os.path.basename(model_def).rsplit('.', 1)[0]
    variant = 'yolov5m'
    for v in VARIANTS:
        if base.startswith(v):
            variant = v
    return variant


class YOLOv5(PersonDetector):
    """Person detector with the reference adapter's contract.

    ``model_def``: an ultralytics ``.pt`` path (the variant from its
    basename) or a variant name ('yolov5m' ...; anything else means
    yolov5m) for random weights (seed 0). ``device``: 'cuda' (default;
    raises without a card) or 'cpu'. ``dtype``: None (f32), 'bfloat16', or
    'int8': bf16, the JAX package's measured policy for this graph, unless
    ``quantize_int8=True`` calibrates on a smooth synthetic frame and
    quantizes the policy-accepted convs. ``phase_stem``: None (on at an
    even ``img_size``, as in the JAX package), True (an odd size raises)
    or False.
    """

    def __init__(self, model_def: str = 'yolov5m',
                 device: Union[str, torch.device, None] = None,
                 dtype: Union[str, torch.dtype, None] = None,
                 conf_thres: float = 0.5, nms_thres: float = 0.45,
                 img_size: int = 640, max_detections: int = 32,
                 max_batch_size: int = 16,
                 phase_stem: Optional[bool] = None,
                 quantize_int8: Optional[bool] = None):
        if quantize_int8 is not None and dtype != 'int8':
            raise ValueError("quantize_int8 only applies with dtype='int8'")
        self.cfg = build_config(_variant(model_def))
        if os.path.exists(model_def):
            net = load_into(YOLOv5Net(self.cfg),
                            load_ultralytics_state_dict(model_def))
        else:
            net = init(self.cfg, seed=0)
        self.device = resolve_device(device)
        net = L.fold_batch_norm(net.eval().to(self.device))
        self.phase_stem = resolve_phase_stem(phase_stem, stem_phaseable(net),
                                             img_size)
        if self.phase_stem:
            phase_stem_params(net)
        self.quantized = False
        if dtype == 'int8':
            if quantize_int8:
                cal = Q.smooth_frames((img_size, img_size))
                if self.phase_stem:
                    cal = P.space_to_depth_host(cal)
                amax = Q.calibrate(net, [torch.from_numpy(cal).to(
                    self.device)], forward=lambda v: net(v, img_size))
                Q.quantize_folded(net, amax)
                self.quantized = True
            dtype = 'bfloat16'
        self.dtype = _resolve_dtype(dtype)
        heads = set(net.model['24'].m)  # the Detect convs stay f32
        for mod in net.modules():
            if isinstance(mod, nn.Conv2d) and mod not in heads:
                mod.to(self.dtype)
        if self.device.type == 'cuda':
            net.to(memory_format=torch.channels_last)
        net.compute_dtype = self.dtype
        self.net = net.requires_grad_(False)
        self.conf_thres = conf_thres
        self.nms_thres = nms_thres
        self.img_size = img_size
        self.max_detections = max_detections
        self.max_batch_size = max(1, max_batch_size)

    @torch.no_grad()
    def _detect(self, frames: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, H, W, 3) RGB on the device -> rows (N, max_det, 7) f32,
        valid (N, max_det) bool."""
        in_hw = (frames.shape[1], frames.shape[2])
        img_size = self.img_size
        preds = self.net(self._letterbox(frames), img_size)
        cls_scores = preds[..., 5:]
        cls_conf = cls_scores.amax(dim=-1)
        cls_pred = torch.argmax(cls_scores, dim=-1)
        # the v5 rule: score = obj * cls_conf, person class only
        score = preds[..., 4] * cls_conf
        score = torch.where((score >= self.conf_thres) & (cls_pred == 0),
                            score, torch.zeros((), device=score.device))
        top_scores, top_idx, boxes = top_candidates(preds, score)
        # class-agnostic NMS (no class offset)
        keep_idx, keep_valid = nms_ingraph(boxes, top_scores, self.nms_thres,
                                           self.max_detections)
        rows = kept_rows(boxes, top_scores, torch.gather(cls_conf, 1, top_idx),
                         torch.gather(cls_pred, 1, top_idx), keep_idx,
                         img_size, in_hw)
        return rows, keep_valid
