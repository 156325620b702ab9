"""Darknet (YOLOv3 / YOLOv3-tiny and user ``.cfg`` graphs) network, cfg
parsing, init and ``.weights`` loading in PyTorch.

Counterpart of ``simple_hrnet_tpu/detectors/darknet.py``. The block lists
are copies of the JAX package's (identical to the official cfgs), and
``parse_cfg`` reads a darknet ``.cfg`` into the same format with the JAX
package's semantics: the activations linear, leaky, relu, logistic, mish
and swish/silu (anything else raises at parse time), an explicit
``padding=``, routes with ``groups``/``group_id`` (one channel group of
the concatenation), and a strided maxpool padded by ``(size - 1) // 2``. A
convolutional block ``i`` is the module ``conv_<i>`` with ``weight``
(OIHW), ``bias`` (no BN) or a ``bn`` BatchNorm2d child — the JAX param
tree's names, so ``models.convert.from_jax_params`` carries weights across.
The space-to-depth phase stem (a TPU layout device) is not ported.

``Darknet.forward`` is the counterpart of ``darknet.apply``: NHWC input
in [0, 1], output (N, total_anchors, 5 + classes) f32 decoded boxes in the
darknet flatten order (anchor, gy, gx).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from simple_hrnet_tpu_torch.models.convert import load_into
from simple_hrnet_tpu_torch.models.layers import add_bias, init_conv_
from simple_hrnet_tpu_torch.ops.cuda import activation as A
from simple_hrnet_tpu_torch.utils.device import host_to_device

Block = Dict[str, Any]


def _conv(filters: int, size: int, stride: int = 1, bn: bool = True,
          activation: str = 'leaky') -> Block:
    return {'type': 'convolutional', 'filters': filters, 'size': size,
            'stride': stride, 'pad': (size - 1) // 2, 'bn': bn,
            'activation': activation}


def _res(filters: int) -> List[Block]:
    """Darknet-53 residual unit: 1x1 half-width, 3x3 full, shortcut -3."""
    return [_conv(filters // 2, 1), _conv(filters, 3),
            {'type': 'shortcut', 'from': -3}]


YOLOV3_ANCHORS = [(10, 13), (16, 30), (33, 23), (30, 61), (62, 45),
                  (59, 119), (116, 90), (156, 198), (373, 326)]
TINY_ANCHORS = [(10, 14), (23, 27), (37, 58), (81, 82), (135, 169),
                (344, 319)]


def yolov3_blocks(num_classes: int = 80) -> List[Block]:
    """The YOLOv3 graph (Darknet-53 + FPN heads), identical to yolov3.cfg."""
    nf = 3 * (num_classes + 5)
    b: List[Block] = [_conv(32, 3)]
    for filters, repeats in [(64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)]:
        b.append(_conv(filters, 3, stride=2))
        for _ in range(repeats):
            b.extend(_res(filters))
    # indices of the 256- and 512-channel stage outputs (official cfg: 36, 61)
    idx_36 = 1 + (1 + 3 * 1) + (1 + 3 * 2) + (1 + 3 * 8) - 1
    idx_61 = idx_36 + (1 + 3 * 8)
    for _ in range(2):
        b.extend([_conv(512, 1), _conv(1024, 3)])
    b.append(_conv(512, 1))
    b.extend([_conv(1024, 3), _conv(nf, 1, bn=False, activation='linear')])
    b.append({'type': 'yolo', 'mask': [6, 7, 8], 'anchors': YOLOV3_ANCHORS,
              'classes': num_classes})
    b.append({'type': 'route', 'layers': [-4]})
    b.extend([_conv(256, 1), {'type': 'upsample', 'stride': 2},
              {'type': 'route', 'layers': [-1, idx_61]}])
    for _ in range(2):
        b.extend([_conv(256, 1), _conv(512, 3)])
    b.append(_conv(256, 1))
    b.extend([_conv(512, 3), _conv(nf, 1, bn=False, activation='linear')])
    b.append({'type': 'yolo', 'mask': [3, 4, 5], 'anchors': YOLOV3_ANCHORS,
              'classes': num_classes})
    b.append({'type': 'route', 'layers': [-4]})
    b.extend([_conv(128, 1), {'type': 'upsample', 'stride': 2},
              {'type': 'route', 'layers': [-1, idx_36]}])
    for _ in range(2):
        b.extend([_conv(128, 1), _conv(256, 3)])
    b.append(_conv(128, 1))
    b.extend([_conv(256, 3), _conv(nf, 1, bn=False, activation='linear')])
    b.append({'type': 'yolo', 'mask': [0, 1, 2], 'anchors': YOLOV3_ANCHORS,
              'classes': num_classes})
    return b


def yolov3_tiny_blocks(num_classes: int = 80) -> List[Block]:
    """The YOLOv3-tiny graph, identical to yolov3-tiny.cfg."""
    nf = 3 * (num_classes + 5)
    b: List[Block] = []
    for filters in [16, 32, 64, 128, 256]:
        b.append(_conv(filters, 3))
        b.append({'type': 'maxpool', 'size': 2, 'stride': 2})
    b.append(_conv(512, 3))
    b.append({'type': 'maxpool', 'size': 2, 'stride': 1})  # 'same' maxpool
    b.append(_conv(1024, 3))
    b.append(_conv(256, 1))
    b.append(_conv(512, 3))
    b.append(_conv(nf, 1, bn=False, activation='linear'))
    b.append({'type': 'yolo', 'mask': [3, 4, 5], 'anchors': TINY_ANCHORS,
              'classes': num_classes})
    b.append({'type': 'route', 'layers': [-4]})
    b.append(_conv(128, 1))
    b.append({'type': 'upsample', 'stride': 2})
    b.append({'type': 'route', 'layers': [-1, 8]})
    b.append(_conv(256, 3))
    b.append(_conv(nf, 1, bn=False, activation='linear'))
    b.append({'type': 'yolo', 'mask': [0, 1, 2], 'anchors': TINY_ANCHORS,
              'classes': num_classes})
    return b


ACTIVATIONS = ('linear', 'leaky', 'relu', 'logistic', 'mish', 'swish',
               'silu')


def parse_cfg(path: str) -> List[Block]:
    """Parse a darknet .cfg into the block-list format above (the JAX
    package's ``parse_cfg``)."""
    sections: List[Tuple[str, Dict[str, str]]] = []
    with open(path) as f:
        current: Optional[Dict[str, str]] = None
        for line in f:
            line = line.strip()
            if not line or line.startswith(('#', ';')):
                continue
            if line.startswith('['):
                current = {}
                sections.append((line[1:-1].strip(), current))
            elif current is not None and '=' in line:
                k, v = line.split('=', 1)
                current[k.strip()] = v.strip()

    blocks: List[Block] = []
    for name, sec in sections:
        if name in ('net', 'network'):
            continue
        if name == 'convolutional':
            act = sec.get('activation', 'linear')
            if act not in ACTIVATIONS:
                # an unknown activation run as linear would give garbage
                # detections
                raise ValueError(
                    f'Unsupported darknet activation {act!r} (supported: '
                    'linear, leaky, relu, logistic, mish, swish/silu)')
            size = int(sec['size'])
            if 'padding' in sec:  # darknet's explicit padding= overrides
                pad = int(sec['padding'])
            else:
                pad = (size - 1) // 2 if sec.get('pad') == '1' else 0
            blocks.append({
                'type': 'convolutional',
                'filters': int(sec['filters']),
                'size': size,
                'stride': int(sec.get('stride', 1)),
                'pad': pad,
                'bn': sec.get('batch_normalize') == '1',
                'activation': act,
            })
        elif name == 'shortcut':
            blocks.append({'type': 'shortcut', 'from': int(sec['from'])})
        elif name == 'route':
            blk: Block = {'type': 'route', 'layers': [
                int(x) for x in sec['layers'].split(',')]}
            if 'groups' in sec:  # yolov4-tiny channel-split routes
                blk['groups'] = int(sec['groups'])
                blk['group_id'] = int(sec.get('group_id', 0))
            blocks.append(blk)
        elif name == 'upsample':
            blocks.append({'type': 'upsample', 'stride': int(sec['stride'])})
        elif name == 'maxpool':
            blocks.append({'type': 'maxpool', 'size': int(sec.get('size', 2)),
                           'stride': int(sec.get('stride', 2))})
        elif name == 'yolo':
            a = [float(x) for x in sec['anchors'].split(',')]
            blocks.append({'type': 'yolo',
                           'mask': [int(x) for x in sec['mask'].split(',')],
                           'anchors': [(a[i], a[i + 1])
                                       for i in range(0, len(a), 2)],
                           'classes': int(sec.get('classes', 80))})
        else:
            raise ValueError(f'Unsupported darknet section [{name}]')
    return blocks


def output_channels(blocks: List[Block], in_channels: int = 3) -> List[int]:
    """Static per-layer output channel counts."""
    chans: List[int] = []
    for i, blk in enumerate(blocks):
        t = blk['type']
        if t == 'convolutional':
            chans.append(blk['filters'])
        elif t in ('shortcut', 'upsample', 'maxpool', 'yolo'):
            chans.append(chans[i - 1] if i else in_channels)
        elif t == 'route':
            chans.append(sum(chans[l if l >= 0 else i + l]
                             for l in blk['layers']) // blk.get('groups', 1))
        else:
            raise ValueError(f'unsupported darknet block {t!r}')
    return chans


def phase_stem_convs(blocks: List[Block]) -> List[str]:
    """The convs that the JAX package's phase stem (``darknet.
    stem_phaseable`` and ``phase_stem_params`` there, on by default at an
    even ``img_size``) rewrites out of the int8 policy, which would
    otherwise take them: ``conv_1`` where a stride-2 3x3 conv follows the
    first conv (YOLOv3; its rewritten form (2, 2, 4co, c1) has kh < 3).
    None where a 2x2 stride-2 maxpool follows it (YOLOv3-tiny) or the stem
    does not qualify (a stride-1 3x3 conv first, then that downsample, and
    no later block routing back to block 0). ``conv_0`` (three input
    channels) is outside the policy either way."""
    if len(blocks) < 2:
        return []
    b0, b1 = blocks[0], blocks[1]
    if not (b0['type'] == 'convolutional' and b0['size'] == 3
            and b0['stride'] == 1 and b0['pad'] == 1):
        return []
    down_conv = (b1['type'] == 'convolutional' and b1['size'] == 3
                 and b1['stride'] == 2 and b1['pad'] == 1)
    down_pool = (b1['type'] == 'maxpool' and b1['size'] == 2
                 and b1['stride'] == 2)
    if not (down_conv or down_pool):
        return []
    for i, blk in enumerate(blocks):
        back = ([blk['from']] if blk['type'] == 'shortcut' else
                blk['layers'] if blk['type'] == 'route' else [])
        if any((l if l >= 0 else i + l) == 0 for l in back):
            return []
    return ['conv_1'] if down_conv else []


@functools.lru_cache(maxsize=None)
def _leaky_slope(dtype: torch.dtype) -> float:
    """darknet's leaky slope 0.1 in ``dtype``, as ``jax.nn.leaky_relu``
    casts it before its product (0.10009765625 in bf16), so that
    ``F.leaky_relu`` rounds the same exact product once."""
    return float(torch.tensor(0.1, dtype=dtype))


class DarknetConv(nn.Module):
    """One convolutional block: conv (bias only without BN) -> BN ->
    activation. After int8 quantization (``quantize.quantize_folded`` with
    ``types=(DarknetConv,)``) its folded conv runs as ``self.qconv``, a
    ``layers.QConv2d``.

    Each activation rounds where the JAX package's does in the compute
    type: leaky's slope is rounded before its one product
    (``_leaky_slope``) and relu is exact; logistic, mish and swish/silu
    are written op by op and rounded after each op, as XLA rounds
    ``jax.nn.sigmoid``, ``y * tanh(softplus(y))`` and ``y * sigmoid(y)``
    (``ops/activation.py``; kernel K4 on the card)."""

    def __init__(self, c_in: int, blk: Block):
        super().__init__()
        f, k = blk['filters'], blk['size']
        self.stride = blk['stride']
        self.padding = blk['pad']
        if blk['activation'] not in ACTIVATIONS:
            raise ValueError(f"unsupported activation {blk['activation']!r}")
        self.activation = blk['activation']
        self.weight = nn.Parameter(torch.empty(f, c_in, k, k))
        self.bias = (None if blk['bn'] else nn.Parameter(torch.empty(f)))
        self.bn = nn.BatchNorm2d(f, eps=1e-5) if blk['bn'] else None
        self.qconv: Optional[nn.Module] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.qconv is not None:
            y = self.qconv(x)
        else:
            y = add_bias(F.conv2d(x, self.weight, None, stride=self.stride,
                                  padding=self.padding), self.bias)
        if self.bn is not None:
            y = self.bn(y)
        act = self.activation
        if act == 'leaky':
            y = F.leaky_relu(y, _leaky_slope(y.dtype))
        elif act == 'relu':
            y = F.relu(y)
        elif act == 'logistic':
            y = A.sigmoid(y)
        elif act == 'mish':
            y = A.mish(y)
        elif act in ('swish', 'silu'):
            y = A.silu(y)
        return y

    def fold(self) -> None:
        """Absorb BN into the conv (same arithmetic as the JAX package)."""
        if self.bn is None:
            return
        with torch.no_grad():
            inv = self.bn.weight / torch.sqrt(self.bn.running_var
                                              + self.bn.eps)
            self.weight.mul_(inv[:, None, None, None])
            self.bias = nn.Parameter(self.bn.bias - self.bn.running_mean * inv,
                                     requires_grad=False)
        self.bn = None


@functools.lru_cache(maxsize=None)
def _anchors_on(anchors: Tuple[Tuple[float, ...], ...],
                device: torch.device) -> torch.Tensor:
    """A YOLO head's (w, h) anchors as f32 on ``device``, copied once."""
    return host_to_device(np.asarray(anchors, np.float32), device)


def _yolo_decode(x: torch.Tensor, blk: Block, img_size: int) -> torch.Tensor:
    """One YOLO head: (N, A*(5+C), g, g) NCHW -> (N, A*g*g, 5+C), boxes
    (cx, cy, w, h) in input pixels, sigmoid objectness and class scores,
    flattened (anchor, gy, gx) like darknet — the channel split is
    anchor-major, exactly the JAX package's NHWC reshape."""
    n, _, gh, gw = x.shape
    n_cls = blk['classes']
    na = len(blk['mask'])
    anchors = _anchors_on(
        tuple(tuple(blk['anchors'][m]) for m in blk['mask']), x.device)
    stride = img_size / gw
    x = x.float().reshape(n, na, 5 + n_cls, gh, gw).permute(0, 1, 3, 4, 2)
    cy = torch.arange(gh, dtype=torch.float32, device=x.device)[:, None]
    cx = torch.arange(gw, dtype=torch.float32, device=x.device)[None, :]
    bx = (torch.sigmoid(x[..., 0]) + cx) * stride
    by = (torch.sigmoid(x[..., 1]) + cy) * stride
    bw = torch.exp(x[..., 2]) * anchors[None, :, None, None, 0]
    bh = torch.exp(x[..., 3]) * anchors[None, :, None, None, 1]
    obj = torch.sigmoid(x[..., 4])
    cls = torch.sigmoid(x[..., 5:])
    out = torch.cat([torch.stack([bx, by, bw, bh, obj], dim=-1), cls], -1)
    return out.reshape(n, na * gh * gw, 5 + n_cls)


class Darknet(nn.Module):
    """A darknet graph from a block list."""

    def __init__(self, blocks: List[Block], in_channels: int = 3):
        super().__init__()
        self.blocks = blocks
        chans = output_channels(blocks, in_channels)
        prev = in_channels
        for i, blk in enumerate(blocks):
            if blk['type'] == 'convolutional':
                self.add_module(f'conv_{i}', DarknetConv(prev, blk))
            prev = chans[i]
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor, img_size: int) -> torch.Tensor:
        """(N, S, S, 3) in [0, 1] NHWC -> (N, anchors, 5 + classes) f32."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        outputs: List[torch.Tensor] = []
        detections: List[torch.Tensor] = []
        for i, blk in enumerate(self.blocks):
            t = blk['type']
            if t == 'convolutional':
                x = getattr(self, f'conv_{i}')(x)
            elif t == 'shortcut':
                f = blk['from']
                x = x + outputs[f if f >= 0 else i + f]
            elif t == 'route':
                feats = [outputs[l if l >= 0 else i + l]
                         for l in blk['layers']]
                x = feats[0] if len(feats) == 1 else torch.cat(feats, 1)
                g = blk.get('groups', 1)
                if g > 1:  # yolov4-tiny: the route keeps one channel group
                    cg = x.shape[1] // g
                    gid = blk.get('group_id', 0)
                    x = x[:, gid * cg:(gid + 1) * cg]
            elif t == 'upsample':
                x = F.interpolate(x, scale_factor=blk['stride'],
                                  mode='nearest')
            elif t == 'maxpool':
                k = blk['size']
                if blk['stride'] == 1:
                    # darknet 'same' maxpool (tiny): pad right/bottom
                    x = F.pad(x, (0, k - 1, 0, k - 1), value=float('-inf'))
                    x = F.max_pool2d(x, k, 1)
                else:
                    # MaxPool2d with padding (size - 1) // 2, as the JAX
                    # package: 0 for the built-in cfgs' even windows, not
                    # for e.g. a size-3 pool of a user cfg
                    x = F.max_pool2d(x, k, blk['stride'],
                                     padding=(k - 1) // 2)
            elif t == 'yolo':
                detections.append(_yolo_decode(x, blk, img_size))
            outputs.append(x)
        return torch.cat(detections, dim=1)

    def fold(self) -> 'Darknet':
        for m in self.modules():
            if isinstance(m, DarknetConv):
                m.fold()
        return self


def init(blocks: List[Block], seed: int = 0,
         in_channels: int = 3) -> Darknet:
    """Random darknet weights (torch-default kaiming-uniform bounds, drawn
    from a generator seeded with ``seed``), identity BN statistics."""
    net = Darknet(blocks, in_channels)
    gen = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, DarknetConv):
            init_conv_(m.weight, m.bias, gen)
    return net.eval()


def darknet_weights_state_dict(path: str, blocks: List[Block],
                               in_channels: int = 3
                               ) -> Dict[str, torch.Tensor]:
    """Read an original darknet ``.weights`` binary (5 int32 header, then per
    conv [bn_bias, bn_scale, bn_mean, bn_var] or [conv_bias], then OIHW
    weights) into a ``Darknet`` state_dict."""
    chans = output_channels(blocks, in_channels)
    data = np.fromfile(path, dtype=np.float32, offset=5 * 4)
    ptr = 0
    sd: Dict[str, torch.Tensor] = {}

    def take(n: int) -> np.ndarray:
        nonlocal ptr
        if ptr + n > data.size:
            raise ValueError(f'{path}: weights file too short for the graph')
        out = data[ptr:ptr + n]
        ptr += n
        return out

    prev = in_channels
    for i, blk in enumerate(blocks):
        if blk['type'] == 'convolutional':
            f, k = blk['filters'], blk['size']
            p = f'conv_{i}'
            if blk['bn']:
                for name in ('bias', 'weight', 'running_mean', 'running_var'):
                    sd[f'{p}.bn.{name}'] = torch.from_numpy(take(f).copy())
            else:
                sd[f'{p}.bias'] = torch.from_numpy(take(f).copy())
            sd[f'{p}.weight'] = torch.from_numpy(
                take(f * prev * k * k).reshape(f, prev, k, k).copy())
        prev = chans[i]
    if ptr != data.size:
        raise ValueError(f'weights file size mismatch: consumed {ptr} of '
                         f'{data.size} floats — cfg/graph does not match')
    return sd


def load_darknet_weights(path: str, blocks: List[Block],
                         in_channels: int = 3) -> Darknet:
    """A ``Darknet`` with the weights of an original ``.weights`` file."""
    net = Darknet(blocks, in_channels)
    return load_into(net, darknet_weights_state_dict(path, blocks,
                                                     in_channels)).eval()


def save_darknet_weights(net: Darknet, path: str) -> None:
    """Write ``net`` (unfolded) as an original darknet ``.weights`` binary."""
    parts = [np.zeros(5, np.int32).view(np.float32)]
    for i, blk in enumerate(net.blocks):
        if blk['type'] != 'convolutional':
            continue
        m = getattr(net, f'conv_{i}')
        if blk['bn']:
            if m.bn is None:
                raise ValueError('save_darknet_weights needs unfolded BN')
            parts += [m.bn.bias, m.bn.weight, m.bn.running_mean,
                      m.bn.running_var]
        else:
            parts.append(m.bias)
        parts.append(m.weight)
    np.concatenate([np.asarray(p.detach().cpu().float().reshape(-1))
                    if isinstance(p, torch.Tensor) else p
                    for p in parts]).astype(np.float32).tofile(path)


def fold_weights(net: Darknet, dtype: Optional[torch.dtype] = None
                 ) -> Darknet:
    """Fold BN for inference and cast the convs' weights to ``dtype`` (the
    YOLO decode stays f32; a quantized block's f32 scales stay f32)."""
    net.fold()
    if dtype is not None:
        for m in net.modules():
            if isinstance(m, DarknetConv):
                m.weight.data = m.weight.data.to(dtype)
                if m.bias is not None:
                    m.bias.data = m.bias.data.to(dtype)
        net.compute_dtype = dtype
    net.requires_grad_(False)
    return net
