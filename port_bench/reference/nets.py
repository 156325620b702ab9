"""Plain PyTorch networks of the benchmark's configurations, in f32.

HRNet (Sun et al. 2019, the official ``pose_hrnet`` graph), PoseResNet
(Xiao et al. 2018, SimpleBaselines), YOLOv3 (darknet ``yolov3.cfg``) and
YOLOv5 v6.x (ultralytics ``models/yolov5*.yaml``), written from their
published descriptions with the module names of the official
``state_dict`` files, so that one flat state dict loads into these and
into the program alike. BatchNorm stays a separate eval-mode layer; every
conv is a plain ``nn.Conv2d`` (or ``nn.ConvTranspose2d``) and every
activation a plain ``torch`` call: no kernel, no folding, no bf16.
Tensors are NCHW. Nothing here imports the measured program.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


def conv3x3(c_in: int, c_out: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, stride=stride, padding=1, bias=False)


def conv1x1(c_in: int, c_out: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 1, stride=stride, bias=False)


def bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv3x3(c_in, planes, stride)
        self.bn1 = bn(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = bn(planes)
        self.downsample = (nn.Sequential(conv1x1(c_in, planes, stride),
                                         bn(planes)) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv1x1(c_in, planes)
        self.bn1 = bn(planes)
        self.conv2 = conv3x3(planes, planes, stride)
        self.bn2 = bn(planes)
        self.conv3 = conv1x1(planes, planes * 4)
        self.bn3 = bn(planes * 4)
        self.downsample = (nn.Sequential(conv1x1(c_in, planes * 4, stride),
                                         bn(planes * 4))
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


# ---------------------------------------------------------------------------
# HRNet
# ---------------------------------------------------------------------------

def _conv_bn_relu(c_in: int, c_out: int, stride: int) -> nn.Sequential:
    return nn.Sequential(conv3x3(c_in, c_out, stride), bn(c_out), nn.ReLU())


class StageModule(nn.Module):
    """Four BasicBlocks a branch, then every output fused from every
    branch: 1x1 conv + BN + nearest upsample from lower resolutions,
    strided 3x3 convs from higher ones, summed and ReLU'd."""

    def __init__(self, n_branches: int, n_out: int, c: int):
        super().__init__()
        self.branches = nn.ModuleList([
            nn.Sequential(*[BasicBlock(c * 2 ** b, c * 2 ** b)
                            for _ in range(4)]) for b in range(n_branches)])
        self.fuse_layers = nn.ModuleList()
        for i in range(n_out):
            row = nn.ModuleList()
            ci = c * 2 ** i
            for j in range(n_branches):
                cj = c * 2 ** j
                if i == j:
                    row.append(nn.Sequential())
                elif i < j:
                    row.append(nn.Sequential(
                        conv1x1(cj, ci), bn(ci),
                        nn.Upsample(scale_factor=2 ** (j - i),
                                    mode='nearest')))
                else:
                    steps = [_conv_bn_relu(cj, cj, 2)
                             for _ in range(i - j - 1)]
                    steps.append(nn.Sequential(conv3x3(cj, ci, 2), bn(ci)))
                    row.append(nn.Sequential(*steps))
            self.fuse_layers.append(row)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        out = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                y = xs[j] if i == j else layer(xs[j])
                acc = y if acc is None else acc + y
            out.append(F.relu(acc))
        return out


class HRNet(nn.Module):
    """HRNet-W``c``: (N, 3, H, W) normalized RGB -> (N, J, H/4, W/4)."""

    def __init__(self, c: int = 48, nof_joints: int = 17):
        super().__init__()
        self.conv1 = conv3x3(3, 64, 2)
        self.bn1 = bn(64)
        self.conv2 = conv3x3(64, 64, 2)
        self.bn2 = bn(64)
        self.layer1 = nn.Sequential(Bottleneck(64, 64, downsample=True),
                                    *[Bottleneck(256, 64) for _ in range(3)])
        self.transition1 = nn.ModuleList([
            _conv_bn_relu(256, c, 1),
            nn.Sequential(_conv_bn_relu(256, 2 * c, 2))])
        self.stage2 = nn.Sequential(StageModule(2, 2, c))
        self.transition2 = nn.ModuleList([
            nn.Sequential(), nn.Sequential(),
            nn.Sequential(_conv_bn_relu(2 * c, 4 * c, 2))])
        self.stage3 = nn.Sequential(*[StageModule(3, 3, c)
                                      for _ in range(4)])
        self.transition3 = nn.ModuleList([
            nn.Sequential(), nn.Sequential(), nn.Sequential(),
            nn.Sequential(_conv_bn_relu(4 * c, 8 * c, 2))])
        self.stage4 = nn.Sequential(StageModule(4, 4, c), StageModule(4, 4, c),
                                    StageModule(4, 1, c))
        self.final_layer = nn.Conv2d(c, nof_joints, 1)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = [self.transition1[0](x), self.transition1[1](x)]
        xs = self.stage2(xs)
        xs = self.stage3(xs + [self.transition2[2](xs[-1])])
        xs = self.stage4(xs + [self.transition3[3](xs[-1])])
        return self.final_layer(xs[0])


# ---------------------------------------------------------------------------
# PoseResNet
# ---------------------------------------------------------------------------

RESNET_SPEC = {18: ('basic', [2, 2, 2, 2]), 34: ('basic', [3, 4, 6, 3]),
               50: ('bottleneck', [3, 4, 6, 3]),
               101: ('bottleneck', [3, 4, 23, 3]),
               152: ('bottleneck', [3, 8, 36, 3])}


class PoseResNet(nn.Module):
    """ResNet backbone -> three 4x4 stride-2 transposed convs of 256
    channels (BN, ReLU) -> 1x1 head."""

    def __init__(self, resnet_size: int = 50, nof_joints: int = 17):
        super().__init__()
        kind, counts = RESNET_SPEC[resnet_size]
        basic = kind == 'basic'
        expansion = 1 if basic else 4
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = bn(64)
        inplanes = 64
        for li, n_blocks in enumerate(counts, start=1):
            planes = 64 * 2 ** (li - 1)
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (li > 1 and b == 0) else 1
                ds = stride != 1 or inplanes != planes * expansion
                blocks.append((BasicBlock if basic else Bottleneck)(
                    inplanes, planes, stride, downsample=ds))
                inplanes = planes * expansion
            self.add_module(f'layer{li}', nn.Sequential(*blocks))
        deconvs = []
        for _ in range(3):
            deconvs += [nn.ConvTranspose2d(inplanes, 256, 4, stride=2,
                                           padding=1, bias=False),
                        bn(256), nn.ReLU()]
            inplanes = 256
        self.deconv_layers = nn.Sequential(*deconvs)
        self.final_layer = nn.Conv2d(256, nof_joints, 1)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.final_layer(self.deconv_layers(x))


# ---------------------------------------------------------------------------
# YOLOv3 (darknet)
# ---------------------------------------------------------------------------

YOLOV3_ANCHORS = [(10, 13), (16, 30), (33, 23), (30, 61), (62, 45),
                  (59, 119), (116, 90), (156, 198), (373, 326)]


def _dconv(filters, size, stride=1, bn_=True, act='leaky'):
    return {'type': 'convolutional', 'filters': filters, 'size': size,
            'stride': stride, 'pad': (size - 1) // 2, 'bn': bn_,
            'activation': act}


def yolov3_blocks(num_classes: int = 80) -> list:
    """``yolov3.cfg``: Darknet-53, then three YOLO heads with FPN routes."""
    nf = 3 * (num_classes + 5)
    b = [_dconv(32, 3)]
    for filters, repeats in [(64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)]:
        b.append(_dconv(filters, 3, stride=2))
        for _ in range(repeats):
            b += [_dconv(filters // 2, 1), _dconv(filters, 3),
                  {'type': 'shortcut', 'from': -3}]
    idx_36, idx_61 = 36, 61

    def head(c, mask):
        out = []
        for _ in range(2):
            out += [_dconv(c, 1), _dconv(2 * c, 3)]
        out += [_dconv(c, 1), _dconv(2 * c, 3),
                _dconv(nf, 1, bn_=False, act='linear'),
                {'type': 'yolo', 'mask': mask, 'classes': num_classes}]
        return out

    b += head(512, [6, 7, 8])
    b += [{'type': 'route', 'layers': [-4]}, _dconv(256, 1),
          {'type': 'upsample', 'stride': 2},
          {'type': 'route', 'layers': [-1, idx_61]}]
    b += head(256, [3, 4, 5])
    b += [{'type': 'route', 'layers': [-4]}, _dconv(128, 1),
          {'type': 'upsample', 'stride': 2},
          {'type': 'route', 'layers': [-1, idx_36]}]
    b += head(128, [0, 1, 2])
    return b


class DarknetConv(nn.Module):
    def __init__(self, c_in: int, blk: dict):
        super().__init__()
        f, k = blk['filters'], blk['size']
        self.stride, self.pad = blk['stride'], blk['pad']
        self.act = blk['activation']
        self.weight = nn.Parameter(torch.empty(f, c_in, k, k))
        self.bias = None if blk['bn'] else nn.Parameter(torch.empty(f))
        self.bn = bn(f) if blk['bn'] else None

    def forward(self, x):
        y = F.conv2d(x, self.weight, self.bias, self.stride, self.pad)
        if self.bn is not None:
            y = self.bn(y)
        return F.leaky_relu(y, 0.1) if self.act == 'leaky' else y


def yolo_decode(x: torch.Tensor, mask: list, img_size: int) -> torch.Tensor:
    """(N, 3 (5+C), g, g) -> (N, 3 g g, 5+C) of (cx, cy, w, h) in input
    pixels, sigmoid objectness and class scores, flattened (anchor, gy,
    gx) as darknet flattens them."""
    n, ch, gh, gw = x.shape
    na = len(mask)
    anchors = torch.tensor([YOLOV3_ANCHORS[m] for m in mask],
                           dtype=torch.float32, device=x.device)
    stride = img_size / gw
    x = x.reshape(n, na, ch // na, gh, gw).permute(0, 1, 3, 4, 2)
    cy = torch.arange(gh, dtype=torch.float32, device=x.device)[:, None]
    cx = torch.arange(gw, dtype=torch.float32, device=x.device)[None, :]
    bx = (torch.sigmoid(x[..., 0]) + cx) * stride
    by = (torch.sigmoid(x[..., 1]) + cy) * stride
    bw = torch.exp(x[..., 2]) * anchors[None, :, None, None, 0]
    bh = torch.exp(x[..., 3]) * anchors[None, :, None, None, 1]
    out = torch.cat([torch.stack([bx, by, bw, bh, torch.sigmoid(x[..., 4])],
                                 -1), torch.sigmoid(x[..., 5:])], -1)
    return out.reshape(n, na * gh * gw, ch // na)


class Darknet(nn.Module):
    """YOLOv3: (N, 3, S, S) in [0, 1] -> (N, anchors, 5 + classes)."""

    def __init__(self, blocks: list):
        super().__init__()
        self.blocks = blocks
        chans, prev = [], 3
        for i, blk in enumerate(blocks):
            t = blk['type']
            if t == 'convolutional':
                self.add_module(f'conv_{i}', DarknetConv(prev, blk))
                chans.append(blk['filters'])
            elif t == 'route':
                chans.append(sum(chans[l if l >= 0 else i + l]
                                 for l in blk['layers']))
            else:
                chans.append(chans[-1])
            prev = chans[-1]

    def forward(self, x, img_size: int):
        outputs, dets = [], []
        for i, blk in enumerate(self.blocks):
            t = blk['type']
            if t == 'convolutional':
                x = getattr(self, f'conv_{i}')(x)
            elif t == 'shortcut':
                x = x + outputs[i + blk['from']]
            elif t == 'route':
                feats = [outputs[l if l >= 0 else i + l]
                         for l in blk['layers']]
                x = feats[0] if len(feats) == 1 else torch.cat(feats, 1)
            elif t == 'upsample':
                x = F.interpolate(x, scale_factor=blk['stride'],
                                  mode='nearest')
            elif t == 'yolo':
                dets.append(yolo_decode(x, blk['mask'], img_size))
            outputs.append(x)
        return torch.cat(dets, 1)

    def head_names(self) -> list:
        """State-dict names (weight, bias) of the three output convs, whose
        rows are anchor-major (x, y, w, h, objectness, classes)."""
        return [(f'{n}.weight', f'{n}.bias') for n, m in self.named_modules()
                if isinstance(m, DarknetConv) and m.bn is None]


# ---------------------------------------------------------------------------
# YOLOv5 v6.x
# ---------------------------------------------------------------------------

YOLOV5_VARIANTS = {'yolov5n': (0.33, 0.25), 'yolov5s': (0.33, 0.50),
                   'yolov5m': (0.67, 0.75), 'yolov5l': (1.00, 1.00),
                   'yolov5x': (1.33, 1.25)}
YOLOV5_ANCHORS = [[[10, 13], [16, 30], [33, 23]],
                  [[30, 61], [62, 45], [59, 119]],
                  [[116, 90], [156, 198], [373, 326]]]


class Conv(nn.Module):
    """conv -> BN -> SiLU."""

    def __init__(self, c_in, c_out, k, stride=1, pad=None):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, stride,
                              k // 2 if pad is None else pad, bias=False)
        self.bn = bn(c_out)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class V5Bottleneck(nn.Module):
    def __init__(self, c, shortcut=True):
        super().__init__()
        self.cv1, self.cv2 = Conv(c, c, 1), Conv(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C3(nn.Module):
    def __init__(self, c_in, c_out, n, shortcut=True):
        super().__init__()
        c_ = c_out // 2
        self.cv1, self.cv2 = Conv(c_in, c_, 1), Conv(c_in, c_, 1)
        self.cv3 = Conv(2 * c_, c_out, 1)
        self.m = nn.Sequential(*[V5Bottleneck(c_, shortcut)
                                 for _ in range(n)])

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPPF(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.cv1, self.cv2 = Conv(c_in, c_in // 2, 1), Conv(c_in * 2, c_out, 1)

    def forward(self, x):
        x = self.cv1(x)
        y1 = F.max_pool2d(x, 5, 1, 2)
        y2 = F.max_pool2d(y1, 5, 1, 2)
        return self.cv2(torch.cat([x, y1, y2, F.max_pool2d(y2, 5, 1, 2)], 1))


class Detect(nn.Module):
    def __init__(self, channels, n_out):
        super().__init__()
        self.m = nn.ModuleList([nn.Conv2d(c, n_out, 1) for c in channels])


def v5_decode(y: torch.Tensor, level: int, img_size: int) -> torch.Tensor:
    n, ch, gh, gw = y.shape
    stride = img_size / gw
    y = torch.sigmoid(y.reshape(n, 3, ch // 3, gh, gw).permute(0, 1, 3, 4, 2))
    cy = torch.arange(gh, dtype=torch.float32, device=y.device)[:, None]
    cx = torch.arange(gw, dtype=torch.float32, device=y.device)[None, :]
    a = torch.tensor(YOLOV5_ANCHORS[level], dtype=torch.float32,
                     device=y.device)
    bx = (y[..., 0] * 2 - 0.5 + cx) * stride
    by = (y[..., 1] * 2 - 0.5 + cy) * stride
    bw = torch.square(y[..., 2] * 2) * a[None, :, None, None, 0]
    bh = torch.square(y[..., 3] * 2) * a[None, :, None, None, 1]
    out = torch.cat([torch.stack([bx, by, bw, bh, y[..., 4]], -1),
                     y[..., 5:]], -1)
    return out.reshape(n, 3 * gh * gw, ch // 3)


class YOLOv5Net(nn.Module):
    """(N, 3, S, S) in [0, 1] -> (N, anchors, 5 + classes)."""

    def __init__(self, variant: str = 'yolov5m', num_classes: int = 80):
        super().__init__()
        d, w = YOLOV5_VARIANTS[variant]

        def ch(v):
            return max(8, int(math.ceil(v * w / 8) * 8))

        def depth(n):
            return max(round(n * d), 1)

        c64, c128, c256, c512, c1024 = (ch(v) for v in (64, 128, 256, 512,
                                                        1024))
        n3, n6, n9 = depth(3), depth(6), depth(9)
        self.model = nn.ModuleDict({
            '0': Conv(3, c64, 6, 2, pad=2), '1': Conv(c64, c128, 3, 2),
            '2': C3(c128, c128, n3), '3': Conv(c128, c256, 3, 2),
            '4': C3(c256, c256, n6), '5': Conv(c256, c512, 3, 2),
            '6': C3(c512, c512, n9), '7': Conv(c512, c1024, 3, 2),
            '8': C3(c1024, c1024, n3), '9': SPPF(c1024, c1024),
            '10': Conv(c1024, c512, 1),
            '13': C3(c1024, c512, n3, shortcut=False),
            '14': Conv(c512, c256, 1),
            '17': C3(c512, c256, n3, shortcut=False),
            '18': Conv(c256, c256, 3, 2),
            '20': C3(c512, c512, n3, shortcut=False),
            '21': Conv(c512, c512, 3, 2),
            '23': C3(c1024, c1024, n3, shortcut=False),
            '24': Detect((c256, c512, c1024), 3 * (num_classes + 5)),
        })

    def forward(self, x, img_size: int):
        m = self.model
        x = m['2'](m['1'](m['0'](x)))
        p3 = x = m['4'](m['3'](x))
        p4 = x = m['6'](m['5'](x))
        x = h10 = m['10'](m['9'](m['8'](m['7'](x))))
        x = h14 = m['14'](m['13'](torch.cat(
            [F.interpolate(x, scale_factor=2, mode='nearest'), p4], 1)))
        out3 = x = m['17'](torch.cat(
            [F.interpolate(x, scale_factor=2, mode='nearest'), p3], 1))
        out4 = x = m['20'](torch.cat([m['18'](x), h14], 1))
        out5 = m['23'](torch.cat([m['21'](x), h10], 1))
        return torch.cat([v5_decode(head(f), i, img_size) for i, (head, f) in
                          enumerate(zip(m['24'].m, (out3, out4, out5)))], 1)

    def head_names(self) -> list:
        return [(f'model.24.m.{i}.weight', f'model.24.m.{i}.bias')
                for i in range(len(self.model['24'].m))]


def build(recipe: dict) -> nn.Module:
    """The network a configuration file's ``pose`` or ``detector`` entry
    names (``kind`` and its sizes)."""
    kind, kw = recipe['kind'], recipe
    if kind == 'hrnet':
        return HRNet(kw['c'], kw.get('nof_joints', 17))
    if kind == 'poseresnet':
        return PoseResNet(kw['c'], kw.get('nof_joints', 17))
    if kind == 'yolov3':
        return Darknet(yolov3_blocks())
    if kind == 'yolov5':
        return YOLOv5Net(kw.get('variant', 'yolov5m'))
    raise ValueError(f'unknown network kind {kind!r}')
