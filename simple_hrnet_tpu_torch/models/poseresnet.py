"""PoseResNet (SimpleBaselines) pose network in PyTorch (NHWC in, NHWC
heatmaps out).

Counterpart of ``simple_hrnet_tpu/models/poseresnet.py``: a ResNet
backbone (18/34/50/101/152) -> three stride-2 4x4 transposed convs
(256 channels, no bias, each with BN and ReLU) -> a 1x1 head computed in
f32. Module names are the official ``pose_resnet_*`` ``state_dict`` names
(``conv1``, ``bn1``, ``layer1..4``, ``deconv_layers.{0..8}``,
``final_layer``). No CUDA kernel of the port runs here: the JAX package
computes this network in XLA outside any Pallas kernel, and the port runs
it as cuDNN convs and transposed convs.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from simple_hrnet_tpu_torch.models import layers as L
from simple_hrnet_tpu_torch.models import quantize as Q

# block type and blocks per layer (the JAX package's RESNET_SPEC)
RESNET_SPEC = {
    18: ('basic', [2, 2, 2, 2]),
    34: ('basic', [3, 4, 6, 3]),
    50: ('bottleneck', [3, 4, 6, 3]),
    101: ('bottleneck', [3, 4, 23, 3]),
    152: ('bottleneck', [3, 8, 36, 3]),
}
DECONV_CHANNELS = 256


class PoseResNet(nn.Module):
    """PoseResNet-``resnet_size`` with ``nof_joints`` heatmap channels."""

    def __init__(self, resnet_size: int = 50, nof_joints: int = 17):
        super().__init__()
        if resnet_size not in RESNET_SPEC:
            raise ValueError(f'resnet_size {resnet_size} not in '
                             f'{sorted(RESNET_SPEC)}')
        block_type, counts = RESNET_SPEC[resnet_size]
        basic = block_type == 'basic'
        expansion = 1 if basic else 4
        self.resnet_size = resnet_size
        self.nof_joints = nof_joints
        self.conv1 = L.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = L.bn(64)
        inplanes = 64
        for li, n_blocks in enumerate(counts, start=1):
            planes = 64 * 2 ** (li - 1)
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (li > 1 and b == 0) else 1
                ds = stride != 1 or inplanes != planes * expansion
                blocks.append((L.BasicBlock if basic else L.Bottleneck)(
                    inplanes, planes, stride, downsample=ds))
                inplanes = planes * expansion
            self.add_module(f'layer{li}', nn.Sequential(*blocks))
        deconvs = []
        for _ in range(3):
            deconvs += [L.ConvTranspose2d(inplanes, DECONV_CHANNELS, 4,
                                          stride=2, padding=1, bias=False),
                        L.bn(DECONV_CHANNELS), nn.ReLU()]
            inplanes = DECONV_CHANNELS
        self.deconv_layers = nn.Sequential(*deconvs)
        self.final_layer = L.Conv2d(DECONV_CHANNELS, nof_joints, 1)
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) normalized RGB -> (N, H/4, W/4, nof_joints) f32."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        # padding counts as -inf, as the JAX package's max_pool pads
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.deconv_layers(x)
        # head in f32, as in the JAX package (bf16 runs upcast here)
        return self.final_layer(x.float()).permute(0, 2, 3, 1)


def init(resnet_size: int = 50, nof_joints: int = 17,
         seed: int = 0) -> PoseResNet:
    """Fresh PoseResNet with torch-default (kaiming-uniform) conv and
    transposed-conv init drawn from a generator seeded with ``seed``;
    identity BN statistics."""
    model = PoseResNet(resnet_size, nof_joints)
    L.init_(model, torch.Generator().manual_seed(seed))
    return model.eval()


def prepare_inference(model: PoseResNet, dtype: torch.dtype = torch.float32,
                      amax: Optional[Dict[str, float]] = None
                      ) -> PoseResNet:
    """Fold BN (the transposed convs' too), quantize (``amax``) and cast
    every conv and transposed conv but the f32 head to ``dtype``, in
    place, on the model's current device.

    ``amax``: the calibration map of ``quantize.calibrate``, taken on the
    folded f32 model BEFORE this call. Every calibrated conv that
    ``quantize.default_policy`` accepts becomes a ``QConv2d`` (on
    ResNet-50, the 3x3 convs of ``layer1`` and ``layer2``); the transposed
    convs are never calibrated (they are not ``nn.Conv2d``), as the JAX
    package's ``deconv2d`` records no amax."""
    model.eval()
    L.fold_batch_norm(model)
    if amax is not None:
        Q.quantize_folded(model, amax)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)) and \
                mod is not model.final_layer:
            mod.to(dtype)
    if next(model.parameters()).device.type == 'cuda':
        model.to(memory_format=torch.channels_last)
    model.compute_dtype = dtype
    model.requires_grad_(False)
    return model
