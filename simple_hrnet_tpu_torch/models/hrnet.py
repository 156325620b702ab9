"""HRNet pose network in PyTorch (NHWC in, NHWC heatmaps out).

Counterpart of ``simple_hrnet_tpu/models/hrnet.py``: stem -> 4 Bottlenecks
-> transitions creating 2/3/4 resolution branches -> repeated stage
modules with all-to-all fusion -> 1x1 head computed in f32. Module names
are the official ``pose_hrnet_*`` ``state_dict`` names.

After ``prepare_inference`` (BN folded, weights cast to the compute type)
every stage module runs hand-written CUDA kernels on CUDA tensors, where
the kernel takes the module's widths (each kernel's ``takes``):
  * branch 0's chain of 4 BasicBlocks through one of
      - ``int8_chain`` (B4) under int8, when its 8 convs are calibrated and
        the quantize policy accepts them, with the cast points of the
        formulation the JAX package runs at that width: its Pallas
        kernel's where ``G * c == 128`` and branch-0 W is a multiple of 8,
        its XLA chain's elsewhere (W48 among them);
      - ``wino_chain`` (B3) in bf16 where the JAX package runs its
        Winograd-H chain: ``G * c == 128`` with ``G = min(4, max(2, 128 //
        c))`` (W32 and W64), branch-0 H even and W a multiple of 8;
      - ``basic_chain`` (K2) everywhere else;
  * fusion output 0 (the high-res branch) through ``fuse_up`` (K3).
That is 8 chain and 8 fuse launches per forward at the published widths
(W32, W48). A chain or fusion that no kernel takes (c = 4, or bf16 c = 8)
runs the plain modules, on every device, as the JAX package runs XLA convs
off its lane rule. On CPU tensors the wrappers run their plain PyTorch
versions. The JAX package also gates K2 and K3 on filling 128 TPU lanes;
the port does not inherit that gate.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from simple_hrnet_tpu_torch.models import layers as L
from simple_hrnet_tpu_torch.models import quantize as Q
from simple_hrnet_tpu_torch.ops.cuda.fuse_up import (fuse_up,
                                                     takes as fuse_up_takes)
from simple_hrnet_tpu_torch.ops.cuda.fused_block import (
    basic_chain, pack_chain_weights, takes as basic_chain_takes)
from simple_hrnet_tpu_torch.ops.cuda.int8_chain import (
    int8_chain, pack_chain_weights_int8, takes as int8_chain_takes)
from simple_hrnet_tpu_torch.ops.cuda.winograd_chain import (
    pack_winograd_weights, takes as wino_chain_takes, wino_chain)

# (n_modules, n_branches) per stage; stage4's last module emits 1 branch
STAGE_CFG = {
    'stage2': (1, 2),
    'stage3': (4, 3),
    'stage4': (3, 4),
}


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW-logical (channels_last) -> contiguous NHWC, a view when the
    tensor is already channels_last."""
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _conv_bn_relu(c_in: int, c_out: int, stride: int) -> nn.Sequential:
    return nn.Sequential(L.conv3x3(c_in, c_out, stride), L.bn(c_out),
                         nn.ReLU())


class StageModule(nn.Module):
    """Per-branch 4x BasicBlock, then O(branches^2) fusion."""

    def __init__(self, n_branches: int, n_out: int, c: int):
        super().__init__()
        self.c = c
        self.n_branches = n_branches
        self.branches = nn.ModuleList([
            nn.Sequential(*[L.BasicBlock(c * 2 ** b, c * 2 ** b)
                            for _ in range(4)])
            for b in range(n_branches)])
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
                        L.conv1x1(cj, ci), L.bn(ci),
                        nn.Upsample(scale_factor=2 ** (j - i),
                                    mode='nearest')))
                else:
                    steps = [_conv_bn_relu(cj, cj, 2)
                             for _ in range(i - j - 1)]
                    steps.append(nn.Sequential(L.conv3x3(cj, ci, 2),
                                               L.bn(ci)))
                    row.append(nn.Sequential(*steps))
            self.fuse_layers.append(row)
        # kernel operands, set by pack() on folded weights: the chain's
        # (basic_chain operands, wino_chain weights or None) or int8_chain's;
        # int8_pallas_casts: whether the JAX package's Pallas int8 kernel,
        # and so its cast points, may run at this width
        self.chain: Optional[tuple] = None
        self.chain_int8: Optional[dict] = None
        self.int8_pallas_casts = False
        self.fuse: Optional[tuple] = None

    def pack(self, dtype: torch.dtype,
             amax: Optional[Dict[str, float]] = None,
             prefix: str = '') -> None:
        """Pack the folded f32 weights for the CUDA kernels: branch 0's
        chain and, for a multi-branch module, output 0's fusion sources.
        ``amax`` (calibration map by module path, this module at
        ``prefix``) selects the int8 chain when all 8 chain convs are
        calibrated and ``quantize.default_policy`` accepts them (the JAX
        package's ``all(...)`` test, hrnet_fast.py:128-130). A chain or a
        fusion that no kernel takes (each kernel's ``takes``) stays
        unpacked, and ``forward`` runs its plain modules, as the JAX
        package runs XLA convs off its lane rule (api.py:294-295). The
        decision depends only on the widths and ``dtype``, never on the
        device."""
        c = self.c
        convs = [conv for blk in self.branches[0]
                 for conv in (blk.conv1, blk.conv2)]
        if any(conv.bias is None for conv in convs):
            raise ValueError('pack() needs folded BN '
                             '(layers.fold_batch_norm first)')
        paths = [f'{prefix}.branches.0.{i // 2}.conv{i % 2 + 1}'
                 for i in range(8)]
        pairs = [(conv.weight, conv.bias) for conv in convs]
        self.chain = self.chain_int8 = self.fuse = None
        # the JAX package's image group G, whose G * c packed lanes decide
        # which chain formulation it runs (api.py:293-295)
        lanes_exact = min(4, max(2, 128 // c)) * c == 128
        self.int8_pallas_casts = lanes_exact
        if amax is not None and int8_chain_takes(c) and all(
                amax.get(p, 0.0) > 0.0 and
                Q.default_policy(Q.conv_shape(conv))
                for p, conv in zip(paths, convs)):
            self.chain_int8 = pack_chain_weights_int8(
                pairs, [amax[p] for p in paths])
        elif basic_chain_takes(c, dtype):
            w, b = pack_chain_weights(pairs, torch.float32)
            # the JAX package packs Winograd weights where G images fill
            # its 128 lanes (api.py:294-295, hrnet_fast.py:144-157) and runs
            # them in bf16 (winograd_chain.py:128-135); the Winograd form
            # rounds differently from the direct conv, so the port follows
            # the same rule to reproduce those numbers (every width B3
            # takes, K2 takes too: it runs where B3's shape rule fails)
            ww = (pack_winograd_weights(w, dtype)
                  if dtype == torch.bfloat16 and lanes_exact
                  and wino_chain_takes(c) else None)
            self.chain = (w.to(dtype), b, ww)
        if self.n_branches > 1:
            srcs = [self.fuse_layers[0][j][0]
                    for j in range(1, self.n_branches)]
            if fuse_up_takes(c, [conv.weight.shape[1] for conv in srcs],
                             [2 ** j for j in range(1, self.n_branches)],
                             dtype):
                bias_sum = torch.zeros_like(srcs[0].bias,
                                            dtype=torch.float32)
                for conv in srcs:
                    bias_sum = bias_sum + conv.bias.float()
                weights = [conv.weight[:, :, 0, 0].t().to(dtype).contiguous()
                           for conv in srcs]
                self.fuse = (weights, bias_sum)

    def _run_chain(self, x: torch.Tensor) -> torch.Tensor:
        """Branch 0 through its chain kernel (x NCHW, NHWC in memory)."""
        h, wd = x.shape[2], x.shape[3]
        if self.chain_int8 is not None:
            # the JAX package runs its Pallas int8 kernel, with its f32
            # handoffs, only at 128 lanes and W % 8 == 0
            # (chain_pallas_int8_ok, fused_block.py:300-313), and the XLA
            # chain, which rounds both handoffs to bf16, elsewhere
            # (hrnet_fast.py:196-206)
            q = self.chain_int8
            return _nchw(int8_chain(
                _nhwc(x), q['wq'], q['wscale'], q['b'], q['ascales'],
                round_handoffs=not (self.int8_pallas_casts and wd % 8 == 0)))
        w, b, ww = self.chain
        if ww is not None and h % 2 == 0 and wd % 8 == 0:
            # wino_pallas_ok's shape rule (winograd_chain.py:128-135)
            return _nchw(wino_chain(_nhwc(x), ww, b))
        return _nchw(basic_chain(_nhwc(x), w, b))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        xs = list(xs)
        for b, branch in enumerate(self.branches):
            if b == 0 and (self.chain is not None or
                           self.chain_int8 is not None):
                xs[0] = self._run_chain(xs[0])
            else:
                xs[b] = branch(xs[b])
        fused = []
        for i, row in enumerate(self.fuse_layers):
            if i == 0 and self.fuse is not None:
                weights, bias_sum = self.fuse
                fused.append(_nchw(fuse_up(
                    _nhwc(xs[0]), [_nhwc(x) for x in xs[1:]], weights,
                    bias_sum)))
                continue
            acc = None
            for j, layer in enumerate(row):
                y = xs[j] if i == j else layer(xs[j])
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused


class HRNet(nn.Module):
    """HRNet-W``c`` with ``nof_joints`` heatmap channels."""

    def __init__(self, c: int = 48, nof_joints: int = 17):
        super().__init__()
        self.c = c
        self.nof_joints = nof_joints
        self.conv1 = L.conv3x3(3, 64, 2)
        self.bn1 = L.bn(64)
        self.conv2 = L.conv3x3(64, 64, 2)
        self.bn2 = L.bn(64)
        self.layer1 = nn.Sequential(
            L.Bottleneck(64, 64, downsample=True),
            *[L.Bottleneck(256, 64) for _ in range(3)])
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
        self.final_layer = L.Conv2d(c, nof_joints, 1)
        self.compute_dtype = torch.float32

    def stage_modules(self) -> List[StageModule]:
        return [*self.stage2, *self.stage3, *self.stage4]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) normalized RGB -> (N, H/4, W/4, nof_joints) f32."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = [self.transition1[0](x), self.transition1[1](x)]
        for m in self.stage2:
            xs = m(xs)
        xs = xs + [self.transition2[2](xs[-1])]
        for m in self.stage3:
            xs = m(xs)
        xs = xs + [self.transition3[3](xs[-1])]
        for m in self.stage4:
            xs = m(xs)
        # head in f32, as in the JAX package (bf16 runs upcast here)
        out = self.final_layer(xs[0].float())
        return out.permute(0, 2, 3, 1)


def init(c: int = 48, nof_joints: int = 17, seed: int = 0) -> HRNet:
    """Fresh HRNet with torch-default (kaiming-uniform) conv init drawn from
    a generator seeded with ``seed``; identity BN statistics."""
    model = HRNet(c, nof_joints)
    L.init_(model, torch.Generator().manual_seed(seed))
    return model.eval()


def prepare_inference(model: HRNet, dtype: torch.dtype = torch.float32,
                      kernels: bool = True,
                      amax: Optional[Dict[str, float]] = None) -> HRNet:
    """Fold BN, pack the kernel operands (``kernels``), quantize (``amax``)
    and cast every other conv but the f32 head to ``dtype``, in place, on
    the model's current device. With ``kernels=False`` the stage modules
    run the plain blocks and fusion (the reference-shaped graph).

    ``amax``: the calibration map of ``quantize.calibrate``, taken on the
    folded f32 model BEFORE this call (a packed chain's convs never run as
    modules). Every calibrated conv that ``quantize.default_policy`` accepts
    becomes a ``QConv2d`` — the precision mix of the JAX facade's
    ``use_fused_kernels=False`` int8 graph — and a chain whose 8 convs
    qualify runs ``int8_chain``."""
    model.eval()
    L.fold_batch_norm(model)
    if kernels:
        for name, m in model.named_modules():
            if isinstance(m, StageModule):
                m.pack(dtype, amax, prefix=name)
    if amax is not None:
        Q.quantize_folded(model, amax)
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d) and mod is not model.final_layer:
            mod.to(dtype)
    if next(model.parameters()).device.type == 'cuda':
        model.to(memory_format=torch.channels_last)
    model.compute_dtype = dtype
    model.requires_grad_(False)
    return model
