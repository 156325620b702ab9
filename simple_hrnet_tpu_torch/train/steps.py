"""Train and eval steps, and the optimizer.

Counterpart of ``simple_hrnet_tpu/train/steps.py``. A train step is the
forward in ``train()`` mode (BatchNorm2d normalizes with the batch
statistics and updates its running statistics with torch momentum
semantics, the unbiased variance stored), the loss in f32, ``backward``,
``optimizer.step`` and the per-step learning rate. An eval step is the
forward in ``eval()`` mode (unfolded BN on the running statistics), with
the flip-test average when ``flip_pairs`` is given.

Both steps run inside ``utils/device.true_f32``, as the facade's pose
model does, so an f32 step computes true f32 on the card, and put the
TF32 flags back. ``dtype='bfloat16'`` is the JAX package's mixed
precision, with explicit casts at its points: every conv and transposed
conv but the head takes its input and weight in bf16 and returns bf16
(the weight cast is part of the graph, so gradients reach the f32 master
weights); BN statistics are f32 and BN returns the activation's type; the
head and the loss are f32. No port CUDA kernel runs here: the kernels
serve the folded inference graph, and the JAX package's training forward
never reaches its Pallas kernels either.

``mesh`` (``parallel/mesh.py``) makes a step data-parallel, one process
per device (the JAX package's sharded step, its ``steps.py``). Where the
mesh carries a process group (``parallel/distributed.initialize``), the
train step wraps the forward in ``DistributedDataParallel`` over the
group, which averages the gradients: with equal rows a process, the
gradient of the global-mean loss; where the group spans more than one
process it also swaps every BN for ``parallel/sync_bn.GlobalBatchNorm2d``
(the global batch's statistics, as the JAX step's one program computes
them; a one-rank group keeps ``BatchNorm2d``, whose statistics are the
global ones already). Both steps then return the global-mean loss and the
heatmaps (and stamped targets) of the global batch, the same on every
process. A mesh without a group is one process: the train step takes one
device (more raise, naming the launch line), and the eval step splits its
batch over the mesh's devices, one replica each, and gathers the outputs
on the first.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from simple_hrnet_tpu_torch.models import layers as L
from simple_hrnet_tpu_torch.ops.decode import flip_test_average
from simple_hrnet_tpu_torch.parallel import distributed as D
from simple_hrnet_tpu_torch.utils.device import host_to_device, true_f32


def compute_dtype(dtype: Optional[str]) -> Optional[torch.dtype]:
    """A dtype name as the step's compute type (None: plain f32)."""
    if dtype is None:
        return None
    table = {'bfloat16': torch.bfloat16, 'bf16': torch.bfloat16,
             'float32': None, 'f32': None}
    if dtype not in table:
        raise ValueError(
            f'Unsupported training dtype {dtype!r}; expected one of '
            f"{sorted(table)} (int8 is a serving-only knob: "
            "SimpleHRNet(dtype='int8'))")
    return table[dtype]


def set_bn_momentum(model: nn.Module, momentum: float) -> None:
    """Every BatchNorm2d's running-statistics momentum (torch semantics:
    new = (1 - m) * old + m * batch)."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.momentum = momentum


def _to_device(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return host_to_device(np.asarray(a), device)


def _batch_inputs(batch: Dict, device_targets: Optional[Dict],
                  device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(image, target, target_weight) on ``device`` from a batch dict.

    ``device_targets=None``: the host pipeline normalized the image and
    stamped the targets (keys image, target, target_weight).

    Otherwise ``device_targets`` is a config dict (heatmap_size,
    image_size, heatmap_sigma, joints_weight) and the batch carries the
    raw tail (image in [0, 255] off the host warp, joints, joints_vis):
    the ImageNet normalize and the gaussian targets are computed here, on
    the device. The normalize subtracts then multiplies by the host
    pipeline's f32 constants, so the image is bit for bit the host one."""
    if device_targets is None:
        return tuple(_to_device(batch[k], device)
                     for k in ('image', 'target', 'target_weight'))
    from simple_hrnet_tpu_torch.data import target as target_gen
    from simple_hrnet_tpu_torch.ops.image import normalize
    image = normalize(_to_device(batch['image'], device))
    target, weight = target_gen.generate_target_device(
        _to_device(batch['joints'], device),
        _to_device(batch['joints_vis'], device),
        tuple(device_targets['heatmap_size']),
        tuple(device_targets['image_size']),
        device_targets.get('heatmap_sigma', 3))
    jw = device_targets.get('joints_weight')
    if jw is not None:
        weight = weight * _to_device(np.asarray(jw, np.float32), device)
    return image, target, weight


def forward(model: nn.Module, image: torch.Tensor,
            dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The model on (N, H, W, 3) ``image`` in the compute type, heatmaps
    (N, h, w, J) in f32. In bf16 the conv and transposed-conv weights (the
    head's excepted) enter as bf16 casts of the f32 parameters."""
    if dtype is None:
        return model(image).float()
    casts = {f'{name}.weight': m.weight.to(dtype)
             for name, m in model.named_modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))
             and m is not model.final_layer}
    saved = model.compute_dtype
    model.compute_dtype = dtype
    try:
        out = functional_call(model, casts, (image,), strict=False)
    finally:
        model.compute_dtype = saved
    return out.float()


class _Forward(nn.Module):
    """``forward(model, image, dtype)`` as a module, so that
    ``DistributedDataParallel`` wraps the bf16 weight casts with it."""

    def __init__(self, model: nn.Module, dtype: Optional[torch.dtype]):
        super().__init__()
        self.model = model
        self.dtype = dtype

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return forward(self.model, image, self.dtype)


def check_train_mesh(mesh) -> None:
    """Training takes one device a process: a mesh over more local devices
    raises, naming the launch that gives each device its process."""
    if mesh is not None and mesh.local_size > 1:
        raise ValueError(
            f'a training mesh drives one device a process, this one has '
            f'{mesh.local_size} local devices ({mesh}); launch one process '
            f'per device: {D.launch_line(mesh.local_size)} (a one-process '
            'mesh over several devices serves inference: SimpleHRNet(mesh='
            '...) and Test(mesh=...))')


def _data_parallel(model: nn.Module, cdt, mesh, device: torch.device):
    """The DDP-wrapped forward over the mesh's group, with global BN where
    the group spans more than one process."""
    from torch.nn.parallel import DistributedDataParallel
    from simple_hrnet_tpu_torch.parallel import sync_bn
    if mesh.process_count > 1:
        sync_bn.convert(model, mesh.group)
    return DistributedDataParallel(
        _Forward(model, cdt),
        device_ids=[device] if device.type == 'cuda' else None,
        process_group=mesh.group, broadcast_buffers=False)


def make_train_step(model: nn.Module, loss_fn: Callable,
                    optimizer: torch.optim.Optimizer,
                    scheduler=None, dtype=None,
                    device_targets: Optional[Dict] = None,
                    bn_momentum: float = L.BN_MOMENTUM,
                    mesh=None) -> Callable:
    """The train step ``step(batch)`` -> (loss, out), or (loss, out,
    target) with ``device_targets``: loss a 0-d f32 tensor, out the f32
    heatmaps (N, h, w, J), both detached, on the model's device.

    The batch is a dict of arrays or tensors: image (N, H, W, 3), target
    (N, h, w, J), target_weight (N, J, 1); or with ``device_targets`` (see
    ``_batch_inputs``) the raw image, joints and joints_vis. Every
    BatchNorm2d's momentum is set to ``bn_momentum``. ``scheduler``
    (``make_optimizer``'s) steps once a step. Under a ``mesh`` with a
    process group the batch is this process's rows, and the step returns
    the global-mean loss and the global batch's heatmaps (module
    docstring)."""
    cdt = compute_dtype(dtype)
    set_bn_momentum(model, bn_momentum)
    device = next(model.parameters()).device
    check_train_mesh(mesh)
    multi = mesh is not None and mesh.group is not None
    run = _data_parallel(model, cdt, mesh, device) if multi \
        else _Forward(model, cdt)

    def step(batch):
        model.train()
        with true_f32():
            image, target, target_weight = _batch_inputs(
                batch, device_targets, device)
            out = run(image)
            loss = loss_fn(out, target, target_weight)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
        if scheduler is not None:
            scheduler.step()
        loss, out = loss.detach(), out.detach()
        if multi:
            loss = D.all_mean(loss, mesh)
            out = D.all_gather_rows(out, mesh)
            if device_targets is not None:
                target = D.all_gather_rows(target, mesh)
        if device_targets is not None:
            return loss, out, target
        return loss, out

    return step


def make_eval_step(model: nn.Module, loss_fn: Callable,
                   flip_pairs: Optional[Sequence] = None, dtype=None,
                   device_targets: Optional[Dict] = None,
                   mesh=None) -> Callable:
    """The eval step ``step(batch)`` -> (loss, out), or (loss, out,
    target) with ``device_targets``: ``eval()`` mode, no gradients, and
    with ``flip_pairs`` the average of the heatmaps and the un-flipped
    heatmaps of the width-flipped image (Test.py:134-141).

    Under a ``mesh`` the batch (this process's rows) is cut into one equal
    part per local device, each run by the model's replica there (copied
    when the step is built), and the outputs are gathered on the model's
    device, then over the processes; the loss is the mean of the parts'.
    The caller pads the batch to a multiple of the mesh's size."""
    cdt = compute_dtype(dtype)
    device = next(model.parameters()).device
    if mesh is not None:
        from simple_hrnet_tpu_torch.parallel.mesh import replicate
        replicas = replicate(model, mesh)
        devices = mesh.devices
    else:
        replicas, devices = [model], [device]

    def one(net, batch, dev):
        net.eval()
        image, target, target_weight = _batch_inputs(
            batch, device_targets, dev)
        out = forward(net, image, cdt)
        if flip_pairs is not None:
            out_f = forward(net, torch.flip(image, dims=[2]), cdt)
            out = flip_test_average(out, out_f, flip_pairs)
        return loss_fn(out, target, target_weight), out, target

    @torch.no_grad()
    def step(batch):
        with true_f32():
            if len(replicas) == 1:
                loss, out, target = one(replicas[0], batch, devices[0])
            else:
                from simple_hrnet_tpu_torch.parallel.mesh import shard_batch
                res = [one(net, part, dev) for net, part, dev in
                       zip(replicas, shard_batch(batch, mesh), devices)]
                loss = torch.stack([r[0].to(device) for r in res]).mean()
                out, target = (torch.cat([r[i].to(device) for r in res])
                               for i in (1, 2))
        if mesh is not None and mesh.group is not None:
            loss = D.all_mean(loss, mesh)
            out = D.all_gather_rows(out, mesh)
            if device_targets is not None:
                target = D.all_gather_rows(target, mesh)
        if device_targets is not None:
            return loss, out, target
        return loss, out

    return step


def make_optimizer(model: nn.Module, name: str = 'SGD', lr: float = 0.001,
                   momentum: float = 0.9, nesterov: bool = False,
                   weight_decay: float = 0.0, lr_decay: bool = False,
                   lr_decay_steps=(170, 200), lr_decay_gamma: float = 0.1,
                   steps_per_epoch: int = 1):
    """SGD (momentum, nesterov) or Adam over ``model.parameters()`` with a
    multi-step LR stepped once per train step (Train.py:173-179, 206-208).

    Returns (optimizer, scheduler). The learning rate of step k (from 0)
    is multiplied by ``lr_decay_gamma`` for every epoch milestone e with
    k >= e * steps_per_epoch: the JAX package's piecewise-constant
    schedule, which is ``MultiStepLR`` at the first step of the milestone
    epoch. ``weight_decay`` is L2 added to the gradient of the parameters
    (torch's ``weight_decay``, which SGD and Adam both add before their
    update); BN running statistics are buffers and never decayed, as the
    JAX package masks them."""
    params = list(model.parameters())
    if name in ('SGD', 'sgd'):
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                              nesterov=nesterov, weight_decay=weight_decay)
    elif name in ('Adam', 'adam'):
        opt = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    else:
        raise NotImplementedError(f'Unknown optimizer {name!r}')
    milestones = ([int(e) * steps_per_epoch for e in lr_decay_steps]
                  if lr_decay else [])
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, milestones,
                                                 gamma=lr_decay_gamma)
    return opt, sched
