"""The data-parallel mesh: a 1-D object over the devices a process drives.

Counterpart of ``simple_hrnet_tpu/parallel/mesh.py``. The JAX package
builds a ``jax.sharding.Mesh`` with one ``'data'`` axis and lets XLA place
the shards. Here a ``Mesh`` lists this process's devices (``devices``)
and, when ``torch.distributed`` is initialized, carries its process group
(``group``): one process drives one device in training (the PyTorch
idiom, ``train/steps.py``), and one process may drive several devices in
inference (``SimpleHRNet(mesh=...)``, the reference's ``DataParallel``,
SimpleHRNet.py:123-135). ``size`` is the length of the ``'data'`` axis:
this process's devices times the processes of the group.

``shard_batch`` cuts a batch along dim 0 into one equal part per local
device; ``replicate`` copies a module, a state dict or a tensor to each
local device. Neither reads anything back to the host.
"""

from __future__ import annotations

import copy
from typing import Any, List, Optional, Sequence, Union

import torch
import torch.nn as nn

AXIS = 'data'


class Mesh:
    """The devices this process drives along the ``'data'`` axis, and the
    ``torch.distributed`` process group (None outside a distributed job).
    A device may repeat (several replicas on one card)."""

    def __init__(self, devices: Sequence[Union[str, torch.device]],
                 group=None, axis: str = AXIS):
        if not devices:
            raise ValueError('a mesh needs at least one device')
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.group = group
        self.axis_names = (axis,)

    @property
    def local_size(self) -> int:
        """The replicas this process drives."""
        return len(self.devices)

    @property
    def process_count(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def process_index(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """The length of the ``'data'`` axis over every process."""
        return self.local_size * self.process_count

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    def __repr__(self) -> str:
        return (f'Mesh(devices={[str(d) for d in self.devices]}, '
                f'processes={self.process_count})')


def _distributed_group():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def make_mesh(n_devices: Optional[int] = None, axis: str = AXIS,
              device: Union[str, torch.device, None] = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` visible CUDA devices (all of
    them by default), or over ``n_devices`` CPU replicas with
    ``device='cpu'`` (the tests). Raises when there are too few devices.

    In a multi-process job (``parallel/distributed.initialize`` first)
    each process drives one device, ``cuda:<local rank>`` (or the CPU):
    the mesh spans every process, and ``n_devices`` must be None or the
    number of processes."""
    group = _distributed_group()
    kind = torch.device('cuda' if device is None else device).type
    if group is not None:
        import torch.distributed as dist
        world = dist.get_world_size(group)
        if world > 1:
            if n_devices is not None and n_devices != world:
                raise ValueError(
                    f'n_devices={n_devices} in a {world}-process job: each '
                    'process drives one device, so the mesh spans all '
                    f'{world} (pass n_devices=None or {world})')
            from simple_hrnet_tpu_torch.parallel.distributed import \
                local_device
            return Mesh([local_device(kind)], group, axis)
    if kind == 'cpu':
        return Mesh(['cpu'] * (n_devices or 1), group, axis)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = have if n_devices is None else n_devices
    if want < 1 or have < want:
        raise ValueError(f'need {want} CUDA devices, have {have} (pass '
                         "device='cpu' for CPU replicas)")
    return Mesh([torch.device('cuda', i) for i in range(want)], group, axis)


def _split(x: torch.Tensor, parts: int) -> List[torch.Tensor]:
    n = x.shape[0]
    if n % parts:
        raise ValueError(f'dim 0 of size {n} does not divide into {parts} '
                         "equal parts along the mesh's 'data' axis")
    return list(torch.split(x, n // parts))


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh: Mesh, axis: str = AXIS) -> List[Any]:
    """A batch (a tensor, an array or a dict/list/tuple of them) cut along
    dim 0 into one equal part per local device, each part on its device
    (``non_blocking``); raises when dim 0 does not divide. In a
    multi-process job each process passes its own rows (see
    ``distributed.global_batch``), as in the JAX package."""
    parts = mesh.local_size

    def part(x, i, d):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        return _split(t, parts)[i].to(d, non_blocking=True)

    return [_tree_map(lambda x, i=i, d=d: part(x, i, d), batch)
            for i, d in enumerate(mesh.devices)]


def move_attrs(module: nn.Module, dev: torch.device) -> None:
    """Tensors a module holds outside its parameters and buffers (in
    tuples, lists or dicts: HRNet's packed kernel weights) moved to
    ``dev``, in every submodule."""
    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        if isinstance(v, (tuple, list)):
            return type(v)(move(e) for e in v)
        if isinstance(v, dict):
            return {k: move(e) for k, e in v.items()}
        return v

    for m in module.modules():
        for k, v in list(vars(m).items()):
            if not k.startswith('_') and isinstance(
                    v, (torch.Tensor, tuple, list, dict)):
                setattr(m, k, move(v))


def module_to(module: nn.Module, dev: torch.device) -> nn.Module:
    """A copy of ``module`` on ``dev``: parameters, buffers and the tensors
    its submodules hold in other attributes."""
    out = copy.deepcopy(module).to(dev)
    move_attrs(out, dev)
    return out


def replicate(tree: Any, mesh: Mesh) -> List[Any]:
    """One copy of a module, a state dict or a tensor per local device: a
    module is copied (``module_to``) to each device it is not already on
    (a device that repeats, or the module's own device, shares the one
    object)."""
    if isinstance(tree, nn.Module):
        own = next(iter(tree.parameters()), None)
        home = own.device if own is not None else torch.device('cpu')
        copies = {home: tree}
        out = []
        for d in mesh.devices:
            if d not in copies:
                copies[d] = module_to(tree, d)
            out.append(copies[d])
        return out
    return [_tree_map(lambda t, d=d: t.to(d) if isinstance(t, torch.Tensor)
                      else t, tree) for d in mesh.devices]
