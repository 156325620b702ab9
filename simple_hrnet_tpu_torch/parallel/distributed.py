"""Multi-process data parallelism over ``torch.distributed``.

Counterpart of ``simple_hrnet_tpu/parallel/distributed.py``. The JAX
package wires its processes into one JAX runtime and lets XLA insert the
collectives; here each process drives one device and joins a
``torch.distributed`` process group:

  * :func:`initialize` joins the group: NCCL where the process's device
    is CUDA, gloo on the CPU; ``init_method='tcp://<coordinator>'`` with
    an explicit world size and rank, or the ``torchrun`` environment
    (``env://``) when every argument is None. A second call is a no-op;
  * ``make_mesh()`` then spans every process, one device each;
  * each process feeds its own rows of the global batch
    (:func:`global_batch`); ``DistributedDataParallel`` averages the
    gradients and ``parallel/sync_bn.py`` normalizes with the global batch
    statistics (``train/steps.py``).

Launch (one process per card)::

    torchrun --nproc_per_node=N -m simple_hrnet_tpu_torch.cli.train_coco \\
        --n_devices N -n EXP ...

The self-test (``python -m simple_hrnet_tpu_torch.parallel.distributed
HOST:PORT NPROC RANK [WEIGHTS.npz [STATS.pt]]``) runs one PoseResNet-18
SGD step on a fixed 64x64 global batch, each process feeding its rows,
and prints ``loss=<repr>``; rank 0 saves the BN running statistics after
the step to ``STATS.pt`` when given.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from simple_hrnet_tpu_torch.utils.device import resolve_device
from .mesh import Mesh


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_device(kind: str = 'cuda') -> torch.device:
    """The device this process drives: ``cuda:<local rank>`` (``LOCAL_RANK``
    from the launcher, else the rank modulo the visible cards), or the
    CPU for ``kind='cpu'``."""
    if kind == 'cpu':
        return torch.device('cpu')
    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError('no CUDA device is visible; pass '
                           "device='cpu' to run on the host")
    local = int(os.environ.get('LOCAL_RANK', process_index()))
    return torch.device('cuda', local % n)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: Optional[str] = None,
               timeout_s: float = 600.0) -> None:
    """Join this process into a ``torch.distributed`` job.

    ``coordinator_address`` 'host:port' with ``num_processes`` and
    ``process_id``, or all three None under ``torchrun`` (its
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``). ``device``
    'cuda' (default; raises without a card, as every entry point does)
    or 'cpu'; ``backend`` defaults to NCCL on CUDA, gloo on the CPU.
    Idempotent, as the JAX package's is."""
    if is_initialized():
        return
    given = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in given) and None in given:
        raise ValueError('pass coordinator_address, num_processes and '
                         'process_id together (or none of them under '
                         'torchrun)')
    kind = resolve_device(device).type
    if backend is None:
        backend = 'nccl' if kind == 'cuda' else 'gloo'
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None:
        dist.init_process_group(backend, init_method='env://',
                                timeout=timeout)
    else:
        dist.init_process_group(
            backend, init_method=f'tcp://{coordinator_address}',
            world_size=int(num_processes), rank=int(process_id),
            timeout=timeout)
    if kind == 'cuda':
        torch.cuda.set_device(local_device())


def launch_line(n: int, module: str = 'simple_hrnet_tpu_torch.cli.train_coco'
                ) -> str:
    """The command that runs ``module`` as ``n`` processes, one a card."""
    return f'torchrun --nproc_per_node={n} -m {module} --n_devices {n} ...'


def cli_mesh(n_devices: Optional[int], device: Optional[str] = None,
             module: str = 'simple_hrnet_tpu_torch.cli.train_coco'):
    """The training CLIs' mesh: under a ``torchrun``-style launch
    (``WORLD_SIZE`` in the environment) join the group and span it; else
    None for ``n_devices`` None or 1, and a ``ValueError`` naming the
    launch line for more."""
    if 'WORLD_SIZE' in os.environ:
        from .mesh import make_mesh
        initialize(device=device)
        return make_mesh(n_devices, device=device)
    if n_devices is not None and n_devices > 1:
        raise ValueError(
            f'--n_devices {n_devices}: data-parallel training runs one '
            f'process a device; launch it as: {launch_line(n_devices, module)}')
    return None


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def global_batch(batch: Any, mesh: Mesh) -> Any:
    """This process's rows of a global batch (a tensor, an array or a dict
    of them): the ``process_index``-th of ``process_count`` equal parts of
    dim 0; raises when dim 0 does not divide."""
    n_proc, rank = mesh.process_count, mesh.process_index

    def rows(x):
        n = x.shape[0]
        if n % n_proc:
            raise ValueError(f'a global batch of {n} rows does not divide '
                             f'over {n_proc} processes')
        k = n // n_proc
        return x[rank * k:(rank + 1) * k]

    if isinstance(batch, dict):
        return {k: rows(v) for k, v in batch.items()}
    return rows(batch)


def all_mean(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the processes of ``t`` (one value per process, equal
    row counts): the global-batch mean of a per-process mean."""
    if mesh.group is None or mesh.process_count == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=mesh.group)
    return t / mesh.process_count


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every process's rows of ``t`` (equal shapes), concatenated in rank
    order along dim 0: the global batch, on every process."""
    if mesh.group is None or mesh.process_count == 1:
        return t
    dev = t.device
    if dev.type == 'cuda' and dist.get_backend(mesh.group) == 'gloo':
        t = t.cpu()  # gloo gathers host tensors
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.process_count)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts).to(dev)


def all_gather_meta(meta: dict, mesh: Mesh) -> dict:
    """A batch's ``joints_data`` dict from every process, merged in rank
    order: arrays concatenated along dim 0, lists joined."""
    if mesh.group is None or mesh.process_count == 1:
        return meta
    parts: List[dict] = [None] * mesh.process_count
    dist.all_gather_object(parts, meta, group=mesh.group)
    out = {}
    for k, v in parts[0].items():
        if isinstance(v, np.ndarray):
            out[k] = np.concatenate([p[k] for p in parts])
        elif isinstance(v, list):
            out[k] = [e for p in parts for e in p[k]]
        else:
            out[k] = v
    return out


def all_gather_objects(obj: Any, mesh: Mesh) -> List[Any]:
    """``obj`` from every process, in rank order."""
    if mesh.group is None or mesh.process_count == 1:
        return [obj]
    parts: List[Any] = [None] * mesh.process_count
    dist.all_gather_object(parts, obj, group=mesh.group)
    return parts


# ---------------------------------------------------------------------------
# self-test: one data-parallel step, each process feeding its rows
# ---------------------------------------------------------------------------

SELFTEST_ROWS = 8


def _selftest_setup(weights: Optional[str] = None, seed: int = 0,
                    device: str = 'cpu'):
    """(model, optimizer, loss function) shared by the multi-process
    self-test and its one-process reference in the tests: PoseResNet-18
    (17 joints, seeded init or ``weights``), SGD lr 1e-3 momentum 0.9."""
    from simple_hrnet_tpu_torch.models.convert import load_into
    from simple_hrnet_tpu_torch.train import losses, steps
    from simple_hrnet_tpu_torch.train.trainer import build_model
    from simple_hrnet_tpu_torch.utils import checkpoint as ckpt

    model = build_model('PoseResNet', 18, 17, seed, torch.device(device))
    if weights is not None:
        load_into(model, ckpt.load(weights))
    optimizer, _ = steps.make_optimizer(model, 'SGD', lr=1e-3, momentum=0.9)
    return model, optimizer, losses.joints_mse_loss


def _selftest_batch(n_global: int = SELFTEST_ROWS, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        'image': rng.standard_normal((n_global, 64, 64, 3)).astype(
            np.float32),
        'target': rng.uniform(0, 1, (n_global, 16, 16, 17)).astype(
            np.float32),
        'target_weight': np.ones((n_global, 17, 1), np.float32),
    }


def running_stats(model: torch.nn.Module) -> dict:
    """Every BN running mean and variance, on the host."""
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if k.endswith(('running_mean', 'running_var'))}


def _selftest(coordinator: str, num_processes: int, process_id: int,
              weights: Optional[str] = None, stats_out: Optional[str] = None,
              seed: int = 0) -> float:
    """One process of the multi-process self-test, on the CPU over gloo:
    a PoseResNet-18 SGD step over the global mesh, this process feeding
    its rows of the fixed global batch. Prints ``loss=<repr>``."""
    from simple_hrnet_tpu_torch.parallel.mesh import make_mesh
    from simple_hrnet_tpu_torch.train import steps

    torch.set_num_threads(1)
    initialize(coordinator, num_processes, process_id, device='cpu')
    try:
        mesh = make_mesh(device='cpu')
        model, optimizer, loss_fn = _selftest_setup(weights, seed)
        step = steps.make_train_step(model, loss_fn, optimizer, mesh=mesh)
        local = global_batch(_selftest_batch(seed=seed), mesh)
        loss, out = step(local)
        assert out.shape == (SELFTEST_ROWS, 16, 16, 17)  # gathered
        loss = float(loss)
        print(f'loss={loss!r}', flush=True)
        if stats_out is not None and process_id == 0:
            torch.save(running_stats(model), stats_out)
        dist.barrier()
    finally:
        shutdown()
    return loss


if __name__ == '__main__':
    import sys
    a = sys.argv[1:]
    _selftest(a[0], int(a[1]), int(a[2]), a[3] if len(a) > 3 else None,
              a[4] if len(a) > 4 else None)
