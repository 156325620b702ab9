"""Device selection for the port's entry points, and their f32 setting.

They run on the card unless the caller asks for the CPU: ``None`` means
'cuda', and asking for a CUDA device without one raises — the port never
serves silently on the host (the JAX facade's rule, api.py:399-416).
``true_f32`` is the one place the port writes PyTorch's TF32 flags, and it
puts back what it found.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                f'device {str(dev)!r} requested but no CUDA device is '
                "visible; pass device='cpu' explicitly to run on the host")
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {device!r} (cuda or cpu)')
    return dev


def host_to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``, with no stream
    synchronization: on a CUDA device it is staged in pinned memory and
    copied with ``non_blocking=True`` (PyTorch's caching host allocator
    keeps the pinned block until the copy is done), where a copy from
    pageable memory would end in a stream synchronize. On the CPU it
    shares the array's memory."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != 'cuda':
        return t
    return t.pin_memory().to(device, non_blocking=True)


@contextlib.contextmanager
def true_f32() -> Iterator[None]:
    """Compute f32 matmuls and convs in true f32 within the block (or the
    decorated function): both TF32 flags off
    (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``), and the values found put back on
    exit, exceptions included. The flags are read when a call is
    dispatched, so a block around the host-side calls is enough; a flag
    write is a host-side setting and makes no stream synchronization.
    (``torch.backends.cudnn.flags`` is not used: its other arguments
    default to ``enabled=False`` and would switch cuDNN off.)"""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
