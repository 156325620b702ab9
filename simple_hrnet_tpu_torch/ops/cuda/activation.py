"""K4: the detectors' sigmoid, SiLU and mish — CUDA kernel and plain
version.

No TPU kernel stands behind it: the JAX package's activations are XLA
elementwise fusions that round to bf16 after every op, and PyTorch's own
calls round once (``ops/activation.py`` gives the ops and their order;
it is the plain version). The kernel is ``csrc/activation.cu``: one pass
over the elements that computes those ops in f32 registers and rounds to
the storage type after each; its note gives the bound on the H100 and the
design.

``sigmoid``, ``silu`` and ``mish`` run the plain version for a CPU tensor
and launch the kernel for a CUDA tensor: f32 or bf16, dense in any order
of its dimensions (NCHW or channels-last, as the detectors' convs leave
it), and outside autograd (the kernel computes no gradient); anything
else raises. The output is a new tensor with the input's strides.
``activation.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from simple_hrnet_tpu_torch.ops.activation import PLAIN
from simple_hrnet_tpu_torch.ops.cuda import build
from simple_hrnet_tpu_torch.ops.cuda.fused_block import DTYPE_CODES

ACT_CODES = {'sigmoid': 0, 'silu': 1, 'mish': 2}


def _dense(x: torch.Tensor) -> bool:
    """Whether ``x`` covers its storage span without gaps or overlap, in
    some order of its dimensions."""
    expect = 1
    for stride, size in sorted((s, n) for s, n in zip(x.stride(), x.shape)
                               if n != 1):
        if stride != expect:
            return False
        expect *= size
    return True


def activation(x: torch.Tensor, act: str) -> torch.Tensor:
    """``act`` ('sigmoid', 'silu' or 'mish') of ``x``: the plain version
    for a CPU tensor, the kernel for a CUDA tensor."""
    if act not in ACT_CODES:
        raise ValueError(f'activation {act!r} is not one of '
                         f'{sorted(ACT_CODES)}')
    if x.device.type == 'cpu':
        return PLAIN[act](x)
    if x.device.type != 'cuda':
        raise ValueError(f'activation: a tensor on {x.device}; want the CPU '
                         f'or a CUDA device')
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f'activation kernel takes float32 or bfloat16, got '
                         f'{x.dtype}')
    if not _dense(x):
        raise ValueError(f'activation kernel wants a dense tensor, got shape '
                         f'{tuple(x.shape)} with strides {x.stride()}')
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError('activation kernel computes no gradient; call it '
                         'under torch.no_grad()')
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _fn()(build.ptr(x), build.ptr(out), x.numel(), ACT_CODES[act],
                   DTYPE_CODES[x.dtype], build.stream_ptr(x.device))
    build.check(rc, 'activation kernel')
    activation.launches += 1
    return out


activation.launches = 0


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (exp(-x) + 1)``, rounded after each op."""
    return activation(x, 'sigmoid')


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, rounded after each op."""
    return activation(x, 'silu')


def mish(x: torch.Tensor) -> torch.Tensor:
    """``x * tanh(softplus(x))``, rounded after each op."""
    return activation(x, 'mish')


def _fn():
    fn = build.library('activation').sht_activation
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn
