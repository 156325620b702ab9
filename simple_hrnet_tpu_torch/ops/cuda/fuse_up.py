"""K3: HRNet's high-resolution fusion output — CUDA kernel and plain version.

Computes ``relu(base + sum_j nearest_up_{f_j}(y_j @ w_j + b_j))``, the
function of ``simple_hrnet_tpu/ops/pallas/fuse_up.py`` (``fuse_up``). The
kernel is ``csrc/fuse_up.cu``; its note gives the bound on the H100 and
the design.

Arguments: ``base`` (B, H, W, C) NHWC; ``ys[j]`` (B, H/f_j, W/f_j, C_j)
with f_j in {2, 4, 8}; ``weights[j]`` the folded 1x1 conv as a (C_j, C)
matrix in the activation type; ``bias_sum`` (C,) f32, the sum of the
sources' folded biases (every output pixel receives exactly one upsampled
value per source, so the biases collapse into the accumulator's start).
The kernel wants C a multiple of 8, each C_j a multiple of 16 (HRNet's
widths are: C_j = f_j * C) and its shared memory within one block's
(``takes``), and raises otherwise.

``fuse_up`` checks the operands' shapes and calls the custom op
``sht::fuse_up`` (``torch.library.custom_op``): its CPU implementation is
the plain version, its CUDA one the kernel launch, which raises where the
kernel does not take the operands, and its fake implementation gives
``torch.export`` the output's shape and type, so an exported graph holds
the op (``utils/export.py``). ``fuse_up.launches`` counts every kernel
launch, eager or from an exported program.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from simple_hrnet_tpu_torch.ops.cuda import build
from simple_hrnet_tpu_torch.ops.cuda.fused_block import DTYPE_CODES

MAX_SOURCES = 3
_SHIFTS = {2: 1, 4: 2, 8: 3}
SMEM_LIMIT = 232448  # shared memory one block can use on the H100


def _factor(base_shape, y_shape) -> int:
    _, h, w, _ = base_shape
    _, hj, wj, _ = y_shape
    if hj == 0 or wj == 0 or h % hj or w % wj or h // hj != w // wj \
            or h // hj not in _SHIFTS:
        raise ValueError(f'fuse_up source {tuple(y_shape)} is not a 2x, 4x '
                         f'or 8x pyramid level of base {tuple(base_shape)}')
    return h // hj


def fuse_up_plain(base: torch.Tensor, ys: Sequence[torch.Tensor],
                  weights: Sequence[torch.Tensor],
                  bias_sum: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 accumulation starting at
    base + bias_sum, f32 products of activation-type inputs, ReLU and one
    cast to the activation type at the end."""
    dt = base.dtype
    acc = base.float() + bias_sum.float()
    for y, w in zip(ys, weights):
        f = _factor(base.shape, y.shape)
        t = torch.matmul(y.float(), w.to(dt).float())
        acc = acc + t.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)
    return torch.relu(acc).to(dt)


def fuse_up(base: torch.Tensor, ys: Sequence[torch.Tensor],
            weights: Sequence[torch.Tensor],
            bias_sum: torch.Tensor) -> torch.Tensor:
    """The fused resize-add through the custom op ``sht::fuse_up``: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if base.ndim != 4 or not 1 <= len(ys) <= MAX_SOURCES or \
            len(weights) != len(ys):
        raise ValueError(f'fuse_up wants base (B, H, W, C) and 1..'
                         f'{MAX_SOURCES} sources with one weight each; got '
                         f'{tuple(base.shape)}, {len(ys)} sources, '
                         f'{len(weights)} weights')
    bsz, c = base.shape[0], base.shape[3]
    for y, w in zip(ys, weights):
        _factor(base.shape, y.shape)
        if y.shape[0] != bsz or tuple(w.shape) != (y.shape[-1], c):
            raise ValueError(f'fuse_up source {tuple(y.shape)} / weight '
                             f'{tuple(w.shape)} do not match base '
                             f'{tuple(base.shape)}')
    if tuple(bias_sum.shape) != (c,):
        raise ValueError(f'fuse_up bias_sum {tuple(bias_sum.shape)} != ({c},)')
    return _fuse_up_op(base, list(ys), list(weights), bias_sum)


@torch.library.custom_op('sht::fuse_up', mutates_args=(), device_types='cpu')
def _fuse_up_op(base: torch.Tensor, ys: List[torch.Tensor],
                weights: List[torch.Tensor],
                bias_sum: torch.Tensor) -> torch.Tensor:
    return fuse_up_plain(base, ys, weights, bias_sum)


@_fuse_up_op.register_kernel('cuda')
def _fuse_up_cuda(base: torch.Tensor, ys: List[torch.Tensor],
                  weights: List[torch.Tensor],
                  bias_sum: torch.Tensor) -> torch.Tensor:
    """The kernel launch; raises where the kernel does not take the
    operands, never falls back to the plain version."""
    bsz, h, wd, c = base.shape
    factors = [_factor(base.shape, y.shape) for y in ys]
    tensors = [base, bias_sum, *ys, *weights]
    if any(t.device != base.device for t in tensors):
        raise ValueError('fuse_up: every tensor must lie on one CUDA device')
    if base.dtype not in DTYPE_CODES or bias_sum.dtype != torch.float32 or \
            any(t.dtype != base.dtype for t in (*ys, *weights)):
        raise ValueError('fuse_up kernel takes f32 or bf16 base, sources and '
                         'weights of one type and an f32 bias_sum')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('fuse_up kernel wants contiguous tensors')
    widths = tuple(y.shape[-1] for y in ys)
    if not takes(c, widths, factors, base.dtype):
        raise ValueError(f'fuse_up kernel takes C a multiple of 8 (every '
                         f'HRNet branch width is), source widths multiples '
                         f'of 16 (16-deep tensor-core steps; an HRNet source '
                         f'is 2, 4 or 8 times C) and at most {SMEM_LIMIT} '
                         f'bytes of shared memory a block; got C = {c}, '
                         f'sources {list(widths)} in {base.dtype}')
    # the kernel's 16-byte copies
    base = base if base.data_ptr() % 16 == 0 else base.clone()
    ys = [y if y.data_ptr() % 16 == 0 else y.clone() for y in ys]
    weights = [w if w.data_ptr() % 16 == 0 else w.clone() for w in weights]
    out = torch.empty_like(base)
    if base.numel() == 0:
        return out
    slots = []
    for y, w, f in zip(ys, weights, factors):
        slots += [build.ptr(y), build.ptr(w), y.shape[-1], _SHIFTS[f]]
    for _ in range(MAX_SOURCES - len(ys)):
        slots += [build.ptr(None), build.ptr(None), 0, 0]
    with torch.cuda.device(base.device):
        rc = _fn()(build.ptr(base), len(ys), *slots, build.ptr(bias_sum),
                   build.ptr(out), bsz, h, wd, c, DTYPE_CODES[base.dtype],
                   build.stream_ptr(base.device))
    build.check(rc, 'fuse_up kernel')
    fuse_up.launches += 1
    return out


@_fuse_up_op.register_fake
def _fuse_up_fake(base, ys, weights, bias_sum):
    return torch.empty_like(base, memory_format=torch.contiguous_format)


fuse_up.launches = 0


def takes(c: int, widths: Sequence[int], factors: Sequence[int],
          dtype: torch.dtype) -> bool:
    """Whether the kernel takes a base of width ``c`` with sources of
    ``widths`` channels at pyramid ``factors`` in ``dtype``. The wrapper
    refuses everything else with this same rule, and ``StageModule.pack``
    leaves such a fusion to the plain modules."""
    return (dtype in DTYPE_CODES and 1 <= len(widths) <= MAX_SOURCES and
            len(factors) == len(widths) and c > 0 and c % 8 == 0 and
            all(cj > 0 and cj % 16 == 0 for cj in widths) and
            all(f in _SHIFTS for f in factors) and
            smem_bytes(c, tuple(widths), tuple(factors), dtype) <= SMEM_LIMIT)


def smem_bytes(c: int, widths: Tuple[int, ...], factors: Tuple[int, ...],
               dtype: torch.dtype) -> int:
    """Shared memory one block of the kernel needs for base width ``c`` and
    sources of ``widths`` channels at pyramid ``factors``: ``make_layout``
    of ``csrc/fuse_up.cu`` on the host, so that the decision is the same
    with or without a card (the card tests hold it against the kernel's
    own ``sht_fuse_up_smem_bytes``)."""
    tc = dtype == torch.bfloat16
    esize = 2 if tc else 4
    teams = stages = 2 if tc else 1
    # 16 x 8 output tiles; a source's window is its share of one
    window = [(16 >> _SHIFTS[f]) * (8 >> _SHIFTS[f]) for f in factors]
    wpitch = (c + 15) // 16 * 16 + 8 if tc else c
    team_bytes = sum(widths) * wpitch * esize + c * 4
    slot = 16 * 8 * c + sum(n * (cj + 8 if tc else cj)
                            for n, cj in zip(window, widths))
    products = sum(n * (c + 4) for n in window) * 4
    return min(team_bytes + teams * (stages * slot * esize + products),
               1 << 30)


def lib_smem_bytes(c: int, widths: Tuple[int, ...],
                   factors: Tuple[int, ...], dtype: torch.dtype) -> int:
    """``smem_bytes`` as the built kernel computes it (needs ``nvcc``)."""
    n = len(widths)
    arr = ctypes.c_int * n
    fn = build.library('fuse_up').sht_fuse_up_smem_bytes
    fn.restype = ctypes.c_size_t
    fn.argtypes = [ctypes.c_int, arr, arr, ctypes.c_int, ctypes.c_int]
    return fn(n, arr(*widths), arr(*(_SHIFTS[f] for f in factors)), c,
              DTYPE_CODES[dtype])


def _fn():
    fn = build.library('fuse_up').sht_fuse_up
    fn.restype = ctypes.c_int
    src = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + src * MAX_SOURCES + \
        [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    return fn
