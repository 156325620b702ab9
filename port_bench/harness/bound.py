"""The yardstick of the kernels' rooflines: the card's published peaks and
each hand-written kernel's operations and bytes from its shapes.

Frozen from the repository's chip-check script (its ``bound`` and the
operation counts of its K2, K3 and K4 timings). Each input is read once
and each output written once; the least time a launch could take is the
larger of its operations over the peak rate of its arithmetic and its
bytes over the peak bandwidth.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA H100 SXM published peaks (data sheet; dense, at 700 W)
PEAK_BYTES = 3.35e12
PEAK_OPS = {'bf16': 989e12, 'f32': 67e12, 'int8': 1979e12}
BYTES = {'bf16': 2, 'f32': 4, 'int8': 1, 'c10::BFloat16': 2, 'float': 4}
# operations an element of the activations (K4), as its plain version
# spells them
ACT_OPS = {'sigmoid': 4, 'silu': 5, 'mish': 9}


def least_s(nbytes: float, ops: float, arith: str) -> Tuple[float, str]:
    """The least seconds the card could take, and what bounds it."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ops / PEAK_OPS[arith]
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def chain(x_shape: Sequence[int], w_shape: Sequence[int],
          b_shape: Sequence[int], itemsize: int = 2) -> Tuple[float, float]:
    """K2 (``sht::basic_chain``): eight 3x3 convs of C -> C over x (B, H,
    W, C) with residuals. Bytes: x read, the output written, the packed
    weights and biases read (weights in the compute type, biases f32).
    Operations: 8 * 2 * B * H * W * C * C * 9."""
    b, h, w, c = (int(v) for v in x_shape)
    nbytes = 2 * _numel(x_shape) * itemsize + _numel(w_shape) * itemsize \
        + _numel(b_shape) * 4
    return nbytes, 8 * 2 * b * h * w * c * c * 9


def fuse_up(base_shape: Sequence[int], y_shapes: Sequence[Sequence[int]],
            w_shapes: Sequence[Sequence[int]], bias_shape: Sequence[int],
            itemsize: int = 2) -> Tuple[float, float]:
    """K3 (``sht::fuse_up``): the high-resolution fuse, base (B, H, W, C)
    plus each lower source's 1x1 conv to C, upsampled, summed, ReLU'd.
    Bytes: base read and output written, each source and weight read,
    the bias sum (f32) read. Operations: 2 * numel(y) * C a source plus 5
    a base element."""
    c = int(base_shape[-1])
    nbytes = 2 * _numel(base_shape) * itemsize \
        + sum(_numel(s) for s in y_shapes) * itemsize \
        + sum(_numel(s) for s in w_shapes) * itemsize \
        + _numel(bias_shape) * 4
    ops = sum(2 * _numel(s) * c for s in y_shapes) + _numel(base_shape) * 5
    return nbytes, ops


def activation(numel: int, act: str = 'silu', itemsize: int = 2
               ) -> Tuple[float, float]:
    """K4: one elementwise pass, the input read and the output written."""
    return 2 * numel * itemsize, ACT_OPS[act] * numel
