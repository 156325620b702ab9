"""The detectors' smooth activations, rounded after every op as the JAX
package's are.

XLA's CPU lowering computes a bf16 elementwise chain in f32 and rounds to
bf16 after every op: ``jax.nn.sigmoid`` is ``1 / (exp(-x) + 1)``, rounded
after the negation, the ``exp``, the add and the divide; ``jax.nn.silu``
is ``x * sigmoid(x)``, rounded once more; mish, ``x *
tanh(softplus(x))``, has softplus as ``max(x, 0) + log1p(exp(-|x|))``
with a NaN select, rounded after each op (the optimized HLO of
``jax.jit`` of each on a bf16 input). PyTorch's ``F.silu``,
``torch.sigmoid``, ``F.softplus`` and ``torch.tanh`` round their f32
result once per call, so on bf16 a third of their outputs lie one bf16
step from the JAX package's.

The functions here are that HLO written op by op on tensors of ``x``'s
type, each op rounding to it; in f32 they are XLA's f32 order too. On CPU
tensors they are what the detectors run. On the card they are the oracle
of the activation kernel (``ops/cuda/activation.py``), which computes the
same ops in registers with a rounding after each. After the first op each
works in place on its own new tensor: the same roundings, with one
allocation and one pass an op (``1 / d`` is ``reciprocal``, the same
correctly rounded quotient).
"""

from __future__ import annotations

import torch


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (exp(-x) + 1)``, each op rounded to ``x``'s type."""
    return torch.neg(x).exp_().add_(1).reciprocal_()


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, each op rounded to ``x``'s type."""
    return sigmoid(x).mul_(x)


def mish(x: torch.Tensor) -> torch.Tensor:
    """``x * tanh(softplus(x))`` with softplus ``where(isnan(x), x,
    max(x, 0) + log1p(exp(-|x|)))``, each op rounded to ``x``'s type."""
    tail = torch.abs(x).neg_().exp_().log1p_()
    softplus = torch.clamp_min(x, 0).add_(tail)
    return torch.where(torch.isnan(x), x, softplus).tanh_().mul_(x)


PLAIN = {'sigmoid': sigmoid, 'silu': silu, 'mish': mish}
