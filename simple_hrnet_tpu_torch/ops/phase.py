"""Space-to-depth ("phase layout") for the detectors' 3-channel conv stems.

Counterpart of ``simple_hrnet_tpu/ops/phase.py``. The JAX package runs
its detectors' first convs on the (H/2, W/2, 4C) tensor of the four pixel
parities, which its letterbox matmuls emit directly, and rewrites the stem
kernels exactly for that layout; it is on by default, so the numbers its
detectors give (and the goldens record) are those of this graph. The port
computes the same graph: the kernel transforms below are copies of the
JAX package's numpy code (that module imports ``jax.numpy``, so it is not
imported here), and ``phase_quadrants`` works on torch tensors.

Layout: channel block ``(a*2+b)*C:(a*2+b+1)*C`` of the (H/2, W/2, 4C)
tensor holds the full-resolution pixel (2Y+a, 2X+b), row-major over (row
parity a, column parity b).

The transforms take and return HWIO kernels, as the JAX package's do; the
port's convs hold OIHW weights, and ``hwio``/``oihw`` are the one place
the two orders meet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Padding = Tuple[Tuple[int, int], Tuple[int, int]]


def hwio(weight: torch.Tensor) -> np.ndarray:
    """An OIHW conv weight as an HWIO numpy kernel (f32 host copy)."""
    return weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0)


def oihw(kernel: np.ndarray) -> torch.Tensor:
    """An HWIO numpy kernel as an OIHW tensor (host)."""
    return torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0,
                                                                  1)))


def phase_kernel_s1(k: np.ndarray, pad: int = 1) -> Tuple[np.ndarray, Padding]:
    """Stride-1 (kh, kw, ci, co) kernel -> phase-to-phase stride-1 kernel
    (T, T, 4ci, 4co) and its padding: the output stays in phase space,
    output block (al, be) holding full-resolution pixel (2Y+al, 2X+be).
    Zero padding in phase space reproduces the full-resolution zero pad
    exactly."""
    kh, kw, ci, co = k.shape
    smin, smax = (0 + 0 - pad) // 2, (1 + (kh - 1) - pad) // 2
    tmin, tmax = (0 + 0 - pad) // 2, (1 + (kw - 1) - pad) // 2
    th, tw = smax - smin + 1, tmax - tmin + 1
    kp = np.zeros((th, tw, 4 * ci, 4 * co), k.dtype)
    for al in range(2):
        for be in range(2):
            for dy in range(kh):
                for dx in range(kw):
                    s, a = divmod(al + dy - pad, 2)
                    t, b = divmod(be + dx - pad, 2)
                    kp[s - smin, t - tmin,
                       (a * 2 + b) * ci:(a * 2 + b + 1) * ci,
                       (al * 2 + be) * co:(al * 2 + be + 1) * co] = k[dy, dx]
    return kp, ((-smin, th - 1 + smin), (-tmin, tw - 1 + tmin))


def phase_kernel_s2(k: np.ndarray, pad: int = 1) -> Tuple[np.ndarray, Padding]:
    """Stride-2 (kh, kw, ci, co) kernel -> stride-1 phase-input kernel
    (T, T, 4ci, co) whose output is the standard (H/2, W/2, co) layout, and
    the asymmetric padding that reproduces the full-resolution zero pad
    (3x3 pad 1 -> 2x2 with ((1, 0), (1, 0)); 6x6 pad 2 -> 3x3 with
    ((1, 1), (1, 1)))."""
    kh, kw, ci, co = k.shape
    smin, smax = (0 - pad) // 2, (kh - 1 - pad) // 2
    tmin, tmax = (0 - pad) // 2, (kw - 1 - pad) // 2
    th, tw = smax - smin + 1, tmax - tmin + 1
    kp = np.zeros((th, tw, 4 * ci, co), k.dtype)
    for dy in range(kh):
        for dx in range(kw):
            s, a = divmod(dy - pad, 2)
            t, b = divmod(dx - pad, 2)
            kp[s - smin, t - tmin,
               (a * 2 + b) * ci:(a * 2 + b + 1) * ci] = k[dy, dx]
    return kp, ((-smin, th - 1 + smin), (-tmin, tw - 1 + tmin))


def phase_paddings(kh: int, kw: int, pad: int) -> Tuple[Padding, Padding]:
    """The (stride-1, stride-2) conv paddings that ``phase_kernel_s1/s2(k,
    pad)`` return for a (kh, kw) kernel, derived from the transforms."""
    dummy = np.zeros((kh, kw, 1, 1), np.float32)
    _, p1 = phase_kernel_s1(dummy, pad=pad)
    _, p2 = phase_kernel_s2(dummy, pad=pad)
    return p1, p2


def tile_phase_bias(bias: np.ndarray) -> np.ndarray:
    """Per-output-channel bias for a phase-space output: 4 phase copies."""
    return np.tile(np.asarray(bias), 4)


def blocked_rows(w: np.ndarray) -> np.ndarray:
    """(out, in) resize matrix -> [even rows; odd rows]: a matmul with it
    emits both phase row-halves as contiguous slices."""
    return np.concatenate([w[0::2], w[1::2]])


def phase_quadrants(u: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) tensor whose rows and columns are [even; odd] blocked
    -> (N, H/2, W/2, 4C) phase tensor: four contiguous slices joined on
    the channels."""
    h2, w2 = u.shape[1] // 2, u.shape[2] // 2
    return torch.cat([u[:, a * h2:(a + 1) * h2, b * w2:(b + 1) * w2]
                      for a in (0, 1) for b in (0, 1)], dim=-1)


def space_to_depth_host(x: np.ndarray) -> np.ndarray:
    """Reference relayout (host numpy): (..., H, W, C) -> (..., H/2, W/2,
    4C). For tests and for the phase form of int8 calibration inputs."""
    return np.concatenate([x[..., a::2, b::2, :] for a in (0, 1)
                           for b in (0, 1)], axis=-1)
