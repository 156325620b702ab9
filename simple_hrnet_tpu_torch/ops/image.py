"""Device image preprocessing, in PyTorch.

Counterpart of ``simple_hrnet_tpu/ops/image.py`` for what ``predict``
runs: the ImageNet ``normalize`` convention; the whole-frame resizers —
cv2-exact bilinear (the detector's letterbox, and the single-person path's
'linear'), cv2-exact bicubic (the single-person default, 'cubic') and
PIL's antialiased bilinear ('bilinear_aa'); the PIL-exact person crop and
the aspect padding of the detection boxes. The resamplers are dense
matmuls, as in the JAX package (which left them to XLA, outside any Pallas
kernel). The whole-frame resizers run in true f32 (``utils/device
.true_f32``: TF32 off); the PIL crop runs in f64, where it is exact (see
``crop_resize_pil``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from simple_hrnet_tpu_torch.utils.device import host_to_device, true_f32

# ImageNet statistics (reference SimpleHRNet.py:152, 171); copies of the
# JAX package's constants, built with the same f32 roundings.
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
IMAGENET_INV_STD = (np.float32(1.0) / IMAGENET_STD).astype(np.float32)
INV255 = np.float32(1.0) / np.float32(255.0)
# normalize = (x_255 - MEAN255) * INV255_STD: never a division, and
# subtract-then-multiply so no compiler can FMA-contract it — the same
# bits as the JAX package and its host pipeline
MEAN255 = (IMAGENET_MEAN * np.float32(255.0)).astype(np.float32)
INV255_STD = (INV255 * IMAGENET_INV_STD).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _normalize_constants(device: torch.device
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MEAN255 and INV255_STD on ``device``, copied there once."""
    return host_to_device(MEAN255, device), host_to_device(INV255_STD, device)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """[0, 255] RGB (..., 3) -> ImageNet-normalized float32."""
    mean, inv_std = _normalize_constants(x.device)
    return (x.float() - mean) * inv_std


def _linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out, in) bilinear matrix: half-pixel centers, edge clamp —
    cv2.resize INTER_LINEAR arithmetic (float path)."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        base = int(np.floor(src))
        frac = src - base
        w[i, min(max(base, 0), in_size - 1)] += 1.0 - frac
        w[i, min(max(base + 1, 0), in_size - 1)] += frac
    return w


def _cubic_weights(in_size: int, out_size: int, a: float = -0.75
                   ) -> np.ndarray:
    """Dense (out, in) bicubic matrix with cv2's kernel (a = -0.75) and
    border clamping — cv2.resize INTER_CUBIC arithmetic."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        base = int(np.floor(src))
        frac = src - base
        for t in range(-1, 3):
            d = abs(frac - t)
            if d <= 1:
                k = (a + 2) * d ** 3 - (a + 3) * d ** 2 + 1
            elif d < 2:
                k = a * d ** 3 - 5 * a * d ** 2 + 8 * a * d - 4 * a
            else:
                k = 0.0
            w[i, min(max(base + t, 0), in_size - 1)] += k
    return w


def _linear_aa_weights(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out, in) antialiased bilinear matrix: Pillow's
    ``precompute_coeffs`` for the triangle filter (the kernel widens by the
    downscale factor, weights normalized per output pixel, window bounds
    by ``int(x + 0.5)``); plain half-pixel bilinear on upscales."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # bilinear filter support = 1.0
    w = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        xs = np.arange(xmin, xmax)
        k = 1.0 - np.abs((xs - center + 0.5) / filterscale)
        k = np.maximum(k, 0.0)
        s = k.sum()
        if s != 0.0:
            k /= s
        w[i, xmin:xmax] = k
    return w.astype(np.float32)


_WEIGHTS = {'linear': _linear_weights, 'cubic': _cubic_weights,
            'bilinear_aa': _linear_aa_weights}


@functools.lru_cache(maxsize=64)
def _weights_on(kind: str, in_size: int, out_size: int,
                device: torch.device) -> torch.Tensor:
    """``_WEIGHTS[kind]`` on ``device``, copied there once per shape."""
    return host_to_device(_WEIGHTS[kind](in_size, out_size), device)


def _resize(image: torch.Tensor, out_hw: Tuple[int, int], kind: str
            ) -> torch.Tensor:
    """(..., H, W, C) resized to ``out_hw`` by two dense f32 matmuls with
    the ``kind`` weights: rows, then columns."""
    wh = _weights_on(kind, image.shape[-3], out_hw[0], image.device)
    ww = _weights_on(kind, image.shape[-2], out_hw[1], image.device)
    with true_f32():
        x = torch.einsum('oh,...hwc->...owc', wh, image.float())
        return torch.einsum('pw,...hwc->...hpc', ww, x)


def resize_linear(image: torch.Tensor, out_hw: Tuple[int, int]
                  ) -> torch.Tensor:
    """cv2.INTER_LINEAR-equivalent resize of (..., H, W, C), in f32."""
    return _resize(image, out_hw, 'linear')


def resize_cubic(image: torch.Tensor, out_hw: Tuple[int, int]
                 ) -> torch.Tensor:
    """cv2.INTER_CUBIC-equivalent resize of (..., H, W, C), in f32: the
    single-person path's default (reference SimpleHRNet.py:216-220)."""
    return _resize(image, out_hw, 'cubic')


def resize_bilinear_aa(image: torch.Tensor, out_hw: Tuple[int, int]
                       ) -> torch.Tensor:
    """PIL-equivalent antialiased bilinear resize of (..., H, W, C), in
    f32 (``transforms.Resize`` on float images)."""
    return _resize(image, out_hw, 'bilinear_aa')


def _triangle_mass(lo: torch.Tensor, hi: torch.Tensor, center: torch.Tensor,
                   fs: torch.Tensor) -> torch.Tensor:
    """Closed-form sum over integer y in [lo, hi) of the PIL triangle
    kernel max(0, 1 - |y + 0.5 - c| / fs), per output pixel (PIL
    normalizes its coefficients over the whole crop window, np.pad zeros
    included). ``lo``/``hi``/``fs`` (P, 1), ``center`` (P, O)."""
    a = torch.maximum(lo, torch.floor(center - fs - 0.5) + 1.0)
    b = torch.minimum(hi - 1.0, torch.ceil(center + fs - 0.5) - 1.0)
    n = torch.clamp(b - a + 1.0, min=0.0)

    def s(p, q):  # sum of (y + 0.5 - c) for integer y in [p, q]
        m = torch.clamp(q - p + 1.0, min=0.0)
        return m * ((p + q) * 0.5 + 0.5 - center)

    mid = torch.minimum(torch.maximum(torch.ceil(center - 0.5) - 1.0,
                                      a - 1.0), b)  # last u < 0
    sum_abs = -s(a, mid) + s(mid + 1.0, b)
    return n - sum_abs / fs


def _pil_axis_weights(lo: torch.Tensor, hi: torch.Tensor, out_size: int,
                      n_frame: int, valid_lo: torch.Tensor,
                      valid_hi: torch.Tensor, dtype: torch.dtype
                      ) -> torch.Tensor:
    """(P, out_size, n_frame) PIL ``precompute_coeffs`` matrices for P crop
    windows [lo, hi) (integer-valued, frame coordinates), in ``dtype``, with zero
    weight outside [valid_lo, valid_hi) (np.pad region) and the frame.
    Each coefficient is rounded to PIL's 8bpc fixed point (1/2^22)."""
    dev = lo.device
    lo = lo.to(dtype)[:, None]
    hi = torch.maximum(hi.to(dtype)[:, None], lo + 1.0)
    scale = (hi - lo) / out_size
    fs = torch.clamp(scale, min=1.0)
    i = torch.arange(out_size, dtype=dtype, device=dev)
    center = lo + (i[None, :] + 0.5) * scale                    # (P, O)
    y = torch.arange(n_frame, dtype=dtype, device=dev)          # (N,)
    u = y[None, None, :] + 0.5 - center[:, :, None]
    k = torch.clamp(1.0 - torch.abs(u) / fs[:, :, None], min=0.0)
    in_box = (y[None, :] >= lo) & (y[None, :] <= hi - 1.0)      # (P, N)
    k = torch.where(in_box[:, None, :], k, torch.zeros((), device=dev))
    denom = _triangle_mass(lo, hi, center, fs)                  # (P, O)
    k = k / torch.clamp(denom, min=1e-12)[:, :, None]
    k = torch.floor(k * float(1 << 22) + 0.5) * (1.0 / float(1 << 22))
    in_valid = (y[None, :] >= valid_lo.to(dtype)[:, None]) & \
        (y[None, :] <= valid_hi.to(dtype)[:, None] - 1.0)
    return torch.where(in_valid[:, None, :], k, torch.zeros((), device=dev))


def crop_resize_pil(frames: torch.Tensor, frame_idx: torch.Tensor,
                    boxes: torch.Tensor, out_hw: Tuple[int, int],
                    valid_boxes: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """PIL-exact person crops, batched: reproduces the reference's
    ``crop -> np.pad -> ToPILImage -> transforms.Resize -> ToTensor``
    (SimpleHRNet.py:237-279) for P dynamic boxes at once.

    frames (F, H, W, C) uint8/float; frame_idx (P,) int; boxes (P, 4) the
    aspect-padded windows (x1, y1, x2, y2, integer-valued); valid_boxes
    (P, 4) the original detections holding real pixels (None: the whole
    window). Width pass first, then height — PIL's order — each rounded
    to uint8. Returns (P, oh, ow, C) f32 in [0, 255].

    Computed in f64, where it is exact: the coefficients are multiples of
    2^-22 and the pixels 8-bit integers, so every product and every sum
    (< 2^9) fits the 53-bit mantissa. The crops are then PIL's bits on any
    device and in any summation order (the JAX package's f32 path can
    flip a round-half case by one count; under x64 it is exact too).
    """
    f64 = torch.float64
    oh, ow = out_hw
    h, w = frames.shape[1], frames.shape[2]
    x1, y1, x2, y2 = boxes.to(f64).unbind(1)
    vb = boxes if valid_boxes is None else valid_boxes
    vx1, vy1, vx2, vy2 = vb.to(f64).unbind(1)
    # the reference truncates the crop at the bottom/right frame edge
    # BEFORE np.pad: the window's hi shifts by the overhang
    x2 = x2 - torch.clamp(vx2 - w, min=0.0)
    y2 = y2 - torch.clamp(vy2 - h, min=0.0)
    ww = _pil_axis_weights(x1, x2, ow, w, vx1, vx2, f64)
    wh = _pil_axis_weights(y1, y2, oh, h, vy1, vy2, f64)
    img = frames[frame_idx.long()].to(f64)                     # (P, H, W, C)
    t = torch.einsum('pow,phwc->phoc', ww, img)
    t = torch.clamp(torch.floor(t + 0.5), 0.0, 255.0)
    out = torch.einsum('pqh,phoc->pqoc', wh, t)
    return torch.clamp(torch.floor(out + 0.5), 0.0, 255.0).float()


def pad_to_aspect(boxes: torch.Tensor, aspect: float,
                  clamp_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Grow xyxy boxes (P, 4) f32 to the height/width ``aspect`` along the
    deficient axis, with the reference's integer arithmetic
    (SimpleHRNet.py:243-272): length = round(side * f), bounds =
    center -/+ length // 2, center = lo + side // 2. ``clamp_hw`` = (H, W)
    clamps the grown axis to the frame (the reference's batch path,
    SimpleHRNet.py:393-407)."""
    x1, y1, x2, y2 = boxes.unbind(1)
    w = x2 - x1
    h = y2 - y1
    cmp = w * aspect - h  # sign(correction - 1), exact integer products

    cy = y1 + torch.floor(h / 2)
    ly = torch.round(w * aspect)
    y1_new = cy - torch.floor(ly / 2)
    y2_new = cy + torch.floor(ly / 2)
    cx = x1 + torch.floor(w / 2)
    lx = torch.round(h * (1.0 / aspect))
    x1_new = cx - torch.floor(lx / 2)
    x2_new = cx + torch.floor(lx / 2)

    if clamp_hw is not None:
        y1_new = torch.clamp(y1_new, min=0.0)
        y2_new = torch.clamp(y2_new, max=float(clamp_hw[0]))
        x1_new = torch.clamp(x1_new, min=0.0)
        x2_new = torch.clamp(x2_new, max=float(clamp_hw[1]))

    grow_y = cmp > 0
    grow_x = cmp < 0
    return torch.stack([
        torch.where(grow_x, x1_new, x1),
        torch.where(grow_y, y1_new, y1),
        torch.where(grow_x, x2_new, x2),
        torch.where(grow_y, y2_new, y2),
    ], dim=1)
