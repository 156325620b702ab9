"""ctypes binding to the native host image pipeline (csrc/host/imgproc.cpp).

Counterpart of ``simple_hrnet_tpu/data/native.py``, with its functions. The
library is the port's own copy of ``native/imgproc.cpp``, compiled by
``g++`` (linking ``-ljpeg``) into ``_build/`` at first use
(``ops/cuda/build.py`` ``host_library``); a build that fails raises there,
with the compiler's output (a missing ``jpeglib.h`` is named in it).

One C call per training sample replaces cv2.imread + warpAffine +
normalize: JPEG decode -> affine warp (bilinear, 0-border) -> ImageNet
normalize, producing the network-ready (h, w, 3) float32 HWC array with no
intermediate Python objects. This is the native data-loader analogue of
the reference's torch-DataLoader C++ workers; it is opt-in
(``COCODataset(use_native_decode=True)``) because JPEG IDCT details can
differ from cv2's decoder at the +-1 LSB level.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_LIB = None


def _load():
    global _LIB
    if _LIB is None:
        from simple_hrnet_tpu_torch.ops.cuda.build import host_library
        lib = host_library('imgproc')
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.jpeg_dims.restype = ctypes.c_int
        lib.jpeg_dims.argtypes = [u8p, ctypes.c_int, i32p, i32p]
        lib.jpeg_decode_rgb.restype = ctypes.c_int
        lib.jpeg_decode_rgb.argtypes = [u8p, ctypes.c_int, u8p]
        lib.decode_warp_normalize.restype = ctypes.c_int
        lib.decode_warp_normalize.argtypes = [
            u8p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p]
        lib.warp_affine_bilinear.restype = None
        lib.warp_affine_bilinear.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, f32p, f32p,
            ctypes.c_int, ctypes.c_int]
        _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the library builds and loads here; a failed build raises
    at the first use of another function."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def jpeg_dims(data: bytes) -> Optional[tuple]:
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.jpeg_dims(_u8p(buf), len(data), ctypes.byref(w),
                     ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def decode_jpeg_rgb(data: bytes) -> Optional[np.ndarray]:
    lib = _load()
    dims = jpeg_dims(data)
    if dims is None:
        return None
    w, h = dims
    out = np.empty((h, w, 3), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    if lib.jpeg_decode_rgb(_u8p(buf), len(data), _u8p(out)) != 0:
        return None
    return out


def warp_affine(src: np.ndarray, m_inv: np.ndarray, oh: int, ow: int
                ) -> np.ndarray:
    """f32 (h, w, 3) -> (oh, ow, 3) via the inverse (dst->src) 2x3 map."""
    lib = _load()
    src = np.ascontiguousarray(src, np.float32)
    m = np.ascontiguousarray(m_inv, np.float32).reshape(6)
    dst = np.empty((oh, ow, 3), np.float32)
    lib.warp_affine_bilinear(_f32p(src), src.shape[0], src.shape[1],
                             _f32p(m), _f32p(dst), oh, ow)
    return dst


def decode_warp_normalize(data: bytes, m_inv: np.ndarray, oh: int, ow: int,
                          mean255, scale) -> Optional[np.ndarray]:
    """Fused JPEG -> warp -> (x_255 - mean255) * scale; (oh, ow, 3) f32.

    Callers pass the shared pre-merged constants (ops/image.py MEAN255 /
    INV255_STD) for the ImageNet normalize, or (0, 1) for the raw
    device_targets tail."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    m = np.ascontiguousarray(m_inv, np.float32).reshape(6)
    mean255 = np.ascontiguousarray(mean255, np.float32)
    scale = np.ascontiguousarray(scale, np.float32)
    out = np.empty((oh, ow, 3), np.float32)
    if lib.decode_warp_normalize(_u8p(buf), len(data), _f32p(m), oh, ow,
                                 _f32p(mean255), _f32p(scale),
                                 _f32p(out)) != 0:
        return None
    return out
