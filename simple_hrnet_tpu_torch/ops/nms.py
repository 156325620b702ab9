"""In-graph box NMS for the detector, in PyTorch.

Counterpart of ``nms_ingraph`` in ``simple_hrnet_tpu/ops/nms.py``: the
``nms_jax`` contract (per-image greedy NMS with a static ``max_out``,
scores <= 0 are padding, ties to the lowest index), run by the CUDA
kernel K1 on CUDA tensors and by its plain version on CPU tensors
(``ops/cuda/nms.py``).

The host tier, in numpy, as the JAX package's (``ops/nms.py:154-290``):
``nms_numpy`` (greedy box NMS in f32, the +1 pixel convention) and the
COCO evaluation's OKS suppression, ``oks_iou``, ``oks_nms``, ``rescore``
and ``soft_oks_nms`` (reference misc/nms/nms.py). ``nms_numpy`` runs the
JAX package's ``libnms`` route (its ops/nms.py:120-150): the port's copy
of ``native/nms.cpp`` (``csrc/host/nms.cpp``), compiled by ``g++`` at
first use; ``native=False`` runs the numpy path, which gives the same keep
lists.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from simple_hrnet_tpu_torch.ops.cuda.nms import nms, nms_plain
from simple_hrnet_tpu_torch.utils.profiling import span
from simple_hrnet_tpu_torch.utils.tracking import COCO_SIGMAS

__all__ = ['nms_ingraph', 'nms_plain', 'nms_numpy', 'oks_iou', 'oks_nms',
           'rescore', 'soft_oks_nms']


def nms_ingraph(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float, max_out: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes (N, 4) / (B, N, 4) f32 xyxy, scores (N,) / (B, N) -> keep_idx
    int32 and keep_valid bool of shape (max_out,) / (B, max_out). In a
    ``sht.nms[B]`` span."""
    with span('nms', boxes.shape[0] if boxes.ndim == 3 else 1):
        if boxes.ndim == 2:
            idx, valid = nms(boxes[None], scores[None], iou_threshold,
                             max_out)
            return idx[0], valid[0]
        return nms(boxes, scores, iou_threshold, max_out)


def _native_nms():
    """The host ``cpu_nms`` (``csrc/host/nms.cpp``), built at first use; a
    failed build raises with the compiler's output."""
    import ctypes
    from simple_hrnet_tpu_torch.ops.cuda.build import host_library
    lib = host_library('nms')
    lib.cpu_nms.restype = ctypes.c_int
    lib.cpu_nms.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int)]
    return lib


def nms_numpy(dets: np.ndarray, thresh: float, native: bool = True) -> list:
    """Greedy box NMS (misc/nms/nms.py:35-72, +1 convention) of (N, 5)
    [x1, y1, x2, y2, score] in float32. Returns the kept indices; tied
    scores rank by descending index (a stable sort, reversed). The host
    C++ library runs it unless ``native=False`` (the numpy loop, the same
    f32 arithmetic and keep lists)."""
    if dets.shape[0] == 0:
        return []
    dets = np.ascontiguousarray(dets, np.float32)
    if native:
        import ctypes
        keep = np.zeros(dets.shape[0], np.int32)
        n = _native_nms().cpu_nms(
            dets.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            dets.shape[0], ctypes.c_float(thresh),
            keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return keep[:n].tolist()
    x1, y1, x2, y2, scores = (dets[:, i] for i in range(5))
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort(kind='stable')[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[np.where(ovr <= thresh)[0] + 1]
    return keep


def oks_iou(g, d, a_g, a_d, sigmas=None, in_vis_thre=None):
    """OKS of one flattened (J*3,) keypoint set ``g`` against each row of
    ``d`` (M, J*3) (misc/nms/nms.py:75-94)."""
    if not isinstance(sigmas, np.ndarray):
        sigmas = COCO_SIGMAS
    variances = (sigmas * 2) ** 2
    xg, yg, vg = g[0::3], g[1::3], g[2::3]
    ious = np.zeros((d.shape[0]))
    for n_d in range(d.shape[0]):
        xd, yd, vd = d[n_d, 0::3], d[n_d, 1::3], d[n_d, 2::3]
        dx = xd - xg
        dy = yd - yg
        e = ((dx ** 2 + dy ** 2) / variances
             / ((a_g + a_d[n_d]) / 2 + np.spacing(1)) / 2)
        if in_vis_thre is not None:
            # the reference's expression (nms.py:91): `and` of two
            # non-empty lists is the second, so only the detection's
            # visibility filters
            ind = list(vg > in_vis_thre) and list(vd > in_vis_thre)
            e = e[ind]
        ious[n_d] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] != 0 \
            else 0.0
    return ious


def oks_nms(kpts_db, thresh, sigmas=None, in_vis_thre=None):
    """Greedy OKS suppression (misc/nms/nms.py:97-124)."""
    if len(kpts_db) == 0:
        return []
    scores = np.array([k['score'] for k in kpts_db])
    kpts = np.array([np.asarray(k['keypoints']).flatten() for k in kpts_db])
    areas = np.array([k['area'] for k in kpts_db])
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        ovr = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]],
                      sigmas, in_vis_thre)
        order = order[np.where(ovr <= thresh)[0] + 1]
    return keep


def rescore(overlap, scores, thresh, type='gaussian'):
    """Soft-NMS rescoring (misc/nms/nms.py:125-134): 'gaussian' decays
    every score by exp(-oks^2/thresh); 'linear' scales the overlaps >=
    thresh by (1 - oks), in place, as the reference does."""
    assert overlap.shape[0] == scores.shape[0]
    if type == 'linear':
        inds = np.where(overlap >= thresh)[0]
        scores[inds] = scores[inds] * (1 - overlap[inds])
    else:
        scores = scores * np.exp(-overlap ** 2 / thresh)
    return scores


def soft_oks_nms(kpts_db, thresh, sigmas=None, in_vis_thre=None,
                 max_dets: int = 20, rescore_type: str = 'gaussian'):
    """Soft OKS-NMS (misc/nms/nms.py:136-177) with both rescore modes."""
    if len(kpts_db) == 0:
        return []
    scores = np.array([k['score'] for k in kpts_db])
    kpts = np.array([np.asarray(k['keypoints']).flatten() for k in kpts_db])
    areas = np.array([k['area'] for k in kpts_db])

    order = scores.argsort()[::-1]
    scores = scores[order]
    keep = np.zeros(max_dets, np.intp)
    keep_cnt = 0
    while order.size > 0 and keep_cnt < max_dets:
        i = order[0]
        ovr = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]],
                      sigmas, in_vis_thre)
        order = order[1:]
        scores = rescore(ovr, scores[1:], thresh, type=rescore_type)
        tmp = scores.argsort()[::-1]
        order = order[tmp]
        scores = scores[tmp]
        keep[keep_cnt] = i
        keep_cnt += 1
    return keep[:keep_cnt].tolist()
