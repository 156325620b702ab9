"""YOLOv3 person detector in PyTorch.

Counterpart of ``simple_hrnet_tpu/detectors/yolov3.py``: letterbox (two
dense matmuls, cv2-exact) -> darknet forward -> box decode -> top-K
candidate select -> class-aware greedy NMS (CUDA kernel K1 on the card)
-> rescale to the original frame, all on the device. Outputs are
static-shape (max_det, 7) rows per frame with a validity mask, in the
reference's row format (x1, y1, x2, y2, conf, cls_conf, cls_pred).
"""

from __future__ import annotations

import abc
import functools
import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from simple_hrnet_tpu_torch.detectors import darknet
from simple_hrnet_tpu_torch.models import quantize as Q
from simple_hrnet_tpu_torch.models.convert import load_into
from simple_hrnet_tpu_torch.ops import image as I
from simple_hrnet_tpu_torch.ops.nms import nms_ingraph
from simple_hrnet_tpu_torch.utils import checkpoint as ckpt
from simple_hrnet_tpu_torch.utils.device import (host_to_device,
                                                 resolve_device, true_f32)

# COCO class names index 0 == person (the default filter)
PERSON_CLASS_ID = 0
# candidates kept per frame before NMS
TOP_K = 256


def letterbox_params(shape_hw: Tuple[int, int], new_shape: int = 416
                     ) -> Tuple[float, float, float, Tuple[int, int]]:
    """Square letterbox geometry (reference YOLOv3.py:23-45): (ratio, dw,
    dh, (new_w, new_h)) with dw/dh the float half paddings."""
    h, w = shape_hw
    ratio = float(new_shape) / max(h, w)
    new_unpad = (int(round(w * ratio)), int(round(h * ratio)))
    dw = (new_shape - new_unpad[0]) / 2
    dh = (new_shape - new_unpad[1]) / 2
    return ratio, dw, dh, new_unpad


def letterbox_device(frames: torch.Tensor, img_size: int) -> torch.Tensor:
    """(N, H, W, 3) RGB uint8/float -> (N, S, S, 3) f32 in [0, 1]: cv2
    INTER_LINEAR resize, then a 127.5 grey border with the reference's
    integer rounding of the pad offsets (YOLOv3.py:43-44)."""
    in_h, in_w = frames.shape[1], frames.shape[2]
    _, dw, dh, (nw, nh) = letterbox_params((in_h, in_w), img_size)
    top = int(round(dh - 0.1))
    left = int(round(dw - 0.1))
    x = I.resize_linear(frames, (nh, nw))
    out = torch.full((frames.shape[0], img_size, img_size, frames.shape[3]),
                     127.5, dtype=torch.float32, device=frames.device)
    out[:, top:top + nh, left:left + nw] = x
    return out / 255.0


def scale_coords_params(img_size: int, shape_hw: Tuple[int, int]
                        ) -> Tuple[float, float, float]:
    """gain/pad mapping letterboxed coords back (YOLOv3.py:49-56)."""
    gain = img_size / max(shape_hw)
    pad_x = (img_size - shape_hw[1] * gain) / 2
    pad_y = (img_size - shape_hw[0] * gain) / 2
    return gain, pad_x, pad_y


@functools.lru_cache(maxsize=64)
def _pad_on(pad_x: float, pad_y: float, device: torch.device) -> torch.Tensor:
    """The letterbox pad (x, y, x, y) as f32 on ``device``, copied once."""
    return host_to_device(np.asarray([pad_x, pad_y, pad_x, pad_y],
                                     np.float32), device)


def top_candidates(preds: torch.Tensor, score: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each frame's ``TOP_K`` best candidates by ``score`` (N, A): their
    scores, indices into A, and (x1, y1, x2, y2) boxes from the (cx, cy,
    w, h) of ``preds`` (N, A, 5 + C). The order is ``lax.top_k``'s:
    descending, the lowest index first among ties — a stable descending
    sort (torch.topk promises no tie order)."""
    k = min(TOP_K, score.shape[1])
    top_scores, top_idx = torch.sort(score, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    xywh = torch.gather(preds[..., :4], 1,
                        top_idx[..., None].expand(-1, -1, 4))
    boxes = torch.stack([
        xywh[..., 0] - xywh[..., 2] / 2, xywh[..., 1] - xywh[..., 3] / 2,
        xywh[..., 0] + xywh[..., 2] / 2, xywh[..., 1] + xywh[..., 3] / 2],
        dim=-1)
    return top_scores, top_idx, boxes


def kept_rows(boxes: torch.Tensor, top_scores: torch.Tensor,
              top_cls_conf: torch.Tensor, top_cls: torch.Tensor,
              keep_idx: torch.Tensor, img_size: int,
              in_hw: Tuple[int, int]) -> torch.Tensor:
    """The NMS survivors ``keep_idx`` (N, max_det) of the candidates as
    (N, max_det, 7) rows (x1, y1, x2, y2, conf, cls_conf, cls_pred),
    their boxes mapped from the letterbox back to the ``in_hw`` frame."""
    keep = keep_idx.long()
    rows = torch.cat([
        torch.gather(boxes, 1, keep[..., None].expand(-1, -1, 4)),
        torch.gather(top_scores, 1, keep)[..., None],
        torch.gather(top_cls_conf, 1, keep)[..., None],
        torch.gather(top_cls, 1, keep).float()[..., None]], dim=-1)
    gain, pad_x, pad_y = scale_coords_params(img_size, in_hw)
    pad = _pad_on(pad_x, pad_y, rows.device)
    rows[..., :4] = torch.clamp((rows[..., :4] - pad) / gain, min=0.0)
    return rows


class PersonDetector(abc.ABC):
    """The reference adapter's API over a subclass's ``_detect`` (one
    chunk of (N, H, W, 3) RGB frames on ``self.device`` -> padded rows and
    validity), in chunks of ``self.max_batch_size`` frames."""

    device: torch.device
    max_batch_size: int

    @abc.abstractmethod
    def _detect(self, frames: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunk of frames -> (rows, valid) on the device."""

    @true_f32()
    def detect_padded(self, frames_rgb) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, H, W, 3) RGB frames (numpy or tensor) -> padded rows and
        validity on the device, in chunks of ``max_batch_size`` frames. The
        detector's one device entry (``predict`` and ``predict_single``
        reach it too): its f32 letterbox and convs run in true f32, and
        the caller's TF32 flags are left as found."""
        frames = torch.as_tensor(frames_rgb, device=self.device)
        parts = [self._detect(frames[s:s + self.max_batch_size])
                 for s in range(0, frames.shape[0], self.max_batch_size)]
        if len(parts) == 1:
            return parts[0]
        return (torch.cat([r for r, _ in parts]),
                torch.cat([v for _, v in parts]))

    def predict_single(self, image: np.ndarray, color_mode: str = 'BGR'):
        """Single frame -> (n_det, 7) array or None (reference YOLOv3.py)."""
        return self.predict(image[None], color_mode=color_mode)[0]

    def predict(self, images: np.ndarray, color_mode: str = 'BGR'
                ) -> List[Optional[np.ndarray]]:
        """Batch of frames -> list of per-image (n_det, 7) arrays or None."""
        frames = torch.as_tensor(np.ascontiguousarray(images),
                                 device=self.device)
        if color_mode == 'BGR':
            frames = frames.flip(-1)
        rows, valid = self.detect_padded(frames)
        rows = rows.cpu().numpy()
        valid = valid.cpu().numpy()
        out: List[Optional[np.ndarray]] = []
        for i in range(rows.shape[0]):
            n = int(valid[i].sum())
            out.append(rows[i, :n] if n > 0 else None)
        return out


class YOLOv3(PersonDetector):
    """Person detector with the reference adapter's constructor surface.

    ``model_def``: 'yolov3', 'yolov3-tiny' or the path of a darknet
    ``.cfg`` (parsed when the file exists; a missing one falls back to the
    built-in blocks, 'tiny' in the name picking YOLOv3-tiny, as in the JAX
    package); ``class_path`` is accepted and not read (the COCO class
    order is built in, as in the JAX package); ``weights_path``: a darknet
    ``.weights`` binary, a ``.pth``/``.pt`` ``Darknet`` state_dict, a JAX
    ``.npz`` darknet tree, or None for random weights (seed 0, for tests
    and smoke runs). ``device``:
    'cuda' (default; raises without a card) or 'cpu'. ``dtype``: None
    (f32) or 'bfloat16' for the darknet convs.
    """

    def __init__(self,
                 model_def: str = 'yolov3',
                 class_path: Optional[str] = None,
                 weights_path: Optional[str] = None,
                 conf_thres: float = 0.2,
                 nms_thres: float = 0.4,
                 img_size: int = 416,
                 classes: Sequence[str] = ('person',),
                 max_batch_size: int = 16,
                 max_detections: int = 32,
                 device: Union[str, torch.device, None] = None,
                 dtype: Union[str, torch.dtype, None] = None,
                 quantize_int8: Optional[bool] = None):
        if quantize_int8 is not None and dtype != 'int8':
            raise ValueError("quantize_int8 only applies with dtype='int8'")
        if model_def.endswith('.cfg') and os.path.exists(model_def):
            self.blocks = darknet.parse_cfg(model_def)
        elif 'tiny' in model_def:
            self.blocks = darknet.yolov3_tiny_blocks()
        else:
            self.blocks = darknet.yolov3_blocks()
        if weights_path and os.path.exists(weights_path):
            if weights_path.endswith('.weights'):
                net = darknet.load_darknet_weights(weights_path, self.blocks)
            else:
                net = load_into(darknet.Darknet(self.blocks),
                                ckpt.load(weights_path)).eval()
        else:
            net = darknet.init(self.blocks, seed=0)
        self.device = resolve_device(device)
        net = darknet.fold_weights(net.to(self.device))
        self.quantized = False
        if dtype == 'int8':
            if quantize_int8 is None:
                quantize_int8 = sum(b['type'] == 'convolutional'
                                    for b in self.blocks) >= 20
            if quantize_int8:
                self._quantize_int8(net, img_size)
                self.quantized = True
            dtype = 'bfloat16'
        self.dtype = _resolve_dtype(dtype)
        self.net = darknet.fold_weights(net, self.dtype)
        self.conf_thres = conf_thres
        self.nms_thres = nms_thres
        self.img_size = img_size
        self.max_detections = max_detections
        self.max_batch_size = max(1, max_batch_size)
        self.class_ids = torch.tensor(
            (PERSON_CLASS_ID,) if 'person' in classes else tuple(range(80)),
            device=self.device)

    def _quantize_int8(self, net: darknet.Darknet, img_size: int) -> None:
        """Calibrate the folded f32 network on a smooth synthetic frame and
        quantize in place the policy-accepted convs that the JAX package
        quantizes with its defaults."""
        cal = torch.from_numpy(Q.smooth_frames((img_size, img_size))).to(
            self.device)
        amax = Q.calibrate(net, [cal], forward=lambda v: net(v, img_size),
                           types=(darknet.DarknetConv,))
        if img_size % 2 == 0:
            # the JAX package's phase stem, on by default at an even size,
            # rewrites these convs out of its quantize policy: they stay in
            # the compute type there, and so here
            for name in darknet.phase_stem_convs(self.blocks):
                amax.pop(name, None)
        Q.quantize_folded(net, amax, types=(darknet.DarknetConv,))

    # -- device pipeline ----------------------------------------------------

    @torch.no_grad()
    def _detect(self, frames: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, H, W, 3) RGB on the device -> rows (N, max_det, 7) f32,
        valid (N, max_det) bool."""
        in_hw = (frames.shape[1], frames.shape[2])
        img_size = self.img_size
        preds = self.net(letterbox_device(frames, img_size), img_size)
        obj = preds[..., 4]
        cls_scores = preds[..., 5:]
        cls_conf = cls_scores.amax(dim=-1)
        cls_pred = torch.argmax(cls_scores, dim=-1)
        keep_cls = torch.isin(cls_pred, self.class_ids)
        score = torch.where((obj >= self.conf_thres) & keep_cls, obj,
                            torch.zeros((), device=obj.device))
        top_scores, top_idx, boxes = top_candidates(preds, score)
        top_cls = torch.gather(cls_pred, 1, top_idx)
        # class-aware NMS: offset boxes per class
        offset = top_cls.float()[..., None] * (2.0 * img_size)
        keep_idx, keep_valid = nms_ingraph(boxes + offset, top_scores,
                                           self.nms_thres,
                                           self.max_detections)
        rows = kept_rows(boxes, top_scores, torch.gather(cls_conf, 1, top_idx),
                         top_cls, keep_idx, img_size, in_hw)
        return rows, keep_valid


def _resolve_dtype(dtype) -> torch.dtype:
    if dtype is None or dtype == torch.float32:
        return torch.float32
    if dtype in ('bfloat16', 'bf16', torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"Unsupported dtype {dtype!r} (None, 'bfloat16' or "
                     "'int8')")
