"""SimpleHRNet — the multi-person inference facade, in PyTorch on CUDA.

Counterpart of ``simple_hrnet_tpu/api.py`` for ``model_name='HRNet'``,
``multiperson=True``, ``yolo_version='v3'`` and ``dtype`` None (f32),
'bfloat16' or 'int8' (post-training quantization of HRNet and YOLOv3, with
``calibration_images`` and ``int8_exclude``). ``predict(image)`` keeps the
reference's contract (one HWC BGR frame or an NHWC stack; (people, joints,
3) arrays of (y, x, conf), optionally preceded by heatmaps and bounding
boxes).

Pipeline, all on the device: each frame is uploaded once as uint8 and
flipped BGR -> RGB there; YOLOv3 detects (NMS kernel K1); the valid
(frame, box) pairs are compacted frame-major by a stable argsort; a
power-of-two bucket of them is aspect-padded, PIL-exact cropped,
normalized, posed by HRNet (a branch-0 chain kernel — K2, the Winograd
chain B3 or the int8 chain B4 — and K3 in every stage module) and
argmax-decoded. The first host read is the people count, after the first
pose batch.

Constructor options of the JAX facade that are not ported raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from simple_hrnet_tpu_torch.detectors.yolov3 import YOLOv3
from simple_hrnet_tpu_torch.models import hrnet
from simple_hrnet_tpu_torch.models import layers as L
from simple_hrnet_tpu_torch.models import quantize as Q
from simple_hrnet_tpu_torch.models.convert import load_into
from simple_hrnet_tpu_torch.ops import decode as D
from simple_hrnet_tpu_torch.ops import image as I
from simple_hrnet_tpu_torch.utils import checkpoint as ckpt
from simple_hrnet_tpu_torch.utils.device import resolve_device


def _buckets(n: int, max_batch: int) -> int:
    """Next power-of-two bucket of ``n``, capped at ``max_batch``."""
    cap = max(max_batch, 1)
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


def _pose_tail(model, crops: torch.Tensor, padded_boxes: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8-rounded crops -> ImageNet normalize -> HRNet -> argmax decode
    into the padded-box frame coordinates (SimpleHRNet.py:279-296)."""
    x = I.normalize(torch.clamp(torch.round(crops), 0.0, 255.0))
    hm = model(x)
    return hm, D.argmax_decode(hm, padded_boxes)


def _not_ported(what: str):
    return NotImplementedError(f'{what} is not ported to the PyTorch/CUDA '
                               'package yet (see ROADMAP.md)')


class SimpleHRNet:
    """Multi-person 2D pose estimation on an NVIDIA GPU.

    Args mirror the JAX facade. ``device``: 'cuda' (default; raises without
    a card) or 'cpu'. ``dtype``: None (f32), 'bfloat16' (HRNet and darknet
    convs in bf16, heatmap head f32) or 'int8': TensorRT-style
    post-training quantization (``models/quantize.py``) of HRNet and of
    YOLOv3 (not of YOLOv3-tiny, as in the JAX package), bf16 elsewhere —
    the precision mix of the JAX facade's ``use_fused_kernels=False`` int8
    graph, with the branch-0 chains on the int8 chain kernel.
    ``calibration_images`` (HWC RGB frames) calibrate the activation
    scales instead of smooth synthetic frames; ``int8_exclude`` (dotted
    path prefixes such as ('stage4',)) keeps those convs bf16. Both raise
    ``ValueError`` without int8. HRNet's branch-0 chain and high-res fusion
    always run through the CUDA kernels on the card
    (``use_fused_kernels=False`` raises). ``interpolation`` is validated as
    in the JAX facade; multi-person crops always use the PIL-exact
    resampler there too.
    """

    def __init__(self,
                 c: int,
                 nof_joints: int,
                 checkpoint_path: str,
                 model_name: str = 'HRNet',
                 resolution: Tuple[int, int] = (384, 288),
                 interpolation: Union[str, int, None] = 'cubic',
                 multiperson: bool = True,
                 return_heatmaps: bool = False,
                 return_bounding_boxes: bool = False,
                 max_batch_size: int = 32,
                 yolo_version: str = 'v3',
                 yolo_model_def: str = 'yolov3',
                 yolo_class_path: Optional[str] = None,
                 yolo_weights_path: Optional[str] = None,
                 device: Union[str, torch.device, None] = None,
                 enable_tensorrt: bool = False,
                 dtype: Union[str, None] = None,
                 use_fused_kernels: bool = True,
                 mesh=None,
                 calibration_images=None,
                 int8_exclude=(),
                 yolo_max_detections: int = 32):
        if calibration_images is not None and dtype != 'int8':
            raise ValueError("calibration_images only applies with "
                             "dtype='int8' (nothing is calibrated "
                             'otherwise)')
        self.int8_exclude = tuple(int8_exclude)
        if self.int8_exclude and dtype != 'int8':
            raise ValueError("int8_exclude only applies with dtype='int8' "
                             '(nothing is quantized otherwise)')
        self.calibration_images = calibration_images
        if model_name not in ('HRNet', 'hrnet'):
            raise _not_ported(f'model_name={model_name!r}')
        if not multiperson:
            raise _not_ported('multiperson=False (the single-person path)')
        if yolo_version != 'v3':
            raise _not_ported(f'yolo_version={yolo_version!r}')
        if enable_tensorrt or checkpoint_path.endswith('.jaxpose'):
            raise _not_ported('engine export / enable_tensorrt')
        if not use_fused_kernels:
            raise _not_ported('use_fused_kernels=False')
        if mesh is not None:
            raise _not_ported('mesh (multi-device inference)')
        if dtype not in (None, 'bfloat16', 'bf16', 'int8'):
            raise ValueError(f'Unsupported dtype {dtype!r}')
        if interpolation not in ('cubic', None, 2, 'linear', 'bilinear', 1,
                                 'bilinear_aa'):
            raise ValueError(f'Unsupported interpolation {interpolation!r}')
        self.c = c
        self.nof_joints = nof_joints
        self.checkpoint_path = checkpoint_path
        self.model_name = model_name
        self.resolution = tuple(resolution)  # (height, width)
        self.interpolation = interpolation
        self.multiperson = multiperson
        self.return_heatmaps = return_heatmaps
        self.return_bounding_boxes = return_bounding_boxes
        self.max_batch_size = max_batch_size
        self.device = resolve_device(device)
        self.quantize_int8 = dtype == 'int8'
        self.dtype = torch.bfloat16 if dtype in ('bfloat16', 'bf16', 'int8') \
            else torch.float32
        if self.device.type == 'cuda':
            # true f32 where f32 is computed: the crops' matmuls and f32
            # convs (cuDNN would otherwise run f32 convs in TF32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        model = load_into(hrnet.HRNet(c, nof_joints),
                          ckpt.load(checkpoint_path)).to(self.device)
        amax = None
        if self.quantize_int8:
            # calibrate the folded f32 model with its plain blocks, before
            # prepare_inference packs the chains (api.py:264-277 of the JAX
            # package calibrates the plain hrnet.apply graph too)
            L.fold_batch_norm(model.eval())
            amax = self._calibrate_int8(model)
            if self.int8_exclude:
                amax = Q.filter_amax(model, amax, self.int8_exclude)
        self.model = hrnet.prepare_inference(model, self.dtype, amax=amax)

        self.detector = YOLOv3(model_def=yolo_model_def,
                               class_path=yolo_class_path,
                               weights_path=yolo_weights_path,
                               max_batch_size=max_batch_size,
                               max_detections=yolo_max_detections,
                               device=self.device,
                               dtype='int8' if self.quantize_int8 else
                               None if self.dtype == torch.float32
                               else 'bfloat16')

    @torch.no_grad()
    def _calibrate_int8(self, model: hrnet.HRNet):
        """Activation amax of every conv of the folded f32 ``model``
        (JAX facade api.py:362-396): one forward on the
        ``calibration_images`` (HWC RGB, linearly resized to the model
        resolution; uint8 frames rounded back to uint8, as cv2.resize does)
        or, without them, on two smooth synthetic frames in [0, 255]; both
        normalized like the serving inputs (subtract, then multiply)."""
        h, w = self.resolution
        if self.calibration_images is not None:
            imgs = []
            for im in self.calibration_images:
                im = np.asarray(im)
                r = I.resize_linear(torch.from_numpy(im).to(self.device),
                                    (h, w))
                if im.dtype == np.uint8:
                    r = torch.clamp(torch.round(r), 0.0, 255.0)
                imgs.append(r.cpu().numpy())
            imgs = np.stack(imgs)
        else:
            imgs = Q.smooth_frames(self.resolution, n=2, lo=0.0, hi=255.0)
        batch = ((imgs.astype(np.float32) - I.MEAN255)
                 * I.INV255_STD).astype(np.float32)
        return Q.calibrate(model, [torch.from_numpy(batch).to(self.device)])

    # ------------------------------------------------------------------
    # device pipeline
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _gather_crop(self, bucket: int, frames_rgb: torch.Tensor,
                     rows: torch.Tensor, valid: torch.Tensor, start: int,
                     clamp_hw: Optional[tuple]):
        """One window of the compaction pipeline: valid (frame, box) pairs
        ordered frame-major (stable argsort), ``bucket`` of them from
        ``start`` cropped, posed and decoded. Slots past the total are
        computed and dropped by the caller."""
        res_h, res_w = self.resolution
        d = valid.shape[1]
        flat_valid = valid.reshape(-1)
        counts = valid.sum(dim=1)
        total = flat_valid.sum()
        order = torch.argsort((~flat_valid).to(torch.uint8), stable=True)
        order = torch.cat([order, order.new_zeros(bucket)])
        sel = order[start:start + bucket]
        fi = sel // d
        boxes = torch.round(rows.reshape(-1, rows.shape[-1])[sel][:, :4])
        padded = I.pad_to_aspect(boxes, res_h / res_w, clamp_hw=clamp_hw)
        crops = I.crop_resize_pil(
            frames_rgb, fi, padded, (res_h, res_w),
            valid_boxes=None if clamp_hw is not None else boxes)
        hm, pts = _pose_tail(self.model, crops, padded)
        return total, counts, hm, padded, pts

    def _run_gathered(self, frames_rgb: torch.Tensor, rows: torch.Tensor,
                      valid: torch.Tensor, clamp_hw: Optional[tuple]):
        """All detections through the gather pipeline. The first window
        uses an optimistic bucket (2 people per frame) and returns the total
        count; follow-up windows cover the rest. Heatmaps come back to the
        host only when ``return_heatmaps`` asks for them (else None)."""
        n_frames = frames_rgb.shape[0]
        bucket0 = _buckets(2 * n_frames, self.max_batch_size)
        total_d, counts_d, hm, pboxes, pts = self._gather_crop(
            bucket0, frames_rgb, rows, valid, 0, clamp_hw)
        total = int(total_d)  # first host sync: the first pose batch is done
        counts = counts_d.cpu().numpy()
        take = min(bucket0, total)
        hm_l, box_l, pts_l = [hm[:take]], [pboxes[:take]], [pts[:take]]
        start = take
        while start < total:
            b = _buckets(total - start, self.max_batch_size)
            _, _, hm, pboxes, pts = self._gather_crop(
                b, frames_rgb, rows, valid, start, clamp_hw)
            take = min(b, total - start)
            hm_l.append(hm[:take])
            box_l.append(pboxes[:take])
            pts_l.append(pts[:take])
            start += take
        hm_all = torch.cat(hm_l).cpu().numpy() if self.return_heatmaps \
            else None
        return (counts, hm_all, torch.cat(box_l).cpu().numpy(),
                torch.cat(pts_l).cpu().numpy())

    def _upload(self, frames_bgr: np.ndarray) -> torch.Tensor:
        """One upload of the uint8 frames; BGR -> RGB on the device."""
        frames = torch.from_numpy(np.ascontiguousarray(frames_bgr))
        return frames.to(self.device).flip(-1)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def predict(self, image: np.ndarray):
        """Estimate poses on one HWC BGR frame or an NHWC stack.

        Returns (people, nof_joints, 3) float32 of (y, x, conf) per frame —
        a single array for one frame, a list for a stack — optionally
        preceded by heatmaps and/or bounding boxes (reference
        SimpleHRNet.py:188-203).
        """
        if image.ndim == 3:
            return self._predict_single(image)
        if image.ndim == 4:
            return self._predict_batch(image)
        raise ValueError('Wrong image format.')

    def _assemble(self, heatmaps, boxes, pts):
        res = []
        if self.return_heatmaps:
            res.append(heatmaps)
        if self.return_bounding_boxes:
            res.append(boxes)
        res.append(pts)
        return res if len(res) > 1 else res[0]

    def _predict_single(self, image: np.ndarray):
        hm_h, hm_w = self.resolution[0] // 4, self.resolution[1] // 4
        frames = self._upload(image[None])
        rows, valid = self.detector.detect_padded(frames)
        counts, hm_all, boxes_all, pts_all = self._run_gathered(
            frames, rows, valid, clamp_hw=None)
        if int(counts[0]) == 0:
            empty_hm = np.zeros((0, self.nof_joints, hm_h, hm_w), np.float32)
            return self._assemble(empty_hm, np.empty((0, 4), np.int32),
                                  np.empty((0, 0, 3), np.float32))
        heatmaps = None if hm_all is None else \
            np.transpose(hm_all, (0, 3, 1, 2))
        return self._assemble(heatmaps, boxes_all.astype(np.int32),
                              pts_all.astype(np.float32))

    def _predict_batch(self, images: np.ndarray):
        n_img = images.shape[0]
        frames = self._upload(images)
        rows, valid = self.detector.detect_padded(frames)
        # the reference's batch path clamps the grown boxes to the frame
        # (SimpleHRNet.py:393-410)
        counts, hm_all, boxes_all, pts_all = self._run_gathered(
            frames, rows, valid,
            clamp_hw=(int(images.shape[1]), int(images.shape[2])))
        heatmaps_b, boxes_b, pts_b = [], [], []
        index = 0
        for i in range(n_img):
            n = int(counts[i])
            pts_b.append(pts_all[index:index + n])
            if hm_all is not None:
                heatmaps_b.append(
                    np.transpose(hm_all[index:index + n], (0, 3, 1, 2)))
            boxes_b.append(boxes_all[index:index + n].astype(np.int32))
            index += n
        res = []
        if self.return_heatmaps:
            res.append(heatmaps_b)
        if self.return_bounding_boxes:
            res.append(boxes_b)
        res.append(pts_b)
        return res if len(res) > 1 else res[0]
