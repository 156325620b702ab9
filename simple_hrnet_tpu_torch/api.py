"""SimpleHRNet — the pose inference facade, in PyTorch on CUDA.

Counterpart of ``simple_hrnet_tpu/api.py``: ``model_name`` 'HRNet' or
'PoseResNet' (ResNet-18/34/50/101/152, ``c`` the ResNet size),
``multiperson`` True (a detector: ``yolo_version`` 'v3', YOLOv3 /
YOLOv3-tiny, or 'v5', YOLOv5 n/s/m/l/x) or False (whole-frame single
person, no detector), and ``dtype`` None (f32), 'bfloat16' or 'int8'
(post-training quantization of the pose model and of YOLOv3, with
``calibration_images`` and ``int8_exclude``; YOLOv5 stays bf16, the JAX
package's policy). ``predict(image)`` keeps the reference's contract (one
HWC BGR frame or an NHWC stack; (people, joints, 3) arrays of (y, x,
conf), optionally preceded by heatmaps and bounding boxes).

Pipeline, all on the device: each frame is uploaded once as uint8 and
flipped BGR -> RGB there. Multi-person: the detector finds people (NMS
kernel K1); the valid (frame, box) pairs are compacted frame-major by a
stable argsort; a power-of-two bucket of them is aspect-padded, PIL-exact
cropped, normalized, posed and argmax-decoded. The first host read is the
people count, after the first pose batch. Single-person: the whole frame
is resized to the model resolution by ``interpolation`` (cv2 bicubic,
cv2 bilinear or PIL's antialiased bilinear, as f32 matmuls), rounded,
normalized, posed and decoded against the whole-frame box. HRNet runs a
branch-0 chain kernel (K2, the Winograd chain B3 or the int8 chain B4)
and K3 in every stage module, unless ``use_fused_kernels=False`` asks for
the plain graph; PoseResNet runs cuDNN convs and transposed convs, as the
JAX package runs it in XLA. f32 work runs in true f32 (TF32 off) inside
each call, and PyTorch's TF32 flags are put back as found
(``utils/device.true_f32``).

``predict_stream`` (fixed-slot, chunked, adaptive and compact modes) and
``warmup`` are the JAX facade's video entry points. A stream launch copies
its frames to the card from pinned memory without a stream
synchronization and calls a runner — a closure cached under the key the
JAX facade gives its jitted graph — that queues its kernels and reads
nothing back, so launches queue up while the host decodes earlier results
(``prefetch``).

``enable_tensorrt=True`` (or a ``.torchpose`` checkpoint path) serves the
pose model from an engine of ``utils/export.py`` instead (the JAX
facade's ``.jaxpose`` branch): it replaces the pose model in every runner,
each batch padded to the engine batch and chunked.

``mesh`` (``parallel/mesh.py``) serves from one process over the mesh's
devices, the reference's ``DataParallel`` (SimpleHRNet.py:123-135) and
the JAX facade's sharding over ``'data'``: one pose model (or one loaded
engine) and, for the stream runners, one detector on each device, shared
where a device repeats. A crop batch is cut along dim 0 into one part a
device, each part cropped, posed and decoded there without a host sync,
and the outputs are gathered on the facade's device (the mesh's first);
the pose buckets are multiples of the mesh's size (JAX ``_buckets``). The
fused-frame runners shard whole frames (detect, crops, pose, decode) when
their frame count divides by the size, and run on the facade's device
otherwise (the one-frame view behind ``_fused_frame``). HRNet's kernels
stay on under a mesh: the JAX facade turns its fused kernels off there
because its batch packing would concatenate across the sharded axis, and
the port does not pack.
"""

from __future__ import annotations

import collections
import copy
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from simple_hrnet_tpu_torch.detectors.yolov3 import YOLOv3
from simple_hrnet_tpu_torch.detectors.yolov5 import YOLOv5
from simple_hrnet_tpu_torch.models import hrnet, poseresnet
from simple_hrnet_tpu_torch.models import layers as L
from simple_hrnet_tpu_torch.models import quantize as Q
from simple_hrnet_tpu_torch.models.convert import load_into
from simple_hrnet_tpu_torch.ops import decode as D
from simple_hrnet_tpu_torch.ops import image as I
from simple_hrnet_tpu_torch.parallel.mesh import (module_to, move_attrs,
                                                  replicate)
from simple_hrnet_tpu_torch.utils import checkpoint as ckpt
from simple_hrnet_tpu_torch.utils.device import (host_to_device,
                                                 resolve_device, true_f32)


HRNET_NAMES = ('HRNet', 'hrnet')
POSERESNET_NAMES = ('PoseResNet', 'poseresnet', 'ResNet', 'resnet')


def _buckets(n: int, max_batch: int, multiple: int = 1) -> int:
    """Next power-of-two bucket of ``n``, capped at ``max_batch``;
    ``multiple`` (the mesh's size) keeps it divisible: the start is
    ``multiple`` and the cap is rounded down to a multiple of it (JAX
    ``_buckets``)."""
    b = max(1, multiple)
    cap = max(multiple, (max_batch // multiple) * multiple) \
        if multiple > 1 else max(max_batch, 1)
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


def _chunks(frames, batch_frames: int):
    """``frames`` as launches of ``batch_frames`` frames of one shape:
    yields (stacked frames, count of real frames). A change of frame shape
    flushes the chunk, and a short chunk is padded with its last frame."""
    buf = []
    for frame in frames:
        f = np.ascontiguousarray(frame)
        if buf and f.shape != buf[0].shape:
            yield np.stack(buf + [buf[-1]] * (batch_frames - len(buf))), \
                len(buf)
            buf = []
        buf.append(f)
        if len(buf) >= batch_frames:
            yield np.stack(buf), len(buf)
            buf = []
    if buf:
        yield np.stack(buf + [buf[-1]] * (batch_frames - len(buf))), len(buf)


def _slot_ladder(cap: int):
    """Empty rung + power-of-two people-slot rungs up to ``cap`` (always
    included): cap=16 -> [0, 2, 4, 8, 16]. The adaptive stream walks this
    ladder so the pose batch tracks the scene's person count instead of
    the worst case. Rung 0 is the idle-camera tier: a detect-only launch
    (no pose batch at all) that escalates on the first detection."""
    ladder = [0]
    s = 2
    while s < cap:
        ladder.append(s)
        s *= 2
    ladder.append(cap)
    return ladder


class _SlotController:
    """Hysteresis controller for adaptive people-slot sizing.

    Escalation is handled by the caller (it must re-run the saturated
    launch); this object tracks the current rung and steps DOWN only after
    a full window of observed per-launch people counts fits strictly
    below the next rung down (strictly: landing exactly at a rung's
    capacity would immediately saturate it and re-escalate — thrash)."""

    def __init__(self, cap: int, window: int):
        self.ladder = _slot_ladder(cap)
        # start at the smallest POSE rung, not the empty rung: most streams
        # open on a populated scene, and a rung-0 first frame with people
        # would always pay a double launch. Rung 0 is reached by descent
        # after a full window of empty frames.
        self.idx = min(1, len(self.ladder) - 1)
        self.cap = cap
        self.counts = collections.deque(maxlen=max(1, window))

    @property
    def slots(self) -> int:
        return self.ladder[self.idx]

    def escalate(self, saturated_slots: int) -> int:
        """Move to the first rung ABOVE a saturated launch's slot count (a
        saturated count means the slot truncation may have dropped real
        people)."""
        while self.ladder[self.idx] <= saturated_slots:
            self.idx += 1
        self.counts.clear()
        return self.ladder[self.idx]

    def observe(self, n: int) -> None:
        self.counts.append(n)
        # descend when the window fits strictly below the next rung down;
        # the rung-0 threshold is 1 (descend only after an ALL-EMPTY
        # window — any detection at rung 0 forces an escalation re-run)
        if (self.idx > 0 and len(self.counts) == self.counts.maxlen
                and max(self.counts) < max(1, self.ladder[self.idx - 1])):
            self.idx -= 1
            self.counts.clear()


@true_f32()
def _pose_tail(model, crops: torch.Tensor, padded_boxes: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crops (or whole frames) rounded and clipped to uint8 values ->
    ImageNet normalize -> pose model -> argmax decode into the boxes' frame
    coordinates (SimpleHRNet.py:279-296), in true f32. The round is the
    identity on frames that were not resized."""
    x = I.normalize(torch.clamp(torch.round(crops), 0.0, 255.0))
    hm = model(x)
    return hm, D.argmax_decode(hm, padded_boxes)


class SimpleHRNet:
    """2D pose estimation, multi-person or whole-frame single-person, on an
    NVIDIA GPU.

    Args mirror the JAX facade. ``model_name``: 'HRNet' (``c`` the width)
    or 'PoseResNet' ('poseresnet', 'ResNet', 'resnet'; ``c`` the ResNet
    size); ``yolo_version``: 'v3' (``yolo_model_def`` 'yolov3' or
    'yolov3-tiny', ``yolo_weights_path``) or 'v5' (``yolo_model_def`` an
    ultralytics ``.pt`` or a variant name; anything else is a random
    yolov5m, as in the JAX facade); with ``multiperson=False`` no detector
    is built (``self.detector`` is None) and the yolo arguments are not
    looked at, as in the JAX facade. ``device``: 'cuda' (default; raises
    without a card) or 'cpu'. ``dtype``: None (f32), 'bfloat16' (pose and
    detector convs in bf16, heatmap head f32) or 'int8': TensorRT-style
    post-training quantization (``models/quantize.py``) of the pose model
    and of YOLOv3 (not of YOLOv3-tiny or YOLOv5, as in the JAX package),
    bf16 elsewhere — the precision mix of the JAX facade's
    ``use_fused_kernels=False`` int8 graph, with HRNet's branch-0 chains
    on the int8 chain kernel. ``calibration_images`` (HWC RGB frames)
    calibrate the activation scales instead of smooth synthetic frames;
    ``int8_exclude`` (dotted path prefixes such as ('stage4',)) keeps
    those convs bf16. Both raise ``ValueError`` without int8. ``mesh``
    serves over the mesh's devices (module docstring); ``device``, when
    given, must be its first. HRNet's
    branch-0 chain and high-res fusion run through the CUDA kernels on the
    card; ``use_fused_kernels=False`` runs HRNet's plain graph instead (the
    JAX facade's, api.py:310-314: every stage module as plain blocks and
    fusion; under int8 the branch-0 convs are ``QConv2d`` modules and no
    chain kernel runs). ``interpolation`` ('cubic'/None/2, 'linear'/
    'bilinear'/1 or 'bilinear_aa') is the single-person whole-frame
    resize; multi-person crops always use the PIL-exact resampler, as in
    the JAX facade. ``enable_tensorrt=True`` or a ``.torchpose``
    ``checkpoint_path`` serves the pose model from that engine
    (``utils/export.Engine`` on ``device``, exported by ``python -m
    simple_hrnet_tpu_torch.cli.export``): its resolution must equal
    ``resolution``, ``dtype`` then sets the detector's type only,
    ``use_fused_kernels`` is not looked at, and ``int8_exclude`` or a JAX
    ``.jaxpose`` engine raise ``ValueError``.
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
        if model_name not in HRNET_NAMES + POSERESNET_NAMES:
            raise ValueError('Wrong model name.')
        # the JAX facade looks at yolo_version only with a detector
        if multiperson and yolo_version not in ('v3', 'v5'):
            raise ValueError('Unsupported YOLO version.')
        if mesh is not None:
            if mesh.process_count > 1:
                raise ValueError(
                    'SimpleHRNet(mesh=...) drives the mesh from one process; '
                    'this mesh spans several processes (a training mesh)')
            if device is not None and \
                    resolve_device(device) != mesh.devices[0]:
                raise ValueError(f'device {device!r} is not the mesh\'s '
                                 f'first device {mesh.devices[0]}')
            device = mesh.devices[0]
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
        self.mesh = mesh
        # pose buckets divisible by the mesh (JAX api.py:548, 853-856)
        self._mult = mesh.size if mesh is not None else 1
        self.quantize_int8 = dtype == 'int8'
        self.dtype = torch.bfloat16 if dtype in ('bfloat16', 'bf16', 'int8') \
            else torch.float32

        self.engine = None
        if enable_tensorrt or checkpoint_path.endswith(('.jaxpose',
                                                        '.torchpose')):
            # the engine path (the JAX facade's api.py:215-251, without
            # mesh): the exported pose model, batches padded to its batch
            if self.int8_exclude:
                raise ValueError(
                    'int8_exclude has no effect on a prebuilt .torchpose '
                    'engine (its precision mix was baked at export time; '
                    'pass --int8_exclude to python -m '
                    'simple_hrnet_tpu_torch.cli.export instead)')
            from simple_hrnet_tpu_torch.utils.export import Engine
            self.engine = Engine(checkpoint_path, device=self.device)
            if self.engine.resolution != self.resolution:
                raise ValueError(
                    f'engine resolution {self.engine.resolution} != '
                    f'requested {self.resolution}')
            self.model = self.engine.apply
        else:
            self.model = self._build_model(use_fused_kernels)
        # one pose model a mesh device (a repeated device shares it)
        self._models = [self.model]
        if mesh is not None:
            self._models = ([self._engine_on(d).apply for d in mesh.devices]
                            if self.engine is not None
                            else replicate(self.model, mesh))
        self._detectors: Dict[tuple, object] = {}

        det_dtype = 'int8' if self.quantize_int8 else \
            None if self.dtype == torch.float32 else 'bfloat16'
        self.detector = None
        if multiperson and yolo_version == 'v3':
            self.detector = YOLOv3(model_def=yolo_model_def,
                                   class_path=yolo_class_path,
                                   weights_path=yolo_weights_path,
                                   max_batch_size=max_batch_size,
                                   max_detections=yolo_max_detections,
                                   device=self.device, dtype=det_dtype)
        elif multiperson:
            self.detector = YOLOv5(model_def=yolo_model_def,
                                   max_batch_size=max_batch_size,
                                   max_detections=yolo_max_detections,
                                   device=self.device, dtype=det_dtype)
        # runner caches, keyed as the JAX facade keys its jit caches
        self._single_runs: Dict[tuple, Callable] = {}
        self._gather_runs: Dict[tuple, Callable] = {}
        self._fused_runs: Dict[tuple, Callable] = {}

    def _build_model(self, use_fused_kernels: bool) -> nn.Module:
        """The pose model from ``checkpoint_path``: folded, quantized
        under int8, and with HRNet's kernels unless ``use_fused_kernels``
        is False."""
        if self.model_name in HRNET_NAMES:
            net = hrnet.HRNet(self.c, self.nof_joints)

            def prepare(model, dtype, amax):
                return hrnet.prepare_inference(model, dtype, amax=amax,
                                               kernels=use_fused_kernels)
        else:
            net = poseresnet.PoseResNet(self.c, self.nof_joints)
            prepare = poseresnet.prepare_inference
        model = load_into(net, ckpt.load(self.checkpoint_path)).to(
            self.device)
        amax = None
        if self.quantize_int8:
            # calibrate the folded f32 model with its plain modules, before
            # prepare_inference packs HRNet's chains (api.py:264-277 of the
            # JAX package calibrates the plain apply graph too)
            L.fold_batch_norm(model.eval())
            amax = self._calibrate_int8(model)
            if self.int8_exclude:
                amax = Q.filter_amax(model, amax, self.int8_exclude)
        return prepare(model, self.dtype, amax=amax)

    def _engine_on(self, dev: torch.device):
        """The engine on mesh device ``dev``: the facade's own on its device,
        else the same file loaded there (weights and constants moved)."""
        if dev == self.device:
            return self.engine
        from simple_hrnet_tpu_torch.utils.export import Engine
        eng = Engine(self.checkpoint_path, device=dev)
        eng.module.to(dev)
        move_attrs(eng.module, dev)
        return eng

    def _detectors_on_mesh(self) -> list:
        """``self.detector`` on each mesh device, copied (its network and
        tensors moved) to a device other than the facade's; cached per
        detector object."""
        out = []
        for d in self.mesh.devices:
            key = (id(self.detector), d)
            if key not in self._detectors:
                if d == self.device:
                    det = self.detector
                else:
                    det = copy.copy(self.detector)
                    for k, v in vars(det).items():
                        if isinstance(v, nn.Module):
                            setattr(det, k, module_to(v, d))
                        elif isinstance(v, torch.Tensor):
                            setattr(det, k, v.to(d))
                    det.device = d
                self._detectors[key] = det
            out.append(self._detectors[key])
        return out

    def _sharded(self, n: int) -> bool:
        """Whether a batch of ``n`` rows runs split over the mesh."""
        return self.mesh is not None and self.mesh.local_size > 1 \
            and n % self.mesh.local_size == 0

    def _on_mesh(self, fn: Callable, shard_args, repl_args=()):
        """``fn(i, *shards, *replicated)`` on each mesh device i: the
        ``shard_args`` cut along dim 0 into one equal part a device and
        the ``repl_args`` copied to it, all ``non_blocking`` (no host
        sync); each output tensor's parts are concatenated on the facade's
        device, in device order."""
        devs = self.mesh.devices
        k = shard_args[0].shape[0] // len(devs)
        copies: Dict[torch.device, list] = {}
        outs = []
        for i, d in enumerate(devs):
            if d not in copies:
                copies[d] = [a.to(d, non_blocking=True) for a in repl_args]
            parts = [a[i * k:(i + 1) * k].to(d, non_blocking=True)
                     for a in shard_args]
            outs.append(fn(i, *parts, *copies[d]))
        return tuple(torch.cat([o[j].to(self.device, non_blocking=True)
                                for o in outs])
                     for j in range(len(outs[0])))

    @torch.no_grad()
    def _calibrate_int8(self, model: nn.Module):
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
    # device pipeline: runners
    # ------------------------------------------------------------------
    #
    # A runner is one launch of device work: it takes tensors already on
    # the device, queues kernels and returns tensors on the device, with no
    # host read and no stream synchronization inside. Runners are cached
    # under the JAX facade's jit-cache keys (its api.py:414-416), so
    # ``warmup`` reports the same counts. The pose model runs under
    # ``true_f32`` in ``_pose_tail``; the detector's ``detect_padded`` and
    # the resizers enter it themselves.

    def _single(self, in_hw: Tuple[int, int], batch: int) -> Callable:
        """The whole-frame runner of ``multiperson=False`` (JAX
        ``_get_single``) for ``batch`` frames of ``in_hw``:
        ``run(frames_rgb)`` takes (batch, H, W, 3) RGB uint8 frames on the
        device, resizes them to the model resolution by ``interpolation``
        (when their size differs), rounds and clips to [0, 255] as the
        reference's uint8 resize does, normalizes, poses and decodes
        against the whole-frame box [0, 0, W, H]; it returns the heatmaps
        (batch, h, w, J) and keypoints (batch, J, 3)."""
        in_hw = (int(in_hw[0]), int(in_hw[1]))
        key = (in_hw, batch)
        if key in self._single_runs:
            return self._single_runs[key]
        res_hw = self.resolution
        model = self.model
        resize = None
        if res_hw != in_hw:
            resize = (I.resize_bilinear_aa
                      if self.interpolation == 'bilinear_aa' else
                      I.resize_linear
                      if self.interpolation in ('linear', 'bilinear', 1)
                      else I.resize_cubic)
        boxes = host_to_device(np.tile(np.asarray(
            [0.0, 0.0, in_hw[1], in_hw[0]], np.float32), (batch, 1)),
            self.device)
        models = self._models

        def tail(i, frames, bxs):
            x = frames.float()
            if resize is not None:
                x = resize(x, res_hw)
            return _pose_tail(models[i], x, bxs)

        @torch.no_grad()
        def run(frames_rgb: torch.Tensor):
            if self._sharded(batch):
                return self._on_mesh(tail, (frames_rgb, boxes))
            return tail(0, frames_rgb, boxes)

        self._single_runs[key] = run
        return run

    def _gather_crop(self, bucket: int, clamp_hw: Optional[tuple] = None
                     ) -> Callable:
        """The compaction runner of one ``bucket`` (JAX
        ``_get_gather_crop``): ``run(frames_rgb, rows, valid, start)`` orders
        the valid (frame, box) pairs frame-major (stable argsort) and crops,
        poses and decodes ``bucket`` of them from ``start``; it returns the
        total count, the per-frame counts, heatmaps, padded boxes and
        keypoints. Slots past the total are computed and dropped by the
        caller."""
        key = ('gather', bucket, clamp_hw)
        if key in self._gather_runs:
            return self._gather_runs[key]
        res_h, res_w = self.resolution
        models = self._models

        def tail(i, fi, padded, boxes, frames_rgb):
            crops = I.crop_resize_pil(
                frames_rgb, fi, padded, (res_h, res_w),
                valid_boxes=None if clamp_hw is not None else boxes)
            return _pose_tail(models[i], crops, padded)

        @torch.no_grad()
        def run(frames_rgb: torch.Tensor, rows: torch.Tensor,
                valid: torch.Tensor, start: int):
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
            if self._sharded(bucket):
                hm, pts = self._on_mesh(tail, (fi, padded, boxes),
                                        (frames_rgb,))
            else:
                hm, pts = tail(0, fi, padded, boxes, frames_rgb)
            return total, counts, hm, padded, pts

        self._gather_runs[key] = run
        return run

    def _check_people_cap(self, max_people: int) -> None:
        det_cap = getattr(self.detector, 'max_detections', max_people)
        if max_people > det_cap:
            raise ValueError(
                f"max_people={max_people} exceeds the detector's "
                f'max_detections={det_cap} — the detector can never fill '
                f'those slots; construct SimpleHRNet('
                f'yolo_max_detections={max_people}) or lower max_people')

    def _fused_frame(self, in_hw: Tuple[int, int], max_people: int
                     ) -> Callable:
        """One frame's fused runner (JAX ``_get_fused_frame``): the
        ``n_frames=1`` view of ``_fused_frames``, taking one (H, W, 3) RGB
        frame and returning that frame's rows."""
        key = (in_hw, max_people)
        if key in self._fused_runs:
            return self._fused_runs[key]
        self._fused_frames(in_hw, max_people, 1)  # built (and checked) now

        def run(frame_rgb: torch.Tensor):
            valid, boxes, hm, pts = self._fused_frames(
                in_hw, max_people, 1)(frame_rgb[None])
            return valid[0], boxes[0], hm[0], pts[0]

        self._fused_runs[key] = run
        return run

    def _fused_frames(self, in_hw: Tuple[int, int], max_people: int,
                      n_frames: int) -> Callable:
        """The fixed-slot runner of ``n_frames`` frames (JAX
        ``_get_fused_frames``): detect, then ``max_people`` static crop
        slots a frame (the detector's score-ordered rows, masked by
        validity; boxes aspect-padded without clamping, PIL-exact crops of
        the real pixels), pose and decode, in one dispatch.
        ``run(frames_rgb)`` takes (F, H, W, 3) RGB frames on the device and
        returns (valid, padded boxes, heatmaps, keypoints) shaped
        (F, max_people, ...)."""
        key = (in_hw, max_people, n_frames)
        if key in self._fused_runs:
            return self._fused_runs[key]
        self._check_people_cap(max_people)
        sharded = self._sharded(n_frames)
        detectors = self._detectors_on_mesh() if sharded \
            else [self.detector]
        models = self._models
        res_h, res_w = self.resolution

        def frames_run(i, frames_rgb):
            nf = frames_rgb.shape[0]
            shp = (nf, max_people)
            rows, valid = detectors[i].detect_padded(frames_rgb)
            rows = rows[:, :max_people]
            valid = valid[:, :max_people]
            boxes = torch.round(rows[..., :4]).reshape(-1, 4)
            padded = I.pad_to_aspect(boxes, res_h / res_w)
            fi = torch.arange(nf * max_people,
                              device=frames_rgb.device) // max_people
            crops = I.crop_resize_pil(frames_rgb, fi, padded, (res_h, res_w),
                                      valid_boxes=boxes)
            hm, pts = _pose_tail(models[i], crops, padded)
            return (valid, padded.reshape(*shp, 4),
                    hm.reshape(*shp, *hm.shape[1:]),
                    pts.reshape(*shp, *pts.shape[1:]))

        @torch.no_grad()
        def run(frames_rgb: torch.Tensor):
            if sharded:
                return self._on_mesh(frames_run, (frames_rgb,))
            return frames_run(0, frames_rgb)

        self._fused_runs[key] = run
        return run

    def _detect_rows(self, in_hw: Tuple[int, int], n_frames: int,
                     max_people: int) -> Callable:
        """Detect-only runner of the compact stream (JAX
        ``_get_detect_rows``): the score-ordered rows, validity and
        per-frame counts, truncated to ``max_people`` a frame exactly as
        ``_fused_frames`` truncates them, so the compaction finds the
        people the fixed-slot stream would."""
        key = ('rows', in_hw, n_frames, max_people)
        if key in self._fused_runs:
            return self._fused_runs[key]
        self._check_people_cap(max_people)
        sharded = self._sharded(n_frames)
        detectors = self._detectors_on_mesh() if sharded \
            else [self.detector]

        def rows_run(i, frames_rgb):
            rows, valid = detectors[i].detect_padded(frames_rgb)
            rows = rows[:, :max_people]
            valid = valid[:, :max_people]
            return rows, valid, valid.sum(dim=1)

        @torch.no_grad()
        def run(frames_rgb: torch.Tensor):
            if sharded:
                return self._on_mesh(rows_run, (frames_rgb,))
            return rows_run(0, frames_rgb)

        self._fused_runs[key] = run
        return run

    def _detect_counts(self, in_hw: Tuple[int, int], n_frames: int
                       ) -> Callable:
        """Rung 0 of the adaptive ladder (JAX ``_get_detect_counts``): a
        detect-only runner returning the per-frame count of EVERY valid
        detector row — no crop slots, no pose batch. Cached under slot
        key 0, as in the JAX facade."""
        key = (in_hw, 0, n_frames)
        if key in self._fused_runs:
            return self._fused_runs[key]
        sharded = self._sharded(n_frames)
        detectors = self._detectors_on_mesh() if sharded \
            else [self.detector]

        def counts_run(i, frames_rgb):
            return (detectors[i].detect_padded(frames_rgb)[1].sum(dim=1),)

        @torch.no_grad()
        def run(frames_rgb: torch.Tensor):
            if sharded:
                return self._on_mesh(counts_run, (frames_rgb,))[0]
            return counts_run(0, frames_rgb)[0]

        self._fused_runs[key] = run
        return run

    def _run_gathered(self, frames_rgb: torch.Tensor, rows: torch.Tensor,
                      valid: torch.Tensor, clamp_hw: Optional[tuple]):
        """All detections through the gather pipeline. The first window
        uses an optimistic bucket (2 people per frame) and returns the total
        count; follow-up windows cover the rest (``_gathered``)."""
        bucket0 = _buckets(2 * frames_rgb.shape[0], self.max_batch_size,
                           self._mult)
        first = self._gather_crop(bucket0, clamp_hw)(frames_rgb, rows, valid,
                                                     0)
        total = int(first[0])  # first host sync: the first pose batch is done
        return (first[1].cpu().numpy(),) + self._gathered(
            frames_rgb, rows, valid, clamp_hw, total, (bucket0, first))

    def _gathered(self, frames_rgb: torch.Tensor, rows: torch.Tensor,
                  valid: torch.Tensor, clamp_hw: Optional[tuple], total: int,
                  first: Optional[tuple] = None):
        """Heatmaps, boxes and keypoints of the first ``total`` compacted
        people on the host (see ``_host``): the slots of the launch
        ``first`` — (its bucket, its outputs), or None — then exact
        follow-up launches of ``_gather_crop`` for the rest."""
        parts, start = [], 0
        if first is not None:
            start = min(first[0], total)
            parts.append((first[1], start))
        while start < total:
            b = _buckets(total - start, self.max_batch_size, self._mult)
            out = self._gather_crop(b, clamp_hw)(frames_rgb, rows, valid,
                                                 start)
            parts.append((out, min(b, total - start)))
            start += parts[-1][1]
        _, boxes, hm, pts = self._host(
            None, *([out[i][:take] for out, take in parts] for i in (3, 2, 4)))
        return hm, boxes, pts

    def _upload(self, frames_bgr: np.ndarray) -> torch.Tensor:
        """One upload of uint8 BGR frames (any leading shape), from pinned
        memory with no stream synchronization; BGR -> RGB on the device."""
        return host_to_device(frames_bgr, self.device).flip(-1)

    # ------------------------------------------------------------------
    # per-frame results
    # ------------------------------------------------------------------

    def _host(self, valid, boxes, hm, pts):
        """Device outputs on the host, one copy each (a list of tensors is
        concatenated first; ``valid`` may be None); heatmaps only when
        ``return_heatmaps`` asks for them (else None)."""
        def get(t):
            if t is None:
                return None
            return (torch.cat(t) if isinstance(t, list) else t).cpu().numpy()
        return (get(valid), get(boxes),
                get(hm) if self.return_heatmaps else None, get(pts))

    def _finish_empty(self):
        """The per-frame result of a frame with zero people — what
        ``_finish_fused`` gives when no slot is valid, built on the host so
        rung-0 (detect-only) launches need no pose outputs."""
        res = []
        if self.return_heatmaps:
            res.append(np.zeros((0, self.nof_joints, self.resolution[0] // 4,
                                 self.resolution[1] // 4), np.float32))
        if self.return_bounding_boxes:
            res.append(np.zeros((0, 4), np.int32))
        res.append(np.zeros((0, self.nof_joints, 3), np.float32))
        return res if len(res) > 1 else res[0]

    def _finish_fused(self, entry):
        """One frame's fixed-slot outputs (host arrays from ``_host``) as
        the per-frame ``predict`` result: the valid slots come first."""
        valid, boxes, hm, pts = entry
        n = int(valid.sum())
        return self._finish_slice(None if hm is None else hm[:n], boxes[:n],
                                  pts[:n])

    def _finish_rows(self, host, n_real: int):
        """The first ``n_real`` frames of a chunk's host outputs (see
        ``_host``), each as ``_finish_fused`` gives it."""
        valid, boxes, hm, pts = host
        return [self._finish_fused((valid[i], boxes[i],
                                    None if hm is None else hm[i], pts[i]))
                for i in range(n_real)]

    def _finish_slice(self, hm, boxes, pts):
        """Per-frame result from compacted-order slices (the cross-frame
        analogue of ``_finish_fused``)."""
        res = []
        if self.return_heatmaps:
            res.append(np.transpose(hm, (0, 3, 1, 2)))
        if self.return_bounding_boxes:
            res.append(boxes.astype(np.int32))
        res.append(pts.astype(np.float32))
        return res if len(res) > 1 else res[0]

    # ------------------------------------------------------------------
    # stream engines
    # ------------------------------------------------------------------

    def _check_mesh_frames(self, batch_frames: int) -> None:
        """Under a mesh a chunk's frames must shard evenly (JAX api.py:
        882-885, 937-941, 1080-1083)."""
        if self.mesh is not None and batch_frames % self.mesh.size:
            raise ValueError(
                f'batch_frames={batch_frames} must divide the mesh '
                f'({self.mesh.size} devices) so frames shard evenly')

    def _pipeline(self, frames, batch_frames: int, prefetch: int,
                  dispatch: Callable, resolve: Callable):
        """The dispatch-ahead loop of every stream mode. Each chunk of
        ``_chunks(frames, batch_frames)`` is uploaded and handed to
        ``dispatch(frames_rgb, n_real)``, which launches it and returns an
        entry; at most ``prefetch`` entries wait, and ``resolve(entry)``
        returns the launch's per-frame results, yielded in order."""
        pending = collections.deque()
        for stack, n_real in _chunks(frames, batch_frames):
            pending.append(dispatch(self._upload(stack), n_real))
            while len(pending) > prefetch:
                yield from resolve(pending.popleft())
        while pending:
            yield from resolve(pending.popleft())

    def predict_stream(self, frames, max_people: int = 16,
                       prefetch: int = 2, batch_frames: int = 1,
                       adaptive_slots: bool = False, slot_window: int = 16,
                       compact_crops: bool = False):
        """Pipelined video inference: yields each frame's ``predict``
        result (keypoints, preceded by heatmaps and boxes when asked for),
        in order, for at most ``max_people`` people a frame.

        Launches are dispatched ``prefetch`` ahead of result consumption;
        a dispatch (upload + runner) makes no host synchronization, so the
        card computes frames i+1..i+prefetch while the host reads frame i.

        ``batch_frames > 1`` runs ``batch_frames`` frames a launch
        (``_fused_frames``): a pose batch of batch_frames * max_people
        crops, at the cost of batching latency. A trailing partial chunk is
        padded with its last frame, a change of frame shape flushes the
        chunk, and only real frames are yielded.

        ``adaptive_slots=True`` treats ``max_people`` as a cap and runs
        each launch at the smallest rung of ``_slot_ladder(max_people)``
        that recent frames fit in: a saturated launch (every slot valid
        below the cap) is re-run a rung up, the rung steps down after
        ``slot_window`` launches fit strictly below it, and after a window
        of empty frames the stream runs the detector alone (rung 0) until
        the first detection. Results equal the fixed-slot stream's.

        ``compact_crops=True`` (needs ``batch_frames > 1``) sizes the pose
        batch to the window's total detected people: a detect-only launch,
        then the frame-major compaction of ``_gather_crop`` in power-of-two
        buckets, the first sized from the previous window's total, with an
        idle tier after an all-empty window. Results equal the fixed-slot
        stream's; combining it with ``adaptive_slots`` is an error.

        Without a detector (``multiperson=False``) each frame is one
        whole-frame launch (``_single``), dispatched ``prefetch`` ahead;
        ``max_people``, ``batch_frames`` and ``adaptive_slots`` are ignored
        and ``compact_crops=True`` raises ``ValueError``, as in the JAX
        facade.
        """
        if compact_crops:
            if self.detector is None or batch_frames <= 1:
                raise ValueError('compact_crops=True requires multiperson '
                                 'detection and batch_frames > 1')
            if adaptive_slots:
                raise ValueError('compact_crops already adapts the pose '
                                 'batch to the scene; drop adaptive_slots')
            yield from self._stream_compact(frames, max_people, prefetch,
                                            batch_frames)
            return
        if self.detector is None:
            yield from self._stream_single(frames, prefetch)
            return
        if adaptive_slots:
            yield from self._stream_adaptive(frames, max_people, prefetch,
                                             batch_frames, slot_window)
            return

        if batch_frames <= 1:
            def dispatch(frames_rgb, _n_real):
                return self._fused_frame(frames_rgb.shape[1:3],
                                         max_people)(frames_rgb[0])

            def resolve(out):
                return [self._finish_fused(self._host(*out))]
        else:
            self._check_mesh_frames(batch_frames)

            def dispatch(frames_rgb, n_real):
                return self._fused_frames(frames_rgb.shape[1:3], max_people,
                                          batch_frames)(frames_rgb), n_real

            def resolve(entry):
                out, n_real = entry
                return self._finish_rows(self._host(*out), n_real)

        yield from self._pipeline(frames, batch_frames, prefetch, dispatch,
                                  resolve)

    def _stream_single(self, frames, prefetch: int):
        """predict_stream without a detector (JAX ``predict_stream``'s
        single-person branch): one ``_single`` launch a frame, dispatched
        ``prefetch`` ahead; each result is ``predict(frame)``'s."""
        def dispatch(frames_rgb, _n_real):
            in_hw = tuple(frames_rgb.shape[1:3])
            return self._single(in_hw, 1)(frames_rgb), in_hw

        def resolve(entry):
            out, in_hw = entry
            _, _, hm, pts = self._host(None, None, *out)
            return [self._finish_single(hm, pts, in_hw)]

        yield from self._pipeline(frames, 1, prefetch, dispatch, resolve)

    def _stream_adaptive(self, frames, cap: int, prefetch: int,
                         batch_frames: int, slot_window: int):
        """predict_stream's adaptive-slot engine (see its docstring).

        Both the per-frame and the chunked mode keep the fixed-slot
        dispatch-ahead; the only synchronous extra work is re-running a
        SATURATED launch (all slots valid below the cap) at a bigger rung,
        which hysteresis makes rare. Escalation decisions are per launch
        (the max count over a chunk's frames) and loop until the launch is
        unsaturated or at the cap, so results equal the fixed-slot
        stream's. A re-run takes the frames already on the device."""
        per_frame = batch_frames <= 1
        if not per_frame:
            self._check_mesh_frames(batch_frames)
        ctl = _SlotController(cap, slot_window)

        def launch(frames_rgb, slots):
            in_hw = frames_rgb.shape[1:3]
            if slots == 0:
                return self._detect_counts(in_hw, len(frames_rgb))(frames_rgb)
            if per_frame:
                out = self._fused_frame(in_hw, slots)(frames_rgb[0])
                return tuple(t[None] for t in out)
            return self._fused_frames(in_hw, slots, batch_frames)(frames_rgb)

        def dispatch(frames_rgb, n_real):
            return launch(frames_rgb, ctl.slots), ctl.slots, frames_rgb, n_real

        def resolve(entry):
            out, slots, frames_rgb, n_real = entry
            if slots == 0:
                # detect-only rung: escalate straight to the first rung that
                # fits the TRUE count (the counts runner sees every detector
                # row, not a slot truncation), so one re-run lands where the
                # saturation cascade would
                m = int(out.max())
                if m == 0:
                    ctl.observe(0)
                    return [self._finish_empty() for _ in range(n_real)]
                slots = ctl.escalate(min(m, cap - 1))
                out = launch(frames_rgb, slots)
            host = self._host(*out)
            m = int(host[0].sum(axis=1).max())
            while m >= slots and slots < cap:
                slots = ctl.escalate(slots)
                host = self._host(*launch(frames_rgb, slots))
                m = int(host[0].sum(axis=1).max())
            ctl.observe(m)
            return self._finish_rows(host, n_real)

        yield from self._pipeline(frames, batch_frames, prefetch, dispatch,
                                  resolve)

    def _stream_compact(self, frames, max_people: int, prefetch: int,
                        batch_frames: int):
        """predict_stream's cross-frame crop-compaction engine.

        Each window runs two launches: ``_detect_rows`` (rows stay on the
        device, truncated to ``max_people`` like the fixed-slot runner),
        then ``_gather_crop``'s frame-major compaction with the pose batch
        sized to a power-of-two bucket of the window's detected people. The
        first pose launch is sized optimistically from the previous
        window's total, so the window's one host read comes after the pose
        launch; shortfalls run exact follow-up launches. A window after an
        all-empty window runs the detector alone (the idle tier) and sizes
        its wake-up pose launch exactly from the read counts. Padded
        duplicate frames sort after every real frame's people and are
        never consumed."""
        self._check_mesh_frames(batch_frames)
        # previous window's total people — sizes the next optimistic pose
        # launch; 0 = idle (detect-only until people reappear)
        prior = [2 * batch_frames]

        def dispatch(frames_rgb, n_real):
            rows, valid, counts_d = self._detect_rows(
                frames_rgb.shape[1:3], batch_frames, max_people)(frames_rgb)
            first = None
            if prior[0] > 0:
                bucket0 = _buckets(prior[0], self.max_batch_size, self._mult)
                first = (bucket0, self._gather_crop(bucket0)(
                    frames_rgb, rows, valid, 0))
            return frames_rgb, rows, valid, counts_d, first, n_real

        def resolve(entry):
            frames_rgb, rows, valid, counts_d, first, n_real = entry
            counts = counts_d.cpu().numpy()[:n_real]  # the window's host read
            needed = int(counts.sum())
            prior[0] = needed
            if first is None and needed == 0:
                return [self._finish_empty() for _ in range(n_real)]
            hm, boxes, pts = self._gathered(frames_rgb, rows, valid, None,
                                            needed, first)
            ends = np.cumsum(counts)
            return [self._finish_slice(None if hm is None else hm[e - n:e],
                                       boxes[e - n:e], pts[e - n:e])
                    for n, e in zip(counts, ends)]

        yield from self._pipeline(frames, batch_frames, prefetch, dispatch,
                                  resolve)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def warmup(self, frame_hw: Tuple[int, int], batch_sizes=(1,),
               stream_max_people=None, stream_batch_frames=(1,)) -> dict:
        """Make first requests cost execution time only, for one frame
        geometry (the JAX facade's ``warmup``, same arguments).

        Builds the CUDA kernels if they are not built yet, then runs each
        listed frame-batch size through ``predict`` on a zero frame and,
        with ``stream_max_people`` (an int, an iterable of ints,
        ``('adaptive', cap)`` for every rung the adaptive stream can visit,
        or ``('compact', cap)`` for the compact stream's detect-rows runner
        and every power-of-two people bucket up to a full window), every
        ``predict_stream`` runner once on zero frames, for each entry of
        ``stream_batch_frames``: cuDNN's algorithm choices and the caching
        allocators are warm afterwards.

        Without a detector (``multiperson=False``) only ``predict`` runs
        (the stream's runner is ``predict``'s one-frame runner).

        Returns {'single': n, 'gather': n, 'fused': n}, the sizes of the
        runner caches.
        """
        if self.device.type == 'cuda':
            from simple_hrnet_tpu_torch.ops.cuda import build
            build.build_all()
        h, w = int(frame_hw[0]), int(frame_hw[1])

        def zeros(n):
            return self._upload(np.zeros((n, h, w, 3), np.uint8))

        for b in batch_sizes:
            dummy = np.zeros((b, h, w, 3), np.uint8)
            self.predict(dummy[0] if b == 1 else dummy)
        if stream_max_people is not None and self.detector is not None:
            compact_cap = None
            if isinstance(stream_max_people, int):
                slot_counts = [stream_max_people]
            elif (len(stream_max_people) == 2
                  and stream_max_people[0] == 'adaptive'):
                slot_counts = _slot_ladder(int(stream_max_people[1]))
            elif (len(stream_max_people) == 2
                  and stream_max_people[0] == 'compact'):
                compact_cap = int(stream_max_people[1])
                slot_counts = []
            else:
                slot_counts = [int(s) for s in stream_max_people]
            if compact_cap is not None:
                for nf in stream_batch_frames:
                    nf = max(int(nf), 1)
                    frames_rgb = zeros(nf)
                    rows, valid, _ = self._detect_rows(
                        (h, w), nf, compact_cap)(frames_rgb)
                    # every power-of-two people bucket a window can need
                    b = _buckets(1, self.max_batch_size, self._mult)
                    seen = set()
                    while True:
                        if b not in seen:
                            seen.add(b)
                            self._gather_crop(b)(frames_rgb, rows, valid, 0)
                        if b >= _buckets(compact_cap * nf,
                                         self.max_batch_size, self._mult):
                            break
                        b = _buckets(b + 1, self.max_batch_size, self._mult)
            for slots in slot_counts:
                for nf in stream_batch_frames:
                    if slots == 0:
                        # the adaptive ladder's detect-only idle rung
                        self._detect_counts((h, w), max(nf, 1))(
                            zeros(max(nf, 1)))
                    elif nf <= 1:
                        self._fused_frame((h, w), slots)(zeros(1)[0])
                    else:
                        self._fused_frames((h, w), slots, nf)(zeros(nf))
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return {'single': len(self._single_runs),
                'gather': len(self._gather_runs),
                'fused': len(self._fused_runs)}

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

    def _finish_single(self, hm, pts, in_hw, stacked: bool = False):
        """The single-person result from host arrays (heatmaps (n, h, w, J)
        or None, keypoints (n, J, 3)) in the JAX facade's shapes and
        dtypes: heatmaps (n, J, h, w), boxes (n, 4) float32 [0, 0, W, H],
        keypoints (n, J, 3) for one frame or (n, 1, J, 3) for a stack."""
        heatmaps = None if hm is None else np.transpose(hm, (0, 3, 1, 2))
        boxes = np.repeat(np.asarray([[0, 0, in_hw[1], in_hw[0]]],
                                     np.float32), pts.shape[0], axis=0)
        pts = pts.astype(np.float32)
        return self._assemble(heatmaps, boxes, pts[:, None] if stacked
                              else pts)

    def _predict_single(self, image: np.ndarray):
        frames = self._upload(image[None])
        if self.detector is None:
            out = self._single(image.shape[:2], 1)(frames)
            _, _, hm, pts = self._host(None, None, *out)
            return self._finish_single(hm, pts, image.shape[:2])
        hm_h, hm_w = self.resolution[0] // 4, self.resolution[1] // 4
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
        if self.detector is None:
            out = self._single(images.shape[1:3], n_img)(frames)
            _, _, hm, pts = self._host(None, None, *out)
            return self._finish_single(hm, pts, images.shape[1:3],
                                       stacked=True)
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
