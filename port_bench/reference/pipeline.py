"""Plain top-down pose pipeline of the reference, in f32 (crops in f64).

The published pipeline of ``SimpleHRNet.predict`` (the reference
implementation the program ports): letterbox each frame for the detector
(cv2 ``INTER_LINEAR`` resize, 127.5 grey border), detect, keep the person
class, greedy NMS, map boxes back to the frame, round them, grow each box
to the pose model's aspect, crop and resize it as PIL does (``crop ->
np.pad -> Resize``), ImageNet-normalize and run the pose model, whose
heatmaps judge the program's argmax decode (``harness/check.py``).
Written here from that description, with
the detector's plain 3-channel stem (the program's phase stem is an exact
rewrite of the same convolution), dense resize matrices and a plain
greedy NMS loop. Nothing here imports the measured program.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import numpy as np
import torch

# ImageNet statistics in [0, 255], subtract then multiply
MEAN255 = (np.asarray([0.485, 0.456, 0.406], np.float32)
           * np.float32(255.0)).astype(np.float32)
INV255_STD = ((np.float32(1.0) / np.float32(255.0))
              * (np.float32(1.0) / np.asarray([0.229, 0.224, 0.225],
                                              np.float32))).astype(np.float32)
TOP_K = 256


@contextlib.contextmanager
def true_f32() -> Iterator[None]:
    """f32 as written on the card: TF32 off for cuDNN convolutions (on by
    default) and for matmuls, the flags found put back on exit. Every use
    of the reference runs inside it."""
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix of cv2 ``INTER_LINEAR``: half-pixel centres, edge
    clamp."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        base = int(np.floor(src))
        frac = src - base
        w[i, min(max(base, 0), in_size - 1)] += 1.0 - frac
        w[i, min(max(base + 1, 0), in_size - 1)] += frac
    return w


def letterbox_geometry(hw: Tuple[int, int], size: int):
    h, w = hw
    ratio = float(size) / max(h, w)
    nw, nh = int(round(w * ratio)), int(round(h * ratio))
    dw, dh = (size - nw) / 2, (size - nh) / 2
    return nw, nh, int(round(dh - 0.1)), int(round(dw - 0.1))


def letterbox(frames_rgb: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W, 3) RGB -> (N, 3, S, S) in [0, 1]."""
    h, w = frames_rgb.shape[1:3]
    nw, nh, top, left = letterbox_geometry((h, w), size)
    dev = frames_rgb.device
    wy = torch.from_numpy(linear_weights(h, nh)).to(dev)
    wx = torch.from_numpy(linear_weights(w, nw)).to(dev)
    x = torch.einsum('oh,nhwc->nowc', wy, frames_rgb.float())
    x = torch.einsum('pw,nhwc->nhpc', wx, x)
    out = torch.full((frames_rgb.shape[0], size, size, 3), 127.5,
                     dtype=torch.float32, device=dev)
    out[:, top:top + nh, left:left + nw] = x
    return (out / 255.0).permute(0, 3, 1, 2).contiguous()


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
               max_out: int) -> list:
    """One frame's greedy NMS: repeatedly keep the highest live score
    (lowest index on ties), drop every box with IoU above ``iou_thres``
    against it (no +1 extent); scores <= 0 are never kept."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    alive = scores > 0
    keep = []
    while len(keep) < max_out and bool(alive.any()):
        s = torch.where(alive, scores, torch.full_like(scores, -1.0))
        i = int(torch.argmax(s))
        keep.append(i)
        xx1 = torch.maximum(x1[i], x1)
        yy1 = torch.maximum(y1[i], y1)
        xx2 = torch.minimum(x2[i], x2)
        yy2 = torch.minimum(y2[i], y2)
        inter = (xx2 - xx1).clamp(min=0) * (yy2 - yy1).clamp(min=0)
        iou = inter / (areas[i] + areas - inter)
        alive = alive & ~(iou > iou_thres)
        alive[i] = False
    return keep


@torch.no_grad()
def detect(net, frames_rgb: torch.Tensor, det: dict,
           candidates: bool = False) -> list:
    """Person rows of each frame: a list of (P, 5) f32 arrays (x1, y1, x2,
    y2, score) in frame pixels, in NMS keep order. ``det`` is the
    configuration's detector entry (kind, img_size, conf_thres,
    nms_thres, max_detections). With ``candidates``, each frame's entry is
    (rows, every person-class anchor's (A, 5) box in frame pixels and
    score before the threshold)."""
    size = det['img_size']
    h, w = frames_rgb.shape[1:3]
    preds = net(letterbox(frames_rgb, size), size)
    cls = preds[..., 5:]
    cls_conf, cls_pred = cls.max(dim=-1)
    if det['kind'] == 'yolov5':      # v5: obj * class confidence
        score = preds[..., 4] * cls_conf
    else:                            # v3: objectness
        score = preds[..., 4]
    raw = score
    score = torch.where((score >= det['conf_thres']) & (cls_pred == 0),
                        score, torch.zeros_like(score))
    gain = size / max(h, w)
    pad = torch.tensor([(size - w * gain) / 2, (size - h * gain) / 2] * 2,
                       device=preds.device)
    out = []
    for f in range(preds.shape[0]):
        if candidates:
            cx, cy, bw, bh = preds[f, :, :4].unbind(-1)
            allb = torch.clamp((torch.stack(
                [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
                - pad) / gain, min=0.0)
            person = cls_pred[f] == 0
            cand = torch.cat([allb, raw[f, :, None]], 1)[person]
        order = torch.sort(score[f], descending=True, stable=True).indices
        order = order[:TOP_K]
        s = score[f, order]
        cx, cy, bw, bh = preds[f, order, :4].unbind(-1)
        boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                             cy + bh / 2], -1)
        keep = greedy_nms(boxes, s, det['nms_thres'], det['max_detections'])
        rows = torch.cat([torch.clamp((boxes[keep] - pad) / gain, min=0.0),
                          s[keep, None]], 1)
        out.append((rows.cpu().numpy(), cand.cpu().numpy()) if candidates
                   else rows.cpu().numpy())
    return out


def pad_to_aspect(box: np.ndarray, aspect: float) -> np.ndarray:
    """A rounded xyxy box grown to height/width ``aspect`` along its short
    axis with the reference's integer arithmetic: length = round(side *
    f), bounds = centre -/+ length // 2, centre = lo + side // 2."""
    x1, y1, x2, y2 = (float(v) for v in box)
    w, h = x2 - x1, y2 - y1
    cmp = w * aspect - h
    if cmp > 0:
        cy = y1 + np.floor(h / 2)
        half = np.floor(np.round(w * aspect) / 2)
        return np.asarray([x1, cy - half, x2, cy + half])
    if cmp < 0:
        cx = x1 + np.floor(w / 2)
        half = np.floor(np.round(h * (1.0 / aspect)) / 2)
        return np.asarray([cx - half, y1, cx + half, y2])
    return np.asarray([x1, y1, x2, y2])


def _pil_axis(lo: float, hi: float, out: int, n: int, vlo: float,
              vhi: float, device) -> torch.Tensor:
    """(out, n) PIL antialiased-bilinear coefficients (f64) of the window
    [lo, hi) (integer-valued) of an axis of n pixels: the triangle kernel
    widened by the downscale factor, normalized over the window's
    positions (the np.pad zeros included), rounded to PIL's 22-bit fixed
    point, and zero outside [vlo, vhi) and outside the frame."""
    hi = max(hi, lo + 1.0)
    scale = (hi - lo) / out
    fs = max(scale, 1.0)
    f64 = torch.float64
    ys = torch.arange(int(lo), int(hi), dtype=f64, device=device)
    c = lo + (torch.arange(out, dtype=f64, device=device) + 0.5) * scale
    k = torch.clamp(1.0 - torch.abs(ys[None] + 0.5 - c[:, None]) / fs,
                    min=0.0)
    k = k / torch.clamp(k.sum(1, keepdim=True), min=1e-12)
    k = torch.floor(k * float(1 << 22) + 0.5) / float(1 << 22)
    ok = (ys >= vlo) & (ys <= vhi - 1) & (ys >= 0) & (ys < n)
    w = torch.zeros((out, n), dtype=f64, device=device)
    w[:, ys[ok].long()] = k[:, ok]
    return w


def crop(frame_rgb: torch.Tensor, window, box, out_hw: Tuple[int, int]
         ) -> torch.Tensor:
    """The person crop (oh, ow, 3) f64 in [0, 255] of an (H, W, 3) frame
    on the device: the frame's pixels inside ``box`` placed in the padded
    ``window`` (zeros elsewhere), resized as PIL resizes a uint8 image
    (width pass, round, height pass, round). Exact in f64."""
    h, w = frame_rgb.shape[:2]
    x1, y1, x2, y2 = (float(v) for v in window)
    vx1, vy1, vx2, vy2 = (float(v) for v in box)
    # the crop is cut at the frame's bottom/right edge before np.pad
    x2 -= max(vx2 - w, 0.0)
    y2 -= max(vy2 - h, 0.0)
    dev = frame_rgb.device
    ww = _pil_axis(x1, x2, out_hw[1], w, vx1, vx2, dev)
    wh = _pil_axis(y1, y2, out_hw[0], h, vy1, vy2, dev)
    t = torch.einsum('ow,hwc->hoc', ww, frame_rgb.double())
    t = torch.clamp(torch.floor(t + 0.5), 0, 255)
    return torch.clamp(torch.floor(torch.einsum('qh,hoc->qoc', wh, t) + 0.5),
                       0, 255)


@torch.no_grad()
def heatmaps(pose, crops: torch.Tensor) -> np.ndarray:
    """(P, oh, ow, 3) crops in [0, 255] on the device -> (P, J, oh/4,
    ow/4) heatmaps on the host."""
    dev = crops.device
    mean = torch.from_numpy(MEAN255).to(dev)
    inv = torch.from_numpy(INV255_STD).to(dev)
    x = ((crops.float() - mean) * inv).permute(0, 3, 1, 2).contiguous()
    return pose(x).float().cpu().numpy()
