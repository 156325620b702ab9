"""Visualization: joint/skeleton drawing + tensorboard image grids.

A copy of the JAX package's ``utils/visualization.py`` (the reference's
misc/visualization.py: names/skeletons :9-68, draw helpers :71-192,
save_images :195-268, video rotation :271-293), on NHWC numpy arrays.
``cv2`` and matplotlib are imported inside the functions that draw, so
importing this module needs neither.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

COCO_JOINT_NAMES = [
    'nose', 'left_eye', 'right_eye', 'left_ear', 'right_ear',
    'left_shoulder', 'right_shoulder', 'left_elbow', 'right_elbow',
    'left_wrist', 'right_wrist', 'left_hip', 'right_hip',
    'left_knee', 'right_knee', 'left_ankle', 'right_ankle']

# (joint_a, joint_b) edges (reference visualization.py:24-44)
COCO_SKELETON = [
    [15, 13], [13, 11], [16, 14], [14, 12], [11, 12], [5, 11], [6, 12],
    [5, 6], [5, 7], [6, 8], [7, 9], [8, 10], [1, 2], [0, 1], [0, 2],
    [1, 3], [2, 4], [3, 5], [4, 6]]

MPII_JOINT_NAMES = [
    'right_ankle', 'right_knee', 'right_hip', 'left_hip', 'left_knee',
    'left_ankle', 'pelvis', 'thorax', 'upper_neck', 'head_top',
    'right_wrist', 'right_elbow', 'right_shoulder', 'left_shoulder',
    'left_elbow', 'left_wrist']

MPII_SKELETON = [
    [5, 4], [4, 3], [0, 1], [1, 2], [3, 2], [3, 6], [2, 6], [6, 7],
    [7, 8], [8, 9], [13, 7], [12, 7], [13, 14], [12, 11], [14, 15],
    [11, 10]]


def _palette(n: int, name: str = 'tab20'):
    import matplotlib.pyplot as plt
    cmap = plt.get_cmap(name)
    return (np.asarray([cmap(i % cmap.N)[:3] for i in range(n)]) * 255
            ).astype(np.uint8)


def draw_points(image: np.ndarray, points: np.ndarray,
                color_palette: str = 'tab20', palette_samples: int = 16,
                confidence_threshold: float = 0.5) -> np.ndarray:
    """Draw joints on a BGR image. points: (J, 3) of (y, x, conf)
    (reference visualization.py:71-104)."""
    import cv2

    colors = _palette(palette_samples, color_palette)[:, ::-1]  # to BGR
    circle_size = max(1, min(image.shape[:2]) // 160)
    for i, pt in enumerate(points):
        if pt[2] > confidence_threshold:
            image = cv2.circle(image, (int(pt[1]), int(pt[0])), circle_size,
                               tuple(int(c) for c in colors[i % len(colors)]),
                               -1)
    return image


def draw_skeleton(image: np.ndarray, points: np.ndarray,
                  skeleton: Sequence[Sequence[int]] = COCO_SKELETON,
                  color_palette: str = 'Set2', palette_samples: int = 8,
                  person_index: int = 0,
                  confidence_threshold: float = 0.5) -> np.ndarray:
    """Draw skeleton edges (reference visualization.py:107-139)."""
    import cv2

    colors = _palette(palette_samples, color_palette)[:, ::-1]
    for joint in skeleton:
        pt1, pt2 = points[joint[0]], points[joint[1]]
        if pt1[2] > confidence_threshold and pt2[2] > confidence_threshold:
            image = cv2.line(
                image, (int(pt1[1]), int(pt1[0])), (int(pt2[1]), int(pt2[0])),
                tuple(int(c) for c in colors[person_index % len(colors)]), 2)
    return image


def draw_points_and_skeleton(image, points, skeleton=COCO_SKELETON,
                             points_color_palette='tab20',
                             points_palette_samples=16,
                             skeleton_color_palette='Set2',
                             skeleton_palette_samples=8, person_index=0,
                             confidence_threshold=0.5):
    """reference visualization.py:142-192."""
    image = draw_skeleton(image, points, skeleton,
                          color_palette=skeleton_color_palette,
                          palette_samples=skeleton_palette_samples,
                          person_index=person_index,
                          confidence_threshold=confidence_threshold)
    image = draw_points(image, points, color_palette=points_color_palette,
                        palette_samples=points_palette_samples,
                        confidence_threshold=confidence_threshold)
    return image


def _denormalize(images_nhwc: np.ndarray) -> np.ndarray:
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    return np.clip(images_nhwc * std + mean, 0, 1)


def _make_grid(images_nhwc: np.ndarray, nrow: int = 8,
               padding: int = 2) -> np.ndarray:
    """Tile (N, H, W, C) into one (H', W', C) grid (torchvision make_grid)."""
    n, h, w, c = images_nhwc.shape
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + padding) + padding,
                     ncol * (w + padding) + padding, c), np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = r * (h + padding) + padding
        x0 = col * (w + padding) + padding
        grid[y0:y0 + h, x0:x0 + w] = images_nhwc[i]
    return grid


def save_images(images, target, joints_target, output, joints_preds,
                joints_visibility, summary_writer=None, step: int = 0,
                prefix: str = '') -> tuple:
    """GT/prediction image grids for tensorboard (reference
    visualization.py:195-268). images NHWC normalized; targets/outputs NHWC
    heatmaps; joints (N, J, 2) xy in input coords."""
    images = _denormalize(np.asarray(images))
    gt_imgs = images.copy()
    pred_imgs = images.copy()
    vis = np.asarray(joints_visibility)
    for i in range(images.shape[0]):
        for j in range(np.asarray(joints_target).shape[1]):
            if vis[i, j, 0] > 0.5:
                x, y = np.asarray(joints_target)[i, j][:2]
                _dot(gt_imgs[i], y * 4, x * 4)
        for j in range(np.asarray(joints_preds).shape[1]):
            x, y = np.asarray(joints_preds)[i, j][:2]
            _dot(pred_imgs[i], y * 4, x * 4)

    grid_gt = _make_grid(gt_imgs)
    grid_pred = _make_grid(pred_imgs)
    if summary_writer is not None:
        summary_writer.add_image(prefix + 'images_gt',
                                 grid_gt.transpose(2, 0, 1), global_step=step)
        summary_writer.add_image(prefix + 'images_pred',
                                 grid_pred.transpose(2, 0, 1),
                                 global_step=step)
    return grid_gt, grid_pred


def _dot(img: np.ndarray, y: float, x: float, r: int = 2):
    h, w = img.shape[:2]
    yi, xi = int(y), int(x)
    if 0 <= yi < h and 0 <= xi < w:
        img[max(0, yi - r):yi + r, max(0, xi - r):xi + r] = [1.0, 0.0, 0.0]


def check_video_rotation(filename: str) -> Optional[int]:
    """Probe rotation metadata (reference visualization.py:271-293).

    Uses ffmpeg-python when present, else ffprobe via subprocess, else None.
    Returns a cv2 rotation code or None.
    """
    import json
    import subprocess

    try:
        out = subprocess.run(
            ['ffprobe', '-loglevel', 'error', '-select_streams', 'v:0',
             '-show_entries', 'stream_tags=rotate', '-of', 'json', filename],
            capture_output=True, text=True, timeout=10)
        tags = json.loads(out.stdout or '{}').get('streams', [{}])[0] \
            .get('tags', {})
        rotation = int(tags.get('rotate', 0))
    except Exception:
        return None

    import cv2
    if rotation == 90:
        return cv2.ROTATE_90_CLOCKWISE
    if rotation == 180:
        return cv2.ROTATE_180
    if rotation == 270:
        return cv2.ROTATE_90_COUNTERCLOCKWISE
    return None
