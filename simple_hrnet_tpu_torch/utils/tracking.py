"""Temporal person-ID tracking (a numpy copy of the JAX package's
``utils/tracking.py``; reference misc/utils.py:251-429).

Hungarian assignment over a blended pose-OKS / box-IoU similarity matrix
with threshold gating, EMA smoothing and fresh-ID allocation, on the host
(O(people^2) tiny matrices a frame). scipy's ``linear_sum_assignment`` is
imported when first needed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# COCO keypoint OKS sigmas (pycocotools; the JAX package's ops/nms.py)
COCO_SIGMAS = np.array([.26, .25, .25, .35, .35, .79, .79, .72, .72, .62,
                        .62, 1.07, 1.07, .87, .87, .89, .89]) / 10.0


def bbox_area(bbox) -> float:
    """(x1, y1, x2, y2) area (reference utils.py:251-266)."""
    x1, y1, x2, y2 = bbox
    return (x2 - x1) * (y2 - y1)


def bbox_iou(a, b) -> float:
    """IoU of two xyxy boxes (reference utils.py:269-334)."""
    x1 = max(a[0], b[0])
    y1 = max(a[1], b[1])
    x2 = min(a[2], b[2])
    y2 = min(a[3], b[3])
    if x2 < x1 or y2 < y1:
        inter = 0.0
    else:
        inter = (x2 - x1) * (y2 - y1)
    union = bbox_area(a) + bbox_area(b) - inter
    return inter / union if union > 0 else 0.0


def oks_iou_yx(g: np.ndarray, d: np.ndarray, a_g: float, a_d: np.ndarray,
               sigmas=None, in_vis_thre=None) -> np.ndarray:
    """OKS with (y, x, conf) joint layout (reference utils.py:341-368).

    The reference's outlier filter ``e = e[e <=2^32 -1]`` means
    ``e <= 29`` (``^`` is XOR and binds looser than ``-``) and is kept:
    dropped joints shrink the mean's denominator. Its visibility filter
    quirk is kept too.
    """
    if sigmas is None:
        sigmas = (COCO_SIGMAS if d.shape[1] == 17
                  else np.ones((d.shape[1],)) / 10.0)
    variances = (np.asarray(sigmas) * 2) ** 2
    yg, xg, vg = g[:, 0], g[:, 1], g[:, 2]
    ious = np.zeros((d.shape[0]))
    for n_d in range(d.shape[0]):
        yd, xd, vd = d[n_d, :, 0], d[n_d, :, 1], d[n_d, :, 2]
        e = ((xd - xg) ** 2 + (yd - yg) ** 2) / variances \
            / ((a_g + a_d[n_d]) / 2 + np.spacing(1)) / 2
        if in_vis_thre is not None:
            # the reference's `and` of two non-empty lists returns the
            # second list, so only the detection's visibility filters
            # (utils.py:361-362)
            ind = list(vg > in_vis_thre) and list(vd > in_vis_thre)
            e = e[ind]
        # reference utils.py:364 `e = e[e <=2^32 -1]`, i.e. e <= 29: far-off
        # joints leave the mean's denominator too
        e = e[e <= 29]
        ious[n_d] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] else 0.0
    return ious


def compute_similarity_matrices(bboxes_a, bboxes_b, poses_a, poses_b
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """(box-IoU, pose-OKS) similarity matrices (reference utils.py:371-383)."""
    assert len(bboxes_a) == len(poses_a) and len(bboxes_b) == len(poses_b)
    result_bbox = np.zeros((len(bboxes_a), len(bboxes_b)), np.float32)
    result_pose = np.zeros((len(poses_a), len(poses_b)), np.float32)
    if len(bboxes_b) == 0:
        return result_bbox, result_pose
    areas_b = np.asarray([bbox_area(b) for b in bboxes_b])
    poses_b_arr = np.asarray(poses_b)
    for i, (bbox_a, pose_a) in enumerate(zip(bboxes_a, poses_a)):
        result_pose[i, :] = oks_iou_yx(np.asarray(pose_a), poses_b_arr,
                                       bbox_area(bbox_a), areas_b)
        for j, bbox_b in enumerate(bboxes_b):
            result_bbox[i, j] = bbox_iou(bbox_a, bbox_b)
    return result_bbox, result_pose


def find_person_id_associations(boxes, pts, prev_boxes, prev_pts,
                                prev_person_ids, next_person_id: int = 0,
                                pose_alpha: float = 0.5,
                                similarity_threshold: float = 0.5,
                                smoothing_alpha: float = 0.):
    """Associate current detections to previous IDs (utils.py:386-429).

    Returns (boxes, pts, person_ids); boxes/pts EMA-smoothed when
    smoothing_alpha > 0.
    """
    from scipy.optimize import linear_sum_assignment

    boxes = np.asarray(boxes, np.float32).copy()
    pts = np.asarray(pts, np.float32).copy()

    bbox_sim, pose_sim = compute_similarity_matrices(
        boxes, prev_boxes, pts, prev_pts)
    similarity = pose_sim * pose_alpha + bbox_sim * (1 - pose_alpha)

    person_ids = np.ones(len(pts), np.int32) * -1
    if similarity.size:
        rows, cols = linear_sum_assignment(1 - similarity)
        for r, c in zip(rows, cols):
            if similarity[r, c] > similarity_threshold:
                person_ids[r] = prev_person_ids[c]
                if smoothing_alpha:
                    boxes[r] = ((1 - smoothing_alpha) * boxes[r]
                                + smoothing_alpha * prev_boxes[c])
                    pts[r] = ((1 - smoothing_alpha) * pts[r]
                              + smoothing_alpha * prev_pts[c])

    new = person_ids == -1
    person_ids[new] = np.arange(next_person_id,
                                next_person_id + int(new.sum()))
    return boxes, pts, person_ids
