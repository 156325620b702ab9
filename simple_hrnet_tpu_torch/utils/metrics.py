"""Accuracy metrics: PCK from heatmaps, the native COCO keypoint AP and
MPII PCKh.

Counterpart of ``simple_hrnet_tpu/utils/metrics.py``. ``evaluate_pck_accuracy``
(reference misc/utils.py:185-244) computes in torch on the output's device.
The COCO keypoint AP is the JAX package's native reimplementation of
COCOeval in numpy (OKS as computeOks, greedy matching by score with crowd
re-matching and ignored GTs, detection-area ignores, 101-point
interpolated AP over OKS .5:.05:.95, AR at maxDets);
``coco_eval_from_results`` uses pycocotools instead when it imports.
``evaluate_pckh`` is the official MPII protocol.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from simple_hrnet_tpu_torch.ops import decode as D
from simple_hrnet_tpu_torch.utils.tracking import COCO_SIGMAS


# ---------------------------------------------------------------------------
# PCK accuracy (train/val metric)
# ---------------------------------------------------------------------------

def _calc_dists(preds: torch.Tensor, target: torch.Tensor,
                normalize: torch.Tensor) -> torch.Tensor:
    """(J, N) distances, -1 for joints without a target (reference
    utils.py:185-198: both target coords must be > 1)."""
    valid = (target[..., 0] > 1) & (target[..., 1] > 1)          # (N, J)
    normed = (preds - target) / normalize[:, None, :]
    dists = torch.linalg.norm(normed, dim=-1)                    # (N, J)
    return torch.where(valid, dists, torch.full_like(dists, -1.0)).T


def evaluate_pck_accuracy(output, target, thr: float = 0.5):
    """PCK@thr from (N, H, W, J) heatmaps, normalized by heatmap size / 10,
    on ``output``'s device. Returns (per-joint acc (J,), avg_acc, cnt,
    pred coords, target coords) as reference utils.py:213-244 does;
    per-joint accuracy is -1 where no joint was evaluable."""
    output = torch.as_tensor(output)
    target = torch.as_tensor(target, device=output.device)
    pred, _ = D.get_max_preds(output)
    gt, _ = D.get_max_preds(target)
    h, w = output.shape[1], output.shape[2]
    norm = (torch.ones((pred.shape[0], 2), device=output.device)
            * torch.tensor([h, w], dtype=torch.float32,
                           device=output.device) / 10)
    dists = _calc_dists(pred, gt, norm)                          # (J, N)

    evaluable = dists != -1
    below = (dists < thr) & evaluable
    cnt_j = evaluable.sum(dim=1)
    acc = torch.where(cnt_j > 0, below.sum(dim=1) / cnt_j.clamp(min=1),
                      torch.full(cnt_j.shape, -1.0, device=output.device))
    valid_joints = acc >= 0
    n_valid = valid_joints.sum()
    avg_acc = torch.where(
        n_valid > 0,
        torch.where(valid_joints, acc, torch.zeros_like(acc)).sum()
        / n_valid.clamp(min=1), torch.zeros((), device=output.device))
    return acc, avg_acc, n_valid, pred, gt


# ---------------------------------------------------------------------------
# COCO keypoint AP (native evaluator)
# ---------------------------------------------------------------------------

def compute_oks(gt_kpts: np.ndarray, gt_area: float, dt_kpts: np.ndarray,
                sigmas: np.ndarray = COCO_SIGMAS,
                gt_bbox=None) -> np.ndarray:
    """OKS of each detection vs one GT (COCOeval.computeOks semantics).

    gt_kpts: (J, 3) [x, y, v]; dt_kpts: (M, J, 3). When the GT has NO
    visible keypoints (k1 == 0 — crowd regions), pycocotools measures each
    detection keypoint's distance to the GT ``bbox`` expanded by its own
    extent on every side (cocoeval.py computeOks `else` branch); pass
    ``gt_bbox`` = [x, y, w, h] to reproduce that. Without a bbox the
    keypoint-position distances are used as a fallback.
    """
    variances = (sigmas * 2) ** 2
    xg, yg, vg = gt_kpts[:, 0], gt_kpts[:, 1], gt_kpts[:, 2]
    k1 = np.count_nonzero(vg > 0)
    oks = np.zeros(dt_kpts.shape[0])
    for i, dt in enumerate(dt_kpts):
        if k1 > 0 or gt_bbox is None:
            dx = dt[:, 0] - xg
            dy = dt[:, 1] - yg
        else:
            bx, by, bw, bh = (float(v) for v in gt_bbox)
            x0, x1 = bx - bw, bx + 2 * bw
            y0, y1 = by - bh, by + 2 * bh
            dx = np.maximum(0.0, x0 - dt[:, 0]) + \
                np.maximum(0.0, dt[:, 0] - x1)
            dy = np.maximum(0.0, y0 - dt[:, 1]) + \
                np.maximum(0.0, dt[:, 1] - y1)
        e = (dx ** 2 + dy ** 2) / variances / (gt_area + np.spacing(1)) / 2
        if k1 > 0:
            e = e[vg > 0]
        oks[i] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] else 0.0
    return oks


def compute_oks_matrices(gts: Dict[int, List[dict]],
                         dts: Dict[int, List[dict]],
                         max_dets: int = 20) -> Dict[int, np.ndarray]:
    """Per-image OKS matrices (D, G): detections score-sorted and
    truncated to max_dets, GTs in their original list order. OKS is
    threshold- and area-range-independent, so ONE pass serves every
    ``coco_keypoint_ap`` call (pycocotools likewise computes ``self.ious``
    once in evaluate() and reuses them across areaRng/iouThrs)."""
    out: Dict[int, np.ndarray] = {}
    for img in sorted(set(gts) | set(dts)):
        gt_all = list(gts.get(img, []))
        dt_list = sorted(dts.get(img, []),
                         key=lambda d: -d['score'])[:max_dets]
        if not dt_list or not gt_all:
            continue
        dt_kpts = np.stack([np.asarray(d['keypoints'], np.float64)
                            for d in dt_list])
        out[img] = np.stack([compute_oks(
            np.asarray(g['keypoints'], np.float64), g['area'], dt_kpts,
            gt_bbox=g.get('bbox')) for g in gt_all]).T      # (D, G)
    return out


def coco_keypoint_ap(gts: Dict[int, List[dict]], dts: Dict[int, List[dict]],
                     oks_thresholds: Optional[np.ndarray] = None,
                     area_range: Tuple[float, float] = (0, float('inf')),
                     max_dets: int = 20,
                     ious: Optional[Dict[int, np.ndarray]] = None
                     ) -> Tuple[float, float, np.ndarray]:
    """COCO-protocol keypoint AP/AR, matching COCOeval's algorithm exactly:

      * GTs are IGNORED (not removed) when crowd, keypoint-less, or outside
        the area range [a0, a1] (closed interval, COCOeval evaluateImg);
        ignored GTs don't count toward recall and detections matched to
        them are excluded from both TP and FP.
      * Matching (per OKS threshold, detections in score order): best
        still-unmatched GT with OKS >= min(thr, 1-1e-10); crowd GTs are
        re-matchable; once a regular match exists, ignored GTs (sorted
        last) are not considered.
      * Unmatched detections whose own area lies outside the range are
        ignored rather than counted as false positives.
      * AP = mean of 101-point interpolated precision; AR = recall at
        maxDets (COCOeval accumulate: rc[-1]).

    gts/dts: imgId -> list of {'keypoints': (J,3), 'area': float,
    'iscrowd': optional bool, 'score': float (dts only)}. Returns
    (AP, AR, per-threshold AP array); (-1, -1, -1s) when no evaluable GT
    exists (COCOeval's empty-category convention).
    """
    if oks_thresholds is None:
        oks_thresholds = np.linspace(0.5, 0.95, 10)
    t_count = len(oks_thresholds)

    scores: List[float] = []
    tp_rows: List[np.ndarray] = []       # (T,) matched-to-regular-gt
    ig_rows: List[np.ndarray] = []       # (T,) ignored detection
    total_gt = 0
    # sorted ids: pycocotools evaluates p.imgIds = np.unique(...) (sorted),
    # and the global mergesort over scores breaks ties by image order — a
    # set's iteration order would make tied-score AP nondeterministic
    img_ids = sorted(set(gts) | set(dts))
    for img in img_ids:
        gt_all = list(gts.get(img, []))
        gt_ig = []
        for g in gt_all:
            kp = np.asarray(g['keypoints'])
            ig = bool(g.get('iscrowd')) or \
                np.count_nonzero(kp[:, 2] > 0) == 0 or \
                g['area'] < area_range[0] or g['area'] > area_range[1]
            gt_ig.append(ig)
        # regular GTs first
        order = sorted(range(len(gt_all)), key=lambda i: gt_ig[i])
        gt_all = [gt_all[i] for i in order]
        gt_ig = np.asarray([gt_ig[i] for i in order], bool)
        gt_crowd = np.asarray([bool(g.get('iscrowd')) for g in gt_all])
        total_gt += int((~gt_ig).sum())

        dt_list = sorted(dts.get(img, []),
                         key=lambda d: -d['score'])[:max_dets]
        if not dt_list:
            continue
        n_dt, n_gt = len(dt_list), len(gt_all)
        dt_out = np.asarray([d['area'] < area_range[0] or
                             d['area'] > area_range[1] for d in dt_list])
        if n_gt:
            if ious is not None:
                # precomputed in original gt order; re-index the columns
                # to this call's ignored-last ordering
                iou_m = ious[img][:, order]
            else:
                dt_kpts = np.stack([np.asarray(d['keypoints'], np.float64)
                                    for d in dt_list])
                iou_m = np.stack([compute_oks(
                    np.asarray(g['keypoints'], np.float64), g['area'],
                    dt_kpts, gt_bbox=g.get('bbox'))
                    for g in gt_all]).T                  # (D, G)
        tp = np.zeros((n_dt, t_count), bool)
        ig = np.zeros((n_dt, t_count), bool)
        for ti, thr in enumerate(oks_thresholds):
            gt_matched = np.full(n_gt, -1)
            for di in range(n_dt):
                iou = min(thr, 1 - 1e-10)
                m = -1
                for gi in range(n_gt):
                    if gt_matched[gi] >= 0 and not gt_crowd[gi]:
                        continue
                    if m >= 0 and not gt_ig[m] and gt_ig[gi]:
                        break  # regular match in hand; rest are ignored
                    if iou_m[di, gi] < iou:
                        continue
                    iou = iou_m[di, gi]
                    m = gi
                if m >= 0:
                    gt_matched[m] = di
                    ig[di, ti] = gt_ig[m]
                    tp[di, ti] = not gt_ig[m]
                else:
                    ig[di, ti] = dt_out[di]  # unmatched + out-of-range area
        for di, d in enumerate(dt_list):
            scores.append(float(d['score']))
            tp_rows.append(tp[di])
            ig_rows.append(ig[di])

    if total_gt == 0:
        return -1.0, -1.0, np.full(t_count, -1.0)
    if not scores:
        return 0.0, 0.0, np.zeros(t_count)

    order = np.argsort(-np.asarray(scores), kind='mergesort')
    tps = np.stack(tp_rows)[order]       # (D, T)
    igs = np.stack(ig_rows)[order]

    recall_thrs = np.linspace(0, 1, 101)
    ap_per_t = np.zeros(t_count)
    ar_per_t = np.zeros(t_count)
    for ti in range(t_count):
        keep = ~igs[:, ti]
        tp_t = tps[keep, ti].astype(np.float64)
        if tp_t.size == 0:
            continue
        cum_tp = np.cumsum(tp_t)
        cum_fp = np.cumsum(1.0 - tp_t)
        precision = cum_tp / (cum_tp + cum_fp + np.spacing(1))
        recall = cum_tp / total_gt
        ar_per_t[ti] = recall[-1]
        p = precision.copy()
        for i in range(len(p) - 1, 0, -1):
            p[i - 1] = max(p[i - 1], p[i])
        idx = np.searchsorted(recall, recall_thrs, side='left')
        prec_at = np.where(idx < len(p), p[np.minimum(idx, len(p) - 1)], 0)
        ap_per_t[ti] = prec_at.mean()
    return float(ap_per_t.mean()), float(ar_per_t.mean()), ap_per_t


def coco_eval_from_results(gt_annotations: dict, results: List[dict]
                           ) -> Dict[str, float]:
    """Evaluate keypoint results (COCO results-json format) against a COCO
    annotation dict (the parsed person_keypoints_*.json). Uses pycocotools
    when importable (bit-identical to the reference COCO.py:574-588), else
    the native evaluator.

    Returns the reference's stats dict: AP, AP .5, AP .75, AP (M), AP (L),
    AR, AR .5, AR .75, AR (M), AR (L).
    """
    try:
        import pycocotools  # noqa: F401
        return _pycocotools_eval(gt_annotations, results)
    except ImportError:
        pass
    return coco_eval_native(gt_annotations, results)


def coco_eval_native(gt_annotations: dict, results: List[dict]
                     ) -> Dict[str, float]:
    """The native COCOeval reimplementation (no pycocotools import).

    Exposed separately so environments WITH pycocotools can bit-check the
    native evaluator against it (scripts/dump_pycocotools_fixture.py +
    tests/test_coco_eval_fixture.py).
    """
    gts: Dict[int, List[dict]] = defaultdict(list)
    for ann in gt_annotations.get('annotations', []):
        if ann.get('category_id') != 1:
            continue
        # crowd / keypoint-less GTs are kept as IGNORED entries (COCOeval
        # semantics), never silently dropped
        kp = np.asarray(ann['keypoints'], np.float64).reshape(-1, 3)
        gts[ann['image_id']].append({'keypoints': kp, 'area': ann['area'],
                                     'iscrowd': bool(ann.get('iscrowd')),
                                     'bbox': ann.get('bbox')})

    dts: Dict[int, List[dict]] = defaultdict(list)
    for res in results:
        kp = np.asarray(res['keypoints'], np.float64).reshape(-1, 3)
        dts[res['image_id']].append(
            {'keypoints': kp, 'score': float(res['score']),
             'area': _kpt_area(kp)})

    # COCOeval keypoint area ranges: all [0, 1e10], M [32^2, 96^2],
    # L [96^2, 1e10] (cocoeval.py Params.setKpParams)
    med = (32 ** 2, 96 ** 2)
    big = (96 ** 2, 1e5 ** 2)
    thrs = np.linspace(0.5, 0.95, 10)
    shared = compute_oks_matrices(gts, dts)  # one OKS pass for all 5 calls
    ap, ar, ap_t = coco_keypoint_ap(gts, dts, thrs, area_range=(0, 1e5 ** 2),
                                    ious=shared)
    ap_m, ar_m, _ = coco_keypoint_ap(gts, dts, thrs, area_range=med,
                                     ious=shared)
    ap_l, ar_l, _ = coco_keypoint_ap(gts, dts, thrs, area_range=big,
                                     ious=shared)
    ap50, ar50, _ = coco_keypoint_ap(gts, dts, np.asarray([0.5]),
                                     area_range=(0, 1e5 ** 2), ious=shared)
    ap75, ar75, _ = coco_keypoint_ap(gts, dts, np.asarray([0.75]),
                                     area_range=(0, 1e5 ** 2), ious=shared)
    return {'AP': ap, 'Ap .5': ap50, 'AP .75': ap75, 'AP (M)': ap_m,
            'AP (L)': ap_l, 'AR': ar, 'AR .5': ar50, 'AR .75': ar75,
            'AR (M)': ar_m, 'AR (L)': ar_l}


def _kpt_area(kp: np.ndarray) -> float:
    """Detection area, pycocotools loadRes semantics for keypoint results:
    bbox of ALL keypoint coordinates (visibility ignored)."""
    x0, x1 = kp[:, 0].min(), kp[:, 0].max()
    y0, y1 = kp[:, 1].min(), kp[:, 1].max()
    return float((x1 - x0) * (y1 - y0))


def _pycocotools_eval(gt_annotations: dict, results: List[dict]):
    import json
    import os
    import tempfile

    from pycocotools.coco import COCO
    from pycocotools.cocoeval import COCOeval

    with tempfile.NamedTemporaryFile('w', suffix='.json', delete=False) as f:
        json.dump(gt_annotations, f)
        gt_path = f.name
    try:
        # COCO() parses the file in its constructor; unlink immediately so
        # per-epoch evals don't leak one large GT json to /tmp each call
        coco = COCO(gt_path)
    finally:
        os.unlink(gt_path)
    coco_dt = coco.loadRes(results)
    ev = COCOeval(coco, coco_dt, 'keypoints')
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    names = ['AP', 'Ap .5', 'AP .75', 'AP (M)', 'AP (L)', 'AR', 'AR .5',
             'AR .75', 'AR (M)', 'AR (L)']
    return dict(zip(names, ev.stats))


# ---------------------------------------------------------------------------
# MPII PCKh
# ---------------------------------------------------------------------------

MPII_JOINT_NAMES = ['Ankle', 'Knee', 'Hip', 'Hip', 'Knee', 'Ankle',
                    'Pelvis', 'Thorax', 'Neck', 'Head', 'Wrist', 'Elbow',
                    'Shoulder', 'Shoulder', 'Elbow', 'Wrist']


def evaluate_pckh(preds: np.ndarray, gts: np.ndarray, vis: np.ndarray,
                  head_sizes: np.ndarray, thr: float = 0.5) -> dict:
    """PCKh@thr: fraction of visible joints within thr * head size.

    preds/gts: (N, 16, 2) original-image (x, y); vis: (N, 16) 0/1;
    head_sizes: (N,). Follows the official MPII protocol (the evaluation
    shipped with the MPII toolkit / HRNet's validate tools): per-joint
    PCKh normalized by the annotated head size; the per-name table
    AVERAGES the left/right sides' percentages (0.5*(L+R), not a
    visible-count pool); 'Mean' is the visible-count-weighted mean over
    the 16 joints with pelvis (6) and thorax (7) MASKED OUT
    (`PCKh.mask[6:8]` in the official script — they sit on the torso
    centerline and are near-saturated, so including them inflates the
    headline). Returns a dict of per-joint-name PCKh values plus 'Mean'.
    """
    preds = np.asarray(preds, np.float64)
    gts = np.asarray(gts, np.float64)
    vis = np.asarray(vis, np.float64) > 0
    head = np.maximum(np.asarray(head_sizes, np.float64), 1e-6)

    dist = np.linalg.norm(preds - gts, axis=-1) / head[:, None]  # (N, 16)
    correct = (dist <= thr) & vis
    n_vis_j = vis.sum(axis=0)                                    # (16,)
    pckh_j = np.where(n_vis_j > 0,
                      correct.sum(axis=0) / np.maximum(n_vis_j, 1), 0.0)

    out = {}
    for name in dict.fromkeys(MPII_JOINT_NAMES):  # keep order, dedupe
        idx = [i for i, n in enumerate(MPII_JOINT_NAMES)
               if n == name and n_vis_j[i] > 0]
        out[name] = float(np.mean(pckh_j[idx])) if idx else 0.0
    keep = n_vis_j > 0
    keep[6:8] = False  # pelvis + thorax out of Mean (official mask)
    out['Mean'] = float((pckh_j[keep] * n_vis_j[keep]).sum()
                        / n_vis_j[keep].sum()) if keep.any() else 0.0
    return out
