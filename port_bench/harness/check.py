"""How ``correct`` is decided: the program's answers on a seeded sample of
the window's chunks, held against the plain reference.

Two stages, each judged on what the timed path produced:

* The detector. The program's rows (captured as the stream's detect call
  returned them) against the reference detector's rows on the same
  frames (``detector_numbers``): frames left without people, and boxes
  moved.
* The pose stage. For each person the stream returned, the reference
  crops the frame by the program's own detection (its rounded box, grown
  to the model's aspect: the window the stream must have used, which must
  equal the box the stream returned, ``box_mismatch``), runs the pose
  model and reads the program's keypoint against its own heatmap:
  ``kp_gap`` is the widest gap, over people and joints, by which the
  reference's heatmap at the program's argmax cell lies below the
  reference's maximum, over that channel's range (max - min);
  ``conf_err`` (widest) and ``conf_err_median`` the gaps between the
  program's confidence and the reference's maximum, over the same range.
  Random weights give heatmaps with near ties, which a lower precision
  may order otherwise; a near tie costs little gap, and a wrong answer a
  large one.

Each configuration file's ``limits`` names the numbers compared and
each one's limit (``PERF.md`` gives the readings each was set from); a
number a configuration does not name is reported and not compared.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from port_bench.reference import pipeline as R

def match(prog: np.ndarray, ref: np.ndarray, share: float = 0.25) -> list:
    """Greedy matching: each program row in keep order takes the unmatched
    reference row nearest to it (the largest of the four coordinate
    gaps), if that gap is at most ``share`` of the reference box's longer
    side (8 px at least: boxes clamped to the frame's edge can have no
    area). Returns (program index, reference index) pairs."""
    taken, pairs = set(), []
    for i in range(len(prog)):
        best, arg = None, None
        for j in range(len(ref)):
            if j in taken:
                continue
            gap = float(np.abs(prog[i, :4] - ref[j, :4]).max())
            if best is None or gap < best:
                best, arg = gap, j
        if arg is None:
            continue
        side = max(ref[arg, 2] - ref[arg, 0], ref[arg, 3] - ref[arg, 1], 8.0)
        if best <= share * side:
            taken.add(arg)
            pairs.append((i, arg))
    return pairs


def detector_numbers(prog_rows: Sequence[np.ndarray], ref: Sequence[tuple]
                     ) -> Dict[str, float]:
    """``prog_rows[f]``: the program's (P, 5) rows of frame f; ``ref[f]``:
    the reference's (rows, person candidates) of it (``R.detect`` with
    ``candidates``).

    ``frames_emptied``: the share of the frames in which the reference
    keeps two people or more that the program returns no row for (a
    detector that leaves frames out; one person may sit at the
    threshold's edge, where rounding decides). ``det_box_px_median``: the
    median over the program's rows of each row's widest coordinate gap to
    the reference row that ``match`` pairs it with, 1000 px where there is
    none (a box moved, or made up, where it is produced).

    Reported, not compared: each program row read against the reference
    candidate nearest to it, ``det_box_px`` the widest box gap,
    ``det_score_err`` the widest score gap and ``det_score_err_median``
    their median, ``det_score_off_share`` the share of rows whose score is
    off by more than 0.01; rows of one side that the other lacks in
    ``people_unmatched``, over the reference's rows."""
    unmatched = n_ref = people = 0
    emptied = crowded = 0
    box_gaps, score_errs, pair_gaps = [], [], []
    for p, (r, cand) in zip(prog_rows, ref):
        pairs = match(p, r)
        unmatched += (len(p) - len(pairs)) + (len(r) - len(pairs))
        n_ref += len(r)
        people += len(p)
        if len(r) >= 2:
            crowded += 1
            emptied += len(p) == 0
        paired = dict(pairs)
        pair_gaps += [float(np.abs(p[i, :4] - r[paired[i], :4]).max())
                      if i in paired else 1e3 for i in range(len(p))]
        for i in range(len(p)):
            if len(cand) == 0:      # no reference candidate at all
                box_gaps.append(1e3)
                score_errs.append(1.0)
                continue
            gaps = np.abs(cand[:, :4] - p[i, :4]).max(1)
            k = int(np.argmin(gaps))
            box_gaps.append(float(gaps[k]))
            score_errs.append(abs(float(p[i, 4] - cand[k, 4])))
    errs = np.asarray(score_errs)
    return {'frames_emptied': emptied / max(crowded, 1),
            'det_box_px_median': float(np.median(pair_gaps)) if pair_gaps
            else 0.0,
            'people_unmatched': unmatched / max(n_ref, 1),
            'det_box_px': max(box_gaps, default=0.0),
            'det_score_err': float(errs.max()) if len(errs) else 0.0,
            'det_score_err_median': float(np.median(errs)) if len(errs)
            else 0.0,
            'det_score_off_share': float(np.mean(errs > 0.01)) if len(errs)
            else 0.0,
            'people': people, 'ref_people': n_ref}


@torch.no_grad()
def pose_numbers(pose, frames_rgb: Sequence[torch.Tensor],
                 rows: Sequence[np.ndarray], outs: Sequence[tuple],
                 res_hw, max_people: int, block: int = 32
                 ) -> Dict[str, float]:
    """``rows[f]``: the program's valid detector rows of frame f (keep
    order); ``outs[f]``: the stream's (boxes (n, 4), keypoints (n, J, 3))
    for it; ``pose`` the reference pose model."""
    aspect = res_hw[0] / res_hw[1]
    mismatch, jobs = 0, []
    for f, (r, (boxes, pts)) in enumerate(zip(rows, outs)):
        n = min(len(r), max_people)
        if len(boxes) != n:
            mismatch += abs(len(boxes) - n) + 1
        for p in range(min(n, len(boxes))):
            rounded = np.round(r[p, :4].astype(np.float32))
            window = R.pad_to_aspect(rounded, aspect)
            if not np.array_equal(window, np.asarray(boxes[p], np.float64)):
                mismatch += 1
            jobs.append((f, window, rounded, pts[p]))
    gaps, errs = [], []
    for s in range(0, len(jobs), block):
        part = jobs[s:s + block]
        crops = torch.stack([R.crop(frames_rgb[f], window, rounded, res_hw)
                             for f, window, rounded, _ in part])
        hms = R.heatmaps(pose, crops)
        for (f, window, _, pts), hm in zip(part, hms):
            j, h, w = hm.shape
            x1, y1, x2, y2 = window
            flat = hm.reshape(j, -1)
            top, low = flat.max(1), flat.min(1)
            span = np.maximum(top - low, 1e-12)
            row = np.rint((pts[:, 0] - y1) / max(y2 - y1, 1e-9) * h)
            col = np.rint((pts[:, 1] - x1) / max(x2 - x1, 1e-9) * w)
            inside = (row >= 0) & (row < h) & (col >= 0) & (col < w)
            at = flat[np.arange(j), (np.clip(row, 0, h - 1) * w
                                     + np.clip(col, 0, w - 1)).astype(int)]
            # a keypoint outside its own box: a gap no heatmap gives
            gaps += np.where(inside, (top - at) / span, 1e3).tolist()
            errs += (np.abs(pts[:, 2] - top) / span).tolist()
    return {'box_mismatch': mismatch, 'kp_gap': max(gaps, default=0.0),
            'conf_err': max(errs, default=0.0),
            'conf_err_median': float(np.median(errs)) if errs else 0.0,
            'people_posed': len(jobs)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= v for k, v in limits.items())


def report(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, dict]:
    """Each compared number beside its limit."""
    return {k: {'value': numbers[k], 'limit': v} for k, v in limits.items()}


def sample_chunks(seed: int, n_chunks: int, k: int) -> List[int]:
    """``k`` chunk indices of ``n_chunks``, drawn from the seed, always
    with the last (the window's latest answers) among them."""
    from port_bench.harness.weights import sub_seed
    rng = np.random.default_rng(sub_seed(seed, 3))
    if n_chunks <= k:
        return list(range(n_chunks))
    pick = set(rng.choice(n_chunks - 1, size=k - 1, replace=False).tolist())
    return sorted(pick | {n_chunks - 1})
