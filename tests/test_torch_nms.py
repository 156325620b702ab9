"""K1's plain version (``ops/cuda/nms.nms_plain``, through
``ops/nms.nms_ingraph``) against the JAX package's ``nms_jax`` at the edge
cases the Hopper kernel's design has to get right, on the CPU.

On CPU tensors the wrapper runs ``nms_plain``, the kernel's oracle on the
card (tests/test_torch_cuda_nms.py holds the kernel against it at the same
cases). Here it is held against the function the kernel replaces:
unsorted scores with exact ties, N = 1000, ``max_out`` above N, inverted
and zero-area boxes with NaN scores, thresholds 0 and negative, batches 1
and 8 against ``jax.vmap``, and the Pallas kernel itself, run interpreted
as tests/test_pallas.py runs it. Every comparison is exact: same indices,
same valid flags, slot for slot.
"""

import numpy as np
import pytest

import jax
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.ops import nms as JN
from simple_hrnet_tpu_torch.ops.nms import nms_ingraph


def _boxes_scores(rng, shape, levels=None, pad=0.1):
    """Boxes over a 450-pixel frame and scores in (0, 1]; ``levels`` rounds
    the scores to that many steps (exact ties); a ``pad`` share is 0."""
    xy = rng.uniform(0, 300, (*shape, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 150, (*shape, 2))], -1)
    scores = rng.uniform(0.01, 1.0, shape)
    if levels is not None:
        scores = np.ceil(scores * levels) / levels
    scores[rng.uniform(0, 1, shape) < pad] = 0.0
    return boxes.astype(np.float32), scores.astype(np.float32)


def _check_one(boxes, scores, thresh, max_out):
    ref_idx, ref_valid = JN.nms_jax(boxes, scores, thresh, max_out=max_out)
    idx, valid = nms_ingraph(torch.from_numpy(boxes),
                             torch.from_numpy(scores), thresh, max_out)
    assert idx.shape == valid.shape == (max_out,)
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    return valid.numpy()


def test_unsorted_scores_with_ties():
    rng = np.random.default_rng(40)
    boxes, scores = _boxes_scores(rng, (256,), levels=4)
    assert not np.all(np.diff(scores) <= 0)  # not in the detector's order
    valid = _check_one(boxes, scores, 0.45, 32)
    assert valid.sum() == 32


def test_n_1000():
    rng = np.random.default_rng(41)
    boxes, scores = _boxes_scores(rng, (1000,), levels=16)
    _check_one(boxes, scores, 0.45, 100)


def test_max_out_above_n_and_live_count():
    rng = np.random.default_rng(42)
    boxes, scores = _boxes_scores(rng, (20,), pad=0.3)
    valid = _check_one(boxes, scores, 0.45, 40)
    assert 0 < valid.sum() < 20


def test_inverted_and_zero_area_boxes_and_nan_scores():
    rng = np.random.default_rng(43)
    boxes, scores = _boxes_scores(rng, (96,), levels=8)
    boxes[:20, 2:] = boxes[:20, :2] - rng.uniform(1, 40, (20, 2))  # inverted
    boxes[20:30, 2] = boxes[20:30, 0]  # zero width
    boxes[30:34] = boxes[34:38]  # duplicates
    scores[40:45] = np.nan
    _check_one(boxes, scores, 0.45, 64)


@pytest.mark.parametrize('thresh', [0.0, -0.25])
def test_threshold_zero_and_negative(thresh):
    """At thresh 0 a box suppresses every box it overlaps at all; below 0
    also the disjoint ones (IoU 0 > thresh), which the kernel's
    ``inter == 0`` shortcut must leave to the division."""
    rng = np.random.default_rng(44)
    boxes, scores = _boxes_scores(rng, (128,), levels=8)
    boxes[:8, 2] = boxes[:8, 0] - 5.0  # inverted in x: negative areas
    valid = _check_one(boxes, scores, thresh, 32)
    if thresh < 0:  # every IoU here is finite, so the best box removes all
        assert valid.sum() == 1


@pytest.mark.parametrize('bsz', [1, 8])
def test_batched_matches_vmapped_nms_jax(bsz):
    rng = np.random.default_rng(45 + bsz)
    boxes, scores = _boxes_scores(rng, (bsz, 256), levels=64, pad=0.22)
    ref_idx, ref_valid = jax.vmap(
        lambda b, s: JN.nms_jax(b, s, 0.4, 32))(boxes, scores)
    idx, valid = nms_ingraph(torch.from_numpy(boxes),
                             torch.from_numpy(scores), 0.4, 32)
    assert idx.shape == valid.shape == (bsz, 32)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


def test_matches_the_pallas_kernel_interpreted():
    from jax.experimental.pallas import tpu as pltpu
    from simple_hrnet_tpu.ops.pallas.nms_pallas import nms_pallas

    rng = np.random.default_rng(47)
    boxes, scores = _boxes_scores(rng, (3, 128), levels=8)
    with pltpu.force_tpu_interpret_mode():  # CPU test env
        ref_idx, ref_valid = jax.vmap(
            lambda b, s: nms_pallas(b, s, 0.45, 32))(boxes, scores)
    idx, valid = nms_ingraph(torch.from_numpy(boxes),
                             torch.from_numpy(scores), 0.45, 32)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
