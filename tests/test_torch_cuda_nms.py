"""K1 (the NMS kernel pair, ``csrc/nms.cu``) against its plain version, on a
card: detector-like inputs, unsorted scores with exact ties, all padding,
``max_out`` above the live count and above N, N from 1 to 1024 at batches
1 and 8, zero-area and inverted boxes, NaN scores, thresholds 0 and
negative (where the kernel's ``inter == 0`` shortcut must not apply), the
inputs the wrapper refuses, and a CUDA-graph replay.

Marked ``cuda``; skips on a host without a CUDA device. Imports neither
JAX nor the JAX package, so it runs on a GPU host without JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_nms.py

Tolerance: slot for slot (``torch.equal`` on the indices and the valid
flags): the kernel's IoU is the plain version's IEEE arithmetic, and its
greedy order is the same function.
"""

import numpy as np
import pytest
import torch

from simple_hrnet_tpu_torch.ops.cuda import nms as TN


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _inputs(dev, rng, bsz, n, levels=8, pad=0.1):
    xy = rng.uniform(0, 300, (bsz, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 150, (bsz, n, 2))], -1)
    scores = np.ceil(rng.uniform(0.01, 1.0, (bsz, n)) * levels) / levels
    scores[rng.uniform(0, 1, (bsz, n)) < pad] = 0.0
    return (torch.tensor(boxes, dtype=torch.float32, device=dev),
            torch.tensor(scores, dtype=torch.float32, device=dev))


def _check(boxes, scores, thresh, max_out):
    """The kernel equals the plain version slot for slot; one launch a
    call. Returns the valid flags."""
    launches = TN.nms.launches
    idx, valid = TN.nms(boxes, scores, thresh, max_out)
    assert TN.nms.launches == launches + 1
    pidx, pvalid = TN.nms_plain(boxes, scores, thresh, max_out)
    torch.cuda.synchronize()
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    assert torch.equal(valid, pvalid)
    assert torch.equal(idx, pidx)
    return valid


@pytest.mark.cuda
def test_nms_kernel_matches_plain(dev):
    rng = np.random.default_rng(30)
    n = 256
    xy = rng.uniform(0, 300, (3, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 150, (3, n, 2))], -1)
    scores = np.ceil(rng.uniform(0.01, 1.0, (3, n)) * 8) / 8  # ties
    scores[rng.uniform(0, 1, (3, n)) < 0.1] = 0.0
    bt = torch.tensor(boxes, dtype=torch.float32, device=dev)
    st = torch.tensor(scores, dtype=torch.float32, device=dev)
    launches = TN.nms.launches
    idx, valid = TN.nms(bt, st, 0.45, 32)
    pidx, pvalid = TN.nms_plain(bt, st, 0.45, 32)
    assert TN.nms.launches == launches + 1
    assert torch.equal(idx, pidx) and torch.equal(valid, pvalid)


@pytest.mark.cuda
def test_nms_kernel_sizes_and_batches(dev):
    """N around the 32-candidate word and chunk edges and at the largest
    the kernel takes, at batches 1 and 8, detector-sorted scores."""
    rng = np.random.default_rng(31)
    for n in (1, 31, 33, 1000, 1024):
        for bsz in (1, 8):
            boxes, scores = _inputs(dev, rng, bsz, n, levels=64)
            scores = torch.sort(scores, dim=1, descending=True,
                                stable=True).values
            _check(boxes, scores, 0.45, 100 if n >= 1000 else 32)


@pytest.mark.cuda
def test_nms_kernel_unsorted_scores_with_ties(dev):
    rng = np.random.default_rng(32)
    boxes, scores = _inputs(dev, rng, 8, 256, levels=4)
    valid = _check(boxes, scores, 0.45, 32)
    assert valid.all()  # four score levels: the ties decide every slot


@pytest.mark.cuda
def test_nms_kernel_padding_and_max_out(dev):
    """All padding; max_out above the live count; max_out above N."""
    rng = np.random.default_rng(33)
    boxes, scores = _inputs(dev, rng, 4, 256)
    valid = _check(boxes, torch.zeros_like(scores), 0.45, 32)
    assert not valid.any()
    boxes, scores = _inputs(dev, rng, 4, 256, pad=0.9)
    valid = _check(boxes, scores, 0.45, 64)
    assert 0 < valid.sum(1).max() < 64
    boxes, scores = _inputs(dev, rng, 2, 20)
    valid = _check(boxes, scores, 0.45, 40)
    assert 0 < valid.sum(1).max() <= 20


@pytest.mark.cuda
def test_nms_kernel_degenerate_boxes_and_nan_scores(dev):
    rng = np.random.default_rng(34)
    boxes, scores = _inputs(dev, rng, 8, 256)
    boxes[:, :20, 2:] = boxes[:, :20, :2] - 7.0  # inverted
    boxes[:, 20:30, 2] = boxes[:, 20:30, 0]  # zero width
    boxes[:, 30:40, 3] = boxes[:, 30:40, 1]  # zero height
    boxes[:, 40:44] = boxes[:, 44:48]  # duplicates
    scores[:, 50:60] = float('nan')
    valid = _check(boxes, scores, 0.45, 64)
    assert valid.any()


@pytest.mark.cuda
@pytest.mark.parametrize('thresh', [0.0, -0.25])
def test_nms_kernel_threshold_zero_and_negative(dev, thresh):
    rng = np.random.default_rng(35)
    boxes, scores = _inputs(dev, rng, 8, 256)
    boxes[:, :8, 2] = boxes[:, :8, 0] - 5.0  # inverted in x: negative areas
    _check(boxes, scores, thresh, 32)


@pytest.mark.cuda
def test_nms_kernel_rejects_bad_inputs(dev):
    boxes = torch.zeros((2, 1025, 4), device=dev)
    with pytest.raises(ValueError):  # N above MAX_N
        TN.nms(boxes, torch.zeros((2, 1025), device=dev), 0.4, 8)
    with pytest.raises(ValueError):  # float64
        TN.nms(boxes[:, :8].double(),
               torch.zeros((2, 8), dtype=torch.float64, device=dev), 0.4, 8)
    with pytest.raises(ValueError):  # boxes not (B, N, 4)
        TN.nms(torch.zeros((2, 8, 3), device=dev),
               torch.zeros((2, 8), device=dev), 0.4, 8)
    with pytest.raises(ValueError):  # scores not (B, N)
        TN.nms(boxes[:, :8], torch.zeros((2, 9), device=dev), 0.4, 8)
    with pytest.raises(ValueError):  # negative max_out
        TN.nms(boxes[:, :8], torch.zeros((2, 8), device=dev), 0.4, -1)


@pytest.mark.cuda
def test_nms_kernel_cuda_graph_replay(dev):
    """A captured call replays on new inputs (copied into the captured
    ones) and equals the eager call on them."""
    rng = np.random.default_rng(36)
    boxes, scores = _inputs(dev, rng, 8, 256, levels=64)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        TN.nms(boxes, scores, 0.4, 32)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        idx, valid = TN.nms(boxes, scores, 0.4, 32)
    for _ in range(3):
        new_boxes, new_scores = _inputs(dev, rng, 8, 256, levels=64)
        boxes.copy_(new_boxes)
        scores.copy_(new_scores)
        graph.replay()
        eidx, evalid = TN.nms(new_boxes, new_scores, 0.4, 32)
        torch.cuda.synchronize()
        assert torch.equal(idx, eidx) and torch.equal(valid, evalid)
