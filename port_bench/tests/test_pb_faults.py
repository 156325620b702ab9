"""A whole run on the CPU, the look for a card skipped, with the timed path
broken underneath: ``correct`` must come out false for each fault a cell
can have (a cell of one chip has no exchange between chips to leave
out; half of a batch is left out of the pose model's and of the
detector's; a detector box altered where it is produced is held only
where the configuration compares the detector's boxes, config 1). And the
lower-precision control, at a size a test run holds, and on the card at
the cells' own sizes."""

import tempfile

import pytest
import torch

from port_bench import control
from port_bench.harness import runner
from port_bench.tests import small


def _wrap_runners(model, wrap):
    for key, run in list(model._fused_runs.items()):
        model._fused_runs[key] = wrap(run)


def answer_altered(model, refs):
    """A keypoint moved where the pose tail produces it."""
    def wrap(run):
        def altered(frames):
            valid, boxes, hm, pts = run(frames)
            pts = pts.clone()
            pts[..., 0, 0] += 24.0
            return valid, boxes, hm, pts
        return altered
    _wrap_runners(model, wrap)


def box_altered(model, refs):
    """The detector's rows shifted where it produces them."""
    inner = model.detector.detect_padded

    def shifted(frames):
        rows, valid = inner(frames)
        rows = rows.clone()
        rows[..., :4] += 12.0
        return rows, valid
    model.detector.detect_padded = shifted


def detector_half_batch(model, refs):
    """Half of each detector batch left out: the second half of each
    chunk's frames get no rows."""
    inner = model.detector.detect_padded

    def halved(frames):
        rows, valid = inner(frames)
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        return rows, valid
    model.detector.detect_padded = halved


def detector_empty(model, refs):
    """The detector returns no rows for any frame."""
    inner = model.detector.detect_padded

    def empty(frames):
        rows, valid = inner(frames)
        return rows, torch.zeros_like(valid)
    model.detector.detect_padded = empty


def state_unchanged(model, refs):
    """Every launch returns what the first one did."""
    def wrap(run):
        first = []

        def stale(frames):
            if not first:
                first.append(run(frames))
            return first[0]
        return stale
    _wrap_runners(model, wrap)


class _Half(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        n = x.shape[0]
        y = self.inner(x[:max(n // 2, 1)])
        return torch.cat([y, y.new_zeros((n - y.shape[0], *y.shape[1:]))])


def half_batch(model, refs):
    """Half of each pose batch left out: its heatmaps never computed
    (zeros), the other half's as computed."""
    model._models[0] = _Half(model._models[0])


@pytest.fixture(scope='module')
def bench():
    root = tempfile.mkdtemp(prefix='pb_faults_')
    return small.make_bench(root), root


@pytest.mark.parametrize('cell,fault', [
    (cell, fault) for cell in ('small_w8_video', 'small_res18_video')
    for fault in (answer_altered, state_unchanged, half_batch,
                  detector_half_batch, detector_empty)] + [
    ('small_w8_video', box_altered)],
    ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_fault_is_not_correct(bench, cell, fault):
    b, root = bench
    torch.set_num_threads(4)
    line = runner.run_cell(cell, 2 ** 32 + 3, 2.0, False,
                           device='cpu', bench=b, bench_dir=root,
                           fault=fault)
    numbers = line.pop('_extras')['numbers']
    assert numbers['ref_people'] > 0
    assert not line['correct'], numbers


def test_fp8_control_is_not_correct(bench):
    b, root = bench
    torch.set_num_threads(4)
    line = runner.run_cell('small_w8_video', 2 ** 32 + 5, 2.0, False,
                           device='cpu', bench=b, bench_dir=root,
                           fault=control.fp8_reference)
    numbers = line.pop('_extras')['numbers']
    assert not line['correct'], numbers


@pytest.mark.cuda
@pytest.mark.parametrize('cell', ['w48_yolov3_crowd_video',
                                  'res50_yolov5m_sparse_video',
                                  'w48_yolov3_live_8cam'])
def test_control_on_card_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    for seed in (101, 102, 103):
        line = runner.run_cell(cell, seed, 4.0, False, device='cuda',
                               fault=control.fp8_reference)
        assert not line['correct'], line['checks']
