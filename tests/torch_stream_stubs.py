"""Detector stubs and frames of the port's stream tests (JAX-free).

``VaryStub`` is the torch twin of ``tests/test_api.py``'s ``_VaryStub``:
the person count of a frame is a pure function of its mean pixel value
(count = mean // 32, capped at 8), over fixed score-ordered rows, so a test
steers the count frame by frame. Its rows live on the device it is built
for, and it reads nothing back, so a stream that uses it stays free of
host synchronizations.
"""

import numpy as np
import torch

N_ROWS = 8


def stub_rows() -> np.ndarray:
    """(8, 7) rows: (x1, y1, x2, y2, conf, cls_conf, cls) of 8 people."""
    rows = np.zeros((N_ROWS, 7), np.float32)
    rows[:, :4] = [[10.0 + 3 * i, 5.0 + 2 * i, 60.0 + 3 * i, 90.0]
                   for i in range(N_ROWS)]
    rows[:, 4:6] = 0.9
    return rows


class VaryStub:
    """``detect_padded`` of (F, H, W, 3) RGB frames -> rows (F, 8, 7) and
    valid (F, 8), with mean // 32 people (capped at 8) a frame."""

    def __init__(self, device='cpu'):
        self.rows = torch.from_numpy(stub_rows()).to(device)

    def detect_padded(self, frames):
        n = torch.clamp((frames.float().mean(dim=(1, 2, 3)) / 32.0)
                        .to(torch.int32), 0, N_ROWS)
        slot = torch.arange(N_ROWS, device=frames.device)
        return (self.rows.expand(frames.shape[0], N_ROWS, 7),
                slot[None, :] < n[:, None])


def frames_with_counts(counts, shape=(100, 120, 3)):
    """Constant BGR frames whose mean is 32 * count + 16, so ``VaryStub``
    finds exactly ``count`` people in each."""
    return [np.full(shape, 32 * c + 16, np.uint8) for c in counts]
