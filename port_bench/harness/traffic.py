"""The camera traffic: synthetic frames drawn from the seed, and the closed-
and open-loop sources that feed them to the stream.

A mix file gives the frame size, the ring of distinct frames the source
cycles through, the stream's settings and the loop: ``closed`` (the
next frame is offered as soon as the stream asks, so the card sets the
pace) or ``open`` (``cameras`` synchronised cameras deliver one frame each
per tick, ticks due at ``tick_hz``, whatever the stream does).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch


@torch.no_grad()
def smooth_frames(n: int, h: int, w: int, seed: int,
                  device: torch.device) -> np.ndarray:
    """``n`` synthetic BGR uint8 frames: smooth blobs over noise (six
    Gaussian blobs of radius 30-120 px and colour 60-190 over uniform
    0-60 noise), drawn on ``device`` from ``seed`` in a few large calls,
    returned on the host as a camera would deliver them."""
    from port_bench.harness.weights import sub_seed
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 1))
    frames = torch.rand((n, h, w, 3), generator=g, device=device) * 60.0
    cy = torch.rand((n, 6), generator=g, device=device) * h
    cx = torch.rand((n, 6), generator=g, device=device) * w
    r = 30.0 + torch.rand((n, 6), generator=g, device=device) * 90.0
    col = 60.0 + torch.rand((n, 6, 3), generator=g, device=device) * 130.0
    yy = torch.arange(h, device=device, dtype=torch.float32)
    xx = torch.arange(w, device=device, dtype=torch.float32)
    for b in range(6):
        gy = torch.exp(-(yy[None, :] - cy[:, b, None]) ** 2
                       / (2 * r[:, b, None] ** 2))            # (n, h)
        gx = torch.exp(-(xx[None, :] - cx[:, b, None]) ** 2
                       / (2 * r[:, b, None] ** 2))            # (n, w)
        frames += (gy[:, :, None, None] * gx[:, None, :, None]
                   * col[:, b, None, None, :])
    return frames.clamp(0, 255).to(torch.uint8).cpu().numpy()


class Source:
    """The frames offered to ``predict_stream``, one at a time, forever.

    Frame i is ``ring[i % len(ring)]``. ``due[i]`` is when frame i was due
    (open loop: its tick's due time; closed loop: when the stream asked
    for it) and ``pulled[i]`` when the stream took it; both on
    ``time.perf_counter``. ``marks`` is called with the index of each
    chunk's first frame as the stream pulls it (the tracer's chunk
    boundaries). ``stop`` ends the source after the current frame."""

    def __init__(self, ring: np.ndarray, mix: dict, marks=None):
        self.ring = ring
        self.open = mix['loop'] == 'open'
        self.cameras = int(mix.get('cameras', 1))
        self.hz = float(mix.get('tick_hz', 0.0))
        self.batch = int(mix['batch_frames'])
        self.due: List[float] = []
        self.pulled: List[float] = []
        self.marks = marks
        self.t0 = None
        self.stopped = False

    def __iter__(self):
        i = 0
        n = len(self.ring)
        while not self.stopped:
            if self.open:
                if self.t0 is None:
                    self.t0 = time.perf_counter()
                due = self.t0 + (i // self.cameras) / self.hz
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            else:
                due = time.perf_counter()
            if self.marks is not None and i % self.batch == 0:
                self.marks(i)
            self.due.append(due)
            self.pulled.append(time.perf_counter())
            yield self.ring[i % n]
            i += 1


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of ``values``, linear between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def open_loop_latencies(due: List[float], yielded: List[float],
                        first: int, count: int) -> np.ndarray:
    """Milliseconds from each frame's due time to the moment the stream
    yielded its result, for frames ``first .. first + count - 1``. A
    stall delays every frame behind it: their due times do not move."""
    d = np.asarray(due[first:first + count], np.float64)
    y = np.asarray(yielded[first:first + count], np.float64)
    if len(y) != count:
        raise ValueError(f'{count - len(y)} frames of the window never '
                         f'yielded a result')
    return (y - d) * 1e3
