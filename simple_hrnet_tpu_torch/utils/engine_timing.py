"""Time an HRNet engine (``utils/export.py``) against the eager model on a
card, in a fresh process.

    python3 -m simple_hrnet_tpu_torch.utils.engine_timing \
        [--width 48] [--dtype bfloat16] [--batch 16] [--reps 10]

From a seeded random ``.pth`` at the width's published resolution (W48
384x288, W32 256x192) it exports the kernel engine (``fused=True``) on the
card, timing the export and the load, and then times, on the host clock
and alternating call for call with the eager model the facade builds
(both in true f32, as the facade runs its pose model):
  * one pose forward at the engine batch;
  * the pose stage of an 8-frame multi-person ``predict`` with 32 people a
    frame: 256 crops in the facade's power-of-two buckets (16, 32 x 7,
    16), one eager forward per bucket, ``Engine.apply`` (engine calls of
    the engine batch) on the same buckets.
Prints one JSON line (medians in ms, and the card's name and power limit).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

RESOLUTION = {48: (384, 288), 32: (256, 192)}
# the pose batches of an 8-frame predict with 32 people a frame at
# max_batch_size 32: the first bucket of 2 people a frame, then the rest
PREDICT8_BUCKETS = (16, 32, 32, 32, 32, 32, 32, 32, 16)


def _median_ms(fns, reps):
    """Each of ``fns`` called ``reps`` times in turn, synchronized after
    each call; the median host ms of each."""
    secs = [[] for _ in fns]
    for _ in range(reps):
        for i, fn in enumerate(fns):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs[i].append(time.perf_counter() - t0)
    return [1e3 * float(np.median(s)) for s in secs]


@torch.no_grad()
def main(width: int = 48, dtype: str = 'bfloat16', batch: int = 16,
         reps: int = 10) -> dict:
    from simple_hrnet_tpu_torch import SimpleHRNet
    from simple_hrnet_tpu_torch.models import hrnet
    from simple_hrnet_tpu_torch.ops.cuda import build
    from simple_hrnet_tpu_torch.utils.device import true_f32
    from simple_hrnet_tpu_torch.utils.export import Engine, export_engine

    build.build_all()
    res = RESOLUTION[width]
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        pth = os.path.join(tmp, f'w{width}.pth')
        torch.save(hrnet.init(width, 17, seed=0).state_dict(), pth)
        t0 = time.perf_counter()
        path = export_engine(os.path.join(tmp, 'e.torchpose'), pth,
                             c=width, resolution=res, batch_size=batch,
                             fused=True, half=dtype == 'bfloat16',
                             int8=dtype == 'int8', device='cuda')
        t1 = time.perf_counter()
        engine = Engine(path)
        t2 = time.perf_counter()
        eager = SimpleHRNet(width, 17, pth, resolution=res, multiperson=False,
                            dtype=None if dtype == 'float32' else dtype,
                            device='cuda').model
    x = torch.randn((max(PREDICT8_BUCKETS), *res, 3), device='cuda')

    def eager_f32(n):
        # the facade runs its pose model in true f32, as Engine does
        with true_f32():
            return eager(x[:n])

    forward = _median_ms([lambda: eager_f32(batch),
                          lambda: engine(x[:batch])], reps)
    stage = _median_ms([lambda: [eager_f32(b) for b in PREDICT8_BUCKETS],
                        lambda: [engine.apply(x[:b])
                                 for b in PREDICT8_BUCKETS]], reps)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = dict(width=width, dtype=dtype, batch=batch, card=card,
               export_s=t1 - t0, load_s=t2 - t1,
               graph_nodes=len(engine.program.graph.nodes),
               forward_ms={'eager': forward[0], 'engine': forward[1]},
               predict8_pose_stage_ms={'eager': stage[0],
                                       'engine': stage[1]},
               predict8_calls={'eager': len(PREDICT8_BUCKETS),
                               'engine': sum(-(-b // batch) for b in
                                             PREDICT8_BUCKETS)})
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--width', type=int, default=48, choices=(32, 48))
    ap.add_argument('--dtype', default='bfloat16',
                    choices=('float32', 'bfloat16', 'int8'))
    ap.add_argument('--batch', type=int, default=16)
    ap.add_argument('--reps', type=int, default=10)
    main(**vars(ap.parse_args()))
