"""Print a golden config's detector rows (x1, y1, x2, y2, score) frame by
frame, below the detector's own threshold too, so that a candidate near
the threshold shows with its score.

The port's rows on the CPU (or ``--device cuda``); with ``--jax`` also the
JAX package's (its default stem and the plain stem the port runs, where
the detector has a phase stem), on the CPU. Without ``--jax`` nothing of
JAX is imported. Run from the repository root:

    python tests/torch_detector_rows.py video_yolov5m_w48 bfloat16 \\
        --conf 0.3 [--device cuda] [--jax]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch_goldens as G  # noqa: E402


def _print(label, rows):
    for i, r in enumerate(rows):
        print(f'{label} frame {i}: {len(r)} rows')
        for row in r:
            print('    ' + ' '.join(f'{v:.6f}' for v in row))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('config')
    ap.add_argument('dtype')
    ap.add_argument('--conf', type=float, default=0.3,
                    help='the detectors\' score threshold for this print')
    ap.add_argument('--device', default='cpu')
    ap.add_argument('--jax', action='store_true',
                    help='also the JAX package\'s rows (CPU)')
    args = ap.parse_args(argv)
    cfg = G.CONFIGS[args.config]
    frames = G.config_frames(args.config)[:cfg['dtypes'][args.dtype]]
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: v[0] for k, v in G.write_weights(
            tmp, G.config_weights(args.config)).items()}
        model = G.port_facade(args.config, paths, args.dtype,
                              device=args.device)
        model.detector.conf_thres = args.conf
        _print(f'port ({args.device})',
               G.detector_rows(model.detector, frames))
        if args.jax:
            import jax
            jax.config.update('jax_platforms', 'cpu')
            from simple_hrnet_tpu import SimpleHRNet as JaxSimpleHRNet
            from simple_hrnet_tpu.detectors import yolov5 as J5
            kw = G.facade_kwargs(args.config, paths, args.dtype)
            jm = JaxSimpleHRNet(cfg['c'], G.JOINTS, paths[cfg['pose']], **kw)
            stems = [('default stem', jm.detector)]
            if getattr(jm.detector, 'phase_stem', False):
                # the same facade with YOLOv5's stem left as one conv
                real = J5.stem_phaseable
                J5.stem_phaseable = lambda params: False
                try:
                    plain = JaxSimpleHRNet(cfg['c'], G.JOINTS,
                                           paths[cfg['pose']], **kw)
                finally:
                    J5.stem_phaseable = real
                stems.append(('plain stem', plain.detector))
            for label, det in stems:
                det.conf_thres = args.conf
                with jax.enable_x64(True):
                    _print(f'JAX ({label})', G.detector_rows(det, frames))
    gold = G.load_golden(args.config)['dtypes'][args.dtype]['frames']
    for i, f in enumerate(gold):
        print(f'golden frame {i} kept: {np.asarray(f.get("det", []))}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
