"""The open-loop cell's rate: the highest tick rate the stream sustains
without a growing backlog, found once by a sweep on the card.

    python3 port_bench/sweep.py --workload <open-loop cell> --seed 5 \\
        --seconds 15 --rates 8 10 11 12 13 14

One run of the cell a rate, in one process; one JSON line a rate: the
frame latency's median and 95th percentile, and the generator's lateness
(how far behind its due time the stream took each tick) at the start and
the end of the window. A sustained rate keeps the lateness flat; above
the knee it grows through the window. The cell's mix then offers about
four fifths of the highest sustained rate. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, default=5)
    p.add_argument('--seconds', type=float, default=15.0)
    p.add_argument('--rates', type=float, nargs='+', required=True)
    args = p.parse_args(argv)
    from port_bench.harness import runner
    for hz in args.rates:
        line = runner.run_cell(args.workload, args.seed, args.seconds, False,
                               device='cuda', mix_update={'tick_hz': hz})
        extras = line.pop('_extras')
        late = extras['lateness_ms']
        tenth = max(1, len(late) // 10)
        lat = line['metrics']['frame_latency_p95_ms']['value']
        print(json.dumps({
            'tick_hz': hz, 'p95_ms': lat,
            'correct': line['correct'],
            'lateness_first_tenth_ms': float(np.median(late[:tenth])),
            'lateness_last_tenth_ms': float(np.median(late[-tenth:])),
            'lateness_max_ms': float(late.max())}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
