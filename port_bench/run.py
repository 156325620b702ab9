"""The port's benchmark: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs the cell of ``BENCHMARK.json`` named by ``--workload`` once on the
CUDA card(s) of this machine and prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; the numbers
compared with the reference come last, under ``checks``, and again as the
last lines of standard error. Exits non-zero, with no result, without a
CUDA card (or with fewer than the cell asks for), without the program
beside the benchmark, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi unavailable ({e})'


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from port_bench.harness import runner, spec
    try:
        cell = spec.cell(args.workload)
    except (FileNotFoundError, KeyError) as e:
        runner.log(f'no such cell: {e}')
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        runner.log(f'this cell needs {cell.chips} CUDA card(s); '
                   f'{torch.cuda.device_count()} visible')
        return 2
    try:
        import simple_hrnet_tpu_torch  # noqa: F401
    except ImportError as e:
        runner.log(f'the program (simple_hrnet_tpu_torch) is not here: {e}')
        return 2
    runner.log(f'card: {card_line()}; torch {torch.__version__} '
               f'(CUDA {torch.version.cuda})')
    line = runner.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device='cuda',
                           t_start=T_START)
    extras = line.pop('_extras')
    runner.log(f'setup_s {extras["setup_s"]:.3f}; numbers {extras["numbers"]}')
    for name, c in line['checks'].items():
        runner.log(f'check {name}: {c["value"]} (limit {c["limit"]})')
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
