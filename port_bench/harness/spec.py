"""Finding a cell's parts by name.

A cell of ``BENCHMARK.json`` names a configuration, a traffic mix and a
chip count. Each part is a file of its own, found by name:
``configs/<config>.json``, ``mixes/<traffic>.json`` and, for each
per-layer metric, ``metrics/<metric>.py`` (a module with ``read(run)``).
Adding a configuration, a mix or a metric adds files and entries; no file
of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_file(repo: str = REPO_DIR) -> dict:
    path = os.path.join(repo, 'BENCHMARK.json')
    if not os.path.exists(path):
        raise FileNotFoundError(f'no BENCHMARK.json at {repo}')
    return load_json(path)


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, 'configs', f'{name}.json'))


def mix(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, 'mixes', f'{name}.json'))


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        f'port_bench_metric_{name.replace(".", "_").replace("-", "_")}',
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its parts loaded."""
    name: str
    chips: int
    config_name: str
    traffic: str
    config: dict
    mix: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _applies(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def cell(name: str, bench: Optional[dict] = None,
         bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` by default): its
    configuration, mix, and the end-to-end and per-layer metrics it
    reports. A per-layer metric without a ``workloads`` list is reported
    wherever the end-to-end metric it moves is."""
    bench = benchmark_file() if bench is None else bench
    found = [w for w in bench['workloads'] if w['name'] == name]
    if not found:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json (have '
                       f'{[w["name"] for w in bench["workloads"]]})')
    w = found[0]
    e2e = [m for m in bench['end_to_end'] if _applies(m, name)]
    e2e_names = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer']
                 if (name in m['workloads'] if 'workloads' in m
                     else m['moves'] in e2e_names)]
    return Cell(name=name, chips=int(w['chips']), config_name=w['config'],
                traffic=w['traffic'],
                config=config(w['config'], bench_dir),
                mix=mix(w['traffic'], bench_dir), end_to_end=e2e,
                per_layer=per_layer)


def readers(c: Cell, bench_dir: str = BENCH_DIR) -> Dict[str, Callable]:
    return {m['name']: metric_reader(m['name'], bench_dir)
            for m in c.per_layer}
