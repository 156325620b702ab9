"""Cells, configurations, mixes and metric readers are found by name, and
a new one is added by adding files and entries alone."""

import json
import os
import shutil

import pytest

from port_bench.harness import spec


def test_every_cell_resolves():
    bench = spec.benchmark_file()
    for w in bench['workloads']:
        cell = spec.cell(w['name'], bench)
        assert cell.config['name'] == w['config']
        assert {m['name'] for m in cell.end_to_end} >= {'setup_s'}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        moved = {m['moves'] for m in cell.per_layer}
        assert moved <= {m['name'] for m in cell.end_to_end}
        for name, read in spec.readers(cell).items():
            assert callable(read), name


def test_config_files_match_benchmark():
    bench = spec.benchmark_file()
    for c in bench['configs']:
        assert os.path.exists(os.path.join(spec.REPO_DIR, c['file']))
        assert spec.config(c['name'])['reduced'] == c['reduced']


def test_add_config_mix_metric_by_files(tmp_path):
    root = tmp_path / 'bench'
    shutil.copytree(spec.BENCH_DIR, root,
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    before = {p: open(p, 'rb').read() for p in
              (str(f) for f in root.rglob('*') if f.is_file())}
    cfg = spec.config('hrnet_w48_384x288-yolov3_416-bf16')
    cfg['name'] = 'hrnet_w32_256x192-yolov3_416-bf16'
    cfg['pose'].update(c=32, res=[256, 192])
    (root / 'configs' / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    mix = spec.mix('crowd_video')
    mix['batch_frames'] = 4
    (root / 'mixes' / 'crowd_video_4.json').write_text(json.dumps(mix))
    (root / 'metrics' / 'people_per_frame.video.py').write_text(
        'def read(run):\n    return 7.0\n')
    bench = spec.benchmark_file()
    bench['workloads'].append({'name': 'w32_crowd_4', 'config': cfg['name'],
                               'traffic': 'crowd_video_4', 'chips': 1,
                               'why': 'test'})
    bench['end_to_end'][0]['workloads'].append('w32_crowd_4')
    bench['per_layer'].append({'name': 'people_per_frame.video',
                               'unit': 'people', 'better': 'higher',
                               'source': 'program_counter',
                               'layer': 'stream', 'moves': 'frames_per_s',
                               'workloads': ['w32_crowd_4']})
    cell = spec.cell('w32_crowd_4', bench, str(root))
    assert cell.config['pose']['c'] == 32 and cell.mix['batch_frames'] == 4
    assert spec.readers(cell, str(root))['people_per_frame.video'](None) == 7
    for path, data in before.items():
        assert open(path, 'rb').read() == data, path


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.cell('no_such_cell')
