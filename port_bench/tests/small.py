"""Small copies of the benchmark's cells for the CPU tests: the same
harness, program and reference at sizes a test run holds (HRNet-W8 at
128x96, PoseResNet-50 at 128x96, 96x128 frames, two-frame chunks; the
detectors keep the input sizes the program's facade gives them, YOLOv3 at
416 and YOLOv5m at 640), in a bench directory of their own."""

from __future__ import annotations

import copy
import json
import os
import shutil

from port_bench.harness import spec

CELLS = {
    'small_w8_video': ('hrnet_w48_384x288-yolov3_416-bf16', 'crowd_video'),
    'small_res18_video': ('poseresnet50_256x192-yolov5m_640-bf16',
                          'sparse_video'),
    'small_w8_live': ('hrnet_w48_384x288-yolov3_416-bf16', 'live_8cam'),
}


def small_config(name: str) -> dict:
    cfg = spec.config(name)
    cfg['dtype'] = None             # f32 on the CPU
    if cfg['pose']['kind'] == 'hrnet':
        cfg['pose'].update(c=8, res=[128, 96])
    else:
        cfg['pose'].update(res=[128, 96])
    return cfg


def small_mix(name: str) -> dict:
    mix = spec.mix(name)
    mix.update(frame_hw=[96, 128], ring=4, batch_frames=2, warm_chunks=1,
               trace_chunks=2, check_chunks=2, tick_hz=2.0, prefetch=1,
               max_people=min(mix['max_people'], 4))
    if 'cameras' in mix:
        mix['cameras'] = 2
    mix['calibration_frames'] = 4
    for det in mix.get('scene', {}).values():
        det['people_per_frame'] = 4
    return mix


def make_bench(root: str) -> dict:
    """A bench directory under ``root`` holding the small cells, the
    benchmark's metric readers, and its BENCHMARK dict."""
    for sub in ('configs', 'mixes'):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    shutil.copytree(os.path.join(spec.BENCH_DIR, 'metrics'),
                    os.path.join(root, 'metrics'), dirs_exist_ok=True)
    bench = copy.deepcopy(spec.benchmark_file())
    workloads = []
    for cell, (cfg, mix) in CELLS.items():
        with open(os.path.join(root, 'configs', f'{cell}.json'), 'w') as f:
            json.dump(small_config(cfg), f)
        with open(os.path.join(root, 'mixes', f'{cell}.json'), 'w') as f:
            json.dump(small_mix(mix), f)
        big = [w for w in bench['workloads'] if w['config'] == cfg
               and w['traffic'] == mix][0]
        workloads.append(dict(big, name=cell, config=cell, traffic=cell))
        for m in bench['end_to_end'] + bench['per_layer']:
            if big['name'] in m.get('workloads', ()):
                m['workloads'] = m['workloads'] + [cell]
    bench['workloads'] = workloads
    return bench
