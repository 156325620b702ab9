"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

The system under test is ``simple_hrnet_tpu_torch.SimpleHRNet`` driven
through ``predict_stream`` as the cell's mix says. Everything else (the
weights, the frames, the sources, the clocks, the trace reductions, the
reference and the comparison) is the benchmark's own.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench.harness import check, spec, trace, traffic, weights

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'simple_hrnet_tpu')


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark must
    never load (compared whole: the program's own name begins with one
    of them)."""
    return sorted({m.split('.')[0] for m in list(sys.modules)
                   if m.split('.')[0] in FORBIDDEN})


def set_cache_dirs(bench_dir: str = spec.BENCH_DIR) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own kernel libraries build into its ``_build/``)."""
    root = os.path.join(bench_dir, '.cache')
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton'),
                     ('TORCHINDUCTOR_CACHE_DIR', 'inductor')):
        os.environ[var] = os.path.join(root, sub)


@dataclass
class Run:
    """What a run measured: the metric readers' input."""
    cell: spec.Cell
    seed: int
    seconds: float
    window_frames: int = 0
    fps: Optional[float] = None
    latencies_ms: Optional[np.ndarray] = None
    lateness_ms: Optional[np.ndarray] = None
    trace: Optional[trace.Trace] = None
    stretch: Optional[tuple] = None
    people: Dict[int, int] = field(default_factory=dict)   # frame -> n


def build_facade(cfg: dict, paths: Dict[str, str], device, dtype: str):
    from simple_hrnet_tpu_torch import SimpleHRNet
    pose, det = cfg['pose'], cfg['detector']
    kw = dict(model_name=pose['model_name'], resolution=tuple(pose['res']),
              multiperson=True, return_heatmaps=False,
              return_bounding_boxes=True,
              max_batch_size=cfg['facade']['max_batch_size'],
              device=device, dtype=dtype,
              use_fused_kernels=cfg['facade']['use_fused_kernels'],
              yolo_max_detections=det['max_detections'])
    if det['kind'] == 'yolov5':
        kw.update(yolo_version='v5', yolo_model_def=paths['detector'])
    else:
        kw.update(yolo_version='v3', yolo_model_def='yolov3',
                  yolo_weights_path=paths['detector'])
    return SimpleHRNet(pose['c'], pose['nof_joints'], paths['pose'], **kw)


class Capture:
    """Keeps, for every stream chunk, the detector rows and validity the
    program's detect call returned (references to its device tensors; no
    copy, no synchronization): the detector's answers, judged after the
    window."""

    def __init__(self, detector):
        self.detector = detector
        self.inner = detector.detect_padded
        self.chunks: List[tuple] = []

        def detect_padded(frames_rgb):
            out = self.inner(frames_rgb)
            self.chunks.append(out)
            return out

        detector.detect_padded = detect_padded

    def remove(self) -> None:
        del self.detector.detect_padded


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device='cuda', t_start: Optional[float] = None,
             bench: Optional[dict] = None, bench_dir: str = spec.BENCH_DIR,
             fault=None, mix_update: Optional[dict] = None) -> dict:
    """One run of cell ``name``. ``t_start``: the process's start on
    ``time.perf_counter`` (set-up is timed from it). ``fault(model, refs)``
    changes the timed path after set-up (the control, and the harness's
    own tests of faults). Returns the result line."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.cell(name, bench, bench_dir)
    cell.mix.update(mix_update or {})
    cfg, mix = cell.config, cell.mix
    dev = torch.device(device)
    set_cache_dirs(bench_dir)
    scene = mix.get('scene', {})
    tmp = tempfile.mkdtemp(prefix='port_bench_')
    marks = [('start', t_start), ('imports', time.perf_counter())]
    try:
        h, w = mix['frame_hw']
        ring = traffic.smooth_frames(mix['ring'], h, w, seed, dev)
        calib = torch.from_numpy(np.ascontiguousarray(
            ring[:int(mix['calibration_frames']), ..., ::-1])).to(dev)
        ref_pose, pose_state = weights.draw(cfg['pose'], scene, seed, 10, dev)
        ref_det, det_state = weights.draw(cfg['detector'], scene, seed, 20,
                                          dev, calib)
        log(f'detector scene: {ref_det.calibration}')
        t_move = time.perf_counter()
        ref_pose, ref_det = ref_pose.cpu(), ref_det.cpu()
        # the reference's own set-up (the objectness search and moving its
        # networks off the card) is timed apart and not counted
        reference_s = (ref_det.calibration['reference_s']
                       + time.perf_counter() - t_move)
        del calib
        if dev.type == 'cuda':   # the peak read is the program's alone
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        marks.append(('frames, weights', time.perf_counter()))
        paths = {
            'pose': weights.write(pose_state, cfg['pose']['kind'], tmp,
                                  'pose'),
            'detector': weights.write(det_state, cfg['detector']['kind'],
                                      tmp, 'detector')}
        del pose_state, det_state
        marks.append(('checkpoints written', time.perf_counter()))
        model = build_facade(cfg, paths, device, cfg['dtype'])
        marks.append(('facade', time.perf_counter()))
        bf, slots = int(mix['batch_frames']), int(mix['max_people'])
        model.warmup(frame_hw=(h, w), batch_sizes=(),
                     stream_max_people=slots, stream_batch_frames=(bf,))
        marks.append(('warmup', time.perf_counter()))
        if fault is not None:
            fault(model, {'pose': ref_pose, 'detector': ref_det})
        result = _window(cell, model, ring, seed, seconds, traced, dev,
                         t_start)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    run, outs, capture, extras = result
    marks.append(('pre-roll', t_start + extras['setup_s']))
    log('set-up s: ' + ', '.join(f'{name} {t - t0:.2f}' for (_, t0), (name, t)
                                  in zip(marks, marks[1:]))
        + f'; of it the reference\'s own {reference_s:.2f}, not counted')
    extras['setup_s'] -= reference_s
    found = forbidden_modules()
    if found:
        raise SystemExit(f'forbidden modules loaded: {found}')
    memory = (torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda'
              else 0)
    rows = [(r.cpu().numpy(), v.cpu().numpy()) for r, v in capture.chunks]
    capture.remove()
    del model, capture
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    with check.R.true_f32():
        numbers = judge(cell, run, ring, rows, outs, ref_det.to(dev),
                        ref_pose.to(dev), seed, dev)
    # a window that yielded no whole chunk has nothing to judge
    correct = numbers['frames_checked'] > 0 and \
        check.verdict(numbers, cfg['limits'])
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = spec.metric_reader(m['name'], bench_dir)(run)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        e2e = {'setup_s': extras['setup_s'], 'frames_per_s': run.fps,
               'frame_latency_p95_ms': None if run.latencies_ms is None
               else traffic.percentile(run.latencies_ms, 95)}
        for m in cell.end_to_end:
            if e2e.get(m['name']) is not None:
                metrics[m['name']] = {'value': e2e[m['name']],
                                      'unit': m['unit']}
    device_info = {'platform': 'gpu' if dev.type == 'cuda' else 'cpu',
                   'kind': (torch.cuda.get_device_name(dev)
                            if dev.type == 'cuda' else 'cpu'),
                   'count': cell.chips, 'memory_peak_bytes': int(memory)}
    line = {'correct': bool(correct), 'attempted': run.window_frames,
            'failed': extras['failed'], 'metrics': metrics,
            'device': device_info}
    if traced and run.trace is not None and run.stretch is not None:
        t0, t1, _ = run.stretch
        device_info['busy_s'] = run.trace.busy_ns(t0, t1) / 1e9
        device_info['window_s'] = (t1 - t0) / 1e9
        line['breakdown'] = breakdown(run.trace, run.stretch)
    line['checks'] = check.report(numbers, cfg['limits'])
    extras['numbers'] = numbers
    line['_extras'] = extras
    return line


def _window(cell: spec.Cell, model, ring, seed: int, seconds: float,
            traced: bool, dev, t_start: float):
    """Pre-roll, the measured window and (traced) the profiled stretch.
    Returns the run, the window's per-frame outputs by frame index, the
    detector capture and extras."""
    mix = cell.mix
    bf = int(mix['batch_frames'])
    slots = int(mix['max_people'])
    spans = None
    if traced:
        spans = trace.Spans()
        spans.wrap(model.detector.net, 'detector')
        spans.wrap(model.model, 'pose')
    prof = {'on': None, 'marks': 0, 'start_after': None, 'done': False}
    trace_chunks = int(mix['trace_chunks'])
    skip = 2

    def on_mark(frame: int) -> None:
        if not traced or prof['done'] or prof['start_after'] is None:
            return
        if prof['on'] is None:
            if time.perf_counter() < prof['start_after']:
                return
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if dev.type == 'cuda':
                acts.append(ProfilerActivity.CUDA)
            prof['on'] = profile(activities=acts, record_shapes=True)
            prof['on'].start()
        trace.mark(frame)
        prof['marks'] += 1
        if prof['marks'] > skip + trace_chunks:
            prof['on'].stop()
            prof['done'] = True

    source = traffic.Source(ring, mix, marks=on_mark)
    capture = Capture(model.detector)
    stream = model.predict_stream(iter(source), max_people=slots,
                                  prefetch=int(mix['prefetch']),
                                  batch_frames=bf)
    yielded: List[float] = []
    outs: Dict[int, tuple] = {}
    pre = int(mix['warm_chunks']) * bf
    run = Run(cell=cell, seed=seed, seconds=seconds)
    extras = {'failed': 0}
    it = iter(stream)
    for i in range(pre):
        next(it)
        yielded.append(time.perf_counter())
    if mix['loop'] == 'open':
        cams, hz = int(mix['cameras']), float(mix['tick_hz'])
        n_window = int(round(seconds * hz)) * cams
        first = pre
        t_window = source.t0 + (first // cams) / hz
        extras['setup_s'] = t_window - t_start
        prof['start_after'] = t_window + 0.4 * seconds
        last = first + n_window
        for i in range(pre, last):
            res = next(it)
            yielded.append(time.perf_counter())
            outs[i] = res
        run.window_frames = n_window
        run.latencies_ms = traffic.open_loop_latencies(
            source.due, yielded, first, n_window)
        run.lateness_ms = (np.asarray(source.pulled[first:last])
                           - np.asarray(source.due[first:last])) * 1e3
        extras['lateness_ms'] = run.lateness_ms
        thirds = np.array_split(run.latencies_ms, 3)
        log('latency p95 ms by third of the window: ' + ', '.join(
            f'{traffic.percentile(t, 95):.2f}' for t in thirds))
        log(f'open loop: {n_window} frames in {n_window // cams} ticks at '
            f'{hz} ticks/s; generator lateness ms median '
            f'{np.median(run.lateness_ms):.3f}, max '
            f'{run.lateness_ms.max():.3f}')
    else:
        t0 = time.perf_counter()
        extras['setup_s'] = t0 - t_start
        prof['start_after'] = t0 + 0.4 * seconds
        t_end = t0 + seconds
        i = pre
        while True:
            res = next(it)
            now = time.perf_counter()
            if now > t_end:
                break
            yielded.append(now)
            outs[i] = res
            i += 1
        run.window_frames = i - pre
        run.fps = run.window_frames / seconds
        since, sixth = np.asarray(yielded[pre:]) - t0, seconds / 6
        log('frames/s by sixth of the window: ' + ', '.join(
            f'{np.sum(since // sixth == k) / sixth:.2f}' for k in range(6)))
    source.stopped = True
    it.close()
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    if prof['on'] is not None and not prof['done']:
        prof['on'].stop()
    if spans is not None:
        spans.remove()
    if prof['on'] is not None:
        run.trace = trace.from_kineto(
            prof['on'].profiler.kineto_results.events())
        run.stretch = run.trace.stretch(skip, trace_chunks)
        if run.stretch is None:
            log(f'trace: only {len(run.trace.marks)} chunk marks; the '
                f'window is too short for {trace_chunks} traced chunks')
    run.people = {i: len(res[0]) for i, res in outs.items()}
    counts = list(run.people.values()) or [0]
    extras['people_a_frame'] = [min(counts), float(np.median(counts)),
                                max(counts)]
    return run, outs, capture, extras


def judge(cell: spec.Cell, run: Run, ring: np.ndarray, rows: list,
          outs: Dict[int, tuple], ref_det, ref_pose, seed: int, dev
          ) -> Dict[str, float]:
    """The compared numbers on a seeded sample of the window's chunks."""
    mix, cfg = cell.mix, cell.config
    bf = int(mix['batch_frames'])
    chunk_ids = sorted({i // bf for i in outs})
    whole = [c for c in chunk_ids if all(c * bf + k in outs
                                         for k in range(bf))]
    picked = check.sample_chunks(seed, len(whole), int(mix['check_chunks']))
    frames = [f for c in picked for f in range(whole[c] * bf,
                                               whole[c] * bf + bf)]
    n = len(ring)
    rgb = [torch.from_numpy(np.ascontiguousarray(ring[f % n][..., ::-1]))
           .to(dev) for f in frames]
    with torch.no_grad():
        ref_rows = []
        for s in range(0, len(rgb), 8):
            ref_rows += check.R.detect(ref_det, torch.stack(rgb[s:s + 8]),
                                       cfg['detector'], candidates=True)
    prog_rows = []
    for f in frames:
        if f // bf < len(rows):
            r, v = rows[f // bf]
            prog_rows.append(r[f % bf][v[f % bf]][:, :5])
        else:   # the detector never ran for this chunk
            prog_rows.append(np.zeros((0, 5), np.float32))
    det = check.detector_numbers(prog_rows, ref_rows)
    res_hw = tuple(cfg['pose']['res'])
    pose = check.pose_numbers(ref_pose, rgb, prog_rows,
                              [(outs[f][0], outs[f][1]) for f in frames],
                              res_hw, int(mix['max_people']))
    numbers = dict(det, **pose)
    numbers['frames_checked'] = len(frames)
    return numbers


def breakdown(tr: trace.Trace, stretch: tuple) -> dict:
    """The ten device operations that took most time in the stretch, by
    name, and the ten longest idle gaps, each named by the host operation
    (outermost op running on the host, spans and runtime calls aside)
    during it."""
    t0, t1, _ = stretch
    by_name: Dict[str, float] = {}
    iv = []
    for e in tr.device:
        s, t = max(e.start, t0), min(e.end, t1)
        if t > s:
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) / 1e9
            iv.append((s, t))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    iv.sort()
    gaps, cur = [], t0
    for s, t in iv:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if t1 > cur:
        gaps.append((cur, t1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = [e for e in tr.host if not e.name.startswith(trace.SPAN_PREFIX)
            and not trace.LAUNCH.match(e.name)
            and not e.name.startswith(('cuda', 'cu'))]
    named = []
    for s, t in gaps:
        mid = (s + t) // 2
        cands = [e for e in host if e.start <= mid < e.end]
        label = 'host idle' if not cands else \
            min(cands, key=lambda e: e.start).name
        named.append([label, (t - s) / 1e9])
    return {'device_ops': [[k, v] for k, v in ops], 'idle_gaps': named}
