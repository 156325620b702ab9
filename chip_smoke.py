"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root on a host with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. build the five CUDA kernels from ``simple_hrnet_tpu_torch/csrc`` (one
     nvcc per source, all at once) and print the build time;
  2. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes (every batch phase 4 gives the pose model): NMS
     slot for slot (the 8-frame and one-frame detects, unsorted scores, N
     = 1000 and 1024, max_out > N), the basic chain at W48 in bf16 and
     f32 (TF32 off), the fuse at W48 in bf16 and f32 and at W32 in bf16,
     the Winograd chain at W32 in bf16, the int8 chain exactly at W32 and
     W48 in both cast-point modes; show that wrong-input controls fall
     outside each tolerance; time the kernel, the plain version and one
     library call (the kernels and the library calls replayed from CUDA
     graphs: NMS at the 8-frame and one-frame detects over a few input
     sets, beside an empty kernel and its eager time; the others over
     input sets larger than twice the L2: the basic chain at W48 batches
     32 and 2, the fuse at W48 with 1-3 sources and at W32 with 3, the
     Winograd and int8 chains at W32 batch 32, the Winograd chain also
     beside K2 at its shape, and failing unless it beats cuDNN's chain);
     check the int8 conv outside the chains (``torch._int_mm``) against
     its CPU integer path;
  3. HRNet-W48 forward at 384x288, kernels against the plain path (f32);
  4. three main paths, each ``SimpleHRNet(c, 17, <.pth>, resolution,
     multiperson=True, yolo_model_def='yolov3', dtype)`` from a seeded
     random ``.pth`` and a seeded random darknet ``.weights`` file:
     W48-384x288 bf16 (basic chain + fuse), W32-256x192 bf16 (Winograd
     chain + fuse) and W32-256x192 int8 (int8 chain + fuse, HRNet and
     YOLOv3 quantized). Each runs ``predict`` on one synthetic 480x640
     frame and on a stack of 8, with every kernel's launch count set to 0
     just before and read just after, and checks that detections reached
     the pose path, that its kernels ran there (8 chain launches per pose
     forward), and that the pose model ran only at batches phase 2
     checked; it is timed, and its 8-frame call is profiled (device time
     by kernel, and each port kernel's device time and launches summed
     over all its instantiations).

Prints the build log, one JSON ``kernels`` line, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. The
``--kernels-only`` flag stops after phase 2 (for iterating on a kernel).
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (dense): NVIDIA data sheet
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
            torch.int8: 1979e12}
L2_BYTES = 50_000_000

# kernel-vs-plain tolerances, relative to max |plain|: f32 differs only by
# summation order (8 chained convs of 432-term sums); bf16 adds one-ulp
# flips at each rounding (2^-8 to 2^-7 of max) that the later convs carry
# on. The bf16 limit sits between that reading and the wrong-bias controls
# that check_chain and check_fuse_up hold against it.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# the int8 chain repeats its plain version's arithmetic exactly (exact int32
# cores, the same IEEE f32 epilogue, rounding half to even), so it must
# equal it bit for bit; its wrong-input controls (one activation scale off
# by 1/127, biases off by one channel) must differ by more than one bf16
# step of max, and the other cast-point mode's result must differ at all
TOL_INT8_CONTROL = 2.0 ** -8

# the batches phase 4's predict calls give the pose model (max_batch_size
# 32, 32 people a frame from the random detector): 2 and 32 for one frame,
# 16 and 32 for the stack of 8. Phase 2 checks the kernels at each; phase 4
# fails if the pose model sees another.
POSE_BATCHES = (2, 16, 32)
# the W32 paths: every power-of-two bucket predict can form at
# max_batch_size 32 (the int8 detector may keep other counts of people)
POSE_BATCHES_W32 = (1, 2, 4, 8, 16, 32)


def cuda_ms(fn, iters=30, warmup=3):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(out, ref):
    out = out.float()
    ref = ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError('kernel output is not finite')
    err = (out - ref).abs().max().item()
    return err, err / max(1.0, ref.abs().max().item())


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# K1's shapes: the 8-frame detect and one frame (batch, candidates, slots)
NMS_SHAPES = ((8, 256, 32), (1, 256, 32))
NMS_THRESH = 0.4


def _nms_inputs(dev, bsz, n, seed, sort=True):
    """Detector-like NMS operands: boxes over a 416 frame, scores at 1/64
    steps (exact ties: the lowest index must win), the last 22% padding
    zeros, sorted descending as the detector passes them unless ``sort``
    is False (then shuffled, padding included)."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand((bsz, n, 2), generator=g) * 380.0
    wh = torch.rand((bsz, n, 2), generator=g) * 150.0 + 4.0
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.rand((bsz, n), generator=g) * 0.8 + 0.2
    scores = torch.round(scores * 64) / 64
    scores[:, n * 200 // 256:] = 0.0
    if sort:
        scores = torch.sort(scores, dim=1, descending=True,
                            stable=True).values
    else:
        perm = torch.argsort(torch.rand((bsz, n), generator=g), dim=1)
        scores = torch.gather(scores, 1, perm)
    return boxes.to(dev), scores.to(dev)


def empty_launch(dev):
    """One empty kernel (``csrc/nms.cu`` ``sht_empty_kernel``) on the
    current stream: the practical floor of one launch."""
    import ctypes

    from simple_hrnet_tpu_torch.ops.cuda import build
    fn = build.library('nms').sht_empty_kernel
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    build.check(fn(build.stream_ptr(dev)), 'empty kernel')


def time_nms(K, dev, shape, sets=4):
    """K1 at ``shape`` replayed from a CUDA graph, cycling over ``sets``
    input sets (each call's inputs lie in the L2, as the detector's
    outputs do), and eagerly (the wrapper's host cost included)."""
    bsz, n, max_out = shape
    ins = [_nms_inputs(dev, bsz, n, seed=11 + i) for i in range(sets)]
    ms = graph_ms([lambda a=a: K.nms(*a, NMS_THRESH, max_out) for a in ins])
    eager = cuda_ms(lambda: K.nms(*ins[0], NMS_THRESH, max_out), iters=100)
    return ms, eager


def check_nms(dev, rec):
    from simple_hrnet_tpu_torch.ops.cuda import nms as K

    # (name, batch, N, max_out, sorted) — every case slot for slot
    cases = (('detect 8 frames', 8, 256, 32, True),
             ('one frame', 1, 256, 32, True),
             ('unsorted, ties', 8, 256, 32, False),
             ('N = 1000', 2, 1000, 100, False),
             ('N = 1024', 2, 1024, 32, True),
             ('max_out > N', 3, 33, 40, False))
    for i, (what, bsz, n, max_out, sort) in enumerate(cases):
        boxes, scores = _nms_inputs(dev, bsz, n, seed=1 + i, sort=sort)
        idx, valid = K.nms(boxes, scores, NMS_THRESH, max_out)
        pidx, pvalid = K.nms_plain(boxes, scores, NMS_THRESH, max_out)
        torch.cuda.synchronize()
        if not torch.equal(valid, pvalid) or not torch.equal(idx, pidx):
            raise AssertionError(f'nms kernel disagrees with its plain '
                                 f'version: {what} (B={bsz} N={n} '
                                 f'max_out={max_out})')
        print(f'K1 nms {what} (B={bsz} N={n} max_out={max_out}): exact, '
              f'{valid.sum().item()} kept', flush=True)
        if i == 0:
            main = (boxes, scores, idx, valid)
    boxes, scores, idx, valid = main
    bsz, n, max_out = NMS_SHAPES[0]
    # the CPU plain version as well (same arithmetic on the host)
    cidx, cvalid = K.nms_plain(boxes.cpu(), scores.cpu(), NMS_THRESH,
                               max_out)
    if not torch.equal(idx.cpu(), cidx) or not torch.equal(valid.cpu(),
                                                           cvalid):
        raise AssertionError('nms kernel disagrees with the CPU plain version')
    # control: the kernel at another threshold must not pass the check
    widx, wvalid = K.nms(boxes, scores, NMS_THRESH - 0.05, max_out)
    control = int(((widx != idx) | (wvalid != valid)).sum().item())
    if control == 0:
        raise AssertionError('nms control: the kernel at threshold '
                             f'{NMS_THRESH - 0.05} equals the plain version '
                             f'at {NMS_THRESH}')
    print(f'K1 nms control (kernel at {NMS_THRESH - 0.05:.2f} against plain '
          f'at {NMS_THRESH}): {control} slots differ', flush=True)

    timings = []
    for shape in NMS_SHAPES:
        ms, eager = time_nms(K, dev, shape)
        timings.append(dict(shape=f'B={shape[0]} N={shape[1]} '
                            f'max_out={shape[2]}', ms=ms, eager_ms=eager))
    floor_ms = graph_ms([lambda: empty_launch(dev)])
    plain_ms = cuda_ms(lambda: K.nms_plain(boxes, scores, NMS_THRESH,
                                           max_out), iters=10)
    ops = bsz * n * n * 12 + bsz * max_out * n * 3
    b_ms, b_by = bound(nbytes(boxes, scores, idx, valid), ops, torch.float32)
    ms = timings[0]['ms']
    rec['nms'] = dict(
        name='nms', route='cuda', source='simple_hrnet_tpu_torch/csrc/nms.cu',
        replaces='simple_hrnet_tpu/ops/pallas/nms_pallas.py:135',
        max_abs_err=0.0, tolerance='exact', control_slots=control,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=timings[0]['shape'], timings=timings,
        empty_kernel_ms=floor_ms, checked=[c[0] for c in cases],
        kept_per_image=valid.sum(1).tolist())
    print('K1 nms, replayed from a CUDA graph (eager, with the host): ' +
          '; '.join(f'{t["shape"]} {t["ms"]:.4f} ms ({t["eager_ms"]:.4f})'
                    for t in timings) +
          f'; empty kernel {floor_ms:.4f} ms; plain {plain_ms:.4f}, bound '
          f'{b_ms:.5f} {b_by}', flush=True)


def _chain_inputs(dev, dtype, bsz, h=96, w=72, c=48):
    """W48 branch-0 operands; biases at folded-BN scale (uniform +-1)."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((bsz, h, w, c), generator=g).to(dev, dtype)
    lim = 1.0 / np.sqrt(9 * c)
    wt = ((torch.rand((8, 3, 3, c, c), generator=g) * 2 - 1) * lim * 1.7)
    b = torch.rand((8, c), generator=g) * 2 - 1
    return x, wt.to(dev, dtype).contiguous(), b.to(dev).contiguous()


def check_controls(what, ref, wrong, tol):
    """Each wrong-bias result must differ from ``ref`` by more than ``tol``
    of max, or the tolerance could not catch a bias bug. Returns the
    smallest such difference (relative to max)."""
    rels = {name: rel_err(out, ref)[1] for name, out in wrong.items()}
    for name, rel in rels.items():
        if rel <= tol:
            raise AssertionError(f'{what}: control "{name}" is within the '
                                 f'tolerance ({rel} <= {tol} of max)')
    print(f'{what} controls (rel to max): '
          f'{ {k: f"{v:.3e}" for k, v in rels.items()} }', flush=True)
    return min(rels.values())


def input_sets(first, per_call, clone):
    """``first`` and enough copies (``clone(first)``) that the sets together
    hold over 100 MB, twice the 50 MB L2: cycling over them, each call reads
    its inputs from device memory, as the bound assumes."""
    return [first] + [clone(first)
                      for _ in range(-(-2 * L2_BYTES // per_call) - 1)]


def time_chain(K, dev, bsz):
    """K2 bf16 at the W48 branch-0 shape, its plain version and cuDNN's
    chain, timed as ``time_fuse`` times K3: the kernel and the library call
    replayed from CUDA graphs over input sets larger than twice the L2, the
    plain version eagerly."""
    x, wt, b = _chain_inputs(dev, torch.bfloat16, bsz)
    per_call = 2 * nbytes(x) + nbytes(wt, b)
    sets = input_sets((x, wt, b), per_call, lambda a: (a[0].clone(), *a[1:]))
    ms = graph_ms([lambda a=a: K.basic_chain(*a) for a in sets])
    it = iter(range(1 << 30))
    plain_ms = cuda_ms(lambda: K.basic_chain_plain(*sets[next(it) %
                                                         len(sets)]),
                       iters=10)
    lib_ms = graph_ms([_lib_chain(*a) for a in sets])
    _, h, w, c = x.shape
    ops = 8 * 2 * bsz * h * w * c * c * 9
    b_ms, b_by = bound(per_call, ops, torch.bfloat16)
    t = dict(shape=f'{tuple(x.shape)} bf16', ms=ms, plain_ms=plain_ms,
             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
             share_of_bound=b_ms / ms, input_sets=len(sets))
    print(f'K2 basic_chain {t["shape"]}: {ms:.4f} ms (plain {plain_ms:.4f}, '
          f'cuDNN {lib_ms:.4f}, bound {b_ms:.5f} {b_by}, '
          f'{100 * b_ms / ms:.1f}% of bound)', flush=True)
    return t


def check_chain(dev, rec):
    from simple_hrnet_tpu_torch.ops.cuda import fused_block as K

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for bsz in POSE_BATCHES:
            x, wt, b = _chain_inputs(dev, dtype, bsz)
            y = K.basic_chain(x, wt, b)
            ref = K.basic_chain_plain(x, wt, b)
            torch.cuda.synchronize()
            err, rel = rel_err(y, ref)
            if rel > TOL[dtype]:
                raise AssertionError(f'basic_chain {dtype} B={bsz}: max err '
                                     f'{err} ({rel} of max) > {TOL[dtype]}')
            errs[(dtype, bsz)] = (err, rel)
            print(f'K2 basic_chain {str(dtype)[6:]} B={bsz}: max abs err '
                  f'{err:.3e} (rel {rel:.3e}, tol {TOL[dtype]:.1e})',
                  flush=True)
    bsz = max(POSE_BATCHES)
    x, wt, b = _chain_inputs(dev, torch.bfloat16, bsz)
    ref = K.basic_chain_plain(x, wt, b)
    last_dropped = b.clone()
    last_dropped[7] = 0.0
    control = check_controls('K2 bf16', ref, {
        'last conv bias dropped': K.basic_chain_plain(x, wt, last_dropped),
        'biases off by one channel': K.basic_chain_plain(
            x, wt, b.roll(1, dims=1))}, TOL[torch.bfloat16])
    del x, wt, b, ref, last_dropped
    # the 8-frame path's batch, then the 1-frame path's smallest
    head, small = time_chain(K, dev, bsz), time_chain(K, dev,
                                                      min(POSE_BATCHES))
    x32, wt32, b32 = _chain_inputs(dev, torch.float32, bsz)
    ms32 = cuda_ms(lambda: K.basic_chain(x32, wt32, b32))
    _, h, w, c = x32.shape
    b32_ms, b32_by = bound(2 * nbytes(x32) + nbytes(wt32, b32),
                           8 * 2 * bsz * h * w * c * c * 9, torch.float32)
    rec['basic_chain'] = dict(
        name='basic_chain', route='cuda',
        source='simple_hrnet_tpu_torch/csrc/fused_block.cu',
        replaces='simple_hrnet_tpu/ops/pallas/fused_block.py:398',
        max_abs_err=max(errs[(torch.bfloat16, n)][0] for n in POSE_BATCHES),
        max_rel_err=max(errs[(torch.bfloat16, n)][1] for n in POSE_BATCHES),
        tolerance=TOL[torch.bfloat16], control_rel=control,
        ms=head['ms'], plain_ms=head['plain_ms'], bound_ms=head['bound_ms'],
        bound_by=head['bound_by'], library_ms=head['library_ms'],
        shape=head['shape'], timings=[head, small],
        checked_batches=list(POSE_BATCHES),
        f32_max_abs_err=max(errs[(torch.float32, n)][0]
                            for n in POSE_BATCHES),
        f32_ms=ms32, f32_bound_ms=b32_ms, f32_bound_by=b32_by)
    print(f'K2 basic_chain f32 B={bsz}: {ms32:.4f} ms (bound {b32_ms:.5f} '
          f'{b32_by})', flush=True)


# the high-res fuse's base shapes (H, W, C) on the main paths: W48 at
# 384x288 and W32 at 256x192; sources at /2, /4, /8 with 2C, 4C, 8C channels
FUSE_W48 = (96, 72, 48)
FUSE_W32 = (64, 48, 32)


def _fuse_inputs(dev, dtype, n_src, bsz, h=96, w=72, c=48):
    """High-res fuse operands for stage 2 (1 source), 3 (2) or 4 (3);
    summed biases at folded-BN scale (uniform +-1)."""
    g = torch.Generator().manual_seed(3 + n_src)
    base = torch.randn((bsz, h, w, c), generator=g).to(dev, dtype)
    ys, ws = [], []
    for j in range(1, n_src + 1):
        f, cj = 2 ** j, c * 2 ** j
        ys.append(torch.randn((bsz, h // f, w // f, cj),
                              generator=g).to(dev, dtype))
        ws.append(((torch.rand((cj, c), generator=g) * 2 - 1) /
                   np.sqrt(cj)).to(dev, dtype))
    bias_sum = (torch.rand((c,), generator=g) * 2 - 1).to(dev)
    return base, ys, ws, bias_sum


def graph_ms(fns, iters=20, reps=10):
    """Mean milliseconds per call of ``fns`` (cycled) replayed from one
    CUDA graph (CUDA events): the host's launch cost, which can exceed a
    kernel's device time, stays out of the reading."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    outs = []  # kept alive, so every captured call writes its own output
    with torch.cuda.graph(graph):
        for i in range(iters):
            outs.append(fns[i % len(fns)]())
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph, outs
    return start.elapsed_time(end) / (reps * iters)


def _lib_fuse(base, ys, ws, bsum):
    """Library yardstick of the fuse: 1x1 cuDNN conv + nearest interpolate
    + add + ReLU on the NHWC (channels_last) tensors."""
    basel = base.permute(0, 3, 1, 2)
    ysl = [y.permute(0, 3, 1, 2) for y in ys]
    wsl = [w.t()[:, :, None, None].contiguous(
        memory_format=torch.channels_last) for w in ws]
    bl = bsum.to(base.dtype)

    def lib():
        acc = basel
        for j, (y, w) in enumerate(zip(ysl, wsl)):
            t = F.conv2d(y, w, bl if j == 0 else None)
            acc = acc + F.interpolate(t, scale_factor=2 ** (j + 1),
                                      mode='nearest')
        return F.relu(acc)
    return lib


def time_fuse(K, dev, shape, n_src, bsz):
    """K3, its plain version and the library yardstick at one bf16 shape,
    cycling over enough input sets (over 100 MB, twice the 50 MB L2) that
    each call reads its inputs from device memory, as the bound assumes.
    The kernel and the library call are replayed from CUDA graphs; the
    plain version, whose time is mostly its own, is timed eagerly."""
    base, ys, ws, bsum = _fuse_inputs(dev, torch.bfloat16, n_src, bsz,
                                      *shape)
    per_call = 2 * nbytes(base) + nbytes(*ys, *ws, bsum)
    sets = input_sets((base, ys, ws, bsum), per_call,
                      lambda a: (a[0].clone(), [y.clone() for y in a[1]],
                                 *a[2:]))
    ms = graph_ms([lambda a=a: K.fuse_up(*a) for a in sets])
    it = iter(range(1 << 30))
    plain_ms = cuda_ms(lambda: K.fuse_up_plain(*sets[next(it) % len(sets)]),
                       iters=10)
    lib_ms = graph_ms([_lib_fuse(*a) for a in sets])
    c = shape[2]
    ops = sum(2 * y.numel() * c for y in ys) + base.numel() * 5
    b_ms, b_by = bound(per_call, ops, torch.bfloat16)
    t = dict(shape=f'{tuple(base.shape)} + {n_src} source'
             f'{"s" if n_src > 1 else ""} bf16', ms=ms, plain_ms=plain_ms,
             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
             share_of_bound=b_ms / ms, input_sets=len(sets))
    print(f'K3 fuse_up {t["shape"]}: {ms:.4f} ms (plain {plain_ms:.4f}, '
          f'library {lib_ms:.4f}, bound {b_ms:.5f} {b_by}, '
          f'{100 * b_ms / ms:.1f}% of bound)', flush=True)
    return t


def check_fuse_up(dev, rec):
    from simple_hrnet_tpu_torch.ops.cuda import fuse_up as K

    # f32 at the W48 batches; bf16 at both widths' batches
    cases = [(torch.float32, FUSE_W48, b) for b in POSE_BATCHES] + \
        [(torch.bfloat16, FUSE_W48, b) for b in POSE_BATCHES] + \
        [(torch.bfloat16, FUSE_W32, b) for b in POSE_BATCHES_W32]
    errs = {}
    for dtype, shape, bsz in cases:
        for n_src in (1, 2, 3):
            args = _fuse_inputs(dev, dtype, n_src, bsz, *shape)
            y = K.fuse_up(*args)
            ref = K.fuse_up_plain(*args)
            torch.cuda.synchronize()
            err, rel = rel_err(y, ref)
            if rel > TOL[dtype]:
                raise AssertionError(
                    f'fuse_up {dtype} {shape} B={bsz} {n_src} sources: max '
                    f'err {err} ({rel} of max) > {TOL[dtype]}')
            errs[(dtype, shape, bsz, n_src)] = (err, rel)
    worst = {}
    for dtype, shape, batches in ((torch.float32, FUSE_W48, POSE_BATCHES),
                                  (torch.bfloat16, FUSE_W48, POSE_BATCHES),
                                  (torch.bfloat16, FUSE_W32,
                                   POSE_BATCHES_W32)):
        worst[(dtype, shape)] = max(v for k, v in errs.items()
                                    if k[:2] == (dtype, shape))
        e = worst[(dtype, shape)]
        print(f'K3 fuse_up {str(dtype)[6:]} base {shape} B={batches}, 1-3 '
              f'sources: max abs err {e[0]:.3e} (rel {e[1]:.3e}, tol '
              f'{TOL[dtype]:.1e})', flush=True)
    bsz = max(POSE_BATCHES)
    base, ys, ws, bsum = _fuse_inputs(dev, torch.bfloat16, 3, bsz)
    control = check_controls('K3 bf16', K.fuse_up_plain(base, ys, ws, bsum), {
        'bias dropped': K.fuse_up_plain(base, ys, ws, torch.zeros_like(bsum)),
        'bias off by one channel': K.fuse_up_plain(base, ys, ws,
                                                   bsum.roll(1)),
        # a tiling or index-shift fault: the last source one pixel off in W
        'last source shifted one pixel in W': K.fuse_up_plain(
            base, ys[:-1] + [ys[-1].roll(1, dims=2)], ws, bsum)},
        TOL[torch.bfloat16])
    del base, ys, ws, bsum
    timings = [time_fuse(K, dev, FUSE_W48, n, bsz) for n in (1, 2, 3)] + \
        [time_fuse(K, dev, FUSE_W32, 3, max(POSE_BATCHES_W32))]
    head = timings[2]  # W48 stage 4, B=32
    bf16 = [v for k, v in errs.items() if k[0] == torch.bfloat16]
    rec['fuse_up'] = dict(
        name='fuse_up', route='cuda',
        source='simple_hrnet_tpu_torch/csrc/fuse_up.cu',
        replaces='simple_hrnet_tpu/ops/pallas/fuse_up.py:161',
        max_abs_err=max(v[0] for v in bf16),
        max_rel_err=max(v[1] for v in bf16),
        max_rel_err_w32=worst[(torch.bfloat16, FUSE_W32)][1],
        tolerance=TOL[torch.bfloat16], control_rel=control,
        ms=head['ms'], plain_ms=head['plain_ms'], bound_ms=head['bound_ms'],
        bound_by=head['bound_by'], library_ms=head['library_ms'],
        shape=head['shape'], timings=timings,
        checked_batches=list(POSE_BATCHES),
        checked_batches_w32=list(POSE_BATCHES_W32),
        f32_max_abs_err=worst[(torch.float32, FUSE_W48)][0])


def _lib_chain(x, wt, b):
    """Library yardstick of a chain: 8 cuDNN convs with the same bias,
    ReLU and residual, on the NHWC (channels_last) tensors."""
    xl = x.permute(0, 3, 1, 2)
    wl = [wt[i].permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last) for i in range(8)]
    bl = [b[i].to(x.dtype) for i in range(8)]

    def lib():
        v = xl
        for blk in range(4):
            mid = F.relu(F.conv2d(v, wl[2 * blk], bl[2 * blk], padding=1))
            v = F.relu(F.conv2d(mid, wl[2 * blk + 1], bl[2 * blk + 1],
                                padding=1) + v)
        return v
    return lib


def _wino_inputs(dev, bsz, h=64, w=48, c=32):
    """W32 branch-0 operands: x bf16, U (8, 4, 3C, C) bf16 from the f32
    weights, the biases, and the weights themselves in bf16 (for K2 and
    cuDNN at the same shape)."""
    from simple_hrnet_tpu_torch.ops.cuda import winograd_chain as K

    x, wt, b = _chain_inputs(dev, torch.float32, bsz, h, w, c)
    return (x.bfloat16(), K.pack_winograd_weights(wt, torch.bfloat16), b,
            wt.bfloat16())


def check_wino(dev, rec):
    """B3 at the W32 branch-0 shape (B, 64, 48, 32), bf16; timed beside
    cuDNN's chain and K2 at the same shape (B = 32), and held to beating
    cuDNN's."""
    from simple_hrnet_tpu_torch.ops.cuda import winograd_chain as K

    errs = {}
    tol = TOL[torch.bfloat16]
    for bsz in POSE_BATCHES_W32:
        x, ww, b, _ = _wino_inputs(dev, bsz)
        y = K.wino_chain(x, ww, b)
        ref = K.wino_chain_plain(x, ww, b)
        torch.cuda.synchronize()
        err, rel = rel_err(y, ref)
        if rel > tol:
            raise AssertionError(f'wino_chain B={bsz}: max err {err} ({rel} '
                                 f'of max) > {tol}')
        errs[bsz] = (err, rel)
    worst = max(errs.values())
    print(f'B3 wino_chain bf16 B={POSE_BATCHES_W32}: max abs err '
          f'{worst[0]:.3e} (rel {worst[1]:.3e}, tol {tol:.1e})', flush=True)
    ref = K.wino_chain_plain(x, ww, b)
    last_dropped = b.clone()
    last_dropped[7] = 0.0
    control = check_controls('B3 bf16', ref, {
        'last conv bias dropped': K.wino_chain_plain(x, ww, last_dropped),
        'biases off by one channel': K.wino_chain_plain(
            x, ww, b.roll(1, dims=1))}, tol)
    del ref, last_dropped
    t = time_wino(dev, max(POSE_BATCHES_W32))
    if t['ms'] >= t['library_ms']:
        raise AssertionError(f'wino_chain {t["ms"]:.4f} ms is not faster '
                             f'than cuDNN\'s chain at {t["shape"]} '
                             f'({t["library_ms"]:.4f} ms)')
    rec['wino_chain'] = dict(
        name='wino_chain', route='cuda',
        source='simple_hrnet_tpu_torch/csrc/winograd_chain.cu',
        replaces='simple_hrnet_tpu/ops/pallas/winograd_chain.py:151',
        max_abs_err=worst[0], max_rel_err=worst[1], tolerance=tol,
        control_rel=control, **t, checked_batches=list(POSE_BATCHES_W32))


def time_wino(dev, bsz=32):
    """B3 bf16 at (bsz, 64, 48, 32), its plain version, cuDNN's chain and K2
    on the same inputs, timed as ``time_fuse`` times K3: the kernels and the
    library call replayed from CUDA graphs over input sets larger than
    twice the L2, the plain version eagerly."""
    from simple_hrnet_tpu_torch.ops.cuda import fused_block as K2
    from simple_hrnet_tpu_torch.ops.cuda import winograd_chain as K

    x, ww, b, wl = _wino_inputs(dev, bsz)
    per_call = 2 * nbytes(x) + nbytes(ww, b)
    sets = input_sets(x, per_call, torch.clone)
    ms = graph_ms([lambda v=v: K.wino_chain(v, ww, b) for v in sets])
    plain_ms = cuda_ms(lambda: K.wino_chain_plain(x, ww, b), iters=10)
    lib_ms = graph_ms([_lib_chain(v, wl, b) for v in sets])
    k2_ms = graph_ms([lambda v=v: K2.basic_chain(v, wl, b) for v in sets])
    _, h, w, c = x.shape
    # 4 Winograd terms over h/2 row pairs with 3C-deep dots: 2/3 of the
    # direct chain's MACs
    ops = 8 * 2 * bsz * (h // 2) * w * 4 * 3 * c * c
    b_ms, b_by = bound(per_call, ops, torch.bfloat16)
    t = dict(shape=f'{tuple(x.shape)} bf16', ms=ms, plain_ms=plain_ms,
             library_ms=lib_ms, k2_ms=k2_ms, bound_ms=b_ms, bound_by=b_by,
             share_of_bound=b_ms / ms, input_sets=len(sets))
    print(f'B3 wino_chain {t["shape"]}: {ms:.4f} ms (plain {plain_ms:.4f}, '
          f'cuDNN {lib_ms:.4f}, K2 {k2_ms:.4f}, bound {b_ms:.5f} {b_by}, '
          f'{100 * b_ms / ms:.1f}% of bound)', flush=True)
    return t


def _int8_inputs(dev, bsz, h, w, c):
    """Chain operands at folded-BN scale and per-conv input amax from the
    f32 chain on the same input (a calibration of this very batch)."""
    from simple_hrnet_tpu_torch.ops.cuda import int8_chain as K

    x, wt, b = _chain_inputs(dev, torch.float32, bsz, h, w, c)
    wk = wt.permute(0, 4, 3, 1, 2)  # OIHW
    amax, v = [], x.permute(0, 3, 1, 2)
    for blk in range(4):
        amax.append(v.abs().max().item())
        mid = F.relu(F.conv2d(v, wk[2 * blk], b[2 * blk], padding=1))
        amax.append(mid.abs().max().item())
        v = F.relu(F.conv2d(mid, wk[2 * blk + 1], b[2 * blk + 1], padding=1)
                   + v)
    q = K.pack_chain_weights_int8(
        [(wk[i].contiguous(), b[i]) for i in range(8)], amax)
    return x.bfloat16(), q, wt


def check_int8_chain(dev, rec):
    """B4 at the W32 branch-0 shape (B, 64, 48, 32) at every W32 batch and
    at the W48 shape (B, 96, 72, 48) at the W48 batches, bf16 in and out,
    exactly, in both cast-point modes: the Pallas kernel's (HRNet's at
    W32) and the XLA chain's (HRNet's at W48); timed at W32 batch 32."""
    from simple_hrnet_tpu_torch.ops import int8 as Q8
    from simple_hrnet_tpu_torch.ops.cuda import int8_chain as K

    shapes = [(bsz, 64, 48, 32) for bsz in POSE_BATCHES_W32] + \
        [(bsz, 96, 72, 48) for bsz in POSE_BATCHES]
    for shape in shapes:
        x, q, _ = _int8_inputs(dev, *shape)
        args = (q['wq'], q['wscale'], q['b'], q['ascales'])
        for mode in (False, True):
            y = K.int8_chain(x, *args, round_handoffs=mode)
            ref = K.int8_chain_plain(x, *args, round_handoffs=mode)
            torch.cuda.synchronize()
            if not torch.equal(y, ref):
                err, rel = rel_err(y, ref)
                raise AssertionError(
                    f'int8_chain {shape} round_handoffs={mode}: not equal '
                    f'to its plain version (max err {err}, {rel} of max)')
    print(f'B4 int8_chain W32 B={POSE_BATCHES_W32}, W48 B={POSE_BATCHES}, '
          f'both cast-point modes: equal to the plain version', flush=True)
    x, q, wt = _int8_inputs(dev, max(POSE_BATCHES_W32), 64, 48, 32)
    args = (q['wq'], q['wscale'], q['b'], q['ascales'])
    ref = K.int8_chain_plain(x, *args)
    off = q['ascales'].clone()
    off[0] = off[0] * (1.0 + 1.0 / 127.0)
    control = check_controls('B4', ref, {
        'first activation scale off by 1/127': K.int8_chain_plain(
            x, q['wq'], q['wscale'], q['b'], off),
        'biases off by one channel': K.int8_chain_plain(
            x, q['wq'], q['wscale'], q['b'].roll(1, dims=1), q['ascales'])},
        TOL_INT8_CONTROL)
    # the exact checks can tell the two modes apart at this shape
    mode_control = check_controls('B4 cast points', ref, {
        'the XLA chain\'s cast points': K.int8_chain_plain(
            x, *args, round_handoffs=True)}, 0.0)
    # library yardstick: 8 torch._int_mm convs over the int8 patch matrix
    # with the same quantize / dequantize / bias / residual / ReLU epilogue
    inva = torch.reciprocal(q['ascales'])
    alpha = q['ascales'][:, None] * q['wscale']
    wl = [q['wq'][i].permute(3, 0, 1, 2).reshape(x.shape[-1], -1)
          .contiguous() for i in range(8)]

    def qconv(v, i):
        acc = Q8.int8_conv_acc(Q8.quantize(v, inva[i]), wl[i], 3, 1, 1)
        return acc.float() * alpha[i] + q['b'][i]

    def lib(v):
        for blk in range(4):
            mid = torch.relu(qconv(v, 2 * blk))
            v = torch.relu(qconv(mid, 2 * blk + 1) + v.float()).to(x.dtype)
        return v
    # timed as time_fuse times K3: graph-replayed over input sets larger
    # than twice the L2 (the plain version eagerly)
    per_call = 2 * nbytes(x) + nbytes(*args)
    sets = input_sets(x, per_call, torch.clone)
    ms = graph_ms([lambda v=v: K.int8_chain(v, *args) for v in sets])
    ms_round = graph_ms([lambda v=v: K.int8_chain(v, *args,
                                                  round_handoffs=True)
                         for v in sets])
    plain_ms = cuda_ms(lambda: K.int8_chain_plain(x, *args), iters=5)
    lib_ms = graph_ms([lambda v=v: lib(v) for v in sets])
    bsz, h, w, c = x.shape
    ops = 8 * 2 * bsz * h * w * c * c * 9
    b_ms, b_by = bound(per_call, ops, torch.int8)
    rec['int8_chain'] = dict(
        name='int8_chain', route='cuda',
        source='simple_hrnet_tpu_torch/csrc/int8_chain.cu',
        replaces='simple_hrnet_tpu/ops/pallas/fused_block.py:329',
        max_abs_err=0.0, tolerance='exact', control_rel=control,
        mode_control_rel=mode_control, ms=ms, ms_round_handoffs=ms_round,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        shape=f'{tuple(x.shape)} bf16', share_of_bound=b_ms / ms,
        input_sets=len(sets), checked_batches=list(POSE_BATCHES_W32),
        checked_batches_w48=list(POSE_BATCHES),
        checked_modes=['pallas', 'round_handoffs'])
    print(f'B4 int8_chain {rec["int8_chain"]["shape"]}: {ms:.4f} ms (round '
          f'handoffs {ms_round:.4f}, plain {plain_ms:.4f}, _int_mm '
          f'{lib_ms:.4f}, bound {b_ms:.5f} {b_by}, '
          f'{100 * b_ms / ms:.1f}% of bound)', flush=True)


def check_qconv(dev):
    """The int8 conv outside the chains: torch._int_mm on the card against
    the CPU's f64 integer path, bit for bit (exact int32 cores)."""
    from simple_hrnet_tpu_torch.ops import int8 as Q8

    g = torch.Generator().manual_seed(6)
    x = torch.randn((16, 32, 64, 48), generator=g).bfloat16()
    wq = torch.randint(-127, 128, (64, 9 * 32), generator=g,
                       dtype=torch.int8)
    ws = torch.rand((64,), generator=g) * 0.01
    a = torch.tensor(0.03)
    bias = torch.rand((64,), generator=g) * 2 - 1
    for stride in (1, 2):
        cpu = Q8.int8_conv2d(x, wq, 3, ws, a, bias, stride, 1)
        gpu = Q8.int8_conv2d(*(t.to(dev) for t in (x, wq)), 3,
                             *(t.to(dev) for t in (ws, a, bias)), stride, 1)
        torch.cuda.synchronize()
        if not torch.equal(gpu.cpu(), cpu):
            raise AssertionError(f'int8 conv (stride {stride}): the CUDA '
                                 f'route disagrees with the CPU integer path')
    print('QConv2d int8 conv: CUDA (torch._int_mm) == CPU (f64 integer '
          'path), bitwise, strides 1 and 2', flush=True)


def check_hrnet_forward(dev, pth):
    """W48-384x288 forward on 2 crops in f32: kernels vs plain modules."""
    from simple_hrnet_tpu_torch.models import convert, hrnet
    from simple_hrnet_tpu_torch.utils import checkpoint as ckpt

    sd = ckpt.load(pth)
    outs = []
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 384, 288, 3), generator=g).to(dev)
    for kernels in (True, False):
        model = hrnet.prepare_inference(
            convert.load_into(hrnet.HRNet(48, 17), sd).to(dev),
            torch.float32, kernels=kernels)
        with torch.no_grad():
            outs.append(model(x))
        del model
    err, rel = rel_err(*outs)
    tol = 1e-3  # f32 summation order through ~100 layers
    if tuple(outs[0].shape) != (2, 96, 72, 17) or rel > tol:
        raise AssertionError(f'HRNet kernels vs plain: shape '
                             f'{tuple(outs[0].shape)}, max err {err} '
                             f'({rel} of max) > {tol}')
    print(f'phase 3: HRNet-W48 384x288 f32 forward, kernels vs plain: max '
          f'abs err {err:.3e} (rel {rel:.3e}, tol {tol:.0e})', flush=True)


def write_weights(tmp):
    """Seeded random HRNet-W48 and HRNet-W32 .pth files and a YOLOv3
    darknet .weights file. The detector heads' person logit is raised so
    the random detector finds people (every candidate is otherwise a coin
    flip among 80 classes)."""
    from simple_hrnet_tpu_torch.detectors import darknet
    from simple_hrnet_tpu_torch.models import hrnet

    pths = {}
    for c, res in ((48, '384x288'), (32, '256x192')):
        pths[c] = os.path.join(tmp, f'pose_hrnet_w{c}_{res}_seed0.pth')
        torch.save(hrnet.init(c, 17, seed=0).state_dict(), pths[c])
    blocks = darknet.yolov3_blocks()
    net = darknet.init(blocks, seed=0)
    with torch.no_grad():
        for i, blk in enumerate(blocks):
            if blk['type'] == 'convolutional' and not blk['bn']:
                getattr(net, f'conv_{i}').bias.view(3, 85)[:, 5] += 4.0
    weights = os.path.join(tmp, 'yolov3_seed0.weights')
    darknet.save_darknet_weights(net, weights)
    return pths, weights


def smooth_frames(n, h=480, w=640, seed=5):
    """Synthetic BGR uint8 frames: smooth blobs over noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = rng.uniform(0, 60, (n, h, w, 3)).astype(np.float32)
    for f in frames:
        for _ in range(6):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(30, 120)
            f += (rng.uniform(60, 190, 3) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None])
    return np.clip(frames, 0, 255).astype(np.uint8)


# phase 4's main paths: (name, width, resolution, dtype, the batches phase 2
# checked the chain at, the chain kernel that must run 8 times per pose
# forward, timing repetitions (1 frame, 8 frames))
MAIN_PATHS = (
    ('w48_bf16', 48, (384, 288), 'bfloat16', POSE_BATCHES, 'basic_chain',
     (3, 2)),
    ('w32_bf16', 32, (256, 192), 'bfloat16', POSE_BATCHES_W32, 'wino_chain',
     (5, 3)),
    ('w32_int8', 32, (256, 192), 'int8', POSE_BATCHES_W32, 'int8_chain',
     (5, 3)),
)
CHAINS = ('basic_chain', 'wino_chain', 'int8_chain')


def run_main_path(dev, path, pth, weights, counters):
    """Phase 4 for one main path: the facade on one frame and on a stack of
    8. Returns the launches per predict and the path's measurements."""
    from simple_hrnet_tpu_torch import SimpleHRNet

    name, c, res, dtype, batches, chain, (reps1, reps8) = path
    t0 = time.perf_counter()
    model = SimpleHRNet(c, 17, pth, resolution=res, multiperson=True,
                        yolo_model_def='yolov3', yolo_weights_path=weights,
                        dtype=dtype, return_heatmaps=True,
                        return_bounding_boxes=True, device='cuda')
    build_s = time.perf_counter() - t0
    print(f'phase 4 [{name}]: SimpleHRNet W{c}-{res[0]}x{res[1]} + '
          f'YOLOv3-416 {dtype} built in {build_s:.1f} s (detector '
          f'quantized: {model.detector.quantized})', flush=True)
    if dtype == 'int8' and not model.detector.quantized:
        raise AssertionError('YOLOv3 was not quantized under int8')
    frames = smooth_frames(8)
    seen = []
    hook = model.model.register_forward_pre_hook(
        lambda _m, args: seen.append(args[0].shape[0]))

    for k in counters.values():
        k.launches = 0
    hm1, boxes1, pts1 = model.predict(frames[0])
    torch.cuda.synchronize()
    single = {k: f.launches for k, f in counters.items()}
    forwards1 = len(seen)
    hm8, boxes8, pts8 = model.predict(frames)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    hook.remove()
    stack = {k: launches[k] - single[k] for k in launches}
    if not set(seen) <= set(batches):
        raise AssertionError(f'[{name}] the pose model ran at batches '
                             f'{sorted(set(seen))}; phase 2 checked the '
                             f'kernels at {batches}')

    n1 = pts1.shape[0]
    n8 = [p.shape[0] for p in pts8]
    if n1 == 0 or sum(n8) == 0:
        raise AssertionError(f'[{name}] no detection reached the pose path '
                             f'({n1} on the single frame, {n8} on the '
                             f'stack)')
    hm_hw = (res[0] // 4, res[1] // 4)
    for hm, pts, boxes, n in [(hm1, pts1, boxes1, n1)] + \
            list(zip(hm8, pts8, boxes8, n8)):
        if hm.shape != (n, 17, *hm_hw) or pts.shape != (n, 17, 3) or \
                boxes.shape != (n, 4):
            raise AssertionError(f'[{name}] bad output shapes {hm.shape} '
                                 f'{pts.shape} {boxes.shape} for {n} people')
        if not (np.isfinite(hm).all() and np.isfinite(pts).all()):
            raise AssertionError(f'[{name}] non-finite heatmaps or keypoints')
    # every stage module runs its chain once: 8 launches per pose forward
    want = {k: 8 * len(seen) if k == chain else 0 for k in CHAINS}
    got = {k: launches[k] for k in CHAINS}
    if got != want or launches['nms'] == 0 or launches['fuse_up'] == 0:
        raise AssertionError(f'[{name}] launches {launches} over '
                             f'{len(seen)} pose forwards; want chains {want} '
                             f'and NMS and the fuse launched')
    print(f'phase 4 [{name}]: people {n1} (single) / {n8} (stack of 8); '
          f'pose batches {seen}; launches per predict: 1 frame {single}, '
          f'8 frames {stack}', flush=True)

    # timed as users call it by default: keypoints only (heatmaps stay on
    # the card)
    model.return_heatmaps = False
    model.return_bounding_boxes = False
    t = {}
    for what, arg, reps in (('single', frames[0], reps1),
                            ('stack8', frames, reps8)):
        t0 = time.perf_counter()
        for _ in range(reps):
            model.predict(arg)
        t[what] = (time.perf_counter() - t0) / reps
    print(f'phase 4 [{name}]: predict 1 frame {t["single"] * 1e3:.1f} ms '
          f'({1 / t["single"]:.2f} frames/s); 8 frames '
          f'{t["stack8"] * 1e3:.1f} ms ({8 / t["stack8"]:.2f} frames/s)',
          flush=True)
    summary = {
        'people_single': n1, 'people_stack8': n8, 'pose_batches': seen,
        'pose_forwards_single': forwards1,
        'pose_forwards_stack8': len(seen) - forwards1,
        'launches_single': single, 'launches_stack8': stack,
        'detector_quantized': model.detector.quantized,
        'build_s': build_s, 'predict_ms_single': t['single'] * 1e3,
        'predict_ms_stack8': t['stack8'] * 1e3}
    busy_ms, top, port = profile_predict(name, model, frames)
    summary.update(stack8_device_busy_ms=busy_ms, stack8_top_device_ms=top,
                   stack8_port_kernels=port)
    del model
    torch.cuda.empty_cache()
    return launches, single, stack, summary


# each port kernel's device functions (profiler names), summed over all
# their instantiations
PORT_KERNELS = {
    'K1 nms': ('nms_mask', 'nms_scan'),
    'K2 basic_chain': ('conv3x3_bf16_tc', 'conv3x3_f32'),
    'B3 wino_chain': ('wino_conv_bf16',),
    'B4 int8_chain': ('int8_conv_tc', 'int8_quantize'),
    'K3 fuse_up': ('fuse_up_kernel',),
}


def profile_predict(name, model, frames):
    """Device time by kernel over one ``predict`` of the 8-frame stack
    (torch.profiler, CUDA activity). Returns the summed device time, the
    ten largest entries and each port kernel's [ms, launches] summed over
    all its instantiations."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.predict(frames)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # device-side entries only (kernels, memcpy, memset): the aten ops
        # that launch them would count the same time again
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, 'self_device_time_total',
                         getattr(ev, 'self_cuda_time_total', 0.0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f'phase 4 [{name}]: profile of predict(8 frames): device busy '
          f'{busy:.2f} ms; by kernel (ms, calls, name):', flush=True)
    for ms, n, key in rows[:15]:
        print(f'    {ms:9.3f} {n:6d}  {key[:110]}')
    port = {}
    for kernel, funcs in PORT_KERNELS.items():
        hit = [(ms, n) for ms, n, key in rows
               if any(re.search(rf'\b{f}\b', key) for f in funcs)]
        if hit:
            port[kernel] = [sum(ms for ms, _ in hit), sum(n for _, n in hit)]
    print(f'phase 4 [{name}]: port kernels, all instantiations (ms, '
          f'launches): ' + '; '.join(f'{k} {ms:.3f} ms, {n}'
                                     for k, (ms, n) in port.items()),
          flush=True)
    return busy, [[round(ms, 4), n, key[:80]] for ms, n, key in rows[:10]], \
        port


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--kernels-only', action='store_true',
                    help='stop after the kernel checks (phase 2)')
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible', file=sys.stderr)
        return 1
    from simple_hrnet_tpu_torch.ops.cuda import build

    dev = torch.device('cuda', 0)
    # every comparison below is in true f32 where f32 is asked for
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    secs = build.build_all()
    print(f'phase 1: built {sorted(secs)} in '
          f'{time.perf_counter() - t0:.1f} s '
          f'({ {k: round(v, 1) for k, v in secs.items()} })', flush=True)
    for name, log in build.BUILD_LOGS.items():
        print(f'--- nvcc {name} ---\n{log.strip()}')

    from simple_hrnet_tpu_torch.ops.cuda import (fuse_up, fused_block,
                                                 int8_chain, nms,
                                                 winograd_chain)
    counters = {'nms': nms.nms, 'basic_chain': fused_block.basic_chain,
                'fuse_up': fuse_up.fuse_up,
                'wino_chain': winograd_chain.wino_chain,
                'int8_chain': int8_chain.int8_chain}

    rec = {}
    check_nms(dev, rec)
    check_chain(dev, rec)
    check_fuse_up(dev, rec)
    check_wino(dev, rec)
    check_int8_chain(dev, rec)
    check_qconv(dev)
    summary = {}
    if not args.kernels_only:
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
            t0 = time.perf_counter()
            pths, weights = write_weights(tmp)
            print(f'seeded weights written in {time.perf_counter() - t0:.1f}'
                  f' s', flush=True)
            check_hrnet_forward(dev, pths[48])
            totals = {k: 0 for k in counters}
            by_path = {k: {} for k in counters}
            for path in MAIN_PATHS:
                launches, single, stack, summary[path[0]] = run_main_path(
                    dev, path, pths[path[1]], weights, counters)
                for k in counters:
                    totals[k] += launches[k]
                    if launches[k]:
                        by_path[k][path[0]] = {'single': single[k],
                                               'stack8': stack[k]}
        if any(n == 0 for n in totals.values()):
            raise AssertionError(f'a kernel was not launched on the main '
                                 f'paths: {totals}')
        # each kernel's per-predict launches on its own path
        home = {'nms': 'w48_bf16', 'basic_chain': 'w48_bf16',
                'fuse_up': 'w48_bf16', 'wino_chain': 'w32_bf16',
                'int8_chain': 'w32_int8'}
        for name, n in totals.items():
            rec[name].update(
                launches=n,
                launches_single=by_path[name][home[name]]['single'],
                launches_stack8=by_path[name][home[name]]['stack8'],
                launches_by_path=by_path[name])
    print(json.dumps({'kernels': list(rec.values()), 'main_path': summary}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
