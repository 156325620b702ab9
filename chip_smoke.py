"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root on a host with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. build the six CUDA kernels from ``simple_hrnet_tpu_torch/csrc`` (one
     nvcc per source, all at once: K1-K3, B3, B4 and K4, the detectors'
     activation kernel) and print the build time;
  2. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes (every batch phases 4, 5 and 7 give the pose model,
     W48's from 1 to 64): NMS
     slot for slot (the 8-, 4- and one-frame detects, unsorted scores, N
     = 1000 and 1024, max_out > N), the basic chain at W48 in bf16 and
     f32 (TF32 off) and at W32 in f32, the fuse at W48 in bf16 and f32 and
     at W32 in bf16 and f32,
     the Winograd chain at W32 in bf16, the int8 chain exactly at W32 and
     W48 in both cast-point modes; show that wrong-input controls fall
     outside each tolerance; time the kernel, the plain version and one
     library call (the kernels and the library calls replayed from CUDA
     graphs: NMS at the 8-, 4- and one-frame detects over a few input
     sets, beside an empty kernel and its eager time; the others over
     input sets larger than twice the L2: the basic chain at W48 batches
     32 and 2, the fuse at W48 with 1-3 sources and at W32 with 3, the
     Winograd and int8 chains at W32 batch 32, the Winograd chain also
     beside K2 at its shape, and failing unless it beats cuDNN's chain);
     check the int8 conv outside the chains (``torch._int_mm``) against
     its CPU integer path; hold K4 (sigmoid, SiLU, mish) against its plain
     version bit for bit at every YOLOv5m-640 activation shape at batches
     1, 4 and 8 in bf16 and f32, with PyTorch's one-rounding calls as
     controls that must differ, read it against the CPU's plain version,
     and time it from a CUDA graph beside ``F.silu`` and its byte bound;
  3. HRNet-W48 forward at 384x288, kernels against the plain path (f32);
  4. three main paths, each ``SimpleHRNet(c, 17, <.pth>, resolution,
     multiperson=True, yolo_model_def='yolov3', dtype)`` from a seeded
     random ``.pth`` and a seeded random darknet ``.weights`` file:
     W48-384x288 bf16 (basic chain + fuse), W32-256x192 bf16 (Winograd
     chain + fuse) and W32-256x192 int8 (int8 chain + fuse, HRNet and
     YOLOv3 quantized); YOLOv3 with its default space-to-depth phase
     stem, as every detector below unless said. Each runs ``predict`` on one synthetic 480x640
     frame and on a stack of 8, with every kernel's launch count set to 0
     just before and read just after, and checks that detections reached
     the pose path, that its kernels ran there (8 chain launches per pose
     forward), and that the pose model ran only at batches phase 2
     checked; it is timed, and its 8-frame call is profiled (device time
     by kernel, each port kernel's device time and launches summed over
     all its instantiations, and the idle share against the host time);
  5. the stream: ``predict_stream`` at W48-384x288 with the seeded
     YOLOv3-416 on 16 synthetic frames, in five modes (fixed per-frame
     with 16 slots, fixed chunked 4 frames a launch, adaptive per-frame
     and chunked with cap 16, compact 4 frames a window). In f32 (TF32
     off) each adaptive mode must equal its fixed mode and compact the
     fixed chunked mode (boxes equal, heatmaps and keypoints within 1e-4),
     and the fixed per-frame stream the first 16 people of
     ``predict(frame)``; a stub detector whose count follows each frame's
     mean makes a scene that must take the adaptive stream to its
     detect-only rung 0 and back. Every run resets the launch counts just
     before and reads them just after (K1 once a detect, the chain and
     the fuse 8 times a pose forward), runs every upload and runner call
     in sync-debug mode 'error', and fails on a pose batch phase 2 did not
     check. Then, in bf16 after ``warmup``, each mode over 64 frames
     (the 16 looped): a first run checked as above (launches, pose
     batches, guarded dispatch, people and finite keypoints), frames/s
     from three timed runs (median, min, max) beside ``predict`` frame by
     frame and on stacks of 4, and device busy time and idle share over
     the first 16 frames (one profiled run against three timed ones);
  6. the SimpleBaselines path: ``SimpleHRNet(50, 17, <.pth>,
     model_name='PoseResNet', resolution=(256, 192), yolo_version='v5',
     yolo_model_def=<.pt>)`` from a seeded random PoseResNet-50 ``.pth``
     and a seeded yolov5m ``.pt`` (the port's own network pickled as
     ultralytics pickles its models, read back through the stub loader;
     ``tests/torch_v5_weights.py``). In f32 on one 480x640 frame it is held
     against the same facade on the CPU (detector rows, heatmaps, and the
     keypoints whose heatmap peak is clear of its runner-up); in bf16 and
     int8 (PoseResNet's policy convs in int8, YOLOv5 bf16) ``predict`` runs
     on 1 and 8 frames, timed and profiled, with K1 launched once a detect
     chunk, K4 once each of YOLOv5m's SiLUs a chunk and no other kernel,
     and no PyTorch SiLU kernel in the profile; in bf16 after ``warmup``
     one chunked
     ``predict_stream`` (4 frames a launch) runs as phase 5 runs its modes,
     dispatch guarded, and is timed over 64 frames. Then the two stem
     forms: YOLOv3-416 (the goldens' seeded weights) and YOLOv5m-640
     built with ``phase_stem=True`` and ``False`` detect on the 8-frame
     stack in f32, each form's rows held against the other's (matched by
     box, boxes within 1e-2 px, scores 1e-4), and each form's letterbox +
     stem convs (``conv_0``/``conv_1``, ``model.0``) in bf16 is timed in
     one profile (device ms a call) and by CUDA events, beside the card's
     name and power limit, its kernels listed;
  7. the single-person path: ``SimpleHRNet(c, 17, <.pth>, resolution,
     multiperson=False, interpolation=...)`` on the same 480x640 frames, no
     detector. In f32, entered with both TF32 flags on (cuDNN's is on by
     PyTorch's default), W48-384x288 and W32-256x192 on the card against
     the same facade on the CPU for 'cubic', 'linear' and 'bilinear_aa':
     the rounded resized frames within one count, heatmaps within 1e-5 of
     max (plus, where a count flipped, the card's own response to it),
     keypoints where the peak is clear, K2 and K3 8 times a call at a
     batch phase 2 checked; the flags must still be on after each
     ``predict``, and a control run with the pose model outside
     ``true_f32`` (in TF32) must exceed that heatmap limit.
     ``use_fused_kernels=False`` at W48 f32 against
     the kernel facade within phase 3's limit, with no port kernel
     launched. ``predict`` on 1 and 8 frames in bf16 at both widths and on
     one frame in W32 int8, launch counts reset just before each call and
     read just after (K1 never; the path's chain and K3 8 times, one pose
     forward a call, at batches phase 2 checked), timed and the 8-frame
     call profiled; the single-person ``predict_stream`` at W48 bf16 after
     ``warmup`` over 64 frames (the 16 looped), dispatch guarded, timed
     and profiled as phase 5's modes;
  8. the engine path (``utils/export.py``): five ``.torchpose`` engines
     exported on the card from phase 4's seeded ``.pth`` files at batch 16
     (W48-384x288 f32 with the kernels and with the plain graph, W48 bf16
     with the kernels, W32-256x192 int8 with the kernels, W32 bf16 with the
     kernels, whose chain is the Winograd op), each export and first load
     timed. Through ``SimpleHRNet(..., enable_tensorrt=True,
     multiperson=True)`` with the seeded YOLOv3-416, on the 8-frame stack in
     f32: the kernel engine against the eager kernel facade and the plain
     engine against ``use_fused_kernels=False`` (boxes equal, heatmaps
     within phase 3's limit, keypoints where the peak is clear), launch
     counts set to 0 just before each call and read just after (K1 once a
     detect chunk; the chain and K3 8 times an engine call, none in the
     plain graph; every engine call at batch 16). The bf16 W48, int8 W32
     and bf16 W32 engines run ``predict`` on 1 and 8 frames, counted the
     same way, each 8-frame answer read against the eager facade of its
     path (the W32 bf16 one also held against that facade at the engine's
     batch: boxes equal, heatmaps within phase 2's bf16 limit, keypoints
     where the peak is clear), timed in turn with the eager facade (call
     for call, one process state) and the 8-frame call profiled, printed
     beside those and phase 4's eager numbers;
     a chunked ``predict_stream`` from the bf16 engine after ``warmup``
     runs as phase 5 runs its modes, dispatch guarded;
  9. the training path (``train/``) at the ``train_coco`` CLI's defaults,
     fed by the port's ``COCODataset`` over seeded annotations and
     in-memory 480x640 images (its image read and warp replaced: the card
     host has no cv2). In f32, HRNet-W48-384x288 at batch 2: one flip-test
     eval step and one SGD train step (momentum 0) on the card from the
     device-target tail, against the same steps on the CPU from the host
     tail, within ``TRAIN_LIMITS`` (loss, heatmaps, the update vector,
     running statistics; the CPU on one thread against its default count
     printed beside them as the rounding yardstick); the steps must put
     back the TF32 flags they find; two controls (one BN momentum 10%
     off, one joint weight 1% off) must fall outside. In bf16,
     ``COCOTrain`` (batch 16, Adam lr 1e-3, flip test) runs an epoch of 2
     steps, validation with OKS-NMS and the native COCO AP, and
     ``_checkpoint``; the losses must be finite; ``load_train`` of
     ``checkpoint_last`` must give the trainer's state bit for bit; the
     loss on one batch repeated for 20 steps must fall; the step is timed
     (median of 10 after warmup, images/s, peak memory) and profiled
     (device busy, idle share, top kernels). No port kernel may launch
     anywhere in the phase;
 10. data parallelism and the host libraries (``parallel/``,
     ``data/native.py``). The facade on a mesh, W48-384x288 bf16 and W32
     int8 with phase 4's seeded files and YOLOv3-416: on ``make_mesh(1)``
     ``predict`` on 1 and 8 frames equals the meshless facade bit for bit;
     on a mesh of two replicas on the one card (``Mesh([cuda:0,
     cuda:0])``: the split, the per-replica dispatch and the gather all
     run) the boxes and people equal the meshless facade's and the
     heatmaps are within phase 2's bf16 limit; launches counted per call
     (the chain 8 times a pose forward of each replica, at batches phase 2
     checked), host time of the 8-frame call (W48 on both meshes, int8
     on the two replicas) and, on the W48 two-replica mesh, its device
     busy time and idle share;
     the fixed chunked stream (4 frames a launch) on the two-replica mesh
     with its dispatch guarded as in phase 5. Training: in a one-rank NCCL
     group, ``MPIITrain`` at the ``train_mpii`` defaults (HRNet-W32
     256x256, 16 joints, batch 16, Adam) in bf16 over seeded annotations
     and in-memory images runs an epoch of 2 steps and validation with
     PCKh, then its step is timed (median of 10, images/s, peak memory)
     and profiled (device busy, idle share); the W48 f32 train and eval
     steps at batch 2 under that mesh (DDP; one rank keeps
     ``BatchNorm2d``) against the meshless steps within ``TRAIN_LIMITS``;
     two processes over gloo on the card (CUDA tensors, each process's BNs
     ``GlobalBatchNorm2d``), each with half of a batch of 4, against the
     one-process steps on the whole batch within ``TRAIN_LIMITS``, with
     phase 9's two controls outside; no port kernel launches in training.
     The host libraries: ``nms_numpy``'s host-library route equals its
     numpy route on the YOLOv3 detections of phase 4's frames; the JPEG
     library is built and checked where ``jpeglib.h`` is installed, and
     the phase says so where it is not;
 11. the production-geometry goldens (``tests/torch_goldens.py``): the
     seeded weight files of BASELINE.json's five configs, the scoreboard
     path and the W32 multi-person path (BN statistics drawn so that
     every folded bias is non-zero) are drawn again with numpy and must
     reproduce the goldens' fingerprints ("weights differ" otherwise);
     each config then runs through the facade on the card with the
     kernels, in every dtype the card times and its golden holds
     (W32-256x192 single-person in f32, bf16 and int8;
     PoseResNet-50-256x192 on 4 frames in f32, bf16 and int8; W48-384x288
     at ``max_batch_size=16`` on 16 frames in f32 and 2 in bf16;
     YOLOv3-tiny + W32 in f32; YOLOv5m-640 + W48 ``predict_stream`` on 8
     frames at 8 people in f32, 5 in bf16; YOLOv3-416 + W48 in f32 and
     bf16; YOLOv3-416 + W32 ``predict`` on a stack of 2 frames in f32,
     bf16 and int8, YOLOv3 quantized), launches counted around each call
     (K1 once a detect, the chain and K3 8 times a pose forward), and is
     held against the JAX package's answers with the helper's card limits
     (f32 heatmaps within 1e-3 of max, boxes and decisive keypoints within
     1e-3 px; bf16 within twice the JAX package's own distance to f32,
     int8 within twice its own int8 spread, the old rule's bound printed
     beside it, and with its quantized convs and their activation scales;
     in bf16 and int8 the people matched by box, the detector's boxes
     within twice the JAX package's own dtype-to-f32 distance, the
     facade's whole-pixel boxes within that and at least one pixel); four
     controls (other frames' golden, a zeroed chain in f32, bf16 and int8,
     the PoseResNet-50 bf16 facade against its int8 golden, and YOLOv3 +
     W32 int8 with its YOLOv3 built with ``phase_stem=False``, whose
     policy quantizes ``conv_1`` too)
     must fail, their readings printed beside their bounds; all six
     kernels must have run (K4 on the YOLOv5m stream, once a SiLU of each
     detect chunk).
     Then the int8 trace: the W32 single-person int8 facade built on the
     card and on the CPU in this process, traced stage by stage
     (``torch_goldens.int8_trace``), with the frames' difference in counts,
     the calibration maps' in ulps, the first traced entry that departs,
     and the card's golden distance rerun on the CPU's frame and then also
     from the CPU's calibration map.

Prints the build log, one JSON ``kernels`` line, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. The
``--kernels-only`` flag stops after phase 2 (for iterating on a kernel);
``--train-only`` runs phase 9 alone, ``--parallel-only`` phase 10 and
``--goldens-only`` phase 11 (after building the kernels).
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
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

# the batches the W48 paths give the pose model: phase 4's predict calls
# (max_batch_size 32, 32 people a frame from the random detector) 2 and 32
# for one frame, 16 and 32 for the stack of 8; phase 5's streams (16
# people a frame) 2-16 a frame and 8-64 in chunks of 4 frames; phase 7's
# single-person path 1 (one frame, and its stream) and 8 (the stack of 8).
# Phase 2 checks the kernels at each; phases 4, 5 and 7 fail if the pose
# model sees another.
POSE_BATCHES = (1, 2, 4, 8, 16, 32, 64)
# the batches at which phase 2 times the W48 kernels (and holds the
# controls at the first): the 8-frame multi-person path's and the
# 1-frame path's smallest
TIME_BATCH = 32
SMALL_BATCH = 2
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


# K1's shapes (batch, candidates, slots): the 8-frame detect of phase 4,
# the 4-frame detect of phase 5's chunked streams and one frame
NMS_SHAPES = ((8, 256, 32), (4, 256, 32), (1, 256, 32))
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
             ('detect 4 frames', 4, 256, 32, True),
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


# branch 0's shapes (H, W, C) on the main paths, the chains' and the
# high-res fuse's base: W48 at 384x288 and W32 at 256x192; the fuse's
# sources at /2, /4, /8 with 2C, 4C, 8C channels
FUSE_W48 = (96, 72, 48)
FUSE_W32 = (64, 48, 32)


def _chain_inputs(dev, dtype, bsz, h=96, w=72, c=48):
    """Branch-0 operands (W48 by default); biases at folded-BN scale
    (uniform +-1)."""
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

    # W48 in f32 and bf16; W32 in f32 (phase 7's f32 single-person path:
    # the Winograd chain takes W32 in bf16 only)
    cases = [(dtype, FUSE_W48, bsz) for dtype in (torch.float32,
                                                  torch.bfloat16)
             for bsz in POSE_BATCHES] + \
        [(torch.float32, FUSE_W32, bsz) for bsz in POSE_BATCHES_W32]
    errs = {}
    for dtype, shape, bsz in cases:
        x, wt, b = _chain_inputs(dev, dtype, bsz, *shape)
        y = K.basic_chain(x, wt, b)
        ref = K.basic_chain_plain(x, wt, b)
        torch.cuda.synchronize()
        err, rel = rel_err(y, ref)
        if rel > TOL[dtype]:
            raise AssertionError(f'basic_chain {dtype} {shape} B={bsz}: max '
                                 f'err {err} ({rel} of max) > {TOL[dtype]}')
        errs[(dtype, shape, bsz)] = (err, rel)
        print(f'K2 basic_chain {str(dtype)[6:]} {shape} B={bsz}: max abs err '
              f'{err:.3e} (rel {rel:.3e}, tol {TOL[dtype]:.1e})', flush=True)
    bsz = TIME_BATCH
    x, wt, b = _chain_inputs(dev, torch.bfloat16, bsz)
    ref = K.basic_chain_plain(x, wt, b)
    last_dropped = b.clone()
    last_dropped[7] = 0.0
    control = check_controls('K2 bf16', ref, {
        'last conv bias dropped': K.basic_chain_plain(x, wt, last_dropped),
        'biases off by one channel': K.basic_chain_plain(
            x, wt, b.roll(1, dims=1))}, TOL[torch.bfloat16])
    del x, wt, b, ref, last_dropped
    head, small = time_chain(K, dev, bsz), time_chain(K, dev, SMALL_BATCH)
    x32, wt32, b32 = _chain_inputs(dev, torch.float32, bsz)
    ms32 = cuda_ms(lambda: K.basic_chain(x32, wt32, b32))
    _, h, w, c = x32.shape
    b32_ms, b32_by = bound(2 * nbytes(x32) + nbytes(wt32, b32),
                           8 * 2 * bsz * h * w * c * c * 9, torch.float32)
    rec['basic_chain'] = dict(
        name='basic_chain', route='cuda',
        source='simple_hrnet_tpu_torch/csrc/fused_block.cu',
        replaces='simple_hrnet_tpu/ops/pallas/fused_block.py:398',
        max_abs_err=max(errs[(torch.bfloat16, FUSE_W48, n)][0]
                        for n in POSE_BATCHES),
        max_rel_err=max(errs[(torch.bfloat16, FUSE_W48, n)][1]
                        for n in POSE_BATCHES),
        tolerance=TOL[torch.bfloat16], control_rel=control,
        ms=head['ms'], plain_ms=head['plain_ms'], bound_ms=head['bound_ms'],
        bound_by=head['bound_by'], library_ms=head['library_ms'],
        shape=head['shape'], timings=[head, small],
        checked_batches=list(POSE_BATCHES),
        f32_max_abs_err=max(errs[(torch.float32, FUSE_W48, n)][0]
                            for n in POSE_BATCHES),
        f32_max_abs_err_w32=max(errs[(torch.float32, FUSE_W32, n)][0]
                                for n in POSE_BATCHES_W32),
        checked_batches_f32_w32=list(POSE_BATCHES_W32),
        f32_ms=ms32, f32_bound_ms=b32_ms, f32_bound_by=b32_by)
    print(f'K2 basic_chain f32 B={bsz}: {ms32:.4f} ms (bound {b32_ms:.5f} '
          f'{b32_by})', flush=True)


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

    # both dtypes at both widths' batches
    cases = [(dtype, FUSE_W48, b) for dtype in (torch.float32,
                                                torch.bfloat16)
             for b in POSE_BATCHES] + \
        [(dtype, FUSE_W32, b) for dtype in (torch.float32, torch.bfloat16)
         for b in POSE_BATCHES_W32]
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
                                  (torch.float32, FUSE_W32, POSE_BATCHES_W32),
                                  (torch.bfloat16, FUSE_W32,
                                   POSE_BATCHES_W32)):
        worst[(dtype, shape)] = max(v for k, v in errs.items()
                                    if k[:2] == (dtype, shape))
        e = worst[(dtype, shape)]
        print(f'K3 fuse_up {str(dtype)[6:]} base {shape} B={batches}, 1-3 '
              f'sources: max abs err {e[0]:.3e} (rel {e[1]:.3e}, tol '
              f'{TOL[dtype]:.1e})', flush=True)
    bsz = TIME_BATCH
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
        f32_max_abs_err=worst[(torch.float32, FUSE_W48)][0],
        f32_max_abs_err_w32=worst[(torch.float32, FUSE_W32)][0])


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


# K4's shapes: the distinct activation shapes (channels, side) of
# YOLOv5m-640 (widths 48-768, strides 2-32), at the batches of phase 6's
# detects (one frame; the stack of 8) and its stream's chunks (4 frames)
ACT_SHAPES = ((48, 320), (96, 160), (48, 160), (192, 80), (96, 80),
              (384, 40), (192, 40), (768, 20), (384, 20))
ACT_BATCHES = (1, 4, 8)
# the ops of each activation's HLO (ops/activation.py), for its bound
ACT_OPS = {'sigmoid': 4, 'silu': 5, 'mish': 9}
# phase 2 times K4 at the largest activation of the 8-frame detect
ACT_TIME_SHAPE = (8, 48, 320, 320)


def _act_input(dev, dtype, shape, seed):
    """Conv-output-like values (normal, sd 3), channels-last as the
    detectors' convs leave them on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev) * 3.0
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _act_once(act):
    """PyTorch's own call for ``act``, which rounds once: the control."""
    return {'sigmoid': torch.sigmoid, 'silu': F.silu,
            'mish': lambda t: t * torch.tanh(F.softplus(t))}[act]


def _differing(a, b):
    """Elements of ``a`` and ``b`` that differ (NaN equal to NaN)."""
    return int(((a != b) & ~(torch.isnan(a) & torch.isnan(b))).sum().item())


def check_activation(dev, rec):
    """K4 against its plain version on the card, bit for bit, at every
    YOLOv5m-640 activation shape and batch, in bf16 and f32, for sigmoid,
    SiLU and mish; PyTorch's one-rounding calls as controls (bf16), which
    must differ; the card's K4 against the CPU's plain version (the JAX
    function on the CPU) read, not gated; timed from a CUDA graph beside
    ``F.silu`` and its byte bound."""
    from simple_hrnet_tpu_torch.ops import activation as P
    from simple_hrnet_tpu_torch.ops.cuda import activation as K

    checked, controls = 0, {}
    for dtype in (torch.bfloat16, torch.float32):
        for i, (c, side) in enumerate(ACT_SHAPES):
            for bsz in ACT_BATCHES:
                x = _act_input(dev, dtype, (bsz, c, side, side), 100 + i)
                for act in P.PLAIN:
                    got, want = K.activation(x, act), P.PLAIN[act](x)
                    diff = _differing(got, want)
                    if diff or got.stride() != x.stride():
                        raise AssertionError(
                            f'K4 {act} {dtype} {tuple(x.shape)}: {diff} '
                            f'elements differ from the plain version')
                    checked += 1
                    if dtype == torch.bfloat16 and (c, side) == (48, 320) \
                            and bsz == 1:
                        controls[act] = _differing(got, _act_once(act)(x)) \
                            / x.numel()
    torch.cuda.synchronize()
    if len(controls) != len(P.PLAIN) or not all(controls.values()):
        raise AssertionError(f'K4 controls: a one-rounding PyTorch call '
                             f'equals the kernel ({controls})')
    x = _act_input(dev, torch.bfloat16, (1, 48, 320, 320), 100)
    cpu = {act: _differing(K.activation(x, act).cpu(),
                           P.PLAIN[act](x.cpu())) for act in P.PLAIN}
    print(f'K4 activation: {checked} (activation, dtype, shape) cases equal '
          f'their plain version bit for bit (bf16 and f32, '
          f'{len(ACT_SHAPES)} YOLOv5m-640 shapes at batches {ACT_BATCHES}); '
          f'controls (PyTorch\'s one rounding, bf16, share differing) '
          f'{ {k: round(v, 4) for k, v in controls.items()} }; card K4 '
          f'against the CPU\'s plain version, bf16 (1, 48, 320, 320), '
          f'elements differing {cpu}', flush=True)

    timings = {}
    for act, dtype in (('silu', torch.bfloat16), ('sigmoid', torch.bfloat16),
                       ('mish', torch.bfloat16), ('silu', torch.float32)):
        x = _act_input(dev, dtype, ACT_TIME_SHAPE, 7)
        per_call = 2 * nbytes(x)
        sets = input_sets(x, per_call, lambda a: a.clone())
        ms = graph_ms([lambda a=a: K.activation(a, act) for a in sets])
        it = iter(range(1 << 30))
        plain_ms = cuda_ms(lambda: P.PLAIN[act](sets[next(it) % len(sets)]),
                           iters=10)
        lib_ms = graph_ms([lambda a=a: _act_once(act)(a) for a in sets]) \
            if act == 'silu' else None
        b_ms, b_by = bound(per_call, ACT_OPS[act] * x.numel(),
                           torch.float32)
        name = f'{act} {"bf16" if dtype == torch.bfloat16 else "f32"}'
        timings[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             share_of_bound=b_ms / ms, input_sets=len(sets))
        print(f'K4 activation {name} {ACT_TIME_SHAPE}: {ms:.4f} ms (plain '
              f'{plain_ms:.4f}, F.silu {"-" if lib_ms is None else f"{lib_ms:.4f}"}, '
              f'bound {b_ms:.5f} {b_by}, {100 * b_ms / ms:.1f}% of bound)',
              flush=True)
    t = timings['silu bf16']
    rec['activation'] = dict(
        name='activation', route='cuda',
        source='simple_hrnet_tpu_torch/csrc/activation.cu',
        replaces='simple_hrnet_tpu/detectors/yolov5.py:83', port_only=True,
        replaces_note='no pl.pallas_call: the XLA fusion of jax.nn.silu '
                      '(and darknet.py:429-433 sigmoid, mish, swish)',
        max_abs_err=0.0, tolerance='exact', control_share=controls,
        cpu_plain_differing=cpu, ms=t['ms'], plain_ms=t['plain_ms'],
        bound_ms=t['bound_ms'], bound_by=t['bound_by'],
        library_ms=t['library_ms'],
        shape=f'{ACT_TIME_SHAPE} silu bf16', timings=timings,
        checked=checked)


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
    if got != want or launches['nms'] == 0 or launches['fuse_up'] == 0 or \
            launches['activation']:
        raise AssertionError(f'[{name}] launches {launches} over '
                             f'{len(seen)} pose forwards; want chains {want} '
                             f'and NMS and the fuse launched, K4 not (YOLOv3 '
                             f'runs leaky)')
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
    busy_ms, top, port = profile_predict(f'phase 4 [{name}]', model, frames)
    idle = 1.0 - busy_ms / (t['stack8'] * 1e3)
    print(f'phase 4 [{name}]: predict(8 frames) host {t["stack8"] * 1e3:.1f} '
          f'ms, device busy {busy_ms:.2f} ms, idle share {100 * idle:.1f}%',
          flush=True)
    summary.update(stack8_device_busy_ms=busy_ms, stack8_top_device_ms=top,
                   stack8_port_kernels=port, stack8_idle_share=idle)
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
    'K4 activation': ('activation_kernel',),
}


def device_profile(fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler, CUDA
    activity). Returns the summed device ms, the rows (ms, calls, name)
    largest first, and each port kernel's [ms, launches] summed over all
    its instantiations."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # device-side entries only (kernels, memcpy, memset): the aten ops
        # that launch them would count the same time again
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        # a range annotated on the device track (the optimizer's step,
        # 'Optimizer.step#Adam.step') spans kernels counted on their own
        if getattr(ev, 'is_user_annotation', False) or \
                ev.key.startswith('Optimizer.'):
            continue
        dev_us = getattr(ev, 'self_device_time_total',
                         getattr(ev, 'self_cuda_time_total', 0.0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    port = {}
    for kernel, funcs in PORT_KERNELS.items():
        hit = [(ms, n) for ms, n, key in rows
               if any(re.search(rf'\b{f}\b', key) for f in funcs)]
        if hit:
            port[kernel] = [sum(ms for ms, _ in hit), sum(n for _, n in hit)]
    return sum(r[0] for r in rows), rows, port


def profile_predict(label, model, frames, forbid=None):
    """Device time by kernel over one ``predict`` of the 8-frame stack,
    printed under ``label``. Returns the summed device time, the ten
    largest entries and each port kernel's [ms, launches] summed over all
    its instantiations. Fails if a kernel's name matches the regex
    ``forbid`` (case ignored)."""
    busy, rows, port = device_profile(lambda: model.predict(frames))
    bad = [key for _, _, key in rows
           if forbid and re.search(forbid, key, re.I)]
    if bad:
        raise AssertionError(f'{label}: kernels matching {forbid!r} ran: '
                             f'{[k[:110] for k in bad]}')
    print(f'{label}: profile of predict(8 frames): device busy '
          f'{busy:.2f} ms; by kernel (ms, calls, name):', flush=True)
    for ms, n, key in rows[:15]:
        print(f'    {ms:9.3f} {n:6d}  {key[:110]}')
    print(f'{label}: port kernels, all instantiations (ms, '
          f'launches): ' + '; '.join(f'{k} {ms:.3f} ms, {n}'
                                     for k, (ms, n) in port.items()),
          flush=True)
    return busy, [[round(ms, 4), n, key[:80]] for ms, n, key in rows[:10]], \
        port


# phase 5's stream modes at W48-384x288 on 480x640 frames: (name,
# predict_stream keywords); 16 people a frame, the cap of the adaptive modes
STREAM_MODES = (
    ('fixed', dict(max_people=16, prefetch=2)),
    ('chunked', dict(max_people=16, batch_frames=4)),
    ('adaptive', dict(max_people=16, adaptive_slots=True)),
    ('adaptive_chunked', dict(max_people=16, batch_frames=4,
                              adaptive_slots=True)),
    ('compact', dict(max_people=16, batch_frames=4, compact_crops=True)),
)
# what each mode must equal: the adaptive modes their fixed-slot mode,
# compact the fixed chunked stream
STREAM_REFERENCE = {'adaptive': 'fixed', 'adaptive_chunked': 'chunked',
                    'compact': 'chunked'}
# the f32 agreement tolerance on heatmaps and keypoints (the JAX package's
# stream tests hold its modes to each other so): the modes differ only in
# the pose batches they form
STREAM_TOL = 1e-4
# the stub scene (``VaryStub`` of tests/torch_stream_stubs.py, whose
# person count follows each frame's mean; the random YOLOv3 finds 32
# people on every frame, so only such a scene rises and falls): people per
# frame (rising and falling through empty frames), the adaptive window that
# lets it reach rung 0 and return, and the people cap (the stub's 8 rows)
STUB_COUNTS = (3, 3, 1, 0, 0, 0, 0, 0, 6, 2, 7, 0)
STUB_WINDOW = 2
STUB_CAP = 8
# phase 5's timing window: ``smooth_frames(16)`` looped to 64 frames, so
# that start-up (the adaptive ladder's climb, the pipeline's fill and
# drain) is a few launches of many; each mode timed this many times. The
# idle share comes from the window's first 16 frames (the profiler's
# summary grows with the run), timed three times unprofiled. Both windows
# are sized so that the whole script stays well inside its time limit on a
# slow card host: the host-bound runs take twice as long there.
STREAM_TIME_FRAMES = 64
STREAM_TIME_RUNS = 3
STREAM_PROFILE_FRAMES = 16


def drive_stream(model, frames, kw, counters, per_pose=None,
                 batches=POSE_BATCHES):
    """One ``predict_stream`` run with every kernel's count set to 0 just
    before and read just after, every upload and runner call in sync-debug
    mode 'error' (``utils/dispatch.strict_dispatch``). Returns the results
    and the run's record: launches, pose batches, detector calls, guarded
    calls. Fails if the pose model saw a batch outside ``batches`` (the
    batches phase 2 checked its kernels at; None: a pose model that runs
    no port kernel), or if a kernel ran other than once a detect (K1, for
    a real detector; never without a detector), once an activation of
    each detect chunk's network (K4: YOLOv5's SiLUs) and ``per_pose`` times
    a pose forward (default HRNet-W48's: the chain and the fuse 8 times
    each)."""
    from simple_hrnet_tpu_torch.detectors.yolov3 import PersonDetector
    from simple_hrnet_tpu_torch.utils.dispatch import strict_dispatch

    seen, detects = [], []
    det = model.detector
    if det is not None:
        real_detect = det.detect_padded
        det.detect_padded = lambda f: (detects.append(f.shape[0]),
                                       real_detect(f))[1]
    # an engine facade's pose model is the exported program's module
    pose = model.model if model.engine is None else model.engine.module
    hook = pose.register_forward_pre_hook(
        lambda _m, args: seen.append(args[0].shape[0]))
    try:
        for k in counters.values():
            k.launches = 0
        with strict_dispatch(model) as calls:
            out = list(model.predict_stream(frames, **kw))
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in counters.items()}
    finally:
        hook.remove()
        if det is not None:
            del det.detect_padded
    if batches is not None and not set(seen) <= set(batches):
        raise AssertionError(f'stream {kw}: the pose model ran at batches '
                             f'{sorted(set(seen))}; phase 2 checked the '
                             f'kernels at {batches}')
    real = isinstance(det, PersonDetector)
    if per_pose is None:
        per_pose = {'basic_chain': 8, 'fuse_up': 8}
    want = {k: per_pose.get(k, 0) * len(seen) for k in counters}
    want['nms'] = len(detects) if real else 0
    if real:
        want['activation'] = activations_per_detect(det) * detect_chunks(
            det, detects)
    if launches != want or (real and not detects):
        raise AssertionError(f'stream {kw}: launches {launches} over '
                             f'{len(detects)} detects and {len(seen)} pose '
                             f'forwards; want {want}')
    if not calls.get('_upload') or sum(calls.values()) <= calls['_upload']:
        raise AssertionError(f'stream {kw}: dispatch not guarded ({calls})')
    return out, dict(launches=launches, pose_batches=seen,
                     detects=len(detects), guarded_calls=dict(calls))


def check_people(what, out, n_frames):
    """A stream's results: one a frame, 1-16 people each (the random
    YOLOv3 finds 32 a frame, the streams keep 16), every array finite.
    Returns the people a frame."""
    arrays = [o if isinstance(o, list) else [o] for o in out]
    people = [a[-1].shape[0] for a in arrays]
    if len(out) != n_frames or not all(0 < n <= 16 for n in people):
        raise AssertionError(f'[{what}] people a frame {people} over '
                             f'{len(out)} of {n_frames} frames')
    if not all(np.isfinite(x).all() for a in arrays for x in a):
        raise AssertionError(f'[{what}] non-finite heatmaps or keypoints')
    return people


def stream_err(what, out, ref, limit=None):
    """Max |difference| of heatmaps and keypoints over two streams' frames
    (``limit``: compare the first ``limit`` people of ``ref``'s frames);
    boxes must be equal and shapes the same. Fails above STREAM_TOL."""
    if len(out) != len(ref):
        raise AssertionError(f'{what}: {len(out)} frames against {len(ref)}')
    err = 0.0
    for i, (o, r) in enumerate(zip(out, ref)):
        o = [np.asarray(a) for a in o]
        r = [np.asarray(a)[:limit] for a in r]
        if [a.shape for a in o] != [a.shape for a in r]:
            raise AssertionError(f'{what}, frame {i}: shapes '
                                 f'{[a.shape for a in o]} against '
                                 f'{[a.shape for a in r]}')
        if not np.array_equal(o[1], r[1]):
            raise AssertionError(f'{what}, frame {i}: boxes differ')
        for a, b in ((o[0], r[0]), (o[2], r[2])):
            if a.size:
                err = max(err, float(np.abs(a - b).max()))
    if err > STREAM_TOL:
        raise AssertionError(f'{what}: max err {err} > {STREAM_TOL}')
    return err


def check_stream_agreement(model, frames, counters):
    """Phase 5 in f32 (TF32 off) with the random YOLOv3: each mode once,
    held to its reference mode, and the per-frame stream to the first 16
    people of ``predict(frame)``."""
    results, record = {}, {}
    for name, kw in STREAM_MODES:
        out, record[name] = drive_stream(model, frames, kw, counters)
        people = check_people(f'{name} f32', out, len(frames))
        results[name] = out
        r = record[name]
        print(f'phase 5 [{name}] f32: people {people}; pose batches '
              f'{r["pose_batches"]}; launches {r["launches"]} over '
              f'{r["detects"]} detects; guarded dispatch calls '
              f'{r["guarded_calls"]}', flush=True)
    errs = {f'{name} vs {ref}': stream_err(f'{name} vs {ref}', results[name],
                                           results[ref])
            for name, ref in STREAM_REFERENCE.items()}
    single = [model.predict(f) for f in frames]
    errs['fixed vs predict'] = stream_err('fixed vs predict(frame)',
                                          results['fixed'], single, limit=16)
    print(f'phase 5 agreement (f32, max |err| of heatmaps and keypoints, '
          f'boxes equal, tol {STREAM_TOL:.0e}): ' +
          '; '.join(f'{k} {v:.3e}' for k, v in errs.items()), flush=True)
    return record, errs


def check_stub_scene(model, counters, dev):
    """Phase 5's rising and falling scene (f32), on a facade of its own
    (runners keep the detector they were built with): the adaptive stream
    must run the detect-only rung 0 and come back to a pose rung; every
    mode must equal the fixed-slot stream there."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), 'tests'))
    from torch_stream_stubs import VaryStub, frames_with_counts

    counts = list(STUB_COUNTS)
    frames = frames_with_counts(counts, shape=(480, 640, 3))
    model.detector = VaryStub(dev)
    rungs = []
    spies = {
        '_fused_frame': lambda hw, s, _g=model._fused_frame: (
            rungs.append(s), _g(hw, s))[1],
        '_detect_counts': lambda hw, n, _g=model._detect_counts: (
            rungs.append(0), _g(hw, n))[1]}
    modes = (('adaptive', dict(adaptive_slots=True, slot_window=STUB_WINDOW)),
             ('adaptive_chunked', dict(batch_frames=4, adaptive_slots=True,
                                       slot_window=STUB_WINDOW)),
             ('compact', dict(batch_frames=4, compact_crops=True)))
    record, outs = {}, {}
    fixed, record['fixed'] = drive_stream(
        model, frames, dict(max_people=STUB_CAP), counters)
    for name, kw in modes:
        if name == 'adaptive':  # the per-frame rungs, 0 = the counts runner
            model.__dict__.update(spies)
        try:
            outs[name], record[name] = drive_stream(
                model, frames, dict(max_people=STUB_CAP, **kw), counters)
        finally:
            for spy in spies:
                model.__dict__.pop(spy, None)
    if [o[2].shape[0] for o in fixed] != counts:
        raise AssertionError(f'stub scene: people '
                             f'{[o[2].shape[0] for o in fixed]} against '
                             f'{counts}')
    first_idle = rungs.index(0) if 0 in rungs else None
    if first_idle is None or not any(r > 0 for r in rungs[first_idle:]):
        raise AssertionError(f'stub scene: the adaptive stream ran rungs '
                             f'{rungs}; want rung 0 and a pose rung after it')
    errs = {name: stream_err(f'stub {name}', out, fixed)
            for name, out in outs.items()}
    print(f'phase 5 stub scene (f32): people {counts}; adaptive rungs '
          f'{rungs}; max |err| against the fixed stream: ' +
          '; '.join(f'{k} {v:.3e}' for k, v in errs.items()), flush=True)
    return dict(counts=counts, rungs=rungs, errs=errs, record=record)


def host_s(fn, reps):
    """Host seconds of each of ``reps`` calls of ``fn``."""
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        secs.append(time.perf_counter() - t0)
    return secs


def time_frames(label, fn, short, n, n_prof):
    """A run over ``n`` frames (``fn``, ending in a device-to-host copy)
    timed STREAM_TIME_RUNS times on the host clock; the same run over the
    first ``n_prof`` frames (``short``) three times, and once profiled:
    device busy and the idle share against their median host time. Prints
    the reading under ``label`` and returns it."""
    torch.cuda.synchronize()
    secs = host_s(fn, STREAM_TIME_RUNS)
    short_ms = 1e3 * float(np.median(host_s(short, 3)))
    busy, _, port = device_profile(short)
    med = float(np.median(secs))
    fps = sorted(n / s for s in secs)
    t = dict(frames=n, host_ms=[1e3 * s for s in secs], frames_per_s=fps,
             frames_per_s_median=n / med, profiled_frames=n_prof,
             profiled_host_ms=short_ms, device_busy_ms=busy,
             idle_share=1.0 - busy / short_ms, port_kernels=port)
    print(f'{label}: {n} frames, {len(secs)} runs: median {n / med:.2f} '
          f'frames/s (min {fps[0]:.2f}, max {fps[-1]:.2f}; host ms '
          f'{" / ".join(f"{1e3 * s:.1f}" for s in secs)}); first {n_prof} '
          f'frames: host {short_ms:.1f} ms, device busy {busy:.2f} ms, idle '
          f'share {100 * t["idle_share"]:.1f}%; port kernels '
          + '; '.join(f'{k} {ms:.3f} ms, {c}' for k, (ms, c) in port.items()),
          flush=True)
    return t


def time_streams(pth, weights, counters):
    """Phase 5's timing in bf16: ``warmup``, then each mode over
    STREAM_TIME_FRAMES frames (``smooth_frames(16)`` looped) beside
    ``predict`` frame by frame and on stacks of 4 (keypoints only, as users
    call it by default). Each stream mode's first run is ``drive_stream``'s
    (launches, pose batches and dispatch checked) and its results are
    checked; then STREAM_TIME_RUNS runs on the host clock around the whole
    run, which ends in a device-to-host copy; then, on the first
    STREAM_PROFILE_FRAMES frames, three such runs and one profiled run:
    device busy and the idle share against their median host time.
    Returns the table and each stream mode's checked run's record."""
    from simple_hrnet_tpu_torch import SimpleHRNet

    model = SimpleHRNet(48, 17, pth, resolution=(384, 288),
                        yolo_model_def='yolov3', yolo_weights_path=weights,
                        dtype='bfloat16', device='cuda')
    hw = (480, 640)
    t0 = time.perf_counter()
    sizes = [model.warmup(hw, batch_sizes=(1, 4), stream_max_people=16,
                          stream_batch_frames=(1, 4)),
             model.warmup(hw, batch_sizes=(),
                          stream_max_people=('adaptive', 16),
                          stream_batch_frames=(1, 4)),
             model.warmup(hw, batch_sizes=(),
                          stream_max_people=('compact', 16),
                          stream_batch_frames=(4,))]
    warm_s = time.perf_counter() - t0
    print(f'phase 5 timing: W48-384x288 bf16 warmup {warm_s:.1f} s, runner '
          f'caches {sizes[-1]}', flush=True)
    frames = list(smooth_frames(16)) * (STREAM_TIME_FRAMES // 16)
    n, n_prof = len(frames), STREAM_PROFILE_FRAMES
    kws = dict(STREAM_MODES)

    def runner(name, fr):
        if name == 'predict_1':
            return lambda: [model.predict(f) for f in fr]
        if name == 'predict_4':
            stacks = [np.stack(fr[i:i + 4]) for i in range(0, len(fr), 4)]
            return lambda: [model.predict(s) for s in stacks]
        return lambda: list(model.predict_stream(fr, **kws[name]))

    table, record = {}, {}
    for name in ('predict_1', 'predict_4', *kws):
        fn, short = runner(name, frames), runner(name, frames[:n_prof])
        # the warm run: the people buckets this scene forms
        if name in kws:
            out, record[name] = drive_stream(model, frames, kws[name],
                                             counters)
            people = check_people(f'{name} bf16', out, n)
            print(f'phase 5 [{name}] bf16: people a frame {min(people)}-'
                  f'{max(people)}; pose batches '
                  f'{sorted(set(record[name]["pose_batches"]))}; launches '
                  f'{record[name]["launches"]} over '
                  f'{record[name]["detects"]} detects', flush=True)
        else:
            fn()
        table[name] = time_frames(f'phase 5 timing [{name}]', fn, short, n,
                                  n_prof)
    del model
    torch.cuda.empty_cache()
    return dict(warmup_s=warm_s, runner_caches=sizes[-1], runs=table), record


def run_stream_phase(dev, pth, weights, counters):
    """Phase 5: the stream modes at W48-384x288 with the seeded YOLOv3-416 on
    ``smooth_frames``: agreement in f32, the stub scene, launches and
    dispatch checked in every run, then timing in bf16. Returns each
    checked run's launches and the phase's record."""
    from simple_hrnet_tpu_torch import SimpleHRNet

    def facade():
        return SimpleHRNet(48, 17, pth, resolution=(384, 288),
                           yolo_model_def='yolov3', yolo_weights_path=weights,
                           return_heatmaps=True, return_bounding_boxes=True,
                           device='cuda')

    t0 = time.perf_counter()
    record, errs = check_stream_agreement(facade(), list(smooth_frames(16)),
                                          counters)
    stub = check_stub_scene(facade(), counters, dev)
    torch.cuda.empty_cache()
    timing, bf16 = time_streams(pth, weights, counters)
    print(f'phase 5: {time.perf_counter() - t0:.1f} s', flush=True)
    launches = {f'stream_{k}': v['launches'] for k, v in record.items()}
    launches.update({f'stream_stub_{k}': v['launches']
                     for k, v in stub['record'].items()})
    launches.update({f'stream_bf16_{k}': v['launches']
                     for k, v in bf16.items()})
    per_frame = {k: {n: c / 16 for n, c in v['launches'].items()}
                 for k, v in record.items()}
    per_frame.update({f'{k}_bf16': {n: c / STREAM_TIME_FRAMES
                                    for n, c in v['launches'].items()}
                      for k, v in bf16.items()})
    return launches, dict(agreement_max_err=errs, modes=record,
                          launches_per_frame=per_frame, stub_scene=stub,
                          timing=timing)


# phase 6: PoseResNet-50 256x192 with YOLOv5m-640, the SimpleBaselines
# path. Card against CPU in f32 (TF32 off), summation order only: detector
# boxes within V5_BOX_TOL px and scores within 1e-5, heatmaps within
# V5_HM_TOL of max |heatmap| (phase 3's f32 limit through ~60 layers);
# a keypoint is compared only where its heatmap peak clears the runner-up
# by 4x the measured heatmap error (elsewhere the argmax is a coin flip).
V5_RES = (256, 192)
V5_BOX_TOL = 1e-2
V5_HM_TOL = 1e-3
V5_STREAM = dict(max_people=16, batch_frames=4)
V5_DTYPES = (('bf16', 'bfloat16', (5, 3)), ('int8', 'int8', (5, 3)))
# ResNet-50's convs under the int8 policy: the 3x3 convs of layer1 and
# layer2
V5_INT8_CONVS = 7


def write_v5_weights(tmp):
    """A seeded random PoseResNet-50 .pth and a seeded yolov5m .pt (the
    port's network pickled as {'model': net}, shaped by
    ``tests/torch_v5_weights.py`` so that the random detector finds
    people and scores them apart)."""
    from simple_hrnet_tpu_torch.models import poseresnet
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), 'tests'))
    from torch_v5_weights import write_yolov5_pt

    pth = os.path.join(tmp, 'pose_resnet_50_256x192_seed0.pth')
    torch.save(poseresnet.init(50, 17, seed=0).state_dict(), pth)
    # person logit +1.5 (the helper's default +3 is for yolov5n at 128):
    # at 320 on smooth_frames it passes ~10-35 candidates a frame, scores
    # apart, so that the card and the CPU rank the same ones
    pt = write_yolov5_pt(os.path.join(tmp, 'yolov5m_seed0.pt'), 'yolov5m',
                         person_logit=1.5)
    return pth, pt


def v5_facade(pth, pt, dtype=None, device='cuda'):
    from simple_hrnet_tpu_torch import SimpleHRNet
    return SimpleHRNet(50, 17, pth, model_name='PoseResNet',
                       resolution=V5_RES, yolo_version='v5',
                       yolo_model_def=pt, dtype=dtype, return_heatmaps=True,
                       return_bounding_boxes=True, device=device)


def check_v5_f32(pth, pt, frame):
    """The f32 facade on the card against the same facade on the CPU (the
    plain versions, K1's included) on one frame."""
    card, cpu = v5_facade(pth, pt), v5_facade(pth, pt, device='cpu')
    rgb = np.ascontiguousarray(frame[None, ..., ::-1])
    gr, gv = (t.cpu().numpy() for t in card.detector.detect_padded(rgb))
    cr, cv = (t.numpy() for t in cpu.detector.detect_padded(rgb))
    people = int(cv.sum())
    if not np.array_equal(gv, cv) or people == 0:
        raise AssertionError(f'phase 6: detector validity card '
                             f'{gv.sum()} against CPU {people} rows')
    box_err = float(np.abs(gr[gv][:, :4] - cr[cv][:, :4]).max())
    score_err = float(np.abs(gr[gv][:, 4:6] - cr[cv][:, 4:6]).max())
    if box_err > V5_BOX_TOL or score_err > 1e-5:
        raise AssertionError(f'phase 6: detector rows differ: boxes '
                             f'{box_err} px, scores {score_err}')
    (hm, bx, pts), (chm, cbx, cpts) = card.predict(frame), cpu.predict(frame)
    if not np.array_equal(bx, cbx) or \
            hm.shape != (people, 17, V5_RES[0] // 4, V5_RES[1] // 4):
        raise AssertionError(f'phase 6: boxes or heatmap shapes differ '
                             f'({hm.shape}, {chm.shape})')
    hm_err = float(np.abs(hm - chm).max())
    top = float(np.abs(chm).max())
    if not np.isfinite(hm).all() or hm_err > V5_HM_TOL * top:
        raise AssertionError(f'phase 6: heatmaps differ by {hm_err} '
                             f'({hm_err / top} of max)')
    two = np.sort(chm.reshape(people, 17, -1), axis=-1)[..., -2:]
    clear = (two[..., 1] - two[..., 0]) > 4 * hm_err
    xy_err = float(np.abs(pts[clear][:, :2] - cpts[clear][:, :2]).max()) \
        if clear.any() else 0.0
    conf_err = float(np.abs(pts[..., 2] - cpts[..., 2]).max())
    if xy_err > 1e-3 or conf_err > V5_HM_TOL * top:
        raise AssertionError(f'phase 6: keypoints differ: positions '
                             f'{xy_err} px, confidences {conf_err}')
    rec = dict(people=people, box_err_px=box_err, score_err=score_err,
               heatmap_err=hm_err, heatmap_rel_err=hm_err / top,
               keypoints_compared=int(clear.sum()),
               keypoints_left_out=int(clear.size - clear.sum()),
               keypoint_xy_err=xy_err, keypoint_conf_err=conf_err)
    print(f'phase 6 f32 card vs CPU: YOLOv5m keeps {people} people on the '
          f'frame (same rows; boxes {box_err:.2e} px, scores '
          f'{score_err:.2e}); heatmaps {hm_err:.2e} ({hm_err / top:.2e} of '
          f'max, tol {V5_HM_TOL:.0e}); keypoints {rec["keypoints_compared"]} '
          f'compared ({xy_err:.2e} px), {rec["keypoints_left_out"]} left out '
          f'(peak within 4x the heatmap error of its runner-up)',
          flush=True)
    return rec


def run_v5_predict(name, dtype, reps, pth, pt, frames, counters):
    """``predict`` on 1 and 8 frames in ``dtype``: K1 once a detect chunk
    (one chunk: max_batch_size 32), K4 once a SiLU of each chunk's
    network, and no other kernel, finite outputs; timed, and the 8-frame
    call profiled, where no PyTorch SiLU kernel may run."""
    model = v5_facade(pth, pt, dtype=dtype)
    if model.detector.quantized or \
            model.detector.dtype != torch.bfloat16:
        raise AssertionError(f'phase 6 [{name}]: YOLOv5 must run bf16')
    from simple_hrnet_tpu_torch.models.layers import QConv2d
    n_q = sum(isinstance(m, QConv2d) for m in model.model.modules())
    if n_q != (V5_INT8_CONVS if dtype == 'int8' else 0):
        raise AssertionError(f'phase 6 [{name}]: {n_q} int8 convs')
    launches = {}
    outs = {}
    silus = activations_per_detect(model.detector)
    for what, arg in (('single', frames[0]), ('stack8', frames)):
        for k in counters.values():
            k.launches = 0
        outs[what] = model.predict(arg)
        torch.cuda.synchronize()
        launches[what] = {k: f.launches for k, f in counters.items()}
        want = {k: int(k == 'nms') for k in counters}
        want['activation'] = silus
        if launches[what] != want:
            raise AssertionError(f'phase 6 [{name}] {what}: launches '
                                 f'{launches[what]}; want {want}')
    hm1, _, pts1 = outs['single']
    people8 = [p.shape[0] for p in outs['stack8'][2]]
    if pts1.shape[0] == 0 or not all(np.isfinite(a).all() for a in
                                     [hm1, pts1, *outs['stack8'][0]]):
        raise AssertionError(f'phase 6 [{name}]: no people or non-finite '
                             f'outputs')
    model.return_heatmaps = model.return_bounding_boxes = False
    t = {}
    for what, arg, n in (('single', frames[0], reps[0]),
                         ('stack8', frames, reps[1])):
        t0 = time.perf_counter()
        for _ in range(n):
            model.predict(arg)
        t[what] = (time.perf_counter() - t0) / n * 1e3
    label = f'phase 6 [{name}]'
    # no PyTorch SiLU kernel: every SiLU is K4 (its launches are counted
    # above by its wrapper; the profiler's own count can miss a record)
    busy, top, port = profile_predict(label, model, frames, forbid='silu')
    if 'K4 activation' not in port:
        raise AssertionError(f'{label}: K4 is not in the profile: {port}')
    idle = 1.0 - busy / t['stack8']
    print(f'{label}: people {pts1.shape[0]} (1 frame) / {people8} (8 '
          f'frames); predict 1 frame {t["single"]:.1f} ms, 8 frames '
          f'{t["stack8"]:.1f} ms ({8e3 / t["stack8"]:.2f} frames/s), device '
          f'busy {busy:.2f} ms, idle share {100 * idle:.1f}%; K1 launches '
          f'per predict {launches["single"]["nms"]} (1 frame), '
          f'{launches["stack8"]["nms"]} (8 frames); K4 (YOLOv5m\'s '
          f'{silus} SiLUs) {launches["single"]["activation"]}, '
          f'{launches["stack8"]["activation"]}', flush=True)
    del model
    torch.cuda.empty_cache()
    return launches, dict(
        people_single=int(pts1.shape[0]), people_stack8=people8,
        int8_convs=n_q, predict_ms_single=t['single'],
        predict_ms_stack8=t['stack8'], stack8_device_busy_ms=busy,
        stack8_idle_share=idle, stack8_top_device_ms=top,
        stack8_port_kernels=port, launches_single=launches['single'],
        launches_stack8=launches['stack8'], silus_per_detect=silus)


def run_v5_stream(pth, pt, counters):
    """One chunked ``predict_stream`` in bf16 after ``warmup``, on phase 5's
    frames: checked as phase 5 checks its runs (K1 once a detect, K4 once
    a SiLU of each detect chunk, no other kernel, every upload and runner
    call guarded), then timed over
    STREAM_TIME_FRAMES frames (median of STREAM_TIME_RUNS, min, max)."""
    model = v5_facade(pth, pt, dtype='bfloat16')
    model.return_heatmaps = model.return_bounding_boxes = False
    model.warmup((480, 640), batch_sizes=(), stream_max_people=16,
                 stream_batch_frames=(4,))
    frames = list(smooth_frames(16))
    out, record = drive_stream(model, frames, V5_STREAM, counters,
                               per_pose={}, batches=None)
    people = [o.shape[0] for o in out]
    if len(out) != 16 or not all(np.isfinite(o).all() for o in out) or \
            record['launches']['nms'] != 4:
        raise AssertionError(f'phase 6 stream: {len(out)} frames, people '
                             f'{people}, launches {record["launches"]}')
    frames = frames * (STREAM_TIME_FRAMES // 16)
    secs = []
    for _ in range(STREAM_TIME_RUNS):
        t0 = time.perf_counter()
        list(model.predict_stream(frames, **V5_STREAM))
        secs.append(time.perf_counter() - t0)
    fps = sorted(len(frames) / s for s in secs)
    med = len(frames) / float(np.median(secs))
    print(f'phase 6 stream (bf16, 4 frames a launch): people a frame '
          f'{people}; launches {record["launches"]} over '
          f'{record["detects"]} detects; guarded dispatch calls '
          f'{record["guarded_calls"]}; {len(frames)} frames: median '
          f'{med:.2f} frames/s (min {fps[0]:.2f}, max {fps[-1]:.2f})',
          flush=True)
    del model
    torch.cuda.empty_cache()
    return record, dict(people=people, frames=len(frames),
                        frames_per_s=fps, frames_per_s_median=med,
                        host_ms=[1e3 * s for s in secs],
                        launches=record['launches'],
                        guarded_calls=record['guarded_calls'])


# the detectors' two stem forms (``phase_stem``), exact rewrites of each
# other: in f32 their rows are held against each other, people matched by
# box, boxes within V5_BOX_TOL px (phase 6's card-against-CPU limit: the
# forms differ by summation order only) and scores within STEM_SCORE_TOL
# (the CPU reads 2.5e-5 between YOLOv3's forms on these frames with the
# goldens' weights; four times that); each form's letterbox and stem convs
# are timed in bf16, STEM_REPS calls a form, in one profile
STEM_SCORE_TOL = 1e-4
STEM_REPS = 5


def _match_rows(label, a, b):
    """Per frame, the valid rows of ``a`` and ``b`` (x1, y1, x2, y2, score,
    ...) matched by box, each row of ``a`` with its nearest in ``b``.
    Returns the largest box and score differences; fails on other
    counts, on no rows or on a row matched twice."""
    box_err = score_err = 0.0
    n = 0
    for i, (ra, rb) in enumerate(zip(a, b)):
        if len(ra) != len(rb):
            raise AssertionError(f'{label}: frame {i} keeps {len(ra)} rows '
                                 f'against {len(rb)}')
        if not len(ra):
            continue
        d = np.abs(ra[:, None, :4] - rb[None, :, :4]).max(-1)
        j = d.argmin(1)
        if len(set(j.tolist())) != len(j):
            raise AssertionError(f'{label}: frame {i}: rows matched twice')
        box_err = max(box_err, float(d[np.arange(len(j)), j].max()))
        score_err = max(score_err, float(np.abs(ra[:, 4] - rb[j, 4]).max()))
        n += len(ra)
    if n == 0:
        raise AssertionError(f'{label}: no rows to compare')
    return box_err, score_err, n


def _stem_bf16(det):
    """``det``'s letterbox and stem convs as its ``_detect`` runs them, on
    bf16 copies of the convs (``fold_weights``' and ``YOLOv5``'s casts):
    YOLOv3's ``conv_0`` and ``conv_1``, YOLOv5's ``model.0``."""
    from simple_hrnet_tpu_torch.detectors.darknet import Darknet
    if isinstance(det.net, Darknet):
        mods = [copy.deepcopy(det.net.conv_0), copy.deepcopy(det.net.conv_1)]
        for m in mods:
            m.weight.data = m.weight.data.to(torch.bfloat16)
            m.bias.data = m.bias.data.to(torch.bfloat16)
    else:
        mods = [copy.deepcopy(det.net.model['0']).to(torch.bfloat16)]

    def stem(frames):
        x = det._letterbox(frames).permute(0, 3, 1, 2).to(torch.bfloat16)
        for m in mods:
            x = m(x)
        return x
    return stem


@torch.no_grad()
def check_stem_forms(tmp, pt, frames):
    """YOLOv3-416 (the goldens' seeded weights: phase 4's own, whose
    activations shrink through the network, give outputs the input barely
    moves) and YOLOv5m-640 (phase 6's ``.pt``) built with
    ``phase_stem=True`` and ``False``: in f32 the 8-frame detects held
    against each other, then each form's letterbox + stem convs in bf16
    timed in one profile (device ms a call from the profile's ranges, and
    CUDA-event ms a call beside them) and its kernels listed."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from simple_hrnet_tpu_torch.detectors.yolov3 import YOLOv3
    from simple_hrnet_tpu_torch.detectors.yolov5 import YOLOv5

    t0 = time.perf_counter()
    weights = _goldens_module().write_weights(tmp, ['yolov3'])['yolov3'][0]
    rgb = np.ascontiguousarray(frames[..., ::-1])
    x = torch.from_numpy(rgb).cuda()
    makers = {'yolov3_416': lambda stem: YOLOv3(
                  'yolov3', weights_path=weights, device='cuda',
                  phase_stem=stem),
              'yolov5m_640': lambda stem: YOLOv5(pt, device='cuda',
                                                 phase_stem=stem)}
    rec, stems = {}, {}
    for name, make in makers.items():
        rows = {}
        for form, flag in (('phase', True), ('plain', False)):
            det = make(flag)
            if det.phase_stem != flag:
                raise AssertionError(f'stem forms [{name}]: phase_stem '
                                     f'{det.phase_stem}, asked {flag}')
            r, v = (t.cpu().numpy() for t in det.detect_padded(rgb))
            rows[form] = [r[i][v[i]] for i in range(len(r))]
            stems[f'{name} {form}'] = _stem_bf16(det)
            del det
        box_err, score_err, n = _match_rows(f'stem forms [{name}]',
                                            rows['phase'], rows['plain'])
        if box_err > V5_BOX_TOL or score_err > STEM_SCORE_TOL:
            raise AssertionError(f'stem forms [{name}] f32: phase against '
                                 f'plain rows: boxes {box_err} px, scores '
                                 f'{score_err}')
        rec[name] = dict(rows=n, box_err_px=box_err, score_err=score_err)
        print(f'stem forms [{name}] f32: phase and plain stems keep the same '
              f'{n} rows over 8 frames (boxes {box_err:.2e} px, scores '
              f'{score_err:.2e})', flush=True)
    torch.cuda.empty_cache()
    for fn in stems.values():  # warm up (cuDNN's algorithm choice)
        fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, fn in stems.items():
            with record_function(label):
                for _ in range(STEM_REPS):
                    fn(x)
            torch.cuda.synchronize()
    ranges = {}
    for ev in prof.events():
        if ev.name in stems and \
                ev.device_type == torch.autograd.DeviceType.CPU:
            ranges[ev.name] = (ranges.get(ev.name, 0.0)
                               + ev.device_time_total / 1e3 / STEM_REPS)
    events = {}
    for label, fn in stems.items():
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(STEM_REPS):
            fn(x)
        end.record()
        torch.cuda.synchronize()
        events[label] = start.elapsed_time(end) / STEM_REPS
    card = card_line()
    kernels = {}
    for label, fn in stems.items():
        print(f'stem forms bf16 [{label}]: letterbox + stem convs on 8 '
              f'frames: device {ranges.get(label, 0.0):.4f} ms a call (one '
              f'profile), {events[label]:.4f} ms a call (CUDA events); '
              f'{card}; its kernels (ms, calls, name), one call:',
              flush=True)
        _, rows, _ = device_profile(lambda: fn(x))
        kernels[label] = [[round(ms, 4), n, key[:80]] for ms, n, key in rows]
        for ms, n, key in rows[:8]:
            print(f'    {ms:9.4f} {n:4d}  {key[:100]}')
    if not all(ranges.get(label, 0.0) > 0 for label in stems):
        raise AssertionError(f'stem forms: the profile gave no device time '
                             f'to a range: {ranges}')
    rec.update(card=card, device_ms=ranges, event_ms=events,
               kernels=kernels, seconds=time.perf_counter() - t0)
    print(f'stem forms: {rec["seconds"]:.1f} s', flush=True)
    return rec


def run_v5_phase(tmp, counters):
    """Phase 6: the PoseResNet-50 + YOLOv5m path (see the module
    docstring), then the check of both detectors' stem forms. Returns
    each run's launches and the phase's record."""
    t0 = time.perf_counter()
    pth, pt = write_v5_weights(tmp)
    frames = smooth_frames(8)
    summary = {'f32_card_vs_cpu': check_v5_f32(pth, pt, frames[0])}
    launches = {}
    for name, dtype, reps in V5_DTYPES:
        runs, summary[name] = run_v5_predict(name, dtype, reps, pth, pt,
                                             frames, counters)
        launches.update({f'v5_{name}_{k}': v for k, v in runs.items()})
    record, summary['stream_bf16'] = run_v5_stream(pth, pt, counters)
    launches['v5_stream_bf16'] = record['launches']
    summary['stem_forms'] = check_stem_forms(tmp, pt, frames)
    summary['seconds'] = time.perf_counter() - t0
    print(f'phase 6: {summary["seconds"]:.1f} s', flush=True)
    return launches, summary

# phase 7: the single-person path (``multiperson=False``): no detector, the
# whole 480x640 frame resized to the model's resolution by
# ``interpolation``, posed and decoded against the frame. f32 card against
# CPU at both widths and each interpolation with both TF32 flags on
# (cuDNN's is on by PyTorch's default): the facade must compute in true
# f32 by itself and leave the flags as it found them. The rounded frames
# within one count (f32 matmuls summed in another order can land a
# half-way value one count apart); heatmaps within SINGLE_HM_TOL of max
# plus, where a count flipped, the card's own response to the flipped
# pixels; keypoints compared where the peak clears its runner-up by 4x the
# heatmap error. (name, width, resolution, dtype, the chain kernel that
# runs 8 times a pose forward, the batches phase 2 checked it at, frame
# counts predict runs on)
SINGLE_PATHS = (
    ('w48_bf16', 48, (384, 288), 'bfloat16', 'basic_chain', POSE_BATCHES,
     (1, 8)),
    ('w32_bf16', 32, (256, 192), 'bfloat16', 'wino_chain', POSE_BATCHES_W32,
     (1, 8)),
    ('w32_int8', 32, (256, 192), 'int8', 'int8_chain', POSE_BATCHES_W32,
     (1,)),
)
SINGLE_INTERPOLATIONS = ('cubic', 'linear', 'bilinear_aa')
# the f32 checks' (width, resolution, the batches phase 2 checked K2 and
# K3 at in f32), and the stream's (bf16) and the plain graph's (f32)
SINGLE_F32 = ((48, (384, 288), POSE_BATCHES),
              (32, (256, 192), POSE_BATCHES_W32))
SINGLE_W48 = (48, (384, 288))
# f32 heatmaps, card against CPU, relative to max: sound runs read under
# 1e-6 (summation order); with the pose model in TF32 the control run
# must read above it
SINGLE_HM_TOL = 1e-5
# timing repetitions of predict on 1 and 8 frames
SINGLE_REPS = {1: 10, 8: 5}


def single_facade(c, res, pth, dtype=None, device='cuda', **kw):
    from simple_hrnet_tpu_torch import SimpleHRNet
    return SimpleHRNet(c, 17, pth, resolution=res, multiperson=False,
                       dtype=dtype, return_heatmaps=True,
                       return_bounding_boxes=True, device=device, **kw)


def tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def tf32_control(model, frame):
    """``model.predict(frame)``'s heatmaps with the pose model outside
    ``true_f32``: ``_pose_tail`` swapped for its undecorated body, so the
    pose model computes with the caller's TF32 flags (the resize keeps its
    own rule)."""
    from simple_hrnet_tpu_torch import api as A

    wrapped = A._pose_tail
    A._pose_tail = wrapped.__wrapped__
    try:
        return model.predict(frame)[0]
    finally:
        A._pose_tail = wrapped


def check_single_f32(dev, pths, frame, counters):
    """Phase 7 in f32: the card against the CPU at W48-384x288 and
    W32-256x192 for each interpolation, entered with both TF32 flags on;
    fails if a facade's construction or ``predict`` changes a flag, if K2
    and K3 do not run 8 times a call at a batch phase 2 checked in f32, or
    if the TF32 control stays within the heatmap limit. Puts the flags
    back as it found them. Returns the record and each call's launches."""
    from simple_hrnet_tpu_torch.ops import image as I

    resizers = {'cubic': I.resize_cubic, 'linear': I.resize_linear,
                'bilinear_aa': I.resize_bilinear_aa}
    want = {k: 8 if k in ('basic_chain', 'fuse_up') else 0 for k in counters}
    found = tf32_flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    rgb = torch.from_numpy(np.ascontiguousarray(frame[..., ::-1]))
    rec, launches = {}, {}
    try:
        for c, res, batches in SINGLE_F32:
            card = single_facade(c, res, pths[c])
            cpu = single_facade(c, res, pths[c], device='cpu')
            seen = []
            hook = card.model.register_forward_pre_hook(
                lambda _m, args: seen.append(args[0].shape[0]))
            for interp in SINGLE_INTERPOLATIONS:
                what = f'phase 7 f32 W{c} {interp}'
                for m in (card, cpu):  # the runners read it when built
                    m.interpolation = interp
                    m._single_runs.clear()
                for k in counters.values():
                    k.launches = 0
                forwards = len(seen)
                hm, bx, pts = card.predict(frame)
                torch.cuda.synchronize()
                run = {k: f.launches for k, f in counters.items()}
                launches[f'single_f32_w{c}_{interp}'] = run
                if tf32_flags() != (True, True):
                    raise AssertionError(f'phase 7: the facade changed the '
                                         f'TF32 flags to {tf32_flags()}')
                if run != want or len(seen) - forwards != 1 or \
                        not set(seen) <= set(batches):
                    raise AssertionError(
                        f'{what}: launches {run} (want {want}), '
                        f'{len(seen) - forwards} pose forwards at batches '
                        f'{sorted(set(seen))}; phase 2 checked {batches}')
                chm, cbx, cpts = cpu.predict(frame)
                pc, ph = (torch.clamp(torch.round(resizers[interp](
                    rgb.to(d), res)), 0.0, 255.0).cpu() for d in (dev, 'cpu'))
                flips = int((pc != ph).sum())
                frame_err = float((pc - ph).abs().max())
                if frame_err > 1.0 or not np.array_equal(bx, cbx) or \
                        hm.shape != chm.shape:
                    raise AssertionError(f'{what}: rounded frames {frame_err}'
                                         f' apart, boxes {bx} / {cbx}, '
                                         f'heatmaps {hm.shape} / '
                                         f'{chm.shape}')
                response = 0.0
                if flips:
                    single = card._single(res, 1)
                    a, b = (single(x.to(dev, torch.uint8)[None])[0]
                            for x in (pc, ph))
                    response = (a - b).abs().permute(0, 3, 1, 2).cpu().numpy()
                top = float(np.abs(chm).max())
                limit = SINGLE_HM_TOL * top + response
                diff = np.abs(hm - chm)
                if not np.isfinite(hm).all() or (diff > limit).any():
                    raise AssertionError(f'{what}: heatmaps differ by '
                                         f'{diff.max()} ({diff.max() / top} '
                                         f'of max; {flips} flipped counts)')
                hm_err = float(diff.max())
                control = np.abs(tf32_control(card, frame) - chm)
                if tf32_flags() != (True, True) or \
                        not (control > limit).any():
                    raise AssertionError(
                        f'{what}: the TF32 control read {control.max() / top}'
                        f' of max, within the limit {SINGLE_HM_TOL}; flags '
                        f'{tf32_flags()}')
                two = np.sort(chm.reshape(1, 17, -1), axis=-1)[..., -2:]
                clear = (two[..., 1] - two[..., 0]) > 4 * hm_err
                xy_err = float(np.abs(pts[clear][:, :2]
                                      - cpts[clear][:, :2]).max()) \
                    if clear.any() else 0.0
                if xy_err > 1e-3 or not clear.any():
                    raise AssertionError(f'{what}: keypoints differ by '
                                         f'{xy_err} px ({int(clear.sum())} '
                                         f'compared)')
                rec[f'w{c}_{interp}'] = dict(
                    frame_flips=flips, frame_max_err=frame_err,
                    heatmap_err=hm_err, heatmap_rel_err=hm_err / top,
                    tf32_control_rel_err=float(control.max()) / top,
                    keypoints_compared=int(clear.sum()),
                    keypoints_left_out=int(clear.size - clear.sum()),
                    keypoint_xy_err=xy_err, launches=run)
                print(f'{what} card vs CPU (TF32 flags on, left on): '
                      f'rounded frames {flips} counts apart (max '
                      f'{frame_err:.0f}); heatmaps {hm_err:.2e} '
                      f'({hm_err / top:.2e} of max, tol {SINGLE_HM_TOL:.0e}'
                      f'; TF32 control {control.max() / top:.2e}); '
                      f'keypoints {int(clear.sum())} compared '
                      f'({xy_err:.2e} px); launches {run}', flush=True)
            hook.remove()
            rec[f'w{c}_pose_batches'] = sorted(set(seen))
            del card, cpu
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = found
    return rec, launches


def check_single_plain(pth, frame, counters):
    """``use_fused_kernels=False`` at W48-384x288 f32 against the kernel
    facade on the card, one frame: heatmaps within phase 3's limit (1e-3 of
    max), no port kernel launched in the plain graph, the chain and the
    fuse 8 times each in the kernel one."""
    outs, launches = {}, {}
    for name, fused in (('kernels', True), ('plain', False)):
        model = single_facade(*SINGLE_W48, pth, use_fused_kernels=fused)
        for k in counters.values():
            k.launches = 0
        outs[name] = model.predict(frame)
        torch.cuda.synchronize()
        launches[name] = {k: f.launches for k, f in counters.items()}
        del model
    want = {k: 8 if k in ('basic_chain', 'fuse_up') else 0 for k in counters}
    if launches['kernels'] != want or any(launches['plain'].values()):
        raise AssertionError(f'phase 7 plain graph: launches {launches}')
    err, rel = rel_err(torch.from_numpy(outs['plain'][0]),
                       torch.from_numpy(outs['kernels'][0]))
    if rel > 1e-3:
        raise AssertionError(f'phase 7 plain graph against the kernels: max '
                             f'err {err} ({rel} of max) > 1e-3')
    print(f'phase 7 use_fused_kernels=False, W48 f32: heatmaps {err:.3e} '
          f'({rel:.3e} of max, tol 1e-3) from the kernel facade; launches '
          f'plain {launches["plain"]}, kernels {launches["kernels"]}',
          flush=True)
    torch.cuda.empty_cache()
    return dict(heatmap_err=err, heatmap_rel_err=rel, launches=launches)


def run_single_predict(path, pth, frames, counters):
    """Phase 7's ``predict`` on one path: on 1 and 8 frames (or 1), launch
    counts set to 0 just before each call and read just after (K1 never,
    the path's chain and K3 8 times a pose forward, one pose forward a
    call, at batches phase 2 checked), shapes and finite outputs; timed,
    and the 8-frame call profiled. Returns the launches and the record."""
    name, c, res, dtype, chain, batches, counts = path
    model = single_facade(c, res, pth, dtype)
    seen = []
    hook = model.model.register_forward_pre_hook(
        lambda _m, args: seen.append(args[0].shape[0]))
    hm_hw = (res[0] // 4, res[1] // 4)
    launches = {}
    try:
        for n in counts:
            arg = frames[0] if n == 1 else frames[:n]
            for k in counters.values():
                k.launches = 0
            forwards = len(seen)
            hm, bx, pts = model.predict(arg)
            torch.cuda.synchronize()
            launches[n] = {k: f.launches for k, f in counters.items()}
            want = {k: 8 if k in (chain, 'fuse_up') else 0 for k in counters}
            shapes = ((n, 17, *hm_hw), (n, 4),
                      (1, 17, 3) if n == 1 else (n, 1, 17, 3))
            if len(seen) - forwards != 1 or launches[n] != want or \
                    (hm.shape, bx.shape, pts.shape) != shapes or \
                    not (np.isfinite(hm).all() and np.isfinite(pts).all()):
                raise AssertionError(
                    f'phase 7 [{name}] {n} frames: {len(seen) - forwards} '
                    f'pose forwards, launches {launches[n]} (want {want}), '
                    f'shapes {hm.shape} {bx.shape} {pts.shape}')
    finally:
        hook.remove()
    if not set(seen) <= set(batches):
        raise AssertionError(f'phase 7 [{name}]: the pose model ran at '
                             f'batches {sorted(set(seen))}; phase 2 checked '
                             f'the kernels at {batches}')
    model.return_heatmaps = model.return_bounding_boxes = False
    t = {}
    for n in counts:
        arg = frames[0] if n == 1 else frames[:n]
        model.predict(arg)
        torch.cuda.synchronize()
        t[n] = 1e3 * float(np.median(host_s(lambda: model.predict(arg),
                                            SINGLE_REPS[n])))
    rec = dict(pose_batches=seen, launches={str(n): v for n, v in
                                            launches.items()},
               predict_ms={str(n): v for n, v in t.items()})
    if 8 in counts:
        busy, top, port = profile_predict(f'phase 7 [{name}]', model,
                                          frames[:8])
        rec.update(stack8_device_busy_ms=busy, stack8_top_device_ms=top,
                   stack8_port_kernels=port,
                   stack8_idle_share=1.0 - busy / t[8])
    print(f'phase 7 [{name}]: W{c}-{res[0]}x{res[1]} {dtype}, launches per '
          f'predict ' + '; '.join(f'{n} frame{"s" if n > 1 else ""} '
                                  f'{launches[n]}' for n in counts) +
          '; predict ' + ', '.join(f'{n} frame{"s" if n > 1 else ""} '
                                   f'{t[n]:.1f} ms ({1e3 * n / t[n]:.2f} '
                                   f'frames/s)' for n in counts) +
          (f'; 8 frames device busy {rec["stack8_device_busy_ms"]:.2f} ms, '
           f'idle share {100 * rec["stack8_idle_share"]:.1f}%'
           if 8 in counts else ''), flush=True)
    del model
    torch.cuda.empty_cache()
    return launches, rec


def run_single_stream(pth, counters):
    """The single-person ``predict_stream`` at W48-384x288 bf16 after
    ``warmup``, over STREAM_TIME_FRAMES frames (``smooth_frames(16)``
    looped): a first run checked as phase 5 checks its runs (no K1, the
    chain and the fuse 8 times a frame, every upload and runner call
    guarded), then timed as phase 5 times its modes."""
    model = single_facade(*SINGLE_W48, pth, 'bfloat16')
    model.return_heatmaps = model.return_bounding_boxes = False
    t0 = time.perf_counter()
    sizes = model.warmup((480, 640), batch_sizes=(1,))
    warm_s = time.perf_counter() - t0
    frames = list(smooth_frames(16)) * (STREAM_TIME_FRAMES // 16)
    out, record = drive_stream(model, frames, {}, counters)
    if len(out) != len(frames) or record['pose_batches'] != [1] * len(out) \
            or not all(o.shape == (1, 17, 3) and np.isfinite(o).all()
                       for o in out):
        raise AssertionError(f'phase 7 stream: {len(out)} frames, pose '
                             f'batches {sorted(set(record["pose_batches"]))}')
    print(f'phase 7 stream (W48-384x288 bf16, warmup {warm_s:.1f} s, '
          f'runner caches {sizes}): launches {record["launches"]} over '
          f'{len(out)} frames; guarded dispatch calls '
          f'{record["guarded_calls"]}', flush=True)
    timing = time_frames(
        'phase 7 stream timing', lambda: list(model.predict_stream(frames)),
        lambda: list(model.predict_stream(frames[:STREAM_PROFILE_FRAMES])),
        len(frames), STREAM_PROFILE_FRAMES)
    del model
    torch.cuda.empty_cache()
    return record, dict(warmup_s=warm_s, runner_caches=sizes,
                        launches=record['launches'],
                        guarded_calls=record['guarded_calls'], **timing)


def run_single_phase(dev, pths, counters):
    """Phase 7: the single-person path (see the module docstring). Returns
    each run's launches and the phase's record."""
    t0 = time.perf_counter()
    frames = smooth_frames(8)
    w48 = pths[SINGLE_W48[0]]
    summary, launches = {}, {}
    summary['f32_card_vs_cpu'], launches = check_single_f32(
        dev, pths, frames[0], counters)
    summary['plain_graph'] = check_single_plain(w48, frames[0], counters)
    for path in SINGLE_PATHS:
        runs, summary[path[0]] = run_single_predict(path, pths[path[1]],
                                                    frames, counters)
        launches.update({f'single_{path[0]}_{n}': v for n, v in runs.items()})
    record, summary['stream_bf16'] = run_single_stream(w48, counters)
    launches['single_stream_bf16'] = record['launches']
    summary['seconds'] = time.perf_counter() - t0
    print(f'phase 7: {summary["seconds"]:.1f} s', flush=True)
    return launches, summary


# phase 8: the engine path (utils/export.py), exported on the card from
# phase 4's seeded .pth files at ENGINE_BATCH, a batch phase 2 checks the
# kernels at: (name, width, resolution, export options, the chain the
# engine must launch 8 times a call, None for the plain graph)
ENGINE_BATCH = 16
ENGINES = (
    ('w48_f32_fused', 48, (384, 288), dict(fused=True), 'basic_chain'),
    ('w48_f32_plain', 48, (384, 288), dict(fused=False), None),
    ('w48_bf16_fused', 48, (384, 288), dict(fused=True, half=True),
     'basic_chain'),
    ('w32_int8_fused', 32, (256, 192), dict(fused=True, int8=True),
     'int8_chain'),
    ('w32_bf16_fused', 32, (256, 192), dict(fused=True, half=True),
     'wino_chain'),
)
# the f32 engines and the eager facade each must agree with: the fused one
# with the kernel facade, the plain one with use_fused_kernels=False;
# heatmaps within phase 3's limit (1e-3 of max, summation order), boxes
# equal, keypoints within 1e-3 px where the heatmap peak clears its
# runner-up by 4x the measured heatmap error
ENGINE_F32 = (('w48_f32_fused', True), ('w48_f32_plain', False))
ENGINE_HM_TOL = 1e-3
# the timed engines, each beside phase 4's eager path of its width and type
ENGINE_TIMED = (('w48_bf16_fused', 'w48_bf16', 'bfloat16'),
                ('w32_int8_fused', 'w32_int8', 'int8'),
                ('w32_bf16_fused', 'w32_bf16', 'bfloat16'))
# the low-precision engines held against the eager facade of their path
# at the engine's batch (``max_batch_size=ENGINE_BATCH``) on the 8-frame
# stack: boxes equal, clear keypoints, heatmaps within phase 2's bf16
# kernel-vs-plain limit of max (the f32 engines equal their eager facades
# bit for bit). Against the eager facade at its own batch (32) the
# agreement of every timed engine is printed, not gated: there cuDNN's
# bf16 convs take other algorithms, and the one-step flips they leave
# carry through the network (1.26e-2 of max at W48, 1.95e-2 at W32 on an
# NVIDIA H100 80GB HBM3 at 700 W, past this limit).
ENGINE_CHECKED = {'w32_bf16_fused': TOL[torch.bfloat16]}
ENGINE_REPS = {1: 5, 8: 5}


def engine_facade(path, c, res, weights, **kw):
    from simple_hrnet_tpu_torch import SimpleHRNet
    return SimpleHRNet(c, 17, path, resolution=res, multiperson=True,
                       yolo_model_def='yolov3', yolo_weights_path=weights,
                       return_heatmaps=True, return_bounding_boxes=True,
                       device='cuda', **kw)


def engine_predict(what, model, arg, counters, chain):
    """One ``predict`` of an engine facade with every kernel's count set to
    0 just before and read just after: K1 once a detect chunk, the chain
    and K3 8 times an engine call (never for the plain graph), every
    engine call at ENGINE_BATCH. Returns the result, the launches and the
    engine calls."""
    seen = []
    hook = model.engine.module.register_forward_pre_hook(
        lambda _m, args: seen.append(args[0].shape[0]))
    n = 1 if arg.ndim == 3 else arg.shape[0]
    try:
        for k in counters.values():
            k.launches = 0
        out = model.predict(arg)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in counters.items()}
    finally:
        hook.remove()
    want = {k: 0 for k in counters}
    want['nms'] = -(-n // model.max_batch_size)
    if chain is not None:
        want[chain] = want['fuse_up'] = 8 * len(seen)
    if launches != want or not seen or set(seen) != {ENGINE_BATCH}:
        raise AssertionError(f'{what}: launches {launches} (want {want}) '
                             f'over engine calls at batches {seen}')
    return out, launches, len(seen)


def export_engines(tmp, pths):
    """Each of ENGINES exported on the card; returns the paths and each
    export's seconds and file size (the first load is timed where each
    engine's facade is built)."""
    from simple_hrnet_tpu_torch.utils.export import export_engine

    paths, secs = {}, {}
    for name, c, res, kw, _ in ENGINES:
        t0 = time.perf_counter()
        paths[name] = export_engine(os.path.join(tmp, f'{name}.torchpose'),
                                    pths[c], c=c, resolution=res,
                                    batch_size=ENGINE_BATCH, device='cuda',
                                    **kw)
        secs[name] = dict(export_s=time.perf_counter() - t0,
                          file_mb=os.path.getsize(paths[name]) / 1e6)
        print(f'phase 8 [{name}]: W{c}-{res[0]}x{res[1]} {kw} exported in '
              f'{secs[name]["export_s"]:.1f} s ({secs[name]["file_mb"]:.1f} '
              f'MB)', flush=True)
        torch.cuda.empty_cache()
    return paths, secs


def load_engine_facade(name, paths, weights, **kw):
    """The engine facade of ENGINES' ``name``, its build timed (the
    engine's load: ``torch.export.load`` and the module); returns it, the
    seconds and the exported graph's node count."""
    _, c, res, _, _ = next(e for e in ENGINES if e[0] == name)
    t0 = time.perf_counter()
    model = engine_facade(paths[name], c, res, weights, **kw)
    load_s = time.perf_counter() - t0
    nodes = len(model.engine.program.graph.nodes)
    print(f'phase 8 [{name}]: engine facade built in {load_s:.1f} s '
          f'({nodes} graph nodes)', flush=True)
    return model, load_s, nodes


def check_engine_f32(paths, pths, weights, frames, counters):
    """The f32 engines through ``SimpleHRNet(..., enable_tensorrt=True,
    multiperson=True)`` on the 8-frame stack against their eager facades
    (ENGINE_F32). Returns each run's launches and the record."""
    from simple_hrnet_tpu_torch import SimpleHRNet

    rec, runs = {}, {}
    for name, fused in ENGINE_F32:
        _, c, res, _, chain = next(e for e in ENGINES if e[0] == name)
        model, load_s, nodes = load_engine_facade(name, paths, weights)
        got, launches, calls = engine_predict(
            f'phase 8 [{name}] f32', model, frames, counters, chain)
        del model
        ref = SimpleHRNet(c, 17, pths[c], resolution=res, multiperson=True,
                          yolo_model_def='yolov3', yolo_weights_path=weights,
                          return_heatmaps=True, return_bounding_boxes=True,
                          device='cuda', use_fused_kernels=fused)
        want = ref.predict(frames)
        del ref
        torch.cuda.empty_cache()
        agree = engine_agreement(f'phase 8 [{name}]', got, want,
                                 ENGINE_HM_TOL)
        rec[name] = dict(load_s=load_s, graph_nodes=nodes,
                         engine_calls=calls, launches=launches, **agree)
        runs[f'engine_{name}_8'] = launches
        print(f'phase 8 [{name}] f32 engine facade vs eager '
              f'(use_fused_kernels={fused}), 8 frames: '
              f'{agreement_line(agree)}; {calls} engine calls, launches '
              f'{launches}', flush=True)
    return runs, rec


def engine_agreement(what, got, want, tol=None):
    """An engine facade's 8-frame ``predict`` (heatmaps, boxes, keypoints)
    against its eager facade's: the people and boxes, the heatmap distance
    of max, and the keypoints where the heatmap peak clears its runner-up
    by 4x that distance. With ``tol`` it fails unless the boxes are equal,
    every heatmap is finite and within ``tol`` of max, and some keypoints
    are clear and within 1e-3 px; without, it only reads. Returns the
    readings."""
    (hm, bx, pts), (rhm, rbx, rpts) = got, want
    boxes_equal = [b.shape for b in bx] == [b.shape for b in rbx] and all(
        np.array_equal(a, b) for a, b in zip(bx, rbx))
    out = dict(boxes_equal=boxes_equal, heatmap_tol=tol)
    fails = [] if boxes_equal else ['boxes differ from the eager facade']
    if boxes_equal:
        hm, rhm = np.concatenate(hm), np.concatenate(rhm)
        pts, rpts = np.concatenate(pts), np.concatenate(rpts)
        top = float(np.abs(rhm).max()) if rhm.size else 0.0
        err = float(np.abs(hm - rhm).max()) if rhm.size else 0.0
        two = np.sort(rhm.reshape(*rhm.shape[:2], -1), axis=-1)[..., -2:]
        clear = (two[..., 1] - two[..., 0]) > 4 * err
        xy_err = float(np.abs(pts[clear][:, :2] - rpts[clear][:, :2]
                              ).max()) if clear.any() else 0.0
        out.update(people=int(hm.shape[0]), heatmap_err=err,
                   heatmap_rel_err=err / top if top else 0.0,
                   keypoints_compared=int(clear.sum()),
                   keypoints_left_out=int(clear.size - clear.sum()),
                   keypoint_xy_err=xy_err)
        if not np.isfinite(hm).all() or hm.shape[0] == 0 or (
                tol is not None and err > tol * top):
            fails.append(f'heatmaps {err} ({out["heatmap_rel_err"]} of max,'
                         f' tol {tol}) from the eager facade, '
                         f'{hm.shape[0]} people')
        if xy_err > 1e-3 or not clear.any():
            fails.append(f'keypoints differ by {xy_err} px '
                         f'({int(clear.sum())} compared)')
    out['failures'] = fails
    if tol is not None and fails:
        raise AssertionError(f'{what}: ' + '; '.join(fails))
    return out


def agreement_line(a):
    if not a['boxes_equal']:
        return 'boxes differ (not gated)'
    tol = 'not gated' if a['heatmap_tol'] is None \
        else f'tol {a["heatmap_tol"]:.3e}'
    return (f'{a["people"]} people, boxes equal, heatmaps '
            f'{a["heatmap_err"]:.3e} ({a["heatmap_rel_err"]:.3e} of max, '
            f'{tol}), keypoints {a["keypoints_compared"]} compared '
            f'({a["keypoint_xy_err"]:.2e} px)'
            + (f'; outside: {"; ".join(a["failures"])}' if a['failures']
               else ''))


def time_engine(engine, paths, pths, weights, frames, counters, eager):
    """``predict`` on 1 and 8 frames of an engine facade: launches checked
    (``engine_predict``), host ms (median), the 8-frame call profiled.
    The eager facade of the same path is built beside it and timed in
    turn with it, call for call, so that both read the process and the
    host in one state; phase 4's eager numbers are printed too."""
    from simple_hrnet_tpu_torch import SimpleHRNet

    name, eager_name, dtype = engine
    _, c, res, _, chain = next(e for e in ENGINES if e[0] == name)
    model, load_s, nodes = load_engine_facade(name, paths, weights,
                                              dtype=dtype)
    runs, calls = {}, {}
    for n in (1, 8):
        arg = frames[0] if n == 1 else frames
        got, runs[f'engine_{name}_{n}'], calls[n] = engine_predict(
            f'phase 8 [{name}] {n} frames', model, arg, counters, chain)
    ref = SimpleHRNet(c, 17, pths[c], resolution=res, multiperson=True,
                      yolo_model_def='yolov3', yolo_weights_path=weights,
                      return_heatmaps=True, return_bounding_boxes=True,
                      dtype=dtype, device='cuda')
    forwards = []
    hook = ref.model.register_forward_pre_hook(
        lambda _m, args: forwards.append(args[0].shape[0]))
    want = ref.predict(frames)
    hook.remove()
    agree = {'eager': engine_agreement(f'phase 8 [{name}]', got, want)}
    if name in ENGINE_CHECKED:
        same = SimpleHRNet(c, 17, pths[c], resolution=res, multiperson=True,
                           yolo_model_def='yolov3',
                           yolo_weights_path=weights, return_heatmaps=True,
                           return_bounding_boxes=True, dtype=dtype,
                           max_batch_size=ENGINE_BATCH, device='cuda')
        agree['eager_at_engine_batch'] = engine_agreement(
            f'phase 8 [{name}] against eager at batch {ENGINE_BATCH}', got,
            same.predict(frames), ENGINE_CHECKED[name])
        del same
    for k, a in agree.items():
        print(f'phase 8 [{name}] engine facade vs {k}, 8 frames: '
              f'{agreement_line(a)}', flush=True)
    for m in (model, ref):
        m.return_heatmaps = m.return_bounding_boxes = False
    t, te = {}, {}
    for n in (1, 8):
        arg = frames[0] if n == 1 else frames
        secs = {'engine': [], 'eager': []}
        for _ in range(ENGINE_REPS[n]):
            for k, m in (('engine', model), ('eager', ref)):
                secs[k] += host_s(lambda: m.predict(arg), 1)
        t[n] = 1e3 * float(np.median(secs['engine']))
        te[n] = 1e3 * float(np.median(secs['eager']))
    del ref
    busy, top, port = profile_predict(f'phase 8 [{name}]', model, frames)
    idle = 1.0 - busy / t[8]
    ev = eager or {}
    print(f'phase 8 [{name}]: predict 1 frame {t[1]:.1f} ms (eager in '
          f'turn {te[1]:.1f}, phase 4 '
          f'{ev.get("predict_ms_single", float("nan")):.1f}), 8 frames '
          f'{t[8]:.1f} ms (eager in turn {te[8]:.1f}, phase 4 '
          f'{ev.get("predict_ms_stack8", float("nan")):.1f}); 8 frames '
          f'device busy {busy:.2f} ms (phase 4 eager '
          f'{ev.get("stack8_device_busy_ms", float("nan")):.2f}), idle share '
          f'{100 * idle:.1f}% (phase 4 eager '
          f'{100 * ev.get("stack8_idle_share", float("nan")):.1f}%); engine '
          f'calls {calls}, eager pose forwards on 8 frames {forwards}',
          flush=True)
    del model
    torch.cuda.empty_cache()
    return runs, dict(load_s=load_s, graph_nodes=nodes, engine_calls=calls,
                      predict_ms={str(n): v for n, v in t.items()},
                      eager_in_turn_predict_ms={str(n): v for n, v in
                                                te.items()},
                      eager_pose_forwards_stack8=forwards,
                      stack8_device_busy_ms=busy, stack8_top_device_ms=top,
                      stack8_port_kernels=port, stack8_idle_share=idle,
                      vs_eager=agree, eager=eager)


def run_engine_stream(paths, weights, counters):
    """A chunked ``predict_stream`` (4 frames a launch, 16 people) from the
    W48 bf16 engine after ``warmup``, as phase 5 runs its modes: launches
    counted, pose batches at ENGINE_BATCH, dispatch under
    ``strict_dispatch``."""
    name = 'w48_bf16_fused'
    _, c, res, _, _ = next(e for e in ENGINES if e[0] == name)
    model = engine_facade(paths[name], c, res, weights, dtype='bfloat16')
    model.return_heatmaps = model.return_bounding_boxes = False
    t0 = time.perf_counter()
    sizes = model.warmup((480, 640), stream_max_people=16,
                         stream_batch_frames=(4,))
    warm_s = time.perf_counter() - t0
    frames = list(smooth_frames(16))
    t0 = time.perf_counter()
    out, record = drive_stream(model, frames, dict(max_people=16,
                                                   batch_frames=4),
                               counters, batches=(ENGINE_BATCH,))
    run_s = time.perf_counter() - t0
    people = check_people('phase 8 stream', out, len(frames))
    print(f'phase 8 stream [{name}] (warmup {warm_s:.1f} s, runner caches '
          f'{sizes}): {len(out)} frames in {1e3 * run_s:.1f} ms, people a '
          f'frame {min(people)}-{max(people)}; launches '
          f'{record["launches"]}; engine calls '
          f'{len(record["pose_batches"])}; guarded dispatch calls '
          f'{record["guarded_calls"]}', flush=True)
    del model
    torch.cuda.empty_cache()
    return record['launches'], dict(warmup_s=warm_s, runner_caches=sizes,
                                    first_run_ms=1e3 * run_s, **record)


def run_engine_phase(tmp, pths, weights, counters, eager):
    """Phase 8: the engine path (see the module docstring). Returns each
    run's launches and the phase's record."""
    t0 = time.perf_counter()
    frames = smooth_frames(8)
    summary, launches = {}, {}
    paths, summary['exports'] = export_engines(tmp, pths)
    runs, summary['f32_vs_eager'] = check_engine_f32(paths, pths, weights,
                                                     frames, counters)
    launches.update(runs)
    for engine in ENGINE_TIMED:
        runs, summary[engine[0]] = time_engine(engine, paths, pths, weights,
                                               frames, counters,
                                               eager.get(engine[1]))
        launches.update(runs)
    launches['engine_stream_bf16'], summary['stream_bf16'] = \
        run_engine_stream(paths, weights, counters)
    summary['seconds'] = time.perf_counter() - t0
    print(f'phase 8: {summary["seconds"]:.1f} s', flush=True)
    return launches, summary


# phase 9: the training path at the train_coco CLI's defaults
TRAIN_RES = (384, 288)          # (height, width)
TRAIN_BATCH = 16
FLIP_PAIRS = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
              [15, 16]]
# the f32 card-vs-CPU limits of one W48 train step and one flip-test eval
# step at batch 2 (true f32 on both): loss relative; heatmaps of their
# largest value; the update vector as a whole (relative); running
# statistics of each BN's largest value. The train-mode forward and its
# backward carry each side's rounding through ~100 batch-statistics BNs,
# and the CPU on one thread against its default count differs by as much
# (the first card readings: train heatmaps 1.9e-4 and the update 3.8%
# from the CPU, the CPU from itself 1.7e-3 and 11%, running statistics
# 1.8e-5 and 1.9e-4); the controls (a BN momentum 10% off, one joint
# weight 1% off) move the running statistics (2e-2) and the loss (2.4e-3)
# by orders more than their limits
TRAIN_LIMITS = {'loss': 1e-5, 'heatmaps': 5e-3, 'eval_loss': 1e-5,
                'eval_heatmaps': 1e-4, 'update': 0.25,
                'running_stats': 1e-3}
REPEAT_STEPS = 20               # the bf16 steps on one repeated batch
TIMED_STEPS = 10                # timed bf16 steps after warmup


def write_memory_coco(root, seed=9):
    """Seeded person_keypoints_{train,val}2017.json under ``root`` (16 and
    8 images of 480x640, two people each, a few joints unlabelled)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, 'annotations'), exist_ok=True)
    ann_id = 1
    for version, n_img, first in (('train2017', 16, 1), ('val2017', 8, 101)):
        images, anns = [], []
        for img_id in range(first, first + n_img):
            images.append({'id': img_id, 'width': 640, 'height': 480,
                           'file_name': '%012d.jpg' % img_id})
            for _ in range(2):
                bw, bh = rng.uniform(80, 220), rng.uniform(160, 400)
                x, y = rng.uniform(0, 640 - bw), rng.uniform(0, 480 - bh)
                kpts = []
                for _ in range(17):
                    if rng.uniform() < 0.15:
                        kpts += [0.0, 0.0, 0]
                    else:
                        kpts += [float(x + rng.uniform(0, bw)),
                                 float(y + rng.uniform(0, bh)), 2]
                anns.append({'id': ann_id, 'image_id': img_id,
                             'category_id': 1, 'iscrowd': 0,
                             'bbox': [float(x), float(y), float(bw),
                                      float(bh)],
                             'area': float(bw * bh), 'keypoints': kpts,
                             'num_keypoints': sum(1 for v in kpts[2::3]
                                                  if v)})
                ann_id += 1
        with open(os.path.join(root, 'annotations',
                               f'person_keypoints_{version}.json'), 'w') as f:
            json.dump({'images': images, 'annotations': anns,
                       'categories': [{'id': 1, 'name': 'person'}]}, f)


class MemoryImages:
    """A dataset's image read and warp in numpy (the card host has no cv2):
    seeded 480x640 block images named by the file's number, and a
    nearest-neighbour warpAffine."""

    def _read_image(self, path):
        img_id = int(os.path.basename(path)[:-4].lstrip('im') or 0)
        blocks = np.random.default_rng(img_id).integers(
            0, 256, (30, 40, 3), dtype=np.uint8)
        return np.repeat(np.repeat(blocks, 16, axis=0), 16, axis=1)

    def _warp(self, image, trans):
        """Nearest-neighbour warpAffine (dst pixel -> source pixel by the
        inverse map, zeros outside)."""
        w, h = int(self.image_size[0]), int(self.image_size[1])
        inv = np.linalg.inv(np.vstack([trans, [0.0, 0.0, 1.0]]))[:2]
        ys, xs = np.mgrid[0:h, 0:w]
        src = inv @ np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
        sx = np.floor(src[0] + 0.5).astype(np.int64)
        sy = np.floor(src[1] + 0.5).astype(np.int64)
        ok = ((sx >= 0) & (sx < image.shape[1]) & (sy >= 0)
              & (sy < image.shape[0]))
        out = np.zeros((h * w, image.shape[2]), image.dtype)
        out[ok] = image[sy[ok], sx[ok]]
        return out.reshape(h, w, image.shape[2])


def memory_coco(**kw):
    """The port's ``COCODataset`` over seeded in-memory 480x640 images: its
    image read and warp replaced (``MemoryImages``), everything else,
    augmentation, targets and ``evaluate_overall_accuracy`` (OKS
    rescoring, OKS-NMS, the native COCO AP) as it is."""
    from simple_hrnet_tpu_torch.data.coco import COCODataset

    class MemoryCOCO(MemoryImages, COCODataset):
        pass

    return MemoryCOCO(image_width=TRAIN_RES[1], image_height=TRAIN_RES[0],
                      **kw)


def _train_f32_run(device, sd, batch, cfg, momentum_off=False, mesh=None):
    """A fresh W48 from ``sd`` on ``device``: one flip-test eval step, then
    one SGD train step (momentum 0, lr 1e-2), data-parallel over ``mesh``
    when given. Returns the results on the host."""
    from simple_hrnet_tpu_torch.models import hrnet
    from simple_hrnet_tpu_torch.train import losses, steps

    model = hrnet.HRNet(48, 17)
    model.load_state_dict(sd)
    model.to(device)
    if device.type == 'cuda':
        model.to(memory_format=torch.channels_last)
    opt, sched = steps.make_optimizer(model, 'SGD', lr=1e-2, momentum=0.0)
    train = steps.make_train_step(model, losses.joints_mse_loss, opt, sched,
                                  device_targets=cfg, mesh=mesh)
    if momentum_off:  # the control: one BN's momentum off by 10%
        model.stage2[0].branches[0][0].bn1.momentum = 0.11
    evaluate = steps.make_eval_step(model, losses.joints_mse_loss,
                                    flip_pairs=FLIP_PAIRS,
                                    device_targets=cfg, mesh=mesh)
    ev_loss, ev_out = evaluate(batch)[:2]
    loss, out = train(batch)[:2]
    return {'eval_loss': float(ev_loss), 'eval_out': ev_out.cpu(),
            'loss': float(loss), 'out': out.cpu(),
            'state': {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}}


def _train_errors(run, ref, sd):
    """Each TRAIN_LIMITS quantity of ``run`` against ``ref``."""
    err = {'loss': abs(run['loss'] / ref['loss'] - 1),
           'eval_loss': abs(run['eval_loss'] / ref['eval_loss'] - 1),
           'heatmaps': rel_err(run['out'], ref['out'])[1],
           'eval_heatmaps': rel_err(run['eval_out'], ref['eval_out'])[1]}
    d_run, d_ref, stats = [], [], 0.0
    for k, v in ref['state'].items():
        if k.endswith(('running_mean', 'running_var')):
            stats = max(stats, ((run['state'][k] - v).abs().max()
                                / v.abs().max()).item())
        elif v.is_floating_point():
            d_run.append((run['state'][k] - sd[k]).ravel())
            d_ref.append((v - sd[k]).ravel())
    d_run, d_ref = torch.cat(d_run), torch.cat(d_ref)
    err['update'] = ((d_run - d_ref).norm() / d_ref.norm()).item()
    err['running_stats'] = stats
    return err


def _train_f32_inputs(root, rows=(0, 1)):
    """The f32 checks' inputs: the host-tail and device-target batches of
    the val items ``rows``, the device-target config, and a seeded W48
    state dict with randomized running statistics."""
    from simple_hrnet_tpu_torch.data.loader import default_collate
    from simple_hrnet_tpu_torch.models import hrnet

    host_ds = memory_coco(root_path=root, data_version='val2017',
                          is_train=False)
    raw_ds = memory_coco(root_path=root, data_version='val2017',
                         is_train=False, device_targets=True)
    image, target, tw, _ = default_collate([host_ds[i] for i in rows])
    host = {'image': image, 'target': target, 'target_weight': tw}
    raw, joints, vis, _ = default_collate([raw_ds[i] for i in rows])
    raw_batch = {'image': raw, 'joints': joints, 'joints_vis': vis}
    cfg = {'heatmap_size': raw_ds.heatmap_size,
           'image_size': raw_ds.image_size,
           'heatmap_sigma': raw_ds.heatmap_sigma, 'joints_weight': None}

    model = hrnet.init(48, 17, seed=1)
    g = torch.Generator().manual_seed(2)
    for m in model.modules():  # eval reads the running statistics
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.5, 0.5, generator=g)
            m.running_var.uniform_(0.5, 2.0, generator=g)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    return host, raw_batch, cfg, sd


def _train_controls(dev, sd, raw_batch, cfg, ref):
    """Phase 9's two controls against ``ref``: the quantities each moves
    outside ``TRAIN_LIMITS`` (it fails if one moves none)."""
    controls = {}
    weights = np.ones((17, 1), np.float32)
    weights[3] = 1.01
    for name, run in (
            ('bn_momentum', _train_f32_run(dev, sd, raw_batch, cfg,
                                           momentum_off=True)),
            ('joint_weight', _train_f32_run(
                dev, sd, raw_batch, dict(cfg, joints_weight=weights)))):
        c_err = _train_errors(run, ref, sd)
        controls[name] = {k: v for k, v in c_err.items()
                          if v > TRAIN_LIMITS[k]}
        if not controls[name]:
            raise AssertionError(f'f32 control {name} stayed within the '
                                 f'limits: {c_err}')
    return controls


def check_train_f32(dev, card, root):
    """Phase 9's f32 check (see the module docstring). The card runs the
    device-target tail, the CPU the host tail of the same items."""
    host, raw_batch, cfg, sd = _train_f32_inputs(root)

    # the steps run in true f32 and put back the TF32 flags they found
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    card_run = _train_f32_run(dev, sd, raw_batch, cfg)
    if not (torch.backends.cuda.matmul.allow_tf32
            and torch.backends.cudnn.allow_tf32):
        raise AssertionError('a train or eval step left a TF32 flag off')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cpu_run = _train_f32_run(torch.device('cpu'), sd, host, None)
    cpu_s = time.perf_counter() - t0
    # the yardstick: the CPU against itself on one thread (another
    # summation order, the same arithmetic)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        noise = _train_errors(_train_f32_run(torch.device('cpu'), sd, host,
                                             None), cpu_run, sd)
    finally:
        torch.set_num_threads(threads)
    err = _train_errors(card_run, cpu_run, sd)
    bad = {k: v for k, v in err.items() if not v <= TRAIN_LIMITS[k]}
    if bad:
        raise AssertionError(f'phase 9 f32: card vs CPU outside the limits '
                             f'{bad} (limits {TRAIN_LIMITS})')
    controls = _train_controls(dev, sd, raw_batch, cfg, cpu_run)
    print(f'phase 9 [{card}]: W48-384x288 f32 train step + flip-test eval '
          f'step at batch 2, card (device targets) vs CPU (host targets, '
          f'{cpu_s:.1f} s): ' + ', '.join(f'{k} {v:.3e}' for k, v in
                                          err.items())
          + f' (limits {TRAIN_LIMITS}); the CPU on 1 thread against '
          f'{threads}: ' + ', '.join(f'{k} {v:.3e}' for k, v in
                                     noise.items())
          + f'; controls outside: {controls}', flush=True)
    return {'errors': err, 'limits': TRAIN_LIMITS, 'controls': controls,
            'cpu_one_thread': noise, 'cpu_s': cpu_s}


def _state_equal(a, b):
    return a.keys() == b.keys() and all(
        torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def run_train_bf16(dev, tmp, card, root):
    """Phase 9's bf16 run (see the module docstring)."""
    from simple_hrnet_tpu_torch.train.trainer import COCOTrain
    from simple_hrnet_tpu_torch.utils import checkpoint as ckpt

    out = {}
    t0 = time.perf_counter()
    trainer = COCOTrain(
        exp_name='phase9', epochs=1, batch_size=TRAIN_BATCH, num_workers=4,
        ds_train=memory_coco(root_path=root, data_version='train2017',
                             is_train=True),
        ds_val=memory_coco(root_path=root, data_version='val2017',
                           is_train=False),
        lr=1e-3, optimizer='Adam', log_path=os.path.join(tmp, 'train_logs'),
        use_tensorboard=False, model_c=48, model_nof_joints=17,
        flip_test_images=True, model_name='HRNet', seed=1,
        dtype='bfloat16', device=dev)
    trainer.run()
    torch.cuda.synchronize()
    out['epoch_s'] = time.perf_counter() - t0
    for k in ('mean_loss_train', 'mean_loss_val', 'mean_acc_val',
              'mean_mAP_val'):
        out[k] = float(getattr(trainer, k))
    if not (np.isfinite(out['mean_loss_train'])
            and np.isfinite(out['mean_loss_val'])):
        raise AssertionError(f'phase 9 bf16: non-finite loss {out}')
    if not 0.0 <= out['mean_mAP_val'] <= 1.0:
        raise AssertionError(f'phase 9 bf16: mAP {out["mean_mAP_val"]}')

    # checkpoint_last holds the state _checkpoint saw, bit for bit
    step, state, cfg = ckpt.load_train(os.path.join(trainer.log_path,
                                                    'checkpoint_last'))
    opt_now = trainer.optimizer.state_dict()
    same = (step == 1 and cfg['best_loss'] == trainer.best_loss
            and cfg['best_mAP'] == trainer.best_mAP
            and _state_equal(state['model'], trainer.model.state_dict())
            and all(_state_equal(st, opt_now['state'][i])
                    for i, st in state['optimizer']['state'].items())
            and state['scheduler'] == trainer.scheduler.state_dict())
    if not same:
        raise AssertionError('phase 9 bf16: load_train of checkpoint_last '
                             'differs from the trainer state')
    out['load_train_bitwise'] = True

    it = iter(trainer.dl_train)
    image, target, tw, _ = next(it)
    it.close()
    batch = {'image': image, 'target': target, 'target_weight': tw}
    step_fn = trainer._train_step
    losses = [float(step_fn(batch)[0]) for _ in range(REPEAT_STEPS)]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f'phase 9 bf16: the loss on one repeated batch '
                             f'did not fall: {losses}')
    out['repeat_losses'] = losses

    torch.cuda.reset_peak_memory_stats(dev)
    secs = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step_fn(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
    step_ms = float(np.median(secs)) * 1e3
    out['step_ms'] = {'median': step_ms, 'min': min(secs) * 1e3,
                      'max': max(secs) * 1e3}
    out['images_per_s'] = TRAIN_BATCH / step_ms * 1e3
    out['peak_gib'] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    busy, rows, port = device_profile(lambda: step_fn(batch))
    out['device_busy_ms'] = busy
    out['idle_share'] = max(0.0, 1.0 - busy / step_ms)
    out['top_kernels'] = [[round(ms, 3), n, key[:80]]
                          for ms, n, key in rows[:10]]
    if port:
        raise AssertionError(f'phase 9 bf16: port kernels in a train step '
                             f'profile: {port}')
    print(f'phase 9 [{card}]: COCOTrain W48-384x288 bf16 batch '
          f'{TRAIN_BATCH} Adam, 2 train steps + validation (16, flip test) + '
          f'checkpoint in {out["epoch_s"]:.1f} s: train loss '
          f'{out["mean_loss_train"]:.5f}, val loss {out["mean_loss_val"]:.5f}'
          f', val AP {out["mean_mAP_val"]:.4f}; load_train bit for bit',
          flush=True)
    print(f'phase 9 [{card}]: loss on one batch over {REPEAT_STEPS} steps: '
          + ' '.join(f'{v:.5f}' for v in losses), flush=True)
    print(f'phase 9 [{card}]: train step median {step_ms:.2f} ms (min '
          f'{out["step_ms"]["min"]:.2f}, max {out["step_ms"]["max"]:.2f}) '
          f'over {TIMED_STEPS}, {out["images_per_s"]:.1f} images/s, peak '
          f'memory {out["peak_gib"]:.2f} GiB; profile of one step: device '
          f'busy {busy:.2f} ms, idle share {out["idle_share"]:.3f}; top '
          f'(ms, calls, name):', flush=True)
    for ms, n, key in rows[:12]:
        print(f'    {ms:9.3f} {n:6d}  {key[:110]}')
    return out


def run_train_phase(dev, tmp, counters):
    """Phase 9: the training path. Returns its record; every port kernel's
    launch count must stay 0 across it."""
    t0 = time.perf_counter()
    card = card_line()
    root = os.path.join(tmp, 'coco')
    write_memory_coco(root)
    for k in counters.values():
        k.launches = 0
    summary = {'card': card, 'f32': check_train_f32(dev, card, root),
               'bf16': run_train_bf16(dev, tmp, card, root)}
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    if any(launches.values()):
        raise AssertionError(f'phase 9: port kernels launched in training '
                             f'or evaluation: {launches}')
    summary['launches'] = launches
    summary['seconds'] = time.perf_counter() - t0
    print(f'phase 9: no port kernel launched ({launches}); '
          f'{summary["seconds"]:.1f} s', flush=True)
    return summary


# ---------------------------------------------------------------------------
# phase 10: data parallelism and the host libraries
# ---------------------------------------------------------------------------

# the facade paths on a mesh (phase 4's): W48 bf16 (K2) and W32 int8 (B4)
PAR_PATHS = (MAIN_PATHS[0], MAIN_PATHS[2])
PAR_STREAM = dict(max_people=16, batch_frames=4)  # fixed chunked
PAR_STREAM_FRAMES = 16
# (timed predict(8 frames) calls, profiled?) a mesh facade, by path. On
# make_mesh(1) the facade runs phase 4's meshless code; int8's 8-frame
# call takes ~1 s and its profile (the patch matrix's thousands of
# launches) ~40 s, so int8 is timed once on the two replicas, unprofiled
PAR_TIMING = {'w48_bf16': {'mesh1': (3, False), 'mesh2': (3, True)},
              'w32_int8': {'mesh1': (0, False), 'mesh2': (1, False)}}
MPII_RES = (256, 256)            # the train_mpii defaults
MPII_WIDTH = 32
MPII_BATCH = 16
DP_ROWS = 4                      # the two-process step's global batch


def _par_facade(path, pth, weights, mesh, detector=None):
    """The path's facade, on ``mesh`` when given; with ``detector`` (the
    meshless facade's YOLOv3) it is built without one and takes that one,
    as tests/test_parallel.py builds its mesh facade."""
    from simple_hrnet_tpu_torch import SimpleHRNet

    _, c, res, dtype = path[:4]
    model = SimpleHRNet(c, 17, pth, resolution=res,
                        multiperson=detector is None,
                        yolo_model_def='yolov3', yolo_weights_path=weights,
                        dtype=dtype, return_heatmaps=True,
                        return_bounding_boxes=True, mesh=mesh,
                        device=None if mesh is not None else 'cuda')
    if detector is not None:
        model.multiperson, model.detector = True, detector
    return model


def _per_frame(out1, out8):
    """(heatmaps, boxes, keypoints) of the single frame, then of each of
    the 8 frames."""
    return [tuple(out1)] + list(zip(*out8))


def _compare_facades(label, got, want, exact):
    """``got`` against ``want`` frame by frame: bit for bit, or boxes and
    people equal and heatmaps within phase 2's bf16 limit of their max.
    Returns the largest heatmap error."""
    worst = 0.0
    for i, ((hm, bx, pts), (rhm, rbx, rpts)) in enumerate(zip(got, want)):
        if exact:
            if not (np.array_equal(hm, rhm) and np.array_equal(bx, rbx)
                    and np.array_equal(pts, rpts)):
                raise AssertionError(f'{label}: frame {i} differs from the '
                                     f'meshless facade')
            continue
        if not np.array_equal(bx, rbx) or pts.shape != rpts.shape:
            raise AssertionError(f'{label}: frame {i} boxes or people differ'
                                 f' from the meshless facade')
        if hm.size:
            err = float(np.abs(hm - rhm).max() / np.abs(rhm).max())
            worst = max(worst, err)
            if not err <= TOL[torch.bfloat16]:
                raise AssertionError(f'{label}: frame {i} heatmaps {err:.3e} '
                                     f'of max from the meshless facade '
                                     f'(limit {TOL[torch.bfloat16]:.3e})')
    return worst


def run_mesh_facade(dev, path, pth, weights, counters, card):
    """Phase 10's facade on one path: meshless, ``make_mesh(1)`` and two
    replicas on the one card. Returns the record and the launches of each
    mesh run."""
    from simple_hrnet_tpu_torch.parallel import Mesh, make_mesh

    name, c, res, dtype, batches, chain = path[:6]
    frames = smooth_frames(8)
    t0 = time.perf_counter()
    base = _par_facade(path, pth, weights, None)
    want = _per_frame(base.predict(frames[0]), base.predict(frames))
    per_pose = {chain: 8, 'fuse_up': 8}
    rec, runs = {'meshless_s': time.perf_counter() - t0}, {}
    for label, mesh in (('mesh1', make_mesh(1)), ('mesh2', Mesh([dev, dev]))):
        tag = f'phase 10 [{name} {label}]'
        t0 = time.perf_counter()
        model = _par_facade(path, pth, weights, mesh, base.detector)
        shared = all(m is model.model for m in model._models)
        seen = []
        hook = model.model.register_forward_pre_hook(
            lambda _m, args: seen.append(args[0].shape[0]))
        for k in counters.values():
            k.launches = 0
        out1 = model.predict(frames[0])
        torch.cuda.synchronize()
        l1 = {k: f.launches for k, f in counters.items()}
        n1 = len(seen)
        out8 = model.predict(frames)
        torch.cuda.synchronize()
        l8 = {k: f.launches - l1[k] for k, f in counters.items()}
        hook.remove()
        if not set(seen) <= set(batches):
            raise AssertionError(f'{tag}: pose batches {sorted(set(seen))}; '
                                 f'phase 2 checked {batches}')
        total = {k: l1[k] + l8[k] for k in counters}
        wanted = {k: per_pose.get(k, 0) * len(seen) for k in counters
                  if k != 'nms'}
        if {k: v for k, v in total.items() if k != 'nms'} != wanted or \
                not total['nms']:
            raise AssertionError(f'{tag}: launches {total} over {len(seen)} '
                                 f'pose forwards; want {wanted} and K1')
        err = _compare_facades(tag, _per_frame(out1, out8), want,
                               exact=label == 'mesh1')
        r = {'replicas': mesh.size, 'shared_model': shared,
             'pose_batches': seen, 'forwards_single': n1,
             'launches_single': l1, 'launches_stack8': l8,
             'launches_per_replica_stack8': {
                 k: v / mesh.size for k, v in l8.items()},
             'heatmap_err': err}
        timing = ''
        reps, profiled = PAR_TIMING[name][label]
        if reps:
            model.return_heatmaps = model.return_bounding_boxes = False
            t1 = time.perf_counter()
            for _ in range(reps):
                model.predict(frames)
            host_ms = (time.perf_counter() - t1) / reps * 1e3
            r.update(host_ms_stack8=host_ms, timed_reps=reps)
            timing = (f'; predict(8 frames) host {host_ms:.1f} ms (mean of '
                      f'{reps})')
        if profiled:
            busy, _, port = device_profile(lambda: model.predict(frames))
            idle = max(0.0, 1.0 - busy / host_ms)
            r.update(device_busy_ms=busy, idle_share=idle, port_kernels=port)
            timing += (f', device busy {busy:.2f} ms, idle share '
                       f'{100 * idle:.1f}%')
        r['seconds'] = time.perf_counter() - t0
        runs[f'{name}_{label}'] = total
        print(f'{tag} [{card}]: predict 1 and 8 frames '
              + ('bit for bit the meshless facade' if label == 'mesh1' else
                 f'boxes and people equal, heatmaps within {err:.3e} of max')
              + f'; pose batches {seen}; launches 1 frame {l1}, 8 frames '
              f'{l8} ({mesh.size} replicas){timing}; {r["seconds"]:.1f} s',
              flush=True)
        if label == 'mesh2' and name == PAR_PATHS[0][0]:
            model.return_heatmaps = model.return_bounding_boxes = True
            stream_frames = list(smooth_frames(PAR_STREAM_FRAMES, seed=7))
            out, srec = drive_stream(model, iter(stream_frames), PAR_STREAM,
                                     counters, per_pose=per_pose,
                                     batches=batches)
            check_people(f'{tag} stream', out, PAR_STREAM_FRAMES)
            # each replica detects 2 of a launch's 4 frames: cuDNN may pick
            # other algorithms at that batch, so boxes are compared, not
            # required equal
            ref = list(base.predict_stream(iter(stream_frames), **PAR_STREAM))
            same = sum(np.array_equal(a[1], b[1]) for a, b in zip(out, ref))
            srec['frames_with_equal_boxes'] = int(same)
            r['stream'] = srec
            runs[f'{name}_{label}_stream'] = srec['launches']
            print(f'{tag}: predict_stream {PAR_STREAM} over '
                  f'{PAR_STREAM_FRAMES} frames, dispatch guarded '
                  f'({srec["guarded_calls"]}): launches {srec["launches"]}, '
                  f'pose batches {sorted(set(srec["pose_batches"]))}; boxes '
                  f'equal to the meshless stream on {same} of '
                  f'{PAR_STREAM_FRAMES} frames', flush=True)
        rec[label] = r
        del model
    del base
    torch.cuda.empty_cache()
    return rec, runs


def write_memory_mpii(root, seed=13):
    """Seeded ``annot/{train,valid}.json`` under ``root`` (32 and 16
    records over 480x640 images ``im<k>.jpg``, a few joints invisible,
    head boxes on every record)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, 'annot'), exist_ok=True)
    for version, n, first in (('train', 32, 1), ('valid', 16, 101)):
        annots = []
        for k in range(first, first + n):
            cx, cy = rng.uniform(200, 440), rng.uniform(150, 330)
            s = rng.uniform(0.9, 1.6)
            joints = np.stack([cx + rng.uniform(-80, 80, 16),
                               cy + rng.uniform(-140, 140, 16)], 1)
            vis = (rng.uniform(0, 1, 16) > 0.1).astype(int)
            annots.append({'image': f'im{k}.jpg', 'center': [cx, cy],
                           'scale': s, 'joints': joints.tolist(),
                           'joints_vis': vis.tolist(),
                           'headbox': [cx - 30, cy - 180, cx + 30,
                                       cy - 110]})
        with open(os.path.join(root, 'annot', f'{version}.json'), 'w') as f:
            json.dump(annots, f)


def memory_mpii(**kw):
    """The port's ``MPIIDataset`` at the ``train_mpii`` resolution over
    seeded in-memory images (``MemoryImages``)."""
    from simple_hrnet_tpu_torch.data.mpii import MPIIDataset

    class MemoryMPII(MemoryImages, MPIIDataset):
        pass

    return MemoryMPII(image_width=MPII_RES[1], image_height=MPII_RES[0],
                      **kw)


def run_mpii_mesh(dev, tmp, card, root, mesh):
    """Phase 10's ``MPIITrain`` bf16 epoch under the one-rank mesh, then
    its step timed and profiled."""
    from simple_hrnet_tpu_torch.train.trainer import MPIITrain

    out = {}
    t0 = time.perf_counter()
    trainer = MPIITrain(
        exp_name='phase10', epochs=1, batch_size=MPII_BATCH, num_workers=4,
        ds_train=memory_mpii(root_path=root, data_version='train',
                             is_train=True),
        ds_val=memory_mpii(root_path=root, data_version='valid',
                           is_train=False),
        lr=1e-3, optimizer='Adam', log_path=os.path.join(tmp, 'mpii_logs'),
        use_tensorboard=False, model_c=MPII_WIDTH, model_nof_joints=16,
        flip_test_images=True, model_name='HRNet', seed=1,
        dtype='bfloat16', mesh=mesh)
    trainer.run()
    torch.cuda.synchronize()
    out['epoch_s'] = time.perf_counter() - t0
    for k in ('mean_loss_train', 'mean_loss_val', 'mean_acc_val',
              'mean_mAP_val'):
        out[k] = float(getattr(trainer, k))
    out['pckh_val'] = {k: float(v) for k, v in trainer.val_accs.items()}
    if not (np.isfinite(out['mean_loss_train'])
            and np.isfinite(out['mean_loss_val'])
            and 0.0 <= out['mean_mAP_val'] <= 1.0):
        raise AssertionError(f'phase 10 MPIITrain: {out}')
    if trainer.len_dl_train != 2 or not os.path.exists(os.path.join(
            trainer.log_path, 'params_best_mAP.npz')):
        raise AssertionError('phase 10 MPIITrain: not 2 steps and a '
                             'checkpoint')
    it = iter(trainer.dl_train)
    image, target, tw, _ = next(it)
    it.close()
    batch = {'image': image, 'target': target, 'target_weight': tw}
    step_fn = trainer._train_step
    for _ in range(2):
        step_fn(batch)
    torch.cuda.reset_peak_memory_stats(dev)
    secs = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step_fn(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
    step_ms = float(np.median(secs)) * 1e3
    out['step_ms'] = {'median': step_ms, 'min': min(secs) * 1e3,
                      'max': max(secs) * 1e3}
    out['images_per_s'] = MPII_BATCH / step_ms * 1e3
    out['peak_gib'] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    busy, rows, port = device_profile(lambda: step_fn(batch))
    out['device_busy_ms'] = busy
    out['idle_share'] = max(0.0, 1.0 - busy / step_ms)
    out['top_kernels'] = [[round(ms, 3), n, key[:80]]
                          for ms, n, key in rows[:8]]
    if port:
        raise AssertionError(f'phase 10: port kernels in a train step: '
                             f'{port}')
    print(f'phase 10 [{card}]: MPIITrain HRNet-W{MPII_WIDTH}-'
          f'{MPII_RES[0]}x{MPII_RES[1]} bf16 batch {MPII_BATCH} Adam under '
          f'a one-rank NCCL mesh: 2 steps + validation (16, flip test, '
          f'PCKh) + checkpoint in {out["epoch_s"]:.1f} s: train loss '
          f'{out["mean_loss_train"]:.5f}, val loss {out["mean_loss_val"]:.5f}'
          f', val PCKh {out["mean_mAP_val"]:.4f}; step median {step_ms:.2f} '
          f'ms (min {out["step_ms"]["min"]:.2f}, max '
          f'{out["step_ms"]["max"]:.2f}) over {TIMED_STEPS}, '
          f'{out["images_per_s"]:.1f} images/s, peak memory '
          f'{out["peak_gib"]:.2f} GiB; device busy {busy:.2f} ms, idle '
          f'share {out["idle_share"]:.3f}', flush=True)
    return out


def dp_child(addr, rank, inputs, out_path):
    """One process of phase 10's two-process step (``--dp-child``): joins
    the gloo group on the card, runs the f32 eval and train steps on its
    rows of the global batch, and (rank 0) saves the gathered results."""
    from simple_hrnet_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize(addr, 2, int(rank), backend='gloo',
                           device='cuda')
    try:
        mesh = make_mesh()
        data = torch.load(inputs, weights_only=False)
        local = distributed.global_batch(data['batch'], mesh)
        run = _train_f32_run(mesh.devices[0], data['sd'], local, data['cfg'],
                             mesh=mesh)
        if int(rank) == 0:
            torch.save(run, out_path)
        torch.distributed.barrier()
    finally:
        distributed.shutdown()
    return 0


def run_two_process_step(dev, tmp, card, root):
    """The two-process f32 step over gloo on the card against the
    one-process step on the whole batch, with phase 9's controls."""
    import socket

    _, raw_batch, cfg, sd = _train_f32_inputs(root, rows=range(DP_ROWS))
    inputs = os.path.join(tmp, 'dp_inputs.pt')
    result = os.path.join(tmp, 'dp_result.pt')
    torch.save({'sd': sd, 'batch': raw_batch, 'cfg': cfg}, inputs)
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    addr = f'127.0.0.1:{s.getsockname()[1]}'
    s.close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--dp-child', addr,
         str(rank), inputs, result], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    secs = time.perf_counter() - t0
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f'phase 10 two-process step failed:\n{o}')
    two = torch.load(result, weights_only=False)
    one = _train_f32_run(dev, sd, raw_batch, cfg)
    err = _train_errors(two, one, sd)
    bad = {k: v for k, v in err.items() if not v <= TRAIN_LIMITS[k]}
    if bad:
        raise AssertionError(f'phase 10: two processes vs one outside the '
                             f'limits {bad} (limits {TRAIN_LIMITS})')
    controls = _train_controls(dev, sd, raw_batch, cfg, two)
    print(f'phase 10 [{card}]: W48-384x288 f32 train + flip-test eval step, '
          f'two processes over gloo on the card ({DP_ROWS // 2} rows each, '
          f'{secs:.1f} s) vs one process on the batch of {DP_ROWS}: '
          + ', '.join(f'{k} {v:.3e}' for k, v in err.items())
          + f'; controls outside: {controls}', flush=True)
    return {'errors': err, 'limits': TRAIN_LIMITS, 'controls': controls,
            'seconds': secs}


def run_train_mesh(dev, tmp, card, counters):
    """Phase 10's training: the one-rank NCCL mesh (the MPII epoch and the
    f32 steps against the meshless ones), then the two-process step."""
    import socket

    from simple_hrnet_tpu_torch.parallel import distributed, make_mesh

    coco_root = os.path.join(tmp, 'coco10')
    write_memory_coco(coco_root)
    mpii_root = os.path.join(tmp, 'mpii')
    write_memory_mpii(mpii_root)
    for k in counters.values():
        k.launches = 0
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    distributed.initialize(f'127.0.0.1:{port}', 1, 0, backend='nccl',
                           device='cuda')
    try:
        mesh = make_mesh()
        if mesh.group is None or mesh.size != 1:
            raise AssertionError(f'phase 10: one-rank mesh {mesh}')
        out = {'mpii': run_mpii_mesh(dev, tmp, card, mpii_root, mesh)}
        _, raw_batch, cfg, sd = _train_f32_inputs(coco_root)
        meshed = _train_f32_run(dev, sd, raw_batch, cfg, mesh=mesh)
    finally:
        distributed.shutdown()
    plain = _train_f32_run(dev, sd, raw_batch, cfg)
    err = _train_errors(meshed, plain, sd)
    bad = {k: v for k, v in err.items() if not v <= TRAIN_LIMITS[k]}
    if bad:
        raise AssertionError(f'phase 10: one-rank mesh vs meshless step '
                             f'outside the limits {bad}')
    out['one_rank_f32'] = err
    print(f'phase 10 [{card}]: W48-384x288 f32 train + flip-test eval step '
          f'at batch 2 under the one-rank mesh (DDP, BatchNorm2d) vs '
          f'meshless: ' + ', '.join(f'{k} {v:.3e}' for k, v in err.items())
          + f' (limits {TRAIN_LIMITS})', flush=True)
    out['two_process'] = run_two_process_step(dev, tmp, card, coco_root)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    if any(launches.values()):
        raise AssertionError(f'phase 10: port kernels launched in training: '
                             f'{launches}')
    out['launches'] = launches
    return out


def _numpy_warp(src, m_inv, oh, ow):
    """Bilinear dst -> src warp with zeros outside, in f64 (the host
    library's arithmetic, data/native.py)."""
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float64)
    sx = m_inv[0, 0] * xs + m_inv[0, 1] * ys + m_inv[0, 2]
    sy = m_inv[1, 0] * xs + m_inv[1, 1] * ys + m_inv[1, 2]
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    fx, fy = sx - x0, sy - y0
    h, w = src.shape[:2]
    out = np.zeros((oh, ow, 3))
    for dy, dx, wt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                       (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yy, xx = y0 + dy, x0 + dx
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        out[ok] += wt[ok][:, None] * src[yy[ok], xx[ok]]
    return out


NATIVE_DECODE_TOL = 1e-4  # of the normalized values' range (f32 weights)


def check_native_decode(jpeg: bytes):
    """The fused ``decode_warp_normalize`` on ``jpeg`` against the library's
    plain decode, warped and normalized in numpy. Returns the largest
    difference; fails above ``NATIVE_DECODE_TOL``."""
    from simple_hrnet_tpu_torch.data import native
    from simple_hrnet_tpu_torch.ops.image import INV255_STD, MEAN255

    rgb = native.decode_jpeg_rgb(jpeg).astype(np.float64)
    m = np.asarray([[0.8, 0.1, 4.5], [-0.1, 0.9, 2.0]], np.float32)
    got = native.decode_warp_normalize(jpeg, m, 96, 72, MEAN255, INV255_STD)
    want = (_numpy_warp(rgb, m.astype(np.float64), 96, 72) - MEAN255) \
        * INV255_STD
    err = float(np.abs(got - want).max())
    if not err <= NATIVE_DECODE_TOL:
        raise AssertionError(f'native decode_warp_normalize {err:.3e} from '
                             f'the numpy warp (limit {NATIVE_DECODE_TOL})')
    return err


def run_host_libraries(card, weights):
    """Phase 10's host libraries: ``nms_numpy``'s library route against
    its numpy route on YOLOv3 detections, and the JPEG library where
    ``jpeglib.h`` is installed."""
    from simple_hrnet_tpu_torch.detectors.yolov3 import YOLOv3
    from simple_hrnet_tpu_torch.ops.nms import nms_numpy

    det = YOLOv3(model_def='yolov3', weights_path=weights, device='cuda')
    rows, valid = det.detect_padded(torch.from_numpy(
        smooth_frames(8)[..., ::-1].copy()).cuda())
    rows, valid = rows.cpu().numpy(), valid.cpu().numpy()
    sets = [rows[i][valid[i]][:, :5] for i in range(len(rows))]
    sets.append(np.concatenate(sets))  # every frame's boxes in one set
    kept = []
    for dets in sets:
        for thr in (0.3, 0.5):
            lib, ref = nms_numpy(dets, thr), nms_numpy(dets, thr,
                                                       native=False)
            if lib != ref:
                raise AssertionError(f'phase 10: nms_numpy library route '
                                     f'{lib} != numpy route {ref}')
            kept.append(len(lib))
    rec = {'nms_sets': len(sets), 'boxes': int(sum(len(d) for d in sets)),
           'kept': kept}
    header = '/usr/include/jpeglib.h'
    if os.path.exists(header):
        encoded = None
        try:
            import cv2
            img = np.repeat(np.repeat(np.random.default_rng(3).integers(
                0, 256, (12, 16, 3), dtype=np.uint8), 8, 0), 8, 1)
            encoded = cv2.imencode('.jpg', img)[1].tobytes()
        except ImportError:
            pass
        if encoded is None:
            rec['native_decode'] = 'built; no JPEG encoder here for an input'
        else:
            rec['native_decode_err'] = check_native_decode(encoded)
    else:
        rec['native_decode'] = f'not built here: {header} is not installed'
    print(f'phase 10 [{card}]: nms_numpy host library == numpy route on '
          f'{rec["boxes"]} YOLOv3 boxes in {rec["nms_sets"]} sets (kept '
          f'{kept}); JPEG library: '
          + (f'decode_warp_normalize within {rec["native_decode_err"]:.3e} '
             f'of the numpy warp' if 'native_decode_err' in rec
             else rec['native_decode']), flush=True)
    return rec


def run_parallel_phase(dev, tmp, pths, weights, counters):
    """Phase 10 (see the module docstring). Returns its record and the
    launches of each facade run on a mesh."""
    t0 = time.perf_counter()
    card = card_line()
    summary, runs = {'card': card}, {}
    for path in PAR_PATHS:
        summary[path[0]], r = run_mesh_facade(dev, path, pths[path[1]],
                                              weights, counters, card)
        runs.update(r)
    summary['train'] = run_train_mesh(dev, tmp, card, counters)
    summary['host_libraries'] = run_host_libraries(card, weights)
    summary['seconds'] = time.perf_counter() - t0
    print(f'phase 10: {summary["seconds"]:.1f} s', flush=True)
    return runs, summary


def _goldens_module():
    """``tests/torch_goldens.py``: the seeded weights, the golden configs,
    their limits and the comparison (JAX-free)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), 'tests'))
    import torch_goldens
    return torch_goldens


def _golden_chain(cfg, dtype):
    """The chain kernel the port runs 8 times a pose forward at a golden
    config (None: PoseResNet, no chain)."""
    if cfg.get('model_name') == 'PoseResNet':
        return None
    if dtype == 'int8':
        return 'int8_chain'
    return ('wino_chain' if (cfg['c'], dtype) == (32, 'bfloat16')
            else 'basic_chain')


def run_golden(G, config, dtype, n, paths, counters, golden):
    """One golden config on the card in ``dtype`` (kernels on): launches
    counted around the config's call (K1 once a detect, K4 once a YOLOv5
    SiLU of each detect chunk, the chain and K3 8 times a pose forward),
    then held against the JAX package's golden.
    Returns the comparison record and the outputs."""
    model = G.port_facade(config, paths, dtype, device='cuda')
    frames = G.config_frames(config)[:n]
    seen, detects = [], []
    det = model.detector
    if det is not None:
        real_detect = det.detect_padded
        det.detect_padded = lambda f: (detects.append(f.shape[0]),
                                       real_detect(f))[1]
    hook = model.model.register_forward_pre_hook(
        lambda _m, args: seen.append(args[0].shape[0]))
    try:
        for k in counters.values():
            k.launches = 0
        outs = G.run_facade(model, config, frames)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in counters.items()}
    finally:
        hook.remove()
        if det is not None:
            del det.detect_padded
    chain = _golden_chain(G.CONFIGS[config], dtype)
    want = {k: 0 for k in counters}
    if chain is not None:
        want[chain] = want['fuse_up'] = 8 * len(seen)
    want['nms'] = len(detects)
    if det is not None:
        want['activation'] = activations_per_detect(det) * detect_chunks(
            det, detects)
    if launches != want or not seen:
        raise AssertionError(f'phase 11 [{config} {dtype}]: launches '
                             f'{launches} over {len(detects)} detects and '
                             f'{len(seen)} pose forwards; want {want}')
    rows = G.detector_rows(det, frames) if det is not None else None
    r = G.compare(outs, golden, dtype, 'card', rows=rows,
                  frames=slice(0, n) if n else None,
                  scales=G.quantized_scales(model) if dtype == 'int8'
                  else None)
    r.update(launches=launches, pose_batches=seen)
    print(f'phase 11 {G.report(r)}; launches {launches}', flush=True)
    if not r['ok']:
        raise AssertionError(f'phase 11: {G.report(r)}')
    del model
    torch.cuda.empty_cache()
    return r, outs


def golden_controls(G, paths, w48_outs):
    """Each gate must fail on a wrong input: W48's frames 0-1 against the
    golden's frames 2-3; W32's plain path (``use_fused_kernels=False``)
    with stage 3's first branch-0 chain output zeroed, in f32, bf16 and
    int8; the PoseResNet-50 bf16 facade against the int8 golden (no conv
    quantized); and the YOLOv3 + W32 int8 facade with its YOLOv3 built
    with ``phase_stem=False``, whose policy quantizes ``conv_1`` too
    (``torch_goldens.plain_stem_int8``; the JAX package's default phase
    stem keeps it in bf16). The last two print every reading beside its
    bound: they show what the int8 gates can and cannot see."""
    rec = {}
    r = G.compare(w48_outs[:2], G.load_golden('w48_384x288_batch16'), 'f32',
                  'card', frames=slice(2, 4))
    if r['ok']:
        raise AssertionError(f'phase 11 control: another frame\'s golden '
                             f'passed: {G.report(r)}')
    rec['other_frames_heatmap_rel_max'] = r['heatmap_rel_max']
    config = 'w32_256x192_single'
    golden = G.load_golden(config)
    for dtype in ('f32', 'bfloat16', 'int8'):
        model = G.port_facade(config, paths, dtype, device='cuda',
                              use_fused_kernels=False)
        hook = G.zero_chain(model.model)
        try:
            outs = G.run_facade(model, config, G.config_frames(config))
        finally:
            hook.remove()
        r = G.compare(outs, golden, dtype, 'card')
        if r['ok']:
            raise AssertionError(f'phase 11 control: a zeroed chain passed '
                                 f'{dtype}: {G.report(r)}')
        rec[f'zeroed_chain_{dtype}_heatmap_rel_max'] = r['heatmap_rel_max']
    for label, config, dtype in (
            ('res50_bf16_as_int8', 'res50_256x192_batch4', 'bfloat16'),
            ('yolov3_conv_1_quantized', 'multiperson_yolov3_w32', 'int8')):
        model = G.port_facade(config, paths, dtype, device='cuda')
        if label == 'yolov3_conv_1_quantized':
            G.plain_stem_int8(model, config, paths)
        frames = G.config_frames(config)
        outs = G.run_facade(model, config, frames)
        rows = (G.detector_rows(model.detector, frames)
                if model.detector is not None else None)
        r = G.compare(outs, G.load_golden(config), 'int8', 'card', rows=rows,
                      scales=G.quantized_scales(model))
        print(f'phase 11 control {label}: {G.report(r)}', flush=True)
        if r['ok']:
            raise AssertionError(f'phase 11 control: {label} passed: '
                                 f'{G.report(r)}')
        rec[label] = {k: v for k, v in r.items() if k != 'config'}
        del model
        torch.cuda.empty_cache()
    print(f'phase 11 controls fail as they must (heatmap distance, of '
          f'max): { {k: v for k, v in rec.items() if k.endswith("max")} }',
          flush=True)
    return rec


# C9: the config whose int8 answer the card's and the CPU's facades are
# traced on, stage by stage
TRACE_CONFIG = 'w32_256x192_single'
# the rows of each trace comparison printed from its first departure on
TRACE_ROWS = 12


def _trace_rows(d):
    """The differing rows of a trace comparison from its first departure
    on (TRACE_ROWS of them), and each stage module's high-resolution fuse
    output (K3's) and the heatmaps."""
    rows = d['rows']
    i = rows.index(d['first']) if d['first'] is not None else len(rows)
    head = [r for r in rows[i:] if r['differ']][:TRACE_ROWS]
    fuses = [r for r in rows if r['name'].endswith(':fuse0') or
             r['name'] == 'heatmaps']
    return head, fuses


def _print_trace(G, label, d):
    head, fuses = _trace_rows(d)
    print(f'phase 11 int8 trace [{label}]: {G.departure_line(d)}',
          flush=True)
    for r in head + fuses:
        print(f'    {r["name"]} ({r["kind"]}): {r["differ"]} of '
              f'{r["elements"]} differ, largest {r["max_diff"]:.3e} '
              f'{r["unit"]}', flush=True)
    return dict(first=d['first'], departing=head, entries=len(d['rows']),
                entries_differing=sum(1 for r in d['rows'] if r['differ']))


def trace_int8(G, paths, golden):
    """C9: where the card's int8 answer departs from the CPU's. The
    TRACE_CONFIG facade in int8 is built on the card and on the CPU in
    this process, on the golden's weights and frame, and traced
    (``torch_goldens.int8_trace``); printed: whether the frames the pose
    model receives differ and by how many counts, the calibration maps'
    largest distance in ulps and how many convs differ, and the first
    traced entry that departs. Then the card facade runs again (a) on the
    CPU's frame and (b) rebuilt from the CPU's calibration map as well
    (the same ``quantize_folded`` and ``prepare_inference`` calls), each
    with its distance to the golden and (b) with its own first
    departure. Diagnosis only: the card's gates are ``run_golden``'s."""
    t0 = time.perf_counter()
    frames = G.config_frames(TRACE_CONFIG)
    amax, traces, dist = {}, {}, {}
    for dev in ('cuda', 'cpu'):
        amax[dev] = {}
        with G.int8_calibration(record=amax[dev]):
            model = G.port_facade(TRACE_CONFIG, paths, 'int8', device=dev)
        traces[dev], outs = G.int8_trace(model, frames)
        dist[dev] = G.compare(outs, golden, 'int8', 'card')[
            'heatmap_rel_max']
        if dev == 'cuda':
            card = model
    cpu = traces['cpu']
    d = G.first_departure(traces['cuda'], cpu)
    frame = d['rows'][0]
    a = G.amax_departure(amax['cuda'], amax['cpu'])
    _, outs = G.int8_trace(card, frames, inject=cpu['input'])
    dist['a_cpu_frame'] = G.compare(outs, golden, 'int8', 'card')[
        'heatmap_rel_max']
    del card
    with G.int8_calibration(replace=amax['cpu']):
        model = G.port_facade(TRACE_CONFIG, paths, 'int8', device='cuda')
    trace_b, outs = G.int8_trace(model, frames, inject=cpu['input'])
    dist['b_cpu_frame_amax'] = G.compare(outs, golden, 'int8', 'card')[
        'heatmap_rel_max']
    d_b = G.first_departure(trace_b, cpu)
    del model
    torch.cuda.empty_cache()
    print(f'phase 11 int8 trace [{TRACE_CONFIG}]: frames the pose model '
          f'receives: {frame["differ"]} of {frame["elements"]} values '
          f'differ (largest {frame["max_diff"]:.0f} counts); calibration '
          f'amax: {a["differ"]} of {a["keys"]} convs differ, largest '
          f'{a["max_ulps"]} ulps ({a["worst"]}); golden distance (of max): '
          f'card {dist["cuda"]:.4e}, CPU {dist["cpu"]:.4e}, (a) card on the '
          f'CPU\'s frame {dist["a_cpu_frame"]:.4e}, (b) and the CPU\'s amax '
          f'{dist["b_cpu_frame_amax"]:.4e}', flush=True)
    rec = dict(config=TRACE_CONFIG, frame_values_differ=frame['differ'],
               frame_max_counts=frame['max_diff'], amax=a, distance=dist,
               card_vs_cpu=_print_trace(G, 'card vs CPU', d),
               b_vs_cpu=_print_trace(G, '(b) card with the CPU\'s frame '
                                     'and amax vs CPU', d_b),
               seconds=time.perf_counter() - t0)
    print(f'phase 11 int8 trace: {rec["seconds"]:.1f} s', flush=True)
    return rec


def run_goldens_phase(counters):
    """Phase 11 (see the module docstring). Returns its record and the
    launches of each config's run."""
    from simple_hrnet_tpu_torch.ops.cuda import build

    G = _goldens_module()
    t0 = time.perf_counter()
    summary, runs = {'card': card_line()}, {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        files = G.write_weights(tmp)
        paths = {k: v[0] for k, v in files.items()}
        goldens = {c: G.load_golden(c) for c in G.CONFIGS}
        for config, golden in goldens.items():
            for name, w in golden['weights'].items():
                if files[name][1] != w['sha256']:
                    raise AssertionError(
                        f'phase 11: weights differ: {name} drew '
                        f'{files[name][1]}, the golden of {config} was made '
                        f'from {w["sha256"]}')
        summary['weights_s'] = time.perf_counter() - t0
        print(f'phase 11: seeded weights written and their fingerprints '
              f'equal the goldens\' in {summary["weights_s"]:.1f} s',
              flush=True)
        w48_outs = None
        for config, cfg in G.CONFIGS.items():
            for dtype, n in cfg['card'].items():
                r, outs = run_golden(G, config, dtype, n, paths, counters,
                                     goldens[config])
                summary[f'{config}/{dtype}'] = r
                runs[f'goldens/{config}/{dtype}'] = r['launches']
                if (config, dtype) == ('w48_384x288_batch16', 'f32'):
                    w48_outs = outs
        summary['controls'] = golden_controls(G, paths, w48_outs)
        summary['int8_trace'] = trace_int8(G, paths, goldens[TRACE_CONFIG])
    totals = {k: sum(l[k] for l in runs.values()) for k in counters}
    if not all(totals.values()):
        raise AssertionError(f'phase 11: a kernel did not run against the '
                             f'goldens: {totals}')
    summary['seconds'] = time.perf_counter() - t0
    print(f'phase 11: every config within its limits; launches {totals}; '
          f'{summary["seconds"]:.1f} s', flush=True)
    return runs, summary


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_counters():
    """Each port kernel's wrapper, whose ``launches`` counts its launches."""
    from simple_hrnet_tpu_torch.ops.cuda import (activation, fuse_up,
                                                 fused_block, int8_chain,
                                                 nms, winograd_chain)
    return {'nms': nms.nms, 'basic_chain': fused_block.basic_chain,
            'fuse_up': fuse_up.fuse_up,
            'wino_chain': winograd_chain.wino_chain,
            'int8_chain': int8_chain.int8_chain,
            'activation': activation.activation}


def activations_per_detect(detector):
    """K4 launches of one forward of ``detector``'s network: one a YOLOv5
    ``Conv`` (its SiLU), one a darknet conv whose activation is logistic,
    mish or swish/silu (YOLOv3's are leaky and linear: none); 0 for a
    stub."""
    from simple_hrnet_tpu_torch.detectors.darknet import DarknetConv
    from simple_hrnet_tpu_torch.detectors.yolov5 import Conv
    net = getattr(detector, 'net', None)
    if net is None:
        return 0
    return sum(isinstance(m, Conv) or (
        isinstance(m, DarknetConv) and
        m.activation in ('logistic', 'mish', 'swish', 'silu'))
        for m in net.modules())


def detect_chunks(detector, frame_counts):
    """Network forwards of ``detect_padded`` calls on ``frame_counts``
    frames: one a chunk of ``max_batch_size`` frames."""
    return sum(-(-n // detector.max_batch_size) for n in frame_counts)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--kernels-only', action='store_true',
                    help='stop after the kernel checks (phase 2)')
    ap.add_argument('--train-only', action='store_true',
                    help='run phase 9 only (it builds no kernel)')
    ap.add_argument('--parallel-only', action='store_true',
                    help='build the kernels, then run phase 10 only')
    ap.add_argument('--goldens-only', action='store_true',
                    help='build the kernels, then run phase 11 only')
    ap.add_argument('--dp-child', nargs=4, help=argparse.SUPPRESS,
                    metavar=('ADDR', 'RANK', 'INPUTS', 'OUT'))
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible', file=sys.stderr)
        return 1
    from simple_hrnet_tpu_torch.ops.cuda import build

    dev = torch.device('cuda', 0)
    # every comparison below is in true f32 where f32 is asked for
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.dp_child:
        return dp_child(*args.dp_child)

    if args.train_only:
        # phase 9 launches no port kernel, so it needs none built
        counters = kernel_counters()
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
            summary = run_train_phase(dev, tmp, counters)
        print(json.dumps({'train': summary}))
        print(card_line())
        return 0

    t0 = time.perf_counter()
    secs = build.build_all()
    print(f'phase 1: built {sorted(secs)} in '
          f'{time.perf_counter() - t0:.1f} s '
          f'({ {k: round(v, 1) for k, v in secs.items()} })', flush=True)
    for name, log in build.BUILD_LOGS.items():
        print(f'--- nvcc {name} ---\n{log.strip()}')

    counters = kernel_counters()

    if args.parallel_only:
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
            pths, weights = write_weights(tmp)
            runs, summary = run_parallel_phase(dev, tmp, pths, weights,
                                               counters)
        print(json.dumps({'parallel': summary, 'launches': runs}))
        print(card_line())
        return 0

    if args.goldens_only:
        runs, summary = run_goldens_phase(counters)
        print(json.dumps({'goldens': summary, 'launches': runs}))
        print(card_line())
        return 0

    rec = {}
    check_nms(dev, rec)
    check_chain(dev, rec)
    check_fuse_up(dev, rec)
    check_wino(dev, rec)
    check_int8_chain(dev, rec)
    check_qconv(dev)
    check_activation(dev, rec)
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
            stream_launches, summary['stream'] = run_stream_phase(
                dev, pths[48], weights, counters)
            v5_launches, summary['poseresnet_yolov5'] = run_v5_phase(
                tmp, counters)
            stream_launches.update(v5_launches)
            single_launches, summary['single_person'] = run_single_phase(
                dev, pths, counters)
            stream_launches.update(single_launches)
            engine_launches, summary['engine'] = run_engine_phase(
                tmp, pths, weights, counters, summary)
            stream_launches.update(engine_launches)
            summary['train'] = run_train_phase(dev, tmp, counters)
            mesh_launches, summary['parallel'] = run_parallel_phase(
                dev, tmp, pths, weights, counters)
            stream_launches.update(mesh_launches)
            golden_launches, summary['goldens'] = run_goldens_phase(counters)
            stream_launches.update(golden_launches)
            for run, launches in stream_launches.items():
                for k in counters:
                    totals[k] += launches[k]
                    if launches[k]:
                        by_path[k][run] = launches[k]
        if any(n == 0 for n in totals.values()):
            raise AssertionError(f'a kernel was not launched on the main '
                                 f'paths: {totals}')
        # each kernel's per-predict launches on its own path
        home = {'nms': 'w48_bf16', 'basic_chain': 'w48_bf16',
                'fuse_up': 'w48_bf16', 'wino_chain': 'w32_bf16',
                'int8_chain': 'w32_int8'}
        for name, n in totals.items():
            if name == 'activation':
                # K4's own path: phase 6's YOLOv5m bf16 predict
                single = by_path[name]['v5_bf16_single']
                stack8 = by_path[name]['v5_bf16_stack8']
            else:
                single = by_path[name][home[name]]['single']
                stack8 = by_path[name][home[name]]['stack8']
            rec[name].update(launches=n, launches_single=single,
                             launches_stack8=stack8,
                             launches_by_path=by_path[name])
    print(json.dumps({'kernels': list(rec.values()), 'main_path': summary}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
