"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root on a host with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. build the five CUDA kernels from ``simple_hrnet_tpu_torch/csrc`` (one
     nvcc per source, all at once) and print the build time;
  2. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes (every batch phase 4 gives the pose model): NMS,
     the basic chain and the fuse at W48 in bf16 and f32 (TF32 off), the
     Winograd chain at W32 in bf16, the int8 chain at W32 and W48; show
     that wrong-input controls fall outside each tolerance; time the
     kernel, the plain version and one library call; check the int8 conv
     outside the chains (``torch._int_mm``) against its CPU integer path;
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
     checked; it is timed, and its 8-frame call is profiled.

Prints the build log, one JSON ``kernels`` line, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. The
``--kernels-only`` flag stops after phase 2 (for iterating on a kernel).
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
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

# kernel-vs-plain tolerances, relative to max |plain|: f32 differs only by
# summation order (8 chained convs of 432-term sums); bf16 adds one-ulp
# flips at each rounding (2^-8 to 2^-7 of max) that the later convs carry
# on. The bf16 limit sits between that reading and the wrong-bias controls
# that check_chain and check_fuse_up hold against it.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# the int8 chain repeats its plain version's arithmetic exactly (exact int32
# cores, the same IEEE f32 epilogue, rounding half to even), so its limit is
# one bf16 step of max; its controls (one activation scale off by 1/127,
# biases off by one channel) sit above it
TOL_INT8 = 2.0 ** -8

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


def check_nms(dev, rec):
    from simple_hrnet_tpu_torch.ops.cuda import nms as K

    g = torch.Generator().manual_seed(1)
    bsz, n, max_out, thr = 8, 256, 32, 0.4
    xy = torch.rand((bsz, n, 2), generator=g) * 380.0
    wh = torch.rand((bsz, n, 2), generator=g) * 150.0 + 4.0
    boxes = torch.cat([xy, xy + wh], -1)
    # detector-like scores: sorted descending, a tail of padding zeros and
    # some exact ties (lowest index must win)
    scores = (torch.rand((bsz, n), generator=g) * 0.8 + 0.2)
    scores = torch.round(scores * 64) / 64
    scores[:, 200:] = 0.0
    scores = torch.sort(scores, dim=1, descending=True, stable=True).values
    boxes, scores = boxes.to(dev), scores.to(dev)

    idx, valid = K.nms(boxes, scores, thr, max_out)
    pidx, pvalid = K.nms_plain(boxes, scores, thr, max_out)
    torch.cuda.synchronize()
    if not torch.equal(valid, pvalid) or not torch.equal(idx, pidx):
        raise AssertionError('nms kernel disagrees with its plain version')
    # the CPU plain version as well (same arithmetic on the host)
    cidx, cvalid = K.nms_plain(boxes.cpu(), scores.cpu(), thr, max_out)
    if not torch.equal(idx.cpu(), cidx) or not torch.equal(valid.cpu(),
                                                           cvalid):
        raise AssertionError('nms kernel disagrees with the CPU plain version')
    ms = cuda_ms(lambda: K.nms(boxes, scores, thr, max_out), iters=100)
    plain_ms = cuda_ms(lambda: K.nms_plain(boxes, scores, thr, max_out),
                       iters=10)
    ops = bsz * n * n * 12 + bsz * max_out * n * 3
    b_ms, b_by = bound(nbytes(boxes, scores, idx, valid), ops, torch.float32)
    rec['nms'] = dict(
        name='nms', route='cuda', source='simple_hrnet_tpu_torch/csrc/nms.cu',
        replaces='simple_hrnet_tpu/ops/pallas/nms_pallas.py:135',
        max_abs_err=0.0, tolerance='exact', ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f'B={bsz} N={n} max_out={max_out}',
        kept_per_image=valid.sum(1).tolist())
    print(f'K1 nms: exact, {ms:.4f} ms (plain {plain_ms:.4f}, bound '
          f'{b_ms:.5f} {b_by})', flush=True)


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
    ms = cuda_ms(lambda: K.basic_chain(x, wt, b))
    plain_ms = cuda_ms(lambda: K.basic_chain_plain(x, wt, b), iters=10)
    # library yardstick: the same chain as 8 cuDNN convs (+ReLU/residual)
    xl = x.permute(0, 3, 1, 2)  # channels_last view
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
    lib_ms = cuda_ms(lib)
    _, h, w, c = x.shape
    ops = 8 * 2 * bsz * h * w * c * c * 9
    b_ms, b_by = bound(2 * nbytes(x) + nbytes(wt, b), ops, torch.bfloat16)
    x32, wt32, b32 = _chain_inputs(dev, torch.float32, bsz)
    ms32 = cuda_ms(lambda: K.basic_chain(x32, wt32, b32))
    b32_ms, b32_by = bound(2 * nbytes(x32) + nbytes(wt32, b32), ops,
                           torch.float32)
    rec['basic_chain'] = dict(
        name='basic_chain', route='cuda',
        source='simple_hrnet_tpu_torch/csrc/fused_block.cu',
        replaces='simple_hrnet_tpu/ops/pallas/fused_block.py:398',
        max_abs_err=max(errs[(torch.bfloat16, n)][0] for n in POSE_BATCHES),
        max_rel_err=max(errs[(torch.bfloat16, n)][1] for n in POSE_BATCHES),
        tolerance=TOL[torch.bfloat16], control_rel=control,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, shape=f'{tuple(x.shape)} bf16',
        checked_batches=list(POSE_BATCHES),
        f32_max_abs_err=max(errs[(torch.float32, n)][0]
                            for n in POSE_BATCHES),
        f32_ms=ms32, f32_bound_ms=b32_ms, f32_bound_by=b32_by)
    print(f'K2 basic_chain bf16 B={bsz}: {ms:.4f} ms (plain {plain_ms:.4f}, '
          f'cuDNN {lib_ms:.4f}, bound {b_ms:.5f} {b_by}); f32 {ms32:.4f} ms',
          flush=True)


def _fuse_inputs(dev, dtype, n_src, bsz, h=96, w=72, c=48):
    """W48 high-res fuse operands for stage 2 (1 source), 3 (2) or 4 (3);
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


def check_fuse_up(dev, rec):
    from simple_hrnet_tpu_torch.ops.cuda import fuse_up as K

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for bsz in POSE_BATCHES:
            for n_src in (1, 2, 3):
                args = _fuse_inputs(dev, dtype, n_src, bsz)
                y = K.fuse_up(*args)
                ref = K.fuse_up_plain(*args)
                torch.cuda.synchronize()
                err, rel = rel_err(y, ref)
                if rel > TOL[dtype]:
                    raise AssertionError(
                        f'fuse_up {dtype} B={bsz} {n_src} sources: max err '
                        f'{err} ({rel} of max) > {TOL[dtype]}')
                errs[(dtype, bsz, n_src)] = (err, rel)
        worst = max(v for k, v in errs.items() if k[0] == dtype)
        print(f'K3 fuse_up {str(dtype)[6:]} B={POSE_BATCHES}, 1-3 sources: '
              f'max abs err {worst[0]:.3e} (rel {worst[1]:.3e}, tol '
              f'{TOL[dtype]:.1e})', flush=True)
    bsz = max(POSE_BATCHES)
    base, ys, ws, bsum = _fuse_inputs(dev, torch.bfloat16, 3, bsz)
    control = check_controls('K3 bf16', K.fuse_up_plain(base, ys, ws, bsum), {
        'bias dropped': K.fuse_up_plain(base, ys, ws, torch.zeros_like(bsum)),
        'bias off by one channel': K.fuse_up_plain(base, ys, ws,
                                                   bsum.roll(1))},
        TOL[torch.bfloat16])
    ms = cuda_ms(lambda: K.fuse_up(base, ys, ws, bsum), iters=100)
    plain_ms = cuda_ms(lambda: K.fuse_up_plain(base, ys, ws, bsum))
    # library yardstick: 1x1 cuDNN conv + nearest interpolate + add + ReLU
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
    lib_ms = cuda_ms(lib, iters=100)
    c = base.shape[-1]
    ops = sum(2 * y.shape[0] * y.shape[1] * y.shape[2] * y.shape[3] * c
              for y in ys) + base.numel() * 5
    b_ms, b_by = bound(2 * nbytes(base) + nbytes(*ys, *ws, bsum), ops,
                       torch.bfloat16)
    rec['fuse_up'] = dict(
        name='fuse_up', route='cuda',
        source='simple_hrnet_tpu_torch/csrc/fuse_up.cu',
        replaces='simple_hrnet_tpu/ops/pallas/fuse_up.py:161',
        max_abs_err=max(v[0] for k, v in errs.items()
                        if k[0] == torch.bfloat16),
        max_rel_err=max(v[1] for k, v in errs.items()
                        if k[0] == torch.bfloat16),
        tolerance=TOL[torch.bfloat16], control_rel=control,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, shape=f'{tuple(base.shape)} + 3 sources bf16',
        checked_batches=list(POSE_BATCHES),
        f32_max_abs_err=max(v[0] for k, v in errs.items()
                            if k[0] == torch.float32))
    print(f'K3 fuse_up bf16 B={bsz} 3 src: {ms:.4f} ms (plain '
          f'{plain_ms:.4f}, library {lib_ms:.4f}, bound {b_ms:.5f} {b_by})',
          flush=True)


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


def check_wino(dev, rec):
    """B3 at the W32 branch-0 shape (B, 64, 48, 32), bf16."""
    from simple_hrnet_tpu_torch.ops.cuda import winograd_chain as K

    errs = {}
    tol = TOL[torch.bfloat16]
    for bsz in POSE_BATCHES_W32:
        x, wt, b = _chain_inputs(dev, torch.float32, bsz, 64, 48, 32)
        x = x.bfloat16()
        ww = K.pack_winograd_weights(wt, torch.bfloat16)
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
    ms = cuda_ms(lambda: K.wino_chain(x, ww, b))
    plain_ms = cuda_ms(lambda: K.wino_chain_plain(x, ww, b), iters=10)
    lib_ms = cuda_ms(_lib_chain(x, wt.bfloat16(), b))
    bsz, h, w, c = x.shape
    # 4 Winograd terms over h/2 row pairs with 3C-deep dots: 2/3 of the
    # direct chain's MACs
    ops = 8 * 2 * bsz * (h // 2) * w * 4 * 3 * c * c
    b_ms, b_by = bound(2 * nbytes(x) + nbytes(ww, b), ops, torch.bfloat16)
    rec['wino_chain'] = dict(
        name='wino_chain', route='cuda',
        source='simple_hrnet_tpu_torch/csrc/winograd_chain.cu',
        replaces='simple_hrnet_tpu/ops/pallas/winograd_chain.py:151',
        max_abs_err=worst[0], max_rel_err=worst[1], tolerance=tol,
        control_rel=control, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, shape=f'{tuple(x.shape)} bf16',
        checked_batches=list(POSE_BATCHES_W32))
    print(f'B3 wino_chain bf16 B={bsz}: {ms:.4f} ms (plain {plain_ms:.4f}, '
          f'cuDNN {lib_ms:.4f}, bound {b_ms:.5f} {b_by})', flush=True)


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
    at the W48 shape (B, 96, 72, 48) at the W48 batches; bf16 in and out."""
    from simple_hrnet_tpu_torch.ops import int8 as Q8
    from simple_hrnet_tpu_torch.ops.cuda import int8_chain as K

    errs = {}
    shapes = [(bsz, 64, 48, 32) for bsz in POSE_BATCHES_W32] + \
        [(bsz, 96, 72, 48) for bsz in POSE_BATCHES]
    for shape in shapes:
        x, q, _ = _int8_inputs(dev, *shape)
        args = (q['wq'], q['wscale'], q['b'], q['ascales'])
        y = K.int8_chain(x, *args)
        ref = K.int8_chain_plain(x, *args)
        torch.cuda.synchronize()
        err, rel = rel_err(y, ref)
        if rel > TOL_INT8:
            raise AssertionError(f'int8_chain {shape}: max err {err} ({rel} '
                                 f'of max) > {TOL_INT8}')
        errs[shape] = (err, rel)
    worst = max(errs.values())
    print(f'B4 int8_chain W32 B={POSE_BATCHES_W32}, W48 B={POSE_BATCHES}: '
          f'max abs err {worst[0]:.3e} (rel {worst[1]:.3e}, tol '
          f'{TOL_INT8:.1e})', flush=True)
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
        TOL_INT8)
    ms = cuda_ms(lambda: K.int8_chain(x, *args))
    plain_ms = cuda_ms(lambda: K.int8_chain_plain(x, *args), iters=5)
    # library yardstick: 8 torch._int_mm convs over the int8 patch matrix
    # with the same quantize / dequantize / bias / residual / ReLU epilogue
    inva = torch.reciprocal(q['ascales'])
    alpha = q['ascales'][:, None] * q['wscale']
    wl = [q['wq'][i].permute(3, 0, 1, 2).reshape(x.shape[-1], -1)
          .contiguous() for i in range(8)]

    def qconv(v, i):
        acc = Q8.int8_conv_acc(Q8.quantize(v, inva[i]), wl[i], 3, 1, 1)
        return acc.float() * alpha[i] + q['b'][i]

    def lib():
        v = x
        for blk in range(4):
            mid = torch.relu(qconv(v, 2 * blk))
            v = torch.relu(qconv(mid, 2 * blk + 1) + v.float()).to(x.dtype)
        return v
    lib_ms = cuda_ms(lib)
    bsz, h, w, c = x.shape
    ops = 8 * 2 * bsz * h * w * c * c * 9
    b_ms, b_by = bound(2 * nbytes(x) + nbytes(*args), ops, torch.int8)
    rec['int8_chain'] = dict(
        name='int8_chain', route='cuda',
        source='simple_hrnet_tpu_torch/csrc/int8_chain.cu',
        replaces='simple_hrnet_tpu/ops/pallas/fused_block.py:329',
        max_abs_err=worst[0], max_rel_err=worst[1], tolerance=TOL_INT8,
        control_rel=control, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, shape=f'{tuple(x.shape)} bf16',
        checked_batches=list(POSE_BATCHES_W32),
        checked_batches_w48=list(POSE_BATCHES))
    print(f'B4 int8_chain B={bsz}: {ms:.4f} ms (plain {plain_ms:.4f}, '
          f'_int_mm {lib_ms:.4f}, bound {b_ms:.5f} {b_by})', flush=True)


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
    busy_ms, top = profile_predict(name, model, frames)
    summary.update(stack8_device_busy_ms=busy_ms, stack8_top_device_ms=top)
    del model
    torch.cuda.empty_cache()
    return launches, single, stack, summary


def profile_predict(name, model, frames):
    """Device time by kernel over one ``predict`` of the 8-frame stack
    (torch.profiler, CUDA activity). Returns the summed device time and
    the ten largest entries."""
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
    return busy, [[round(ms, 4), n, key[:80]] for ms, n, key in rows[:10]]


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
