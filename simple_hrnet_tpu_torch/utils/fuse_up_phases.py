"""Where K3's, K2's, B3's and B4's time goes: the kernels with phases left
out; and K1 (NMS) timed whole beside other versions of it.

Builds copies of ``csrc/fuse_up.cu`` (K3, the high-res fuse),
``csrc/fused_block.cu`` (K2, the branch-0 chain),
``csrc/winograd_chain.cu`` (B3, the Winograd-H chain) and
``csrc/int8_chain.cu`` (B4, the int8 chain) with some of the three phases
of their tile loops removed — the ring's copies ('loads'), the
tensor-core products ('products') and the epilogue with its stores
('epilogue') — and times each copy beside the whole kernel the way
``chip_smoke.py`` times them: replayed from a CUDA graph over input sets
larger than twice the L2. K3 runs at the shapes ``chip_smoke.py`` times
(HRNet-W48 stage 2-4 and HRNet-W32 stage 4, bf16, 32 crops), K2 in bf16 at
the W48 branch-0 shape with 32 and 2 crops, B3 in bf16 at the W32 branch-0
shape with 32 and 2 crops (beside K2 at that shape), B4 at the W32
branch-0 shape with 32 and 2 crops in the Pallas kernel's cast points
(HRNet's mode at W32). A copy without some
phase computes garbage; only its time means something. ``--kernel nms``
times ``csrc/nms.cu`` (K1) at the 8-frame and one-frame detect shapes
((8, 256, 32) and (1, 256, 32): images, candidates, slots), replayed from
a CUDA graph as ``chip_smoke.py`` times it: whole, with only its mask
kernel doing work (the scan returns after its wait), with neither kernel
doing work, and beside an empty kernel. Needs a card and ``nvcc``; run
from the repository root:

    python3 -m simple_hrnet_tpu_torch.utils.fuse_up_phases [--kernel K]
        [--chain-baseline OTHER/fused_block.cu ...]
        [--wino-baseline OTHER/winograd_chain.cu ...]
        [--int8-baseline OTHER/int8_chain.cu ...]
        [--nms-baseline OTHER/nms.cu ...]

``--chain-baseline``, ``--wino-baseline``, ``--int8-baseline`` and
``--nms-baseline`` (repeatable) also build other versions of
``fused_block.cu``, ``winograd_chain.cu``, ``int8_chain.cu`` or
``nms.cu`` (for example the parent commit's) and time each whole beside
the kernel's variants, so versions are compared in one run on one card.
An older ``int8_chain.cu`` whose C entry lacks the trailing cast-point
argument runs its own cast points, and an older ``nms.cu`` whose C entry
lacks the trailing scratch pointer ignores it (the wrapper's extra
argument is ignored); each ``nms.cu`` must equal the plain version at
both shapes before it is timed.

Prints one line per variant (ms at each shape), a streaming yardstick (a
``copy_`` of the W48 base, to read the card's practical bytes/s) and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

from simple_hrnet_tpu_torch.ops.cuda import build
from simple_hrnet_tpu_torch.ops.cuda import fuse_up as K3
from simple_hrnet_tpu_torch.ops.cuda import fused_block as K2
from simple_hrnet_tpu_torch.ops.cuda import winograd_chain as KW

# variant -> the phases it keeps
VARIANTS = {
    'whole kernel': ('loads', 'products', 'epilogue'),
    'no products': ('loads', 'epilogue'),
    'no loads': ('products', 'epilogue'),
    'loads only': ('loads',),
    'products only': ('products',),
    'epilogue only': ('epilogue',),
    'skeleton': (),
}
# kernel source -> the phase calls of its tile loop (regexes)
PHASE_CALLS = {
    'fuse_up': {
        'loads': r'load_tile<T>\(a, ring [^;]*;',
        'products': r'products\(a, wsm, slot, tsm\);',
        'epilogue': r'epilogue<T>\(a, slot, tsm, bias, item\);',
    },
    'fused_block': {
        'loads': r'load_tile<C>\(a, ring \+ [^;]*;',
        'products': r'products<C>\([^;]*;',
        'epilogue': r'epilogue<C>\([^;]*;',
    },
}
# B3's tile loop spells its phase calls as K2's does
PHASE_CALLS['winograd_chain'] = PHASE_CALLS['fused_block']
PHASE_CALLS['int8_chain'] = {
    'loads': r'load_tile<KS, NJ>\(a, ld, ring \+ [^;]*;',
    'products': r'products<KS, NJ>\([^;]*;',
    'epilogue': r'epilogue<KS, NJ>\([^;]*;',
}
# what takes a removed call's place: K2's products leave their results in
# registers, so without the epilogue a sum of them is stored where no run
# looks (a negative zero sum), or the compiler would drop the products too
REMOVED = {
    ('fused_block', 'epilogue'):
        '{ float s_ = 0.f; _Pragma("unroll") for (int i_ = 0; i_ < '
        '(int)(sizeof(acc) / sizeof(float)); ++i_) s_ += (&acc[0][0][0])[i_];'
        ' if (__float_as_uint(s_) == 0x80000000u) a.out[0] = '
        '__float2bfloat16_rn(s_); }',
    # B3's products start its sums; without them the epilogue gets zeros
    ('winograd_chain', 'products'): 'zero(ye); zero(yo);',
    ('winograd_chain', 'epilogue'):
        '{ float s_ = 0.f; _Pragma("unroll") for (int i_ = 0; i_ < '
        '(int)(sizeof(ye) / sizeof(float)); ++i_) s_ += (&ye[0][0][0])[i_] + '
        '(&yo[0][0][0])[i_]; if (__float_as_uint(s_) == 0x80000000u) '
        'a.out[0] = __float2bfloat16_rn(s_); }',
    ('int8_chain', 'epilogue'):
        '{ int s_ = 0; _Pragma("unroll") for (int i_ = 0; i_ < '
        '(int)(sizeof(acc) / sizeof(int)); ++i_) s_ += (&acc[0][0][0])[i_]; '
        'if (s_ == 0x7fffffff) { if (a.qout != nullptr) a.qout[0] = 1; '
        'else a.out[0] = __float2bfloat16_rn(1.f); } }',
}


def variant_source(name, keep) -> str:
    with open(os.path.join(build.CSRC_DIR, f'{name}.cu')) as f:
        src = f.read()
    for phase, call in PHASE_CALLS[name].items():
        gone = REMOVED.get((name, phase), ';').replace('\\', '\\\\')
        src, n = re.subn(call, gone if phase not in keep else r'\g<0>', src)
        if not n:
            raise RuntimeError(f'no {phase} call found in {name}.cu')
    return src


def build_variants(name, out_dir, extra=None):
    """Compile every variant of kernel ``name`` (and each ``extra`` label:
    source path), one nvcc each, all at once."""
    os.makedirs(out_dir, exist_ok=True)
    sources = {}
    for i, (label, keep) in enumerate(VARIANTS.items()):
        cu = os.path.join(out_dir, f'{name}_v{i}.cu')
        with open(cu, 'w') as f:
            f.write(variant_source(name, keep))
        sources[label] = cu
    sources.update(extra or {})
    return compile_all(name, sources, out_dir)


def compile_all(name, sources, out_dir):
    """Compile each label's source, one nvcc each, all at once; returns
    the loaded libraries by label."""
    procs = {}
    for i, (label, cu) in enumerate(sources.items()):
        so = os.path.join(out_dir, f'lib{name}_v{i}.so')
        procs[label] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, '-o', so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for label, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for "{label}":\n{out}')
        libs[label] = ctypes.CDLL(so)
    return libs


def fuse_up_phases(cs, dev):
    libs = build_variants('fuse_up', os.path.join(build.BUILD_DIR,
                                                  'fuse_up_phases'))
    cases = [(cs.FUSE_W48, n) for n in (1, 2, 3)] + [(cs.FUSE_W32, 3)]
    inputs = []
    for shape, n_src in cases:
        args = cs._fuse_inputs(dev, torch.bfloat16, n_src, 32, *shape)
        per_call = 2 * cs.nbytes(args[0]) + cs.nbytes(*args[1], *args[2],
                                                      args[3])
        inputs.append(cs.input_sets(
            args, per_call,
            lambda a: (a[0].clone(), [y.clone() for y in a[1]], *a[2:])))
    print('K3 fuse_up, ms at (32, 96, 72, 48) + 1 / 2 / 3 sources and '
          '(32, 64, 48, 32) + 3 sources, bf16:')
    for label, lib in libs.items():
        build._LIBS['fuse_up'] = lib
        row = [cs.graph_ms([lambda a=a: K3.fuse_up(*a) for a in sets])
               for sets in inputs]
        print(f'  {label:>14}: ' + '  '.join(f'{ms:.4f}' for ms in row),
              flush=True)
    build._LIBS.pop('fuse_up')
    base = [a[0] for a in inputs[2]]
    outs = [torch.empty_like(b) for b in base]
    ms = cs.graph_ms([lambda b=b, o=o: o.copy_(b)
                      for b, o in zip(base, outs)])
    moved = 2 * cs.nbytes(base[0])
    print(f'  copy_ of the W48 base ({moved / 1e6:.1f} MB moved): '
          f'{ms:.4f} ms, {moved / ms / 1e9:.3f} TB/s')


def _labelled(paths):
    return {os.path.basename(os.path.dirname(os.path.abspath(p))) + '/' +
            os.path.basename(p): p for p in paths}


def chain_phases(cs, dev, baselines=()):
    libs = build_variants('fused_block', os.path.join(
        build.BUILD_DIR, 'fused_block_phases'), _labelled(baselines))
    inputs = []
    for bsz in (32, 2):
        args = cs._chain_inputs(dev, torch.bfloat16, bsz)
        per_call = 2 * cs.nbytes(args[0]) + cs.nbytes(*args[1:])
        inputs.append(cs.input_sets(args, per_call,
                                    lambda a: (a[0].clone(), *a[1:])))
    print('K2 basic_chain, ms at (32, 96, 72, 48) and (2, 96, 72, 48), '
          'bf16:')
    for label, lib in libs.items():
        build._LIBS['fused_block'] = lib
        row = [cs.graph_ms([lambda a=a: K2.basic_chain(*a) for a in sets])
               for sets in inputs]
        print(f'  {label:>14}: ' + '  '.join(f'{ms:.4f}' for ms in row),
              flush=True)
    build._LIBS.pop('fused_block')


def wino_phases(cs, dev, baselines=()):
    libs = build_variants('winograd_chain', os.path.join(
        build.BUILD_DIR, 'winograd_chain_phases'), _labelled(baselines))
    inputs, k2 = [], []
    for bsz in (32, 2):
        x, ww, b, wl = cs._wino_inputs(dev, bsz)
        per_call = 2 * cs.nbytes(x) + cs.nbytes(ww, b)
        sets = cs.input_sets(x, per_call, torch.clone)
        inputs.append([(v, ww, b) for v in sets])
        k2.append([(v, wl, b) for v in sets])
    print('B3 wino_chain, ms at (32, 64, 48, 32) and (2, 64, 48, 32), '
          'bf16:')
    for label, lib in libs.items():
        build._LIBS['winograd_chain'] = lib
        row = [cs.graph_ms([lambda a=a: KW.wino_chain(*a) for a in sets])
               for sets in inputs]
        print(f'  {label:>14}: ' + '  '.join(f'{ms:.4f}' for ms in row),
              flush=True)
    build._LIBS.pop('winograd_chain')
    row = [cs.graph_ms([lambda a=a: K2.basic_chain(*a) for a in sets])
           for sets in k2]
    print(f'  {"K2 same shape":>14}: ' + '  '.join(f'{ms:.4f}' for ms in row),
          flush=True)


def int8_phases(cs, dev, baselines=()):
    from simple_hrnet_tpu_torch.ops.cuda import int8_chain as K8

    libs = build_variants('int8_chain', os.path.join(
        build.BUILD_DIR, 'int8_chain_phases'), _labelled(baselines))
    inputs = []
    for bsz in (32, 2):
        x, q, _ = cs._int8_inputs(dev, bsz, 64, 48, 32)
        args = (q['wq'], q['wscale'], q['b'], q['ascales'])
        per_call = 2 * cs.nbytes(x) + cs.nbytes(*args)
        sets = cs.input_sets(x, per_call, torch.clone)
        inputs.append([(v, *args) for v in sets])
    print('B4 int8_chain, ms at (32, 64, 48, 32) and (2, 64, 48, 32), '
          'bf16 in and out:')
    for label, lib in libs.items():
        build._LIBS['int8_chain'] = lib
        row = [cs.graph_ms([lambda a=a: K8.int8_chain(*a) for a in sets])
               for sets in inputs]
        print(f'  {label:>14}: ' + '  '.join(f'{ms:.4f}' for ms in row),
              flush=True)
    build._LIBS.pop('int8_chain')


# K1's phases: the scan kernel returning as soon as its wait ends ('mask
# only': the mask kernel and both launches), and the mask kernel returning
# at once as well ('launches only'); their results are garbage
NMS_CUTS = {
    'mask': (r'asm volatile\("griddepcontrol\.launch_dependents;\\n" '
             r'::: "memory"\);', r'\g<0> if (n > 0) return;'),
    'scan': (r'asm volatile\("griddepcontrol\.wait;\\n" ::: "memory"\);',
             r'\g<0> return;'),
}
NMS_VARIANTS = {'mask only': ('scan',), 'launches only': ('mask', 'scan')}


def nms_versions(cs, dev, baselines=()):
    from simple_hrnet_tpu_torch.ops.cuda import nms as K1

    out_dir = os.path.join(build.BUILD_DIR, 'nms_versions')
    os.makedirs(out_dir, exist_ok=True)
    tree = os.path.join(build.CSRC_DIR, 'nms.cu')
    sources = {'tree': tree}
    for i, (label, cuts) in enumerate(NMS_VARIANTS.items()):
        with open(tree) as f:
            src = f.read()
        for cut in cuts:
            src, n = re.subn(*NMS_CUTS[cut], src)
            if n != 1:
                raise RuntimeError(f'no single {cut} cut point in nms.cu')
        sources[label] = os.path.join(out_dir, f'nms_cut{i}.cu')
        with open(sources[label], 'w') as f:
            f.write(src)
    sources.update(_labelled(baselines))
    libs = compile_all('nms', sources, out_dir)
    print('K1 nms, ms at ' + ' and '.join(str(s) for s in cs.NMS_SHAPES) +
          ' (images, candidates, slots), replayed from a CUDA graph; eager '
          'in brackets:')
    for label, lib in libs.items():
        build._LIBS['nms'] = lib
        if label not in NMS_VARIANTS:  # a whole version: check it first
            for bsz, n, max_out in cs.NMS_SHAPES:
                boxes, scores = cs._nms_inputs(dev, bsz, n, seed=11)
                got = K1.nms(boxes, scores, cs.NMS_THRESH, max_out)
                want = K1.nms_plain(boxes, scores, cs.NMS_THRESH, max_out)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f'{label} disagrees with nms_plain '
                                         f'at {(bsz, n, max_out)}')
        row = [cs.time_nms(K1, dev, shape) for shape in cs.NMS_SHAPES]
        print(f'  {label:>14}: ' + '  '.join(f'{ms:.4f} ({eager:.4f})'
                                             for ms, eager in row),
              flush=True)
    build._LIBS['nms'] = libs['tree']
    print(f'  {"empty kernel":>14}: '
          f'{cs.graph_ms([lambda: cs.empty_launch(dev)]):.4f}')
    build._LIBS.pop('nms')


def main():
    import chip_smoke as cs  # the repository root's: shapes, inputs, timing

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--kernel', choices=('fuse_up', 'basic_chain', 'wino',
                                         'int8', 'nms', 'all'),
                    default='all')
    ap.add_argument('--chain-baseline', metavar='FUSED_BLOCK_CU',
                    action='append', default=[],
                    help='another fused_block.cu to time whole beside K2')
    ap.add_argument('--wino-baseline', metavar='WINOGRAD_CHAIN_CU',
                    action='append', default=[],
                    help='another winograd_chain.cu to time whole beside B3')
    ap.add_argument('--int8-baseline', metavar='INT8_CHAIN_CU',
                    action='append', default=[],
                    help='another int8_chain.cu to time whole beside B4')
    ap.add_argument('--nms-baseline', metavar='NMS_CU', action='append',
                    default=[],
                    help='another nms.cu to time whole beside K1')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('fuse_up_phases: no CUDA device visible', file=sys.stderr)
        return 1
    dev = torch.device('cuda', 0)
    if args.kernel in ('fuse_up', 'all'):
        fuse_up_phases(cs, dev)
    if args.kernel in ('basic_chain', 'all'):
        chain_phases(cs, dev, args.chain_baseline)
    if args.kernel in ('wino', 'all'):
        wino_phases(cs, dev, args.wino_baseline)
    if args.kernel in ('int8', 'all'):
        int8_phases(cs, dev, args.int8_baseline)
    if args.kernel in ('nms', 'all'):
        nms_versions(cs, dev, args.nms_baseline)
    print(cs.card_line())
    return 0


if __name__ == '__main__':
    sys.exit(main())
