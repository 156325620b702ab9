"""Where K3's time goes: the high-res fuse kernel with phases left out.

Builds copies of ``csrc/fuse_up.cu`` with some of the three phases of its
tile loop removed — the ring's copies ('loads'), the tensor-core products
('products') and the epilogue with its stores ('epilogue') — and times each
copy beside the whole kernel at the shapes ``chip_smoke.py`` times (HRNet-W48
stage 2-4 and HRNet-W32 stage 4, bf16, 32 crops), the same way: replayed
from a CUDA graph over input sets larger than L2. A copy without some phase
computes garbage; only its time means something. Needs a card and ``nvcc``;
run from the repository root:

    python3 -m simple_hrnet_tpu_torch.utils.fuse_up_phases

Prints one line per variant (ms at each shape), a streaming yardstick (a
``copy_`` of the W48 base, to read the card's practical bytes/s) and the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import torch

from simple_hrnet_tpu_torch.ops.cuda import build
from simple_hrnet_tpu_torch.ops.cuda import fuse_up as K

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
PHASE_CALLS = {
    'loads': r'load_tile<T>\(a, ring [^;]*;',
    'products': r'products\(a, wsm, slot, tsm\);',
    'epilogue': r'epilogue<T>\(a, slot, tsm, bias, item\);',
}


def variant_source(keep) -> str:
    with open(os.path.join(build.CSRC_DIR, 'fuse_up.cu')) as f:
        src = f.read()
    for phase, call in PHASE_CALLS.items():
        src, n = re.subn(call, ';' if phase not in keep else r'\g<0>', src)
        if not n:
            raise RuntimeError(f'no {phase} call found in fuse_up.cu')
    return src


def build_variants(out_dir):
    """Compile every variant, one nvcc each, all at once."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, keep) in enumerate(VARIANTS.items()):
        cu = os.path.join(out_dir, f'fuse_up_v{i}.cu')
        so = os.path.join(out_dir, f'libfuse_up_v{i}.so')
        with open(cu, 'w') as f:
            f.write(variant_source(keep))
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, '-o', so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for "{name}":\n{out}')
        libs[name] = ctypes.CDLL(so)
    return libs


def main():
    import chip_smoke as cs  # the repository root's: shapes, inputs, timing

    if not torch.cuda.is_available():
        print('fuse_up_phases: no CUDA device visible', file=sys.stderr)
        return 1
    libs = build_variants(os.path.join(build.BUILD_DIR, 'fuse_up_phases'))
    dev = torch.device('cuda', 0)
    cases = [(cs.FUSE_W48, n) for n in (1, 2, 3)] + [(cs.FUSE_W32, 3)]
    inputs = []
    for shape, n_src in cases:
        args = cs._fuse_inputs(dev, torch.bfloat16, n_src, 32, *shape)
        per_call = 2 * cs.nbytes(args[0]) + cs.nbytes(*args[1], *args[2],
                                                      args[3])
        sets = [args] + [(args[0].clone(), [y.clone() for y in args[1]],
                          args[2], args[3])
                         for _ in range(-(-2 * cs.L2_BYTES // per_call) - 1)]
        inputs.append(sets)
    print('ms at (32, 96, 72, 48) + 1 / 2 / 3 sources and (32, 64, 48, 32) '
          '+ 3 sources, bf16:')
    for name, lib in libs.items():
        build._LIBS['fuse_up'] = lib
        K.smem_bytes.cache_clear()
        row = [cs.graph_ms([lambda a=a: K.fuse_up(*a) for a in sets])
               for sets in inputs]
        print(f'  {name:>14}: ' + '  '.join(f'{ms:.4f}' for ms in row),
              flush=True)
    base = [a[0] for a in inputs[2]]
    outs = [torch.empty_like(b) for b in base]
    ms = cs.graph_ms([lambda b=b, o=o: o.copy_(b)
                      for b, o in zip(base, outs)])
    moved = 2 * cs.nbytes(base[0])
    print(f'  copy_ of the W48 base ({moved / 1e6:.1f} MB moved): '
          f'{ms:.4f} ms, {moved / ms / 1e9:.3f} TB/s')
    print(cs.card_line())
    return 0


if __name__ == '__main__':
    sys.exit(main())
