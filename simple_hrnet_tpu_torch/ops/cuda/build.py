"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds, not minutes). Libraries are
built at first use into ``simple_hrnet_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags so an edited
source is rebuilt. ``build_all`` starts one ``nvcc`` per missing source,
all at once, and waits for every one.

Nothing here runs at import time: the CPU tests import every module on a
host with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(PKG_DIR, '_build')

KERNELS = ('nms', 'fused_block', 'fuse_up', 'winograd_chain', 'int8_chain')

# no --use_fast_math: the NMS kernel must reproduce the plain version's
# IEEE division slot for slot
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
              '-lineinfo')

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's stderr (ptxas register / shared-memory report) of this process's
# builds, by kernel name
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME') and
                 os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'),
                 shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                       'the CUDA kernels build only on a host with the CUDA '
                       'toolkit')


def _so_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f'{name}.cu')
    h = hashlib.sha1()
    with open(src, 'rb') as f:
        h.update(f.read())
    h.update(' '.join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f'lib{name}-{h.hexdigest()[:12]}.so')


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, all nvcc
    processes in parallel. Returns seconds per kernel built (0.0 for one
    already built); raises with nvcc's output if any build fails."""
    names = list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    seconds = {n: 0.0 for n in names}
    for n in names:
        so = _so_path(n)
        if os.path.exists(so):
            continue
        tmp = f'{so}.{os.getpid()}.tmp'
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp,
               os.path.join(CSRC_DIR, f'{n}.cu')]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, so, time.perf_counter())
    failed = []
    for n, (proc, tmp, so, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        BUILD_LOGS[n] = out
        if proc.returncode != 0:
            failed.append(f'--- nvcc {n}.cu (rc {proc.returncode}) ---\n{out}')
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(_so_path(name))
        _LIBS[name] = lib
    return lib


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a kernel launch."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA error {rc} at launch')


def ptr(t: Optional['object']) -> ctypes.c_void_p:
    """Device pointer of a tensor (None -> NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
