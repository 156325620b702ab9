"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds, not minutes). Libraries are
built at first use into ``simple_hrnet_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags so an edited
source is rebuilt. ``build_all`` starts one ``nvcc`` per missing source,
all at once, and waits for every one.

``host_library`` builds the host C++ libraries (``csrc/host/*.cpp``:
the box NMS of ``ops/nms.nms_numpy`` and the JPEG decode-warp-normalize of
``data/native.py``) the same way, with ``g++``.

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

KERNELS = ('nms', 'fused_block', 'fuse_up', 'winograd_chain', 'int8_chain',
           'activation')

# no --use_fast_math: the NMS kernel must reproduce the plain version's
# IEEE division slot for slot, and the activation kernel its IEEE expf,
# log1pf, tanhf and division bit for bit
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


# the host libraries (csrc/host/<name>.cpp): the JAX package's
# native/Makefile flags, one g++ each, at first use
HOST_DIR = os.path.join(CSRC_DIR, 'host')
HOST_FLAGS = ('-O3', '-march=native', '-fPIC', '-std=c++17', '-shared')
HOST_LINK = {'nms': (), 'imgproc': ('-ljpeg',)}


def _cpu_tag() -> bytes:
    """The host CPU's model and feature flags: ``-march=native`` builds for
    them, so a library built on another host is not reused."""
    try:
        with open('/proc/cpuinfo') as f:
            lines = [ln for ln in f if ln.startswith(('model name', 'flags'))]
        return ''.join(sorted(set(lines))).encode()
    except OSError:
        import platform
        return platform.processor().encode()


def _host_so_path(name: str) -> str:
    h = hashlib.sha1()
    with open(os.path.join(HOST_DIR, f'{name}.cpp'), 'rb') as f:
        h.update(f.read())
    h.update(' '.join(HOST_FLAGS + HOST_LINK[name]).encode())
    h.update(_cpu_tag())
    return os.path.join(BUILD_DIR, f'libhost_{name}-{h.hexdigest()[:12]}.so')


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library ``name`` ('nms' or 'imgproc'), compiled by
    ``g++`` into ``_build/`` first if missing. A failed build raises with
    the compiler's output (a missing ``jpeglib.h`` is named there): the
    callers never give way to another route."""
    lib = _LIBS.get(f'host:{name}')
    if lib is not None:
        return lib
    so = _host_so_path(name)
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        cxx = os.environ.get('CXX') or shutil.which('g++') or 'g++'
        tmp = f'{so}.{os.getpid()}.tmp'
        cmd = [cxx, *HOST_FLAGS, '-o', tmp,
               os.path.join(HOST_DIR, f'{name}.cpp'), *HOST_LINK[name]]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f'host library {name}: cannot run {cxx}: '
                               f'{e}') from e
        BUILD_LOGS[f'host:{name}'] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f'host library {name} failed to build ({" ".join(cmd)}):\n'
                f'{proc.stdout}{proc.stderr}')
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    _LIBS[f'host:{name}'] = lib
    return lib


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a kernel launch.

    The ``ctypes`` launch goes through the CUDA runtime's current device,
    so every wrapper launches inside ``torch.cuda.device(<input>.device)``:
    a replica on ``cuda:1`` then launches in device 1's context, with
    device 1's pointers and stream, and the caller's current device is put
    back afterwards."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA error {rc} at launch')


def ptr(t: Optional['object']) -> ctypes.c_void_p:
    """Device pointer of a tensor (None -> NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
