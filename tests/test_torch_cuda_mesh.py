"""The kernel wrappers on a second card: each launches in the context of its
input's device.

A ``ctypes`` launch goes through the CUDA runtime's current device, so
every wrapper launches inside ``torch.cuda.device(<input>.device)``, and
each kernel sets its shared-memory attribute once per device. On a host
with two CUDA devices, each of the five wrappers (K1 NMS, the K2 chain,
the B3 Winograd chain, the B4 int8 chain and the K3 fuse) is called on
tensors of ``cuda:1`` while ``cuda:0`` is current: the current device
stays ``cuda:0``, the output lies on ``cuda:1``, nothing is allocated on
``cuda:0``, the launch is counted once, and the result equals the same
call on ``cuda:0`` bit for bit (the same kernel on the same inputs).

Marked ``cuda``; skips unless two CUDA devices are visible. Imports
neither JAX nor the JAX package:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_mesh.py
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

pytestmark = pytest.mark.cuda


@pytest.fixture
def two():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA devices')
    return torch.device('cuda', 0), torch.device('cuda', 1)


def _calls():
    """(name, wrapper, inputs on a device) for each kernel at a small
    shape of its path."""
    import chip_smoke as S
    from simple_hrnet_tpu_torch.ops.cuda import (fuse_up, fused_block,
                                                 int8_chain, nms,
                                                 winograd_chain)

    def nms_args(dev):
        return (*S._nms_inputs(dev, 2, 256, seed=1), S.NMS_THRESH, 32)

    def chain_args(dev):
        return S._chain_inputs(dev, torch.bfloat16, 2)

    def wino_args(dev):
        return S._wino_inputs(dev, 2)[:3]

    def int8_args(dev):
        x, q, _ = S._int8_inputs(dev, 2, 64, 48, 32)
        return (x, q['wq'], q['wscale'], q['b'], q['ascales'])

    def fuse_args(dev):
        return S._fuse_inputs(dev, torch.bfloat16, 3, 2)

    return (('nms', nms.nms, nms_args),
            ('basic_chain', fused_block.basic_chain, chain_args),
            ('wino_chain', winograd_chain.wino_chain, wino_args),
            ('int8_chain', int8_chain.int8_chain, int8_args),
            ('fuse_up', fuse_up.fuse_up, fuse_args))


def _outs(res):
    return res if isinstance(res, tuple) else (res,)


@pytest.mark.parametrize('idx', range(5))
def test_wrapper_launches_on_its_inputs_device(two, idx):
    d0, d1 = two
    name, fn, make = _calls()[idx]
    ref = _outs(fn(*make(d0)))  # built and warmed on device 0 first
    args1 = make(d1)
    torch.cuda.synchronize(d0)
    torch.cuda.synchronize(d1)
    torch.cuda.set_device(d0)
    before = torch.cuda.memory_allocated(d0)
    n = fn.launches
    got = _outs(fn(*args1))
    torch.cuda.synchronize(d1)
    assert torch.cuda.current_device() == 0, name
    assert fn.launches == n + 1, name
    assert torch.cuda.memory_allocated(d0) == before, name
    for g, r in zip(got, ref):
        assert g.device == d1, name
        assert torch.equal(g.cpu(), r.cpu()), name
