"""K4 (the activation kernel, ``csrc/activation.cu``) against its plain
version (``ops/activation.py``), on a card: sigmoid, SiLU and mish in f32
and bf16, at odd element counts (a tail past the last 16-byte vector),
from a pointer off the 16-byte grid, on NCHW and channels-last tensors,
with zeros, infinities and large magnitudes; one launch a call; the
inputs the wrapper refuses; a CUDA-graph replay; and the detectors'
modules, which launch it once an activation.

Marked ``cuda``; skips on a host without a CUDA device. Imports neither
JAX nor the JAX package, so it runs on a GPU host without JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_activation.py

Tolerance: bit for bit (NaN where the plain version gives NaN): the
kernel computes the plain version's ops with the same IEEE functions and
rounds where it does.
"""

import numpy as np
import pytest
import torch

from simple_hrnet_tpu_torch.ops import activation as P
from simple_hrnet_tpu_torch.ops.cuda import activation as A

ACTS = ('sigmoid', 'silu', 'mish')
DTYPES = (torch.float32, torch.bfloat16)
SPECIALS = (0.0, -0.0, float('inf'), float('-inf'), 100.0, -100.0, 88.5,
            -88.5, 1e-30, -1e-30, 20.0, -20.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _values(n, seed, dev, dtype):
    x = np.random.default_rng(seed).normal(0.0, 4.0, n).astype(np.float32)
    k = min(n, len(SPECIALS))
    x[:k] = SPECIALS[:k]
    return torch.from_numpy(x).to(dev, dtype)


def _assert_same(got, want, what=''):
    """Bit for bit, NaN where ``want`` is NaN (silu(-inf) is -inf * 0)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), what
    assert torch.equal(got[~nan], want[~nan]), \
        f'{what}: {int((got != want)[~nan].sum())} elements differ'


def _check(x, act):
    """The kernel equals the plain version bit for bit on ``x``, with one
    launch, and keeps ``x``'s strides."""
    launches = A.activation.launches
    got = A.activation(x, act)
    assert A.activation.launches == launches + 1
    want = P.PLAIN[act](x)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    assert got.stride() == x.stride()
    _assert_same(got, want, f'{act} {x.dtype}')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('act', ACTS)
def test_kernel_matches_plain(dev, act, dtype):
    for i, n in enumerate((1, 7, 8, 9, 4099, 1_000_003)):
        _check(_values(n, i, dev, dtype), act)
    # off the 16-byte grid: the elements go one at a time
    _check(_values(4099, 7, dev, dtype)[1:], act)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES)
def test_layouts(dev, dtype):
    """NCHW and channels-last at a detector-like odd shape."""
    x = _values(2 * 48 * 17 * 13, 8, dev, dtype).reshape(2, 48, 17, 13)
    for act in ACTS:
        _check(x, act)
        _check(x.contiguous(memory_format=torch.channels_last), act)


@pytest.mark.cuda
def test_control_rounds_unlike_torch(dev):
    """PyTorch's one-rounding calls are not the function: in bf16 they
    differ from the kernel on a large share of elements."""
    x = _values(1 << 20, 9, dev, torch.bfloat16)
    for act, once in (('sigmoid', torch.sigmoid),
                      ('silu', torch.nn.functional.silu)):
        share = (A.activation(x, act) != once(x)).float().mean().item()
        assert share > 0.1, (act, share)


@pytest.mark.cuda
def test_refused_inputs(dev):
    x = _values(64, 10, dev, torch.float32).reshape(8, 8)
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        A.silu(x.half())
    with pytest.raises(ValueError, match='dense'):
        A.silu(x[:, ::2])
    with pytest.raises(ValueError, match='gradient'):
        A.silu(x.clone().requires_grad_(True))
    with pytest.raises(ValueError, match='is not one of'):
        A.activation(x, 'gelu')
    launches = A.activation.launches
    assert A.silu(x[:0]).shape == (0, 8)
    assert A.activation.launches == launches


@pytest.mark.cuda
def test_graph_replay(dev):
    """Captured in a CUDA graph and replayed on new inputs, the kernel
    still equals its plain version."""
    x = _values(1 << 16, 11, dev, torch.bfloat16)
    A.silu(x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = A.silu(x)
    x.copy_(_values(1 << 16, 12, dev, torch.bfloat16))
    graph.replay()
    torch.cuda.synchronize()
    _assert_same(out, P.silu(x), 'replayed')


@pytest.mark.cuda
def test_detector_modules_launch_once_an_activation(dev):
    """A bf16 yolov5n forward launches K4 once a ``Conv``, and its output
    equals the same network's with the plain version in place of K4; a
    darknet conv with mish launches it once."""
    from simple_hrnet_tpu_torch.detectors import darknet as TD
    from simple_hrnet_tpu_torch.detectors import yolov5 as T5
    from simple_hrnet_tpu_torch.models import layers as L

    net = T5.init(T5.build_config('yolov5n'), seed=0)
    net = L.fold_batch_norm(net).to(dev)
    heads = set(net.model['24'].m)
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d) and m not in heads:
            m.to(torch.bfloat16)
    net.compute_dtype = torch.bfloat16
    net.to(memory_format=torch.channels_last)
    convs = sum(isinstance(m, T5.Conv) for m in net.modules())
    x = torch.rand((2, 128, 128, 3), generator=torch.Generator().manual_seed(
        13)).to(dev)
    with torch.no_grad():
        launches = A.activation.launches
        got = net(x, 128)
        assert A.activation.launches == launches + convs
        real = A.silu
        A.silu = P.silu
        try:
            want = net(x, 128)
        finally:
            A.silu = real
    torch.cuda.synchronize()
    assert torch.equal(got, want)

    blk = {'type': 'convolutional', 'bn': False, 'filters': 8, 'size': 3,
           'stride': 1, 'pad': 1, 'activation': 'mish'}
    m = TD.DarknetConv(4, blk)
    torch.nn.init.normal_(m.weight)
    torch.nn.init.normal_(m.bias)
    m = m.to(dev, torch.bfloat16)
    with torch.no_grad():
        launches = A.activation.launches
        y = m(torch.randn((1, 4, 9, 11), device=dev, dtype=torch.bfloat16))
        assert A.activation.launches == launches + 1
    assert torch.isfinite(y).all()
