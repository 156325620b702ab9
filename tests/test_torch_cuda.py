"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``; skips on a host without a CUDA device. Imports neither
JAX nor the JAX package, so it runs on a GPU host without JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.) Tolerances: NMS slot
for slot; the chain and the fuse 1e-4 of max in f32 with TF32 off
(summation order only), 2^-6 of max in bf16 (chip_smoke.py's limit), the
same for the Winograd chain; the int8 chain and the int8 conv bit for bit
(exact int32 cores and the same IEEE f32 epilogue as their plain
versions).
"""

import numpy as np
import pytest
import torch

from simple_hrnet_tpu_torch.ops import int8 as T8
from simple_hrnet_tpu_torch.ops.cuda import fuse_up as TF
from simple_hrnet_tpu_torch.ops.cuda import fused_block as TB
from simple_hrnet_tpu_torch.ops.cuda import int8_chain as TI8
from simple_hrnet_tpu_torch.ops.cuda import nms as TN
from simple_hrnet_tpu_torch.ops.cuda import winograd_chain as TW


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
def test_nms_kernel_matches_plain(dev):
    rng = np.random.default_rng(30)
    n = 256
    xy = rng.uniform(0, 300, (3, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 150, (3, n, 2))], -1)
    scores = np.ceil(rng.uniform(0.01, 1.0, (3, n)) * 8) / 8  # ties
    scores[rng.uniform(0, 1, (3, n)) < 0.1] = 0.0
    bt = torch.tensor(boxes, dtype=torch.float32, device=dev)
    st = torch.tensor(scores, dtype=torch.float32, device=dev)
    launches = TN.nms.launches
    idx, valid = TN.nms(bt, st, 0.45, 32)
    pidx, pvalid = TN.nms_plain(bt, st, 0.45, 32)
    assert TN.nms.launches == launches + 1
    assert torch.equal(idx, pidx) and torch.equal(valid, pvalid)


@pytest.mark.cuda
@pytest.mark.parametrize('c', [16, 48])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -6)])
def test_chain_and_fuse_kernels_match_plain(dev, dtype, tol, c):
    g = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn(2, 24, 16, c, device=dev, generator=g).to(dtype)
    w = (torch.rand(8, 3, 3, c, c, device=dev, generator=g) * 0.2
         - 0.1).to(dtype)
    b = torch.rand(8, c, device=dev, generator=g) * 2 - 1
    out = TB.basic_chain(x, w, b).float()
    ref = TB.basic_chain_plain(x, w, b).float()
    assert (out - ref).abs().max() <= tol * max(1.0, ref.abs().max())
    ys = [torch.randn(2, 24 // f, 16 // f, c * f, device=dev,
                      generator=g).to(dtype) for f in (2, 4, 8)]
    ws = [(torch.rand(c * f, c, device=dev, generator=g) * 0.2
           - 0.1).to(dtype) for f in (2, 4, 8)]
    bs = torch.rand(c, device=dev, generator=g) * 2 - 1
    out = TF.fuse_up(x, ys, ws, bs).float()
    ref = TF.fuse_up_plain(x, ys, ws, bs).float()
    assert (out - ref).abs().max() <= tol * max(1.0, ref.abs().max())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_chain_kernel_rejects_width_not_multiple_of_8(dev):
    x = torch.zeros(1, 8, 8, 12, device=dev)
    with pytest.raises(ValueError, match='multiple of 8'):
        TB.basic_chain(x, torch.zeros(8, 3, 3, 12, 12, device=dev),
                       torch.zeros(8, 12, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize('c', [16, 32])
def test_wino_chain_kernel_matches_plain(dev, c):
    g = torch.Generator(device=dev).manual_seed(32)
    x = torch.randn(3, 24, 20, c, device=dev, generator=g).bfloat16()
    w = torch.rand(8, 3, 3, c, c, device=dev, generator=g) * 0.2 - 0.1
    b = torch.rand(8, c, device=dev, generator=g) * 2 - 1
    ww = TW.pack_winograd_weights(w, torch.bfloat16)
    launches = TW.wino_chain.launches
    out = TW.wino_chain(x, ww, b).float()
    assert TW.wino_chain.launches == launches + 1
    ref = TW.wino_chain_plain(x, ww, b).float()
    assert (out - ref).abs().max() <= 2.0 ** -6 * max(1.0, ref.abs().max())
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize('c', [16, 48])
def test_int8_chain_kernel_matches_plain(dev, c):
    g = torch.Generator(device=dev).manual_seed(33)
    x = torch.randn(3, 24, 20, c, device=dev, generator=g)
    w = torch.rand(8, c, c, 3, 3, device=dev, generator=g) * 0.2 - 0.1
    b = torch.rand(8, c, device=dev, generator=g) * 2 - 1
    amax = [4.0 + i for i in range(8)]
    q = TI8.pack_chain_weights_int8([(w[i], b[i]) for i in range(8)], amax)
    args = (q['wq'], q['wscale'], q['b'], q['ascales'])
    launches = TI8.int8_chain.launches
    out = TI8.int8_chain(x.bfloat16(), *args)
    assert TI8.int8_chain.launches == launches + 1
    assert torch.equal(out, TI8.int8_chain_plain(x.bfloat16(), *args))
    with pytest.raises(ValueError, match='bf16'):
        TI8.int8_chain(x, *args)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_int8_conv_cuda_route_matches_cpu_integer_path(dev):
    g = torch.Generator().manual_seed(34)
    x = torch.randn(2, 32, 15, 13, generator=g).bfloat16()
    wq = torch.randint(-127, 128, (48, 9 * 32), generator=g,
                       dtype=torch.int8)
    ws = torch.rand(48, generator=g) * 0.01
    a = torch.tensor(0.02)
    bias = torch.rand(48, generator=g)
    for stride in (1, 2):
        cpu = T8.int8_conv2d(x, wq, 3, ws, a, bias, stride, 1)
        gpu = T8.int8_conv2d(x.to(dev), wq.to(dev), 3, ws.to(dev), a.to(dev),
                             bias.to(dev), stride, 1)
        assert torch.equal(gpu.cpu(), cpu)
