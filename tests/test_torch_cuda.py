"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``; skips on a host without a CUDA device. Imports neither
JAX nor the JAX package, so it runs on a GPU host without JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.) Tolerances: NMS slot
for slot; the chain and the fuse 1e-4 of max in f32 with TF32 off
(summation order only), 2^-6 of max in bf16 (chip_smoke.py's limit).
"""

import numpy as np
import pytest
import torch

from simple_hrnet_tpu_torch.ops.cuda import fuse_up as TF
from simple_hrnet_tpu_torch.ops.cuda import fused_block as TB
from simple_hrnet_tpu_torch.ops.cuda import nms as TN


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
