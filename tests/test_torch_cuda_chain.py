"""K2 (the branch-0 chain kernel) bf16 path against its plain version, on a
card: every width the tensor-core path takes, ragged images that no 8 x 8
tile divides, batches with fewer tiles than resident blocks and with more
than one tile per warp, and the shapes the wrapper refuses.

Marked ``cuda``; skips on a host without a CUDA device. Imports neither
JAX nor the JAX package, so it runs on a GPU host without JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_chain.py

Tolerance as in tests/test_torch_cuda.py: 2^-6 of max in bf16
(chip_smoke.py's limit).
"""

import pytest
import torch

from simple_hrnet_tpu_torch.ops.cuda import fused_block as TB

TOL = 2.0 ** -6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _operands(dev, shape, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(*shape, device=dev, generator=g).bfloat16()
    w = ((torch.rand(8, 3, 3, c, c, device=dev, generator=g) * 2 - 1) *
         1.7 / (3 * c ** 0.5)).bfloat16()
    b = torch.rand(8, c, device=dev, generator=g) * 2 - 1
    return x, w, b


def _check(x, w, b):
    launches = TB.basic_chain.launches
    out = TB.basic_chain(x, w, b)
    assert TB.basic_chain.launches == launches + 1
    ref = TB.basic_chain_plain(x, w, b).float()
    torch.cuda.synchronize()
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max() <= TOL * max(1.0,
                                                       ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('c', [16, 32, 48, 64])
def test_chain_bf16_every_width(dev, c):
    """(48, 64, 48, C): 2304 tiles, more than one per warp at every width,
    so every warp's ring slots are refilled."""
    _check(*_operands(dev, (48, 64, 48, c), 40 + c))


@pytest.mark.cuda
@pytest.mark.parametrize('c', [16, 48])
def test_chain_bf16_ragged_single_image(dev, c):
    """13 x 11: tiles hang over the bottom and right edges (zero-filled
    halo, stores masked), one image, 4 tiles for 132 blocks."""
    _check(*_operands(dev, (1, 13, 11, c), 50 + c))


@pytest.mark.cuda
def test_chain_bf16_fewer_tiles_than_blocks(dev):
    """The 1-frame path's batch at the W48 shape (216 tiles: most blocks get
    one or two, most warps none) and a strip of 15 tiles."""
    _check(*_operands(dev, (2, 96, 72, 48), 60))
    _check(*_operands(dev, (3, 8, 40, 48), 61))


@pytest.mark.cuda
@pytest.mark.parametrize('shape,wshape,match', [
    ((16, 16, 48), (8, 3, 3, 48, 48), r'wants x \(B, H, W, C\)'),
    ((1, 16, 16, 48), (8, 3, 3, 32, 32), 'do not match'),
    ((1, 16, 16, 24), (8, 3, 3, 24, 24), 'takes C in'),
    ((1, 16, 16, 8), (8, 3, 3, 8, 8), 'takes C in'),
    ((1, 16, 16, 80), (8, 3, 3, 80, 80), 'takes C in'),
], ids=['rank3', 'weights', 'c24', 'c8', 'c80'])
def test_chain_bf16_refuses(dev, shape, wshape, match):
    x = torch.zeros(*shape, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(*wshape, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(8, wshape[-1], device=dev)
    launches = TB.basic_chain.launches
    with pytest.raises(ValueError, match=match):
        TB.basic_chain(x, w, b)
    assert TB.basic_chain.launches == launches
