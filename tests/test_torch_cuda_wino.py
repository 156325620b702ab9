"""B3 (the Winograd-H chain kernel) against its plain version, on a card:
every width the kernel takes at the W32 branch-0 shape, at the batches
``predict`` forms and one larger, ragged images that no 8 x 8 tile
divides, the launch counter, and the shapes the wrapper refuses.

Marked ``cuda``; skips on a host without a CUDA device. Imports neither
JAX nor the JAX package, so it runs on a GPU host without JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_wino.py

Tolerance as in tests/test_torch_cuda.py: 2^-6 of max in bf16
(chip_smoke.py's limit).
"""

import pytest
import torch

from simple_hrnet_tpu_torch.ops.cuda import winograd_chain as TW

TOL = 2.0 ** -6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _operands(dev, shape, seed):
    """bf16 x, U from f32 weights at folded-BN scale, f32 biases."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(*shape, device=dev, generator=g).bfloat16()
    w = ((torch.rand(8, 3, 3, c, c, device=dev, generator=g) * 2 - 1) *
         1.7 / (3 * c ** 0.5))
    b = torch.rand(8, c, device=dev, generator=g) * 2 - 1
    return x, TW.pack_winograd_weights(w, torch.bfloat16), b


def _check(x, ww, b):
    launches = TW.wino_chain.launches
    out = TW.wino_chain(x, ww, b)
    assert TW.wino_chain.launches == launches + 1
    ref = TW.wino_chain_plain(x, ww, b).float()
    torch.cuda.synchronize()
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max() <= TOL * max(1.0,
                                                       ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('c', TW.WINO_WIDTHS)
def test_wino_chain_kernel_matches_plain(dev, c):
    """(3, 24, 20, C): W = 20 leaves half a tile at the right edge."""
    g = torch.Generator(device=dev).manual_seed(32)
    x = torch.randn(3, 24, 20, c, device=dev, generator=g).bfloat16()
    w = torch.rand(8, 3, 3, c, c, device=dev, generator=g) * 0.2 - 0.1
    b = torch.rand(8, c, device=dev, generator=g) * 2 - 1
    _check(x, TW.pack_winograd_weights(w, torch.bfloat16), b)


@pytest.mark.cuda
@pytest.mark.parametrize('c', TW.WINO_WIDTHS)
def test_wino_chain_every_width_at_predict_batches(dev, c):
    """(B, 64, 48, C) at the batches predict forms most, 1, 2 (fewer tiles
    than resident blocks: most warps get none) and 32 (at most one tile a
    warp at C = 32), and at 48, where every block has more tiles than
    warps (two teams, ring slots refilled) at both widths."""
    for bsz in (1, 2, 32, 48):
        _check(*_operands(dev, (bsz, 64, 48, c), 70 + bsz + c))


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1, 6, 13, 32), (2, 10, 20, 64)],
                         ids=['6x13', '10x20'])
def test_wino_chain_ragged_images(dev, shape):
    """Even H not a multiple of 8 (the last tile's lower row pairs lie
    outside the image) and W not a multiple of 8 (zero-filled halo columns,
    stores masked)."""
    _check(*_operands(dev, shape, 80 + shape[1]))


@pytest.mark.cuda
@pytest.mark.parametrize('shape,dtype,match', [
    ((1, 16, 16, 16), torch.bfloat16, 'takes C in'),
    ((1, 16, 16, 48), torch.bfloat16, 'takes C in'),
    ((1, 15, 16, 32), torch.bfloat16, 'odd'),
    ((1, 16, 16, 32), torch.float32, 'bf16'),
], ids=['c16', 'c48', 'odd_h', 'f32'])
def test_wino_chain_refuses(dev, shape, dtype, match):
    """Widths without a template, odd H and non-bf16 tensors raise before
    any launch, and the counter does not move."""
    c = shape[-1]
    x = torch.zeros(*shape, device=dev, dtype=dtype)
    ww = torch.zeros(8, 4, 3 * c, c, device=dev, dtype=dtype)
    b = torch.zeros(8, c, device=dev)
    launches = TW.wino_chain.launches
    with pytest.raises(ValueError, match=match):
        TW.wino_chain(x, ww, b)
    assert TW.wino_chain.launches == launches
