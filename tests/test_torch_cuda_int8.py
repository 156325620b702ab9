"""B4 (the int8 chain kernel) against its plain version, on a card, in both
cast-point modes: every width class the kernel is compiled for, the W32
branch-0 shape at the smallest and largest batch ``predict`` forms, ragged
images that no 8 x 8 tile divides, widths above 64 (output channels split
over two grid rows), the launch counter, and the inputs the wrapper
refuses.

Marked ``cuda``; skips on a host without a CUDA device. Imports neither
JAX nor the JAX package, so it runs on a GPU host without JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_int8.py

Tolerance: bit for bit (``torch.equal``): the int32 cores are exact in any
order, and the kernel's f32 epilogue is the plain version's IEEE
operations in the same order with the same roundings.
"""

import pytest
import torch

from simple_hrnet_tpu_torch.ops.cuda import int8_chain as TI8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _operands(dev, shape, seed):
    """bf16 x, and the packing of 8 convs at folded-BN scale with input
    amax that clip the largest activations."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(*shape, device=dev, generator=g)
    w = ((torch.rand(8, c, c, 3, 3, device=dev, generator=g) * 2 - 1) *
         1.7 / (3 * c ** 0.5))
    b = torch.rand(8, c, device=dev, generator=g) * 2 - 1
    amax = [2.5 + 0.5 * i for i in range(8)]
    q = TI8.pack_chain_weights_int8([(w[i], b[i]) for i in range(8)], amax)
    return x.bfloat16(), (q['wq'], q['wscale'], q['b'], q['ascales'])


def _check(x, args):
    """The kernel equals the plain version in both modes, each wrapper
    call counts one launch, and the two modes differ (else the check could
    not tell them apart)."""
    outs = []
    for round_handoffs in (False, True):
        launches = TI8.int8_chain.launches
        out = TI8.int8_chain(x, *args, round_handoffs=round_handoffs)
        assert TI8.int8_chain.launches == launches + 1
        ref = TI8.int8_chain_plain(x, *args, round_handoffs=round_handoffs)
        torch.cuda.synchronize()
        assert out.shape == x.shape and out.dtype == torch.bfloat16
        assert torch.isfinite(out.float()).all()
        assert torch.equal(out, ref)
        outs.append(out)
    assert not torch.equal(*outs)


@pytest.mark.cuda
@pytest.mark.parametrize('c', [8, 16, 32, 48, 64])
def test_int8_chain_kernel_matches_plain(dev, c):
    """(3, 24, 20, C): W = 20 leaves half a tile at the right edge. C = 8
    and 48 pad the input channels with zeros to 32 and 64; the wrapper
    refuses f32 input."""
    x, args = _operands(dev, (3, 24, 20, c), 33 + c)
    _check(x, args)
    with pytest.raises(ValueError, match='bf16'):
        TI8.int8_chain(x.float(), *args)


@pytest.mark.cuda
@pytest.mark.parametrize('bsz', [1, 32])
def test_int8_chain_at_the_w32_shape(dev, bsz):
    """(B, 64, 48, 32), W32 branch 0: one image (most warps get no tile)
    and 32 (at most one tile a warp)."""
    _check(*_operands(dev, (bsz, 64, 48, 32), 40 + bsz))


@pytest.mark.cuda
def test_int8_chain_ragged_images(dev):
    """H and W not multiples of 8: the last tiles' rows and columns lie
    outside the image (zero-filled halos, masked stores), at widths whose
    pixel rows take 8-byte and 16-byte copies; more tiles than warps at
    (40, 36, 44, 48) (1200 tiles for 132 blocks of 8 warps), so the blocks
    form teams and warps refill their rings."""
    for shape in ((2, 13, 11, 24), (1, 10, 20, 64), (40, 36, 44, 48)):
        _check(*_operands(dev, shape, 50 + shape[-1]))


@pytest.mark.cuda
def test_int8_chain_wide(dev):
    """Widths above 64 split the output channels over two grid rows; 72
    leaves the second row one n8 tile of real channels."""
    for c in (72, 128):
        _check(*_operands(dev, (2, 16, 12, c), 60 + c))


@pytest.mark.cuda
def test_int8_chain_refuses(dev):
    """Non-bf16 input, widths the kernel is not compiled for and tensors
    off the card raise before any launch, and the counter does not move."""
    x, args = _operands(dev, (1, 8, 8, 16), 70)
    launches = TI8.int8_chain.launches
    with pytest.raises(ValueError, match='bf16'):
        TI8.int8_chain(x.half(), *args)
    with pytest.raises(ValueError, match='one CUDA device'):
        TI8.int8_chain(x, *(t.cpu() for t in args))
    for c in (12, 136):
        z = torch.zeros(1, 8, 8, c, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match='multiple of 8 up to'):
            TI8.int8_chain(z, torch.zeros(8, 3, 3, c, c, device=dev,
                                          dtype=torch.int8),
                           torch.ones(8, c, device=dev),
                           torch.zeros(8, c, device=dev),
                           torch.ones(8, device=dev))
    assert TI8.int8_chain.launches == launches


@pytest.mark.cuda
def test_int8_chain_takes_exactly_what_launches(dev):
    """``takes(c)`` holds exactly where a launch succeeds, for every width
    a multiple of 4 up to 136."""
    for c in range(4, 137, 4):
        z = torch.zeros(1, 8, 8, c, device=dev, dtype=torch.bfloat16)
        args = (torch.zeros(8, 3, 3, c, c, device=dev, dtype=torch.int8),
                torch.ones(8, c, device=dev), torch.zeros(8, c, device=dev),
                torch.ones(8, device=dev))
        try:
            out = TI8.int8_chain(z, *args)
            torch.cuda.synchronize()
            launched = bool(torch.equal(out, TI8.int8_chain_plain(z, *args)))
        except ValueError:
            launched = False
        assert launched == TI8.takes(c), c
