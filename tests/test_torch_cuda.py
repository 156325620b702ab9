"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``; skips on a host without a CUDA device. Imports neither
JAX nor the JAX package, so it runs on a GPU host without JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.) Tolerances: the chain
and the fuse (at a ragged 24 x 16 base; the W48 and W32 stage shapes are
in tests/test_torch_cuda_fuse.py) 1e-4 of max in f32 with TF32 off
(summation order only), 2^-6 of max in bf16 (chip_smoke.py's limit); the
int8 conv bit for bit (exact int32 cores and the same IEEE f32 epilogue
as its CPU path). The Winograd chain's card tests are in
tests/test_torch_cuda_wino.py, the int8 chain's in
tests/test_torch_cuda_int8.py, NMS's in tests/test_torch_cuda_nms.py.
HRNet at widths the chain kernels do not take runs its plain modules
there: 1e-4 of max in f32 (the same modules), 2^-5 of max in bf16 (the
fuse kernel rounds once where the plain fusion rounds at every conv and
add, over ~90 layers).
"""

import pytest
import torch

from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.ops import int8 as T8
from simple_hrnet_tpu_torch.ops.cuda import fuse_up as TF
from simple_hrnet_tpu_torch.ops.cuda import fused_block as TB
from simple_hrnet_tpu_torch.ops.cuda import int8_chain as TI8
from simple_hrnet_tpu_torch.ops.cuda import winograd_chain as TW


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


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
def test_fuse_kernel_rejects_width_not_multiple_of_8(dev):
    base = torch.zeros(1, 16, 16, 12, device=dev, dtype=torch.bfloat16)
    ys = [torch.zeros(1, 8, 8, 24, device=dev, dtype=torch.bfloat16)]
    ws = [torch.zeros(24, 12, device=dev, dtype=torch.bfloat16)]
    with pytest.raises(ValueError, match='multiple of 8'):
        TF.fuse_up(base, ys, ws, torch.zeros(12, device=dev))


@pytest.mark.cuda
def test_chain_kernel_rejects_width_not_multiple_of_8(dev):
    x = torch.zeros(1, 8, 8, 12, device=dev)
    with pytest.raises(ValueError, match='multiple of 8'):
        TB.basic_chain(x, torch.zeros(8, 3, 3, 12, 12, device=dev),
                       torch.zeros(8, 12, device=dev))


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


@pytest.mark.cuda
def test_fuse_smem_rule_matches_the_kernel(dev):
    """fuse_up.takes decides on the host's copy of the kernel's shared-
    memory layout; it must give the kernel's own numbers."""
    for c in (8, 16, 32, 48, 64):
        for n in (1, 2, 3):
            widths = tuple(c * 2 ** j for j in range(1, n + 1))
            factors = tuple(2 ** j for j in range(1, n + 1))
            for dtype in (torch.float32, torch.bfloat16):
                assert TF.smem_bytes(c, widths, factors, dtype) == \
                    TF.lib_smem_bytes(c, widths, factors, dtype)


@pytest.mark.cuda
def test_hrnet_widths_without_chain_kernels_run_on_cuda(dev):
    """HRNet(4) in f32 (no kernel takes C = 4: no chain, no fuse packed)
    and HRNet(8) in bf16 (K2's bf16 path does not take C = 8: no chain;
    the fuse runs on K3) forward on CUDA tensors and match the plain
    modules."""
    chains = (TB.basic_chain, TW.wino_chain, TI8.int8_chain)
    for c, dtype, tol in ((4, torch.float32, 1e-4),
                          (8, torch.bfloat16, 2.0 ** -5)):
        x = torch.randn(2, 64, 64, 3, generator=torch.Generator()
                        .manual_seed(36)).to(dev)
        outs = []
        for kernels in (True, False):
            model = TH.prepare_inference(TH.init(c, 17, seed=0).to(dev),
                                         dtype, kernels=kernels)
            assert all(m.chain is None and m.chain_int8 is None
                       for m in model.stage_modules())
            chain0 = [k.launches for k in chains]
            fuse0 = TF.fuse_up.launches
            with torch.no_grad():
                outs.append(model(x).float())
            assert [k.launches for k in chains] == chain0
            assert TF.fuse_up.launches - fuse0 == (8 if kernels and c == 8
                                                   else 0)
        torch.cuda.synchronize()
        out, ref = outs
        assert out.shape == (2, 16, 16, 17) and torch.isfinite(out).all()
        assert (out - ref).abs().max() <= tol * max(1.0, ref.abs().max())
