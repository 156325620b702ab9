"""K3 (the high-res fuse kernel) against its plain version at the stage
shapes of HRNet-W48 384x288 and HRNet-W32 256x192, on a card.

Marked ``cuda``; skips on a host without a CUDA device. Imports neither
JAX nor the JAX package, so it runs on a GPU host without JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_fuse.py

Tolerances as in tests/test_torch_cuda.py: 1e-4 of max in f32 with TF32
off (summation order only), 2^-6 of max in bf16 (chip_smoke.py's limit).
"""

import numpy as np
import pytest
import torch

from simple_hrnet_tpu_torch.ops.cuda import fuse_up as TF


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('n_src', [1, 2, 3])
@pytest.mark.parametrize('h,w,c', [(96, 72, 48), (64, 48, 32)],
                         ids=['w48', 'w32'])
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -6)])
def test_fuse_kernel_matches_plain_at_stage_shapes(dev, dtype, tol, h, w, c,
                                                   n_src):
    """K3 at the high-res branch shapes of HRNet-W48 384x288 and HRNet-W32
    256x192, with the sources of stage 2 (1), 3 (2) and 4 (3)."""
    g = torch.Generator(device=dev).manual_seed(35)
    base = torch.randn(3, h, w, c, device=dev, generator=g).to(dtype)
    fs = [2 ** j for j in range(1, n_src + 1)]
    ys = [torch.randn(3, h // f, w // f, c * f, device=dev,
                      generator=g).to(dtype) for f in fs]
    ws = [((torch.rand(c * f, c, device=dev, generator=g) * 2 - 1) /
           np.sqrt(c * f)).to(dtype) for f in fs]
    bs = torch.rand(c, device=dev, generator=g) * 2 - 1
    launches = TF.fuse_up.launches
    out = TF.fuse_up(base, ys, ws, bs).float()
    assert TF.fuse_up.launches == launches + 1
    ref = TF.fuse_up_plain(base, ys, ws, bs).float()
    assert (out - ref).abs().max() <= tol * max(1.0, ref.abs().max())
    torch.cuda.synchronize()
