"""The port's engines (``utils/export.py``) on a card: exported there,
reloaded, launching the kernels from the exported program.

Marked ``cuda``; skips on a host without a CUDA device. Imports neither
JAX nor the JAX package:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_export.py

Tolerance: f32 heatmaps within 1e-3 of max (``chip_smoke.py`` phase 3's
limit, summation order through ~100 layers), in true f32.
"""

import numpy as np
import pytest
import torch

from simple_hrnet_tpu_torch import SimpleHRNet
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.models.convert import load_into
from simple_hrnet_tpu_torch.ops.cuda import fuse_up as TF
from simple_hrnet_tpu_torch.ops.cuda import fused_block as TB
from simple_hrnet_tpu_torch.ops.cuda import int8_chain as TI8
from simple_hrnet_tpu_torch.ops.cuda import winograd_chain as TW
from simple_hrnet_tpu_torch.utils import checkpoint as ckpt
from simple_hrnet_tpu_torch.utils import export as TE
from simple_hrnet_tpu_torch.utils.dispatch import strict_dispatch

RES = (64, 64)
BATCH = 4
COUNTERS = {'basic_chain': TB.basic_chain, 'wino_chain': TW.wino_chain,
            'int8_chain': TI8.int8_chain, 'fuse_up': TF.fuse_up}


@pytest.fixture(scope='module')
def engines(tmp_path_factory):
    """A W16 checkpoint and its engines: f32 fused on the card and on the
    CPU, int8 fused on the card; and a W32 bf16 fused engine on the card,
    the width whose bf16 chain is the Winograd kernel (branch 0 is 16x16,
    H even)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    d = tmp_path_factory.mktemp('engines')
    pth = str(d / 'w16.pth')
    torch.save(TH.init(16, 17, seed=0).state_dict(), pth)
    pth32 = str(d / 'w32.pth')
    torch.save(TH.init(32, 17, seed=0).state_dict(), pth32)
    kw = dict(c=16, resolution=RES, batch_size=BATCH, fused=True)
    return {'pth': pth,
            'cuda': TE.export_engine(str(d / 'cuda.torchpose'), pth,
                                     device='cuda', **kw),
            'cpu': TE.export_engine(str(d / 'cpu.torchpose'), pth,
                                    device='cpu', **kw),
            'int8': TE.export_engine(str(d / 'int8.torchpose'), pth,
                                     device='cuda', int8=True, **kw),
            'w32_bf16': TE.export_engine(str(d / 'w32_bf16.torchpose'),
                                         pth32, device='cuda',
                                         **dict(kw, c=32, half=True))}


def _x(seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (BATCH, *RES, 3)).astype(np.float32))


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.cuda
def test_card_engine_reloads_and_matches_eager(engines):
    eng = TE.Engine(engines['cuda'])
    assert eng.device.type == 'cuda' and eng.meta['device'] == 'cuda'
    x = _x().cuda()
    out = eng(x)
    model = TH.prepare_inference(load_into(TH.HRNet(16, 17), ckpt.load(
        engines['pth'])).cuda(), torch.float32)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            ref = model(x)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    assert out.shape == (BATCH, 16, 16, 17) and torch.isfinite(out).all()
    assert _rel(out, ref) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize('name, chain', [('cuda', 'basic_chain'),
                                         ('int8', 'int8_chain'),
                                         ('w32_bf16', 'wino_chain')])
def test_exported_program_counts_launches(engines, name, chain):
    """Every stage module's chain and fuse run from the exported graph: 8
    launches each per engine call, no other chain."""
    eng = TE.Engine(engines[name])
    x = _x(1).cuda()
    eng(x)
    torch.cuda.synchronize()
    for f in COUNTERS.values():
        f.launches = 0
    out = eng(x)
    torch.cuda.synchronize()
    got = {k: f.launches for k, f in COUNTERS.items()}
    assert got == {k: 8 if k in (chain, 'fuse_up') else 0 for k in COUNTERS}
    assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_cross_device_load_raises(engines):
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        TE.Engine(engines['cuda'], device='cpu')
    with pytest.raises(ValueError, match="exported for 'cpu'"):
        TE.Engine(engines['cpu'], device='cuda')


@pytest.mark.cuda
def test_cpu_engine_agrees_with_card_engine(engines):
    x = _x(2)
    card = TE.Engine(engines['cuda'])(x.cuda()).cpu()
    host = TE.Engine(engines['cpu'], device='cpu')(x)
    assert _rel(card, host) <= 1e-3


@pytest.mark.cuda
def test_facade_engine_stream_dispatch(engines):
    """The facade on the card engine: a chunked stream after ``warmup``
    runs every dispatch without a stream synchronization."""
    model = SimpleHRNet(16, 17, engines['cuda'], resolution=RES,
                        enable_tensorrt=True, yolo_model_def='yolov3-tiny',
                        max_batch_size=BATCH, device='cuda')
    frames = list(np.random.default_rng(3).integers(
        0, 256, (4, 96, 128, 3)).astype(np.uint8))
    model.warmup((96, 128), stream_max_people=2, stream_batch_frames=(2,))
    with strict_dispatch(model):
        out = list(model.predict_stream(frames, max_people=2,
                                        batch_frames=2))
    assert len(out) == 4 and all(o.shape[1:] == (17, 3) for o in out)
