"""The port's engines (``utils/export.py``, ``.torchpose``) against the JAX
package's (``.jaxpose``), on the CPU, from the same ``.npz`` checkpoints.

Tolerances: f32 heatmaps 2e-4 (the house tolerance), decoded keypoint
positions 1e-4 px. A ``fused=True`` engine must hold the chain and fuse
custom ops in its exported graph, a ``fused=False`` one none; a W32 bf16
one the Winograd chain op, with heatmaps equal to the eager model's. The
int8 engine is in ``test_torch_export_int8.py``.
"""

import numpy as np
import pytest

import jax
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu import SimpleHRNet as JaxSimpleHRNet
from simple_hrnet_tpu.models import convert as JC
from simple_hrnet_tpu.utils import checkpoint as jckpt
from simple_hrnet_tpu.utils import export as JE

from simple_hrnet_tpu_torch import SimpleHRNet
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.models import poseresnet as TP
from simple_hrnet_tpu_torch.models.convert import load_into
from simple_hrnet_tpu_torch.utils import checkpoint as TCkpt
from simple_hrnet_tpu_torch.utils import export as TE

from test_torch_api import _TwoProcessMesh

RES = (64, 64)


def _jax_npz(path, net):
    """``net``'s weights written by the JAX package's ``ckpt.save``."""
    jckpt.save(path, JC.state_dict_to_tree(net.state_dict()))
    return path


@pytest.fixture(scope='module')
def npz(tmp_path_factory):
    d = tmp_path_factory.mktemp('engines')
    return {'dir': d,
            'p18': _jax_npz(str(d / 'p18.npz'), TP.PoseResNet(18, 17)),
            'w16': _jax_npz(str(d / 'w16.npz'), TH.init(16, 17, seed=0)),
            'w8': _jax_npz(str(d / 'w8.npz'), TH.init(8, 17, seed=1))}


@pytest.fixture(scope='module')
def w8_engines(npz):
    """The W8 64x64 batch-1 ``fused=False`` engines of both packages
    (test_utils.py:173's, at a width the port's f32 chain kernel takes)."""
    d = npz['dir']
    return (JE.export_engine(str(d / 'w8.jaxpose'), npz['w8'], c=8,
                             resolution=RES, batch_size=1),
            TE.export_engine(str(d / 'w8.torchpose'), npz['w8'], c=8,
                             resolution=RES, batch_size=1, device='cpu'))


def _both(npz, name, c, batch, **kw):
    """The JAX engine and the port's (on the CPU) of one checkpoint."""
    d = npz['dir']
    jax_path = JE.export_engine(str(d / f'{name}.jaxpose'), npz[name], c=c,
                                resolution=RES, batch_size=batch, **kw)
    port_path = TE.export_engine(str(d / f'{name}.torchpose'), npz[name],
                                 c=c, resolution=RES, batch_size=batch,
                                 device='cpu', **kw)
    return JE.Engine(jax_path), TE.Engine(port_path, device='cpu')


def _ops(engine):
    return sorted({str(n.target) for n in engine.program.graph.nodes
                   if str(n.target).startswith('sht.')})


def test_poseresnet18_engine_matches_jax(npz):
    """test_utils.py:70's engine (PoseResNet-18, 64x64, batch 2)."""
    jeng, teng = _both(npz, 'p18', 18, 2, model_name='PoseResNet')
    assert teng.batch_size == 2 and teng.resolution == RES
    assert teng.meta == dict(jeng.meta, device='cpu')
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    out = teng(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 16, 16, 17) and _ops(teng) == []
    np.testing.assert_allclose(out, np.asarray(jeng(x)), atol=2e-4,
                               rtol=2e-4)


def test_fused_engine_holds_the_kernel_ops(npz):
    """A W16 ``fused=True`` engine: its exported graph calls the chain and
    fuse custom ops, 8 each, and its heatmaps are the JAX fused engine's."""
    jeng, teng = _both(npz, 'w16', 16, 2, fused=True)
    targets = [str(n.target) for n in teng.program.graph.nodes]
    assert targets.count('sht.basic_chain.default') == 8
    assert targets.count('sht.fuse_up.default') == 8
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    np.testing.assert_allclose(teng(torch.from_numpy(x)).numpy(),
                               np.asarray(jeng(x)), atol=2e-4, rtol=2e-4)


def test_w32_bf16_engine_holds_the_winograd_chain(tmp_path):
    """A W32 bf16 ``fused=True`` engine, the width at which the bf16 chain
    is the Winograd op (branch 0 16x16 at 64x64, H even): its graph calls
    ``sht::wino_chain`` and the fuse 8 times each and never the basic
    chain, and its heatmaps equal the port's eager bf16 model's bit for
    bit (both run the ops' plain versions on the CPU)."""
    pth = str(tmp_path / 'w32.pth')
    torch.save(TH.init(32, 17, seed=2).state_dict(), pth)
    eng = TE.Engine(TE.export_engine(
        str(tmp_path / 'w32_bf16.torchpose'), pth, c=32, resolution=RES,
        batch_size=2, half=True, fused=True, device='cpu'), device='cpu')
    targets = [str(n.target) for n in eng.program.graph.nodes]
    assert targets.count('sht.wino_chain.default') == 8
    assert targets.count('sht.fuse_up.default') == 8
    assert 'sht.basic_chain.default' not in targets
    model = TH.prepare_inference(load_into(TH.HRNet(32, 17),
                                           TCkpt.load(pth)), torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, *RES, 3)).astype(np.float32))
    with torch.no_grad():
        want = model(x)
    got = eng(x)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 17)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_facade_engine_matches_jax_facade(npz, w8_engines):
    """test_utils.py:173: ``SimpleHRNet(enable_tensorrt=True)``
    single-person on a batch-1 engine against the JAX facade on its
    ``.jaxpose``, and against the port's facade on the checkpoint; a
    ``fused=False`` engine holds no kernel op."""
    jpath, tpath = w8_engines
    kw = dict(multiperson=False, resolution=RES, return_heatmaps=True)
    frame = np.random.default_rng(3).integers(0, 256, (64, 64, 3)).astype(
        np.uint8)
    port = SimpleHRNet(8, 17, tpath, enable_tensorrt=True, device='cpu',
                       **kw)
    assert port.engine is not None and _ops(port.engine) == []
    hm, pts = port.predict(frame)
    rhm, rpts = JaxSimpleHRNet(8, 17, jpath, enable_tensorrt=True,
                               **kw).predict(frame)
    np.testing.assert_allclose(hm, rhm, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(pts[..., :2], rpts[..., :2], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(pts[..., 2], rpts[..., 2], atol=2e-4)
    live = SimpleHRNet(8, 17, npz['w8'], device='cpu', **kw).predict(frame)
    np.testing.assert_allclose(hm, live[0], atol=2e-4, rtol=2e-4)


def test_batches_are_padded_to_the_engine_batch(npz):
    """Any batch through a batch-2 engine: zero-padded and chunked, the
    first n heatmaps returned (Engine.apply, the facade's pose model);
    a stack of 3 frames through the facade gives the live facade's."""
    path = TE.export_engine(str(npz['dir'] / 'p18b2.torchpose'), npz['p18'],
                            c=18, model_name='PoseResNet', resolution=RES,
                            batch_size=2, device='cpu')
    eng = TE.Engine(path, device='cpu')
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (5, 64, 64, 3)).astype(np.float32))
    whole = torch.cat([eng(x[0:2]), eng(x[2:4]),
                       eng(torch.cat([x[4:], torch.zeros_like(x[4:])]))])
    for n in (1, 2, 3, 5):
        torch.testing.assert_close(eng.apply(x[:n]), whole[:n], rtol=0,
                                   atol=0)
    frames = np.random.default_rng(5).integers(0, 256, (3, 64, 64, 3)) \
        .astype(np.uint8)
    kw = dict(model_name='PoseResNet', multiperson=False, resolution=RES,
              device='cpu')
    out = SimpleHRNet(18, 17, path, **kw).predict(frames)
    live = SimpleHRNet(18, 17, npz['p18'], **kw).predict(frames)
    assert out.shape == live.shape == (3, 1, 17, 3)
    np.testing.assert_allclose(out, live, atol=2e-4, rtol=2e-4)


def test_engine_errors(npz, w8_engines):
    """The JAX facade's resolution and ``int8_exclude`` errors; a
    ``.jaxpose`` (by name or by content) and ``int8_exclude`` without int8
    raise ``ValueError``; so does a mesh that spans several processes."""
    jpath, path = w8_engines
    kw = dict(multiperson=False, device='cpu', enable_tensorrt=True)
    with pytest.raises(ValueError, match=r'engine resolution \(64, 64\) != '
                                         r'requested \(128, 96\)'):
        SimpleHRNet(8, 17, path, resolution=(128, 96), **kw)
    with pytest.raises(ValueError, match='int8_exclude has no effect'):
        SimpleHRNet(8, 17, path, resolution=RES, dtype='int8',
                    int8_exclude=('stage4',), **kw)
    with pytest.raises(ValueError, match='from one process'):
        SimpleHRNet(8, 17, path, resolution=RES, mesh=_TwoProcessMesh(),
                    **kw)
    renamed = str(npz['dir'] / 'w8_jax.torchpose')
    with open(jpath, 'rb') as src, open(renamed, 'wb') as dst:
        dst.write(src.read())
    for p in (jpath, renamed):
        with pytest.raises(ValueError, match='JAX StableHLO engine.*'
                           'simple_hrnet_tpu_torch.cli.export'):
            SimpleHRNet(8, 17, p, resolution=RES, **kw)
    with pytest.raises(ValueError, match='int8_exclude only applies'):
        TE.export_engine(str(npz['dir'] / 'x.torchpose'), npz['w8'], c=8,
                         int8_exclude=('stage4',), device='cpu')
