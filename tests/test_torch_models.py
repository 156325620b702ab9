"""The port's HRNet, BN folding and checkpoint loading against the JAX
package, on the CPU, in f32 (house tolerance 2e-4).

HRNet runs at c=8 on 64x64 inputs: the input side must be a multiple of
32 so the /32 branch upsamples back onto the /4 grid (64x48 would leave
a 1.5-pixel branch). Weights are carried across with
``convert.from_jax_params``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.models import convert as JC
from simple_hrnet_tpu.models import hrnet as JH
from simple_hrnet_tpu.models import layers as JL

from simple_hrnet_tpu_torch.models import convert as TC
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.models import layers as TL
from simple_hrnet_tpu_torch.ops.cuda import fuse_up, fused_block
from simple_hrnet_tpu_torch.utils import checkpoint as ckpt

TOL = 2e-4


def _randomize_bn(tree, rng):
    """Non-trivial BN statistics so every converter mapping matters."""
    if 'mean' in tree and 'kernel' not in tree:
        shape = np.asarray(tree['scale']).shape
        return {'scale': rng.uniform(0.5, 1.5, shape).astype(np.float32),
                'bias': rng.uniform(-0.2, 0.2, shape).astype(np.float32),
                'mean': rng.uniform(-0.5, 0.5, shape).astype(np.float32),
                'var': rng.uniform(0.5, 2.0, shape).astype(np.float32)}
    return {k: _randomize_bn(v, rng) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


@pytest.fixture(scope='module')
def w8():
    rng = np.random.default_rng(0)
    tree = _randomize_bn(JH.init(jax.random.PRNGKey(0), c=8, nof_joints=17),
                         rng)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(JH.apply)(JL.fold_batch_norm(tree), x))
    return tree, x, ref


def _port(tree, kernels=True):
    model = TC.load_into(TH.HRNet(8, 17), TC.from_jax_params(tree))
    return TH.prepare_inference(model, torch.float32, kernels=kernels)


@pytest.mark.parametrize('kernels', [True, False])
def test_hrnet_matches_jax(w8, kernels):
    """Folded forward, through the kernel wrappers' plain versions
    (kernels=True: 8 chain + 8 fuse_up calls) or the plain modules."""
    tree, x, ref = w8
    model = _port(tree, kernels)
    chain0, fuse0 = fused_block.basic_chain.launches, fuse_up.fuse_up.launches
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 17)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    # CPU tensors never count as kernel launches
    assert fused_block.basic_chain.launches == chain0
    assert fuse_up.fuse_up.launches == fuse0
    assert (all(m.chain is not None for m in model.stage_modules())
            == kernels)


def test_unfolded_hrnet_matches_jax(w8):
    tree, x, _ = w8
    model = TC.load_into(TH.HRNet(8, 17), TC.from_jax_params(tree)).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(JH.apply)(tree, x))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_hrnet_bf16_close_to_f32(w8):
    """bf16 runs (CPU, plain kernel versions) stay near the f32 result:
    within 5% of the heatmap range after ~70 bf16 roundings."""
    tree, x, ref = w8
    model = TC.load_into(TH.HRNet(8, 17), TC.from_jax_params(tree))
    TH.prepare_inference(model, torch.bfloat16)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32  # the head runs in f32
    err = np.abs(out.numpy() - ref).max()
    assert err < 0.05 * np.abs(ref).max()


def test_pth_through_both_loaders(tmp_path):
    """A port-initialized .pth (official names) -> the JAX loader and the
    port's loader -> same heatmaps; wrapped/prefixed variants load too."""
    model = TH.init(8, 17, seed=3)
    sd = model.state_dict()
    path = str(tmp_path / 'pose_hrnet_w8.pth')
    torch.save(sd, path)
    wrapped = str(tmp_path / 'harness.pth')
    torch.save({'model': {f'module.{k}': v for k, v in sd.items()},
                'epoch': 3}, wrapped)

    x = np.random.default_rng(4).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(JH.apply)(
        JL.fold_batch_norm(JC.load_pth(path)), x))
    for p in (path, wrapped):
        port = TH.prepare_inference(
            TC.load_into(TH.HRNet(8, 17), ckpt.load(p)))
        with torch.no_grad():
            out = port(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_from_jax_params_inverts_state_dict_to_tree():
    sd = TH.init(8, 17, seed=5).state_dict()
    back = TC.from_jax_params(JC.state_dict_to_tree(sd))
    expect = {k: v for k, v in sd.items()
              if not k.endswith('num_batches_tracked')}
    assert set(back) == set(expect)
    for k, v in expect.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())


def test_load_into_rejects_mismatched_checkpoint():
    sd = TH.init(8, 17, seed=6).state_dict()
    with pytest.raises(RuntimeError, match='size mismatch'):
        TC.load_into(TH.HRNet(16, 17), sd)
    sd.pop('final_layer.bias')
    with pytest.raises(ValueError):
        TC.load_into(TH.HRNet(8, 17), sd)


def test_fold_batch_norm_matches_jax_folding(w8):
    """The port's folding arithmetic gives the JAX package's folded
    kernels and biases."""
    tree = w8[0]
    model = TC.load_into(TH.HRNet(8, 17), TC.from_jax_params(tree))
    TL.fold_batch_norm(model)
    folded = JL.fold_batch_norm(tree)
    got = TC.from_jax_params(folded)
    sd = model.state_dict()
    for k, v in got.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in model.modules())
