"""The port's HRNet at every width the JAX package serves, and B3's plain
version at the widths its kernel takes, on the CPU.

The JAX facade takes any ``c``: it runs its kernels only where its lane
rule holds and XLA convs elsewhere. The port packs a chain or a fusion
only where a kernel takes the widths (each wrapper's ``takes``), decided
from the widths and the compute type alone, so these CPU tests see what a
card runs: HRNet(4) packs nothing and matches the JAX package's
``hrnet.apply`` at the house tolerance 2e-4 in f32; bf16 HRNet(8) packs
the fusion (K3) but no chain (K2's bf16 widths are 16-64). B3's plain
version is held against the Pallas ``chain_pallas_grouped_wino`` (G = 1,
interpreted) at C = 32 and 64 with the tolerances of
tests/test_torch_winograd.py: f32 1e-4, bf16 2^-6 of max. The card tests
are tests/test_torch_cuda.py and tests/test_torch_cuda_wino.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.models import hrnet as JH
from simple_hrnet_tpu.models import layers as JL
from simple_hrnet_tpu.ops.pallas import fused_block as JB
from simple_hrnet_tpu.ops.pallas import winograd_chain as JW

from simple_hrnet_tpu_torch.models import convert as TC
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.ops.cuda import fuse_up as TF
from simple_hrnet_tpu_torch.ops.cuda import fused_block as TB
from simple_hrnet_tpu_torch.ops.cuda import winograd_chain as TW

from test_torch_kernels import _randomized_blocks
from test_torch_models import _randomize_bn

TOL = 2e-4


def _packed(c, dtype, n_branches=4):
    m = TH.StageModule(n_branches, n_branches, c).eval()
    TH.L.fold_batch_norm(m)
    m.pack(dtype)
    return m


def test_hrnet_c4_packs_no_kernel_and_matches_jax():
    rng = np.random.default_rng(90)
    tree = _randomize_bn(JH.init(jax.random.PRNGKey(90), c=4,
                                 nof_joints=17), rng)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(JH.apply)(JL.fold_batch_norm(tree), x))
    model = TH.prepare_inference(
        TC.load_into(TH.HRNet(4, 17), TC.from_jax_params(tree)))
    assert all(m.chain is None and m.chain_int8 is None and m.fuse is None
               for m in model.stage_modules())
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 17)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_hrnet_c8_bf16_packs_the_fuse_but_no_chain():
    model = TH.prepare_inference(TH.init(8, 17, seed=91), torch.bfloat16)
    mods = model.stage_modules()
    assert all(m.chain is None and m.chain_int8 is None for m in mods)
    assert all((m.fuse is not None) == (m.n_branches > 1) for m in mods)
    fuse0 = TF.fuse_up.launches
    x = torch.from_numpy(np.random.default_rng(91).standard_normal(
        (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        out = model(x)
    assert out.shape == (1, 16, 16, 17) and torch.isfinite(out).all()
    assert TF.fuse_up.launches == fuse0  # CPU: the plain version


@pytest.mark.parametrize('c,dtype,wino', [(8, torch.float32, False),
                                          (32, torch.bfloat16, True),
                                          (48, torch.bfloat16, False)])
def test_published_widths_pack_as_before(c, dtype, wino):
    """A stage-4 module (3 fusion sources) packs its chain for K2, with
    Winograd weights for B3 where the JAX package runs Winograd, and its
    fusion for K3; each kernel's predicate agrees."""
    m = _packed(c, dtype)
    w, b, ww = m.chain
    assert w.dtype == dtype and tuple(w.shape) == (8, 3, 3, c, c)
    assert (ww is not None) == wino == TW.takes(c) and \
        TB.takes(c, dtype) and m.chain_int8 is None
    weights, bias_sum = m.fuse
    assert [tuple(x.shape) for x in weights] == [(c * f, c)
                                                for f in (2, 4, 8)]
    assert TF.takes(c, [c * f for f in (2, 4, 8)], [2, 4, 8], dtype)


@pytest.mark.parametrize('c', TW.WINO_WIDTHS)
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -6)])
def test_wino_plain_matches_pallas_wino_at_kernel_widths(c, dtype, tol):
    rng = np.random.default_rng(92 + c)
    blocks = _randomized_blocks(rng, c)
    wts, bias = JB.pack_chain_weights(blocks, jnp.float32, group=1)
    convs = []
    for bp in blocks:
        for k in ('conv1', 'conv2'):
            convs.append((torch.from_numpy(np.transpose(
                np.asarray(bp[k]['kernel']), (3, 2, 0, 1)).copy()),
                torch.from_numpy(np.array(bp[k]['bias']))))
    w, b = TB.pack_chain_weights(convs, torch.float32)
    x = rng.standard_normal((1, 8, 8, c)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x, jdt)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(JW.chain_pallas_grouped_wino(
            xj, JW.pack_winograd_weights(wts, jnp.float32), bias
        ).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(dtype)
    out = TW.wino_chain(xt, TW.pack_winograd_weights(w, dtype), b)
    assert out.dtype == dtype and out.shape == xt.shape
    out = out.float().numpy()
    assert np.abs(out - ref).max() <= tol * max(1.0, np.abs(ref).max())
