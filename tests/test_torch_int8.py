"""The port's int8 stack against the JAX package, on the CPU: the int8
chain (B4), the quantized conv outside it, calibration and quantization.

Tolerances, with their reasons:
  * packing (int8 weights, weight and activation scales, biases) and the
    quantized convs' operands: bitwise, given the same f32 weights and amax;
  * ``int8_chain_plain`` against the Pallas ``chain_pallas_int8_grouped``
    (G = 1, interpreted): bitwise in bf16, 1e-6 of max in f32 (the int32
    cores are exact; only the f32 epilogue's rounding may differ by an
    ulp); against the XLA ``blockdiag_chain_int8_grouped`` in f32 (where
    its cast points coincide with the kernel's): the same;
  * ``QConv2d`` against the jitted JAX ``layers.conv2d`` int8 branch:
    bitwise (exact int32 cores, the same f32 epilogue: one fused
    multiply-add, as XLA's CPU lowering contracts the dequantize and the
    bias);
  * calibration amax: 1e-5 relative (the two packages' f32 convs sum in
    different orders).
The CUDA kernel is held against the plain version on a card by
tests/test_torch_cuda.py and chip_smoke.py.
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
from simple_hrnet_tpu.models import quantize as JQ
from simple_hrnet_tpu.ops.pallas import fused_block as JB

from simple_hrnet_tpu_torch.models import convert as TC
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.models import layers as TL
from simple_hrnet_tpu_torch.models import quantize as TQ
from simple_hrnet_tpu_torch.ops.cuda import int8_chain as TI8

from test_torch_kernels import _randomized_blocks


@pytest.fixture(scope='module')
def chain_q():
    """4 folded BasicBlocks at C=16, their per-conv input amax from the f32
    chain (as tests/test_quantize.py calibrates), and both packings."""
    rng = np.random.default_rng(50)
    blocks = _randomized_blocks(rng, 16)
    x = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
    amax, convs, amax_list = {}, [], []
    v = jnp.asarray(x)
    for bp in blocks:
        res = v
        for j, ck in enumerate(('conv1', 'conv2')):
            amax[id(bp[ck])] = float(jnp.max(jnp.abs(v)))
            amax_list.append(amax[id(bp[ck])])
            convs.append((torch.from_numpy(np.transpose(
                np.asarray(bp[ck]['kernel']), (3, 2, 0, 1)).copy()),
                torch.from_numpy(np.array(bp[ck]['bias']))))
            v = JL.conv2d(v, bp[ck], stride=1, padding=1)
            v = jnp.maximum(v + (res if j == 1 else 0.0), 0.0)
    q = JB.pack_chain_weights_int8(blocks, amax, group=1)
    return x, q, TI8.pack_chain_weights_int8(convs, amax_list)


def test_pack_chain_weights_int8_bitwise(chain_q):
    _, q, tq = chain_q
    for k in ('wq', 'wscale', 'b', 'ascales'):
        assert tq[k].dtype == (torch.int8 if k == 'wq' else torch.float32)
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(q[k]))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_int8_chain_plain_matches_pallas_int8(chain_q, dtype):
    x, q, tq = chain_q
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x, jdt)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(JB.chain_pallas_int8_grouped(xj, q).astype(
            jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(dtype)
    out = TI8.int8_chain(xt, tq['wq'], tq['wscale'], tq['b'], tq['ascales'])
    assert out.dtype == dtype and out.shape == xt.shape
    out = out.float().numpy()
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(out, ref)
    else:
        assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()
        # in f32 the XLA chain's handoffs are the kernel's cast points
        xla = np.asarray(JB.blockdiag_chain_int8_grouped(
            xj, q, dtype=jnp.float32))
        assert np.abs(out - xla).max() <= 1e-6 * np.abs(xla).max()


def test_int8_chain_rejects_mismatched_operands(chain_q):
    _, _, tq = chain_q
    with pytest.raises(ValueError, match='do not match'):
        TI8.int8_chain(torch.zeros(1, 8, 8, 8), tq['wq'], tq['wscale'],
                       tq['b'], tq['ascales'])


@pytest.mark.parametrize('stride', [1, 2])
def test_qconv_matches_jax_int8_conv(stride):
    """The quantized conv (quantize, exact int32 core, f32 dequant + bias
    in one FMA, cast) against layers.conv2d's kernel_q branch, in f32 and
    bf16, bit for bit."""
    rng = np.random.default_rng(60 + stride)
    x = rng.standard_normal((2, 15, 13, 32)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 32, 48)) * 0.1).astype(np.float32)
    node = {'kernel': jnp.asarray(k),
            'bias': jnp.asarray(rng.standard_normal(48).astype(np.float32))}
    a = float(np.abs(x).max()) * 0.8  # some inputs clip
    qnode = JQ.quantize_folded({'c': node}, {id(node): a},
                               policy=lambda s: True)['c']
    conv = torch.nn.Conv2d(32, 48, 3, stride=stride, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.transpose(k, (3, 2, 0, 1))))
        conv.bias.copy_(torch.from_numpy(np.array(node['bias'])))
    model = torch.nn.Sequential(conv)
    TQ.quantize_folded(model, {'0': a})  # 3x3, 32 -> 48: in the policy
    q = model[0]
    assert isinstance(q, TL.QConv2d)
    np.testing.assert_array_equal(
        q.wq.numpy(), np.transpose(np.asarray(qnode['kernel_q']),
                                   (3, 0, 1, 2)).reshape(48, -1))
    np.testing.assert_array_equal(q.wscale.numpy(), np.asarray(
        qnode['wscale']))
    assert q.ascale.item() == float(qnode['ascale'])
    for jdt, tdt in ((None, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        # jitted, as the JAX facade runs it: XLA fuses the dequantize and
        # the bias add, and its CPU lowering contracts them into one FMA
        ref = np.asarray(jax.jit(lambda v, jdt=jdt: JL.conv2d(
            v, qnode, stride=stride, padding=1, dtype=jdt))(
                jnp.asarray(x, jdt or jnp.float32)).astype(jnp.float32))
        xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
        with torch.no_grad():
            out = q(xt)
        assert out.dtype == tdt
        out = out.permute(0, 2, 3, 1).float().numpy()
        np.testing.assert_array_equal(out, ref)


def _jax_tree(model: torch.nn.Module) -> dict:
    """The JAX-layout folded param tree of a folded port model (HWIO
    ``kernel`` + ``bias`` nodes under state_dict paths): both packages then
    hold the very same f32 weights."""
    tree: dict = {}
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            node = tree
            for part in name.split('.'):
                node = node.setdefault(part, {})
            node['kernel'] = np.transpose(m.weight.detach().numpy(),
                                          (2, 3, 1, 0)).copy()
            node['bias'] = m.bias.detach().numpy().copy()
    return tree


@pytest.fixture(scope='module')
def w16():
    model = TL.fold_batch_norm(TH.init(16, 17, seed=7))
    tree = _jax_tree(model)
    x = np.random.default_rng(70).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    jamax = JQ.calibrate(JH.apply, tree, [x])
    return model, tree, x, jamax


def test_calibration_matches_jax(w16):
    model, tree, x, jamax = w16
    amax = TQ.calibrate(model, [torch.from_numpy(x)])
    ref = TC.amax_from_jax(tree, jamax)
    assert set(amax) == set(ref) == set(TC.conv_node_paths(tree).values())
    assert 'stage4.2.branches.0.0.conv1' in amax
    for p, a in ref.items():
        assert abs(amax[p] - a) <= 1e-5 * a, p


def test_quantize_folded_matches_jax(w16):
    """With JAX's amax carried across, every quantized conv's int8 weights
    and scales equal JAX's quantize_folded output bit for bit, and the
    policy picks the same convs."""
    model, tree, _, jamax = w16
    jq = JQ.quantize_folded(tree, jamax)
    paths = TC.conv_node_paths(jq)
    amax = TC.amax_from_jax(tree, jamax)
    port = TL.fold_batch_norm(TH.init(16, 17, seed=7))
    TQ.quantize_folded(port, amax)
    mods = dict(port.named_modules())
    n_q = 0
    for node_id, path in paths.items():
        node = [n for n in _walk(jq) if id(n) == node_id][0]
        if 'kernel_q' not in node:
            assert not isinstance(mods[path], TL.QConv2d), path
            continue
        n_q += 1
        q = mods[path]
        assert isinstance(q, TL.QConv2d), path
        co = node['kernel_q'].shape[3]
        np.testing.assert_array_equal(q.wq.numpy(), np.transpose(
            np.asarray(node['kernel_q']), (3, 0, 1, 2)).reshape(co, -1))
        np.testing.assert_array_equal(q.wscale.numpy(),
                                      np.asarray(node['wscale']))
        assert q.ascale.item() == float(node['ascale'])
        np.testing.assert_array_equal(q.bias.numpy(),
                                      np.asarray(node['bias']))
    assert n_q > 30


def _walk(tree):
    if isinstance(tree, dict):
        yield tree
        for v in tree.values():
            yield from _walk(v)


def test_filter_amax(w16):
    model, tree, _, jamax = w16
    amax = TC.amax_from_jax(tree, jamax)
    kept = TQ.filter_amax(model, amax, ('stage4', 'stage3.0.branches'))
    assert not any(p.startswith('stage4.') for p in kept)
    assert not any(p.startswith('stage3.0.branches.') for p in kept)
    assert 'stage3.0.fuse_layers.1.0.0.0' in kept
    assert len(kept) < len(amax)
    with pytest.raises(ValueError, match='match no conv'):
        TQ.filter_amax(model, amax, ('stage_4',))
    assert TQ.filter_amax(model, amax, ()) is amax


def test_stage_modules_take_the_int8_chain(w16):
    """Every stage module runs int8_chain when its 8 chain convs are
    calibrated and accepted by the policy (c=16); one conv left out of the
    map keeps that module's bf16 chain; the other convs become QConv2d."""
    _, tree, _, jamax = w16
    amax = TC.amax_from_jax(tree, jamax)
    amax.pop('stage3.1.branches.0.2.conv2')
    model = TH.prepare_inference(TL.fold_batch_norm(TH.init(16, 17, seed=7)),
                                 torch.bfloat16, amax=amax)
    names = dict((m, n) for n, m in model.named_modules())
    for m in model.stage_modules():
        int8 = names[m] != 'stage3.1'
        assert (m.chain_int8 is not None) == int8
        assert (m.chain is None) == int8
    assert isinstance(model.stage2[0].branches[1][0].conv1, TL.QConv2d)
    assert isinstance(model.transition2[2][0][0], TL.QConv2d)
    assert not isinstance(model.transition1[0][0], TL.QConv2d)  # C_in 256
    assert not isinstance(model.conv1, TL.QConv2d)  # C_in = 3
    assert not isinstance(model.final_layer, TL.QConv2d)
    x = torch.from_numpy(np.random.default_rng(71).standard_normal(
        (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        out = model(x)
    assert out.shape == (1, 16, 16, 17) and torch.isfinite(out).all()


def test_smooth_frames_bitwise():
    for args in (((64, 48),), ((416, 416),), ((64, 48), 2, 0.0, 255.0)):
        np.testing.assert_array_equal(TQ.smooth_frames(*args),
                                      JQ.smooth_frames(*args))
    assert TQ.default_policy((3, 3, 16, 128)) and \
        not TQ.default_policy((1, 1, 32, 32)) and \
        not TQ.default_policy((3, 3, 3, 64)) and \
        not TQ.default_policy((3, 3, 128, 256))
