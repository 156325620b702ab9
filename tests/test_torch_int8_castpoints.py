"""The int8 chain's two cast-point modes against the JAX package, on the
CPU, and the rule by which the port's HRNet picks one.

The JAX package runs its Pallas int8 chain kernel only where G images
fill exactly 128 lanes (``G * c == 128``, ``G = min(4, max(2, 128 //
c))``) and branch-0 W % 8 == 0 (``chain_pallas_int8_ok``); everywhere else,
W48 and c = 16 among them, it runs the XLA ``blockdiag_chain_int8_grouped``,
which rounds the conv1 -> conv2 handoff and each block output to bf16
before it quantizes them. ``int8_chain_plain(..., round_handoffs=True)``
is held against that XLA chain (G = 1, bf16) at c = 16 and 48 BIT FOR BIT:
the int32 cores are exact, and both sides take the same f32 operations in
the same order with the same roundings. The control shows the fault this
mode repairs: the Pallas kernel's cast points (``round_handoffs=False``,
what the port ran at every width before) do not give those numbers. The
Pallas mode's bitwise match with the interpreted Pallas kernel is
tests/test_torch_int8.py's; the kernel's, on a card,
tests/test_torch_cuda_int8.py's.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.models import layers as JL
from simple_hrnet_tpu.ops.pallas import fused_block as JB

from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.ops.cuda import int8_chain as TI8

from test_torch_kernels import _randomized_blocks


@functools.lru_cache(maxsize=None)
def _chains(c):
    """4 folded BasicBlocks at width c, their per-conv input amax from the
    f32 chain, the JAX XLA int8 chain's bf16 output on a bf16 input, and
    the port's operands for the same input."""
    rng = np.random.default_rng(90 + c)
    blocks = _randomized_blocks(rng, c)
    x = rng.standard_normal((2, 16, 16, c)).astype(np.float32)
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
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(JB.blockdiag_chain_int8_grouped(
        xj, q, dtype=jnp.bfloat16).astype(jnp.float32))
    tq = TI8.pack_chain_weights_int8(convs, amax_list)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    return ref, xt, (tq['wq'], tq['wscale'], tq['b'], tq['ascales'])


@pytest.mark.parametrize('c', [16, 48])
def test_round_handoffs_matches_jax_xla_int8_chain(c):
    ref, x, args = _chains(c)
    out = TI8.int8_chain(x, *args, round_handoffs=True)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    np.testing.assert_array_equal(out.float().numpy(), ref)


@pytest.mark.parametrize('c', [16, 48])
def test_pallas_cast_points_miss_jax_xla_int8_chain(c):
    """The control: at these widths the Pallas kernel's cast points give
    other numbers than the chain the JAX package runs there."""
    ref, x, args = _chains(c)
    out = TI8.int8_chain(x, *args, round_handoffs=False).float().numpy()
    assert np.abs(out - ref).max() > 0.0
    assert (out != ref).mean() > 0.1


@pytest.mark.parametrize('c', [16, 32, 48, 64])
def test_pack_picks_the_cast_points_by_the_lane_rule(c):
    """Pallas cast points exactly where G * c == 128 (c = 32, 64), the XLA
    chain's elsewhere (c = 16, 48), for an int8 chain."""
    m = TH.StageModule(1, 1, c).eval()
    TH.L.fold_batch_norm(m)
    amax = {f'm.branches.0.{i // 2}.conv{i % 2 + 1}': 3.0 for i in range(8)}
    m.pack(torch.bfloat16, amax, prefix='m')
    assert m.chain_int8 is not None and m.chain is None
    assert m.int8_pallas_casts == (c in (32, 64))


def test_run_chain_rounds_handoffs_off_the_w_rule():
    """At c = 32 the chain takes the Pallas cast points where branch-0 W is
    a multiple of 8 and the XLA chain's where it is not, as
    chain_pallas_int8_ok decides."""
    c = 32
    m = TH.StageModule(1, 1, c).eval()
    TH.L.init_(m, torch.Generator().manual_seed(95))
    TH.L.fold_batch_norm(m)
    amax = {f'm.branches.0.{i // 2}.conv{i % 2 + 1}': 3.0 for i in range(8)}
    m.pack(torch.bfloat16, amax, prefix='m')
    q = m.chain_int8
    args = (q['wq'], q['wscale'], q['b'], q['ascales'])
    g = torch.Generator().manual_seed(96)
    for wd, rounds in ((16, False), (12, True)):
        x = torch.randn(2, c, 8, wd, generator=g).bfloat16()
        with torch.no_grad():
            out = m._run_chain(x)
        xh = x.permute(0, 2, 3, 1).contiguous()
        want = TI8.int8_chain_plain(xh, *args, round_handoffs=rounds)
        other = TI8.int8_chain_plain(xh, *args, round_handoffs=not rounds)
        assert not torch.equal(want, other)
        assert torch.equal(out.permute(0, 2, 3, 1), want)
