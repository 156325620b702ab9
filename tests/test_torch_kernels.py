"""The port's kernel modules against the JAX package, on the CPU.

On CPU tensors each kernel wrapper runs its plain PyTorch version, which
is held here against the JAX function the CUDA kernel replaces (Pallas
kernels run interpreted, as the JAX package's own tests run them):
  * K1 NMS: slot for slot against ``ops.nms.nms_jax``;
  * K2 BasicBlock chain: against ``chain_pallas_grouped`` (G = 1) and 4x
    ``layers.basic_block``;
  * K3 fuse_up: against the Pallas ``fuse_up`` with 1, 2 and 3 sources.
f32 comparisons use the house tolerance 2e-4. The CUDA kernels are held
against the plain versions on a card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.models import layers as JL
from simple_hrnet_tpu.ops import nms as JN
from simple_hrnet_tpu.ops.pallas import fuse_up as JF
from simple_hrnet_tpu.ops.pallas import fused_block as JB

from simple_hrnet_tpu_torch.ops.cuda import fuse_up as TF
from simple_hrnet_tpu_torch.ops.cuda import fused_block as TB
from simple_hrnet_tpu_torch.ops.cuda import nms as TN
from simple_hrnet_tpu_torch.ops.nms import nms_ingraph

TOL = 2e-4


def _boxes_scores(rng, n, levels=None):
    boxes = np.zeros((n, 4), np.float32)
    boxes[:, 0] = rng.uniform(0, 300, n)
    boxes[:, 1] = rng.uniform(0, 300, n)
    boxes[:, 2] = boxes[:, 0] + rng.uniform(10, 150, n)
    boxes[:, 3] = boxes[:, 1] + rng.uniform(10, 150, n)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    if levels is not None:  # few distinct values: many exact ties
        scores = (np.ceil(scores * levels) / levels).astype(np.float32)
    scores[rng.uniform(0, 1, n) < 0.1] = 0.0  # padding entries
    return boxes, scores


@pytest.mark.parametrize('n,levels', [(64, None), (256, None), (256, 4)])
def test_nms_plain_matches_nms_jax(n, levels):
    rng = np.random.default_rng(n + (levels or 0))
    boxes, scores = _boxes_scores(rng, n, levels)
    ref_idx, ref_valid = JN.nms_jax(boxes, scores, 0.45, max_out=32)
    # the per-image form, as the JAX detector calls nms_ingraph
    idx, valid = nms_ingraph(torch.from_numpy(boxes),
                             torch.from_numpy(scores), 0.45, 32)
    assert idx.shape == valid.shape == (32,) and idx.dtype == torch.int32
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


def test_nms_plain_batched_matches_vmapped_nms_jax():
    rng = np.random.default_rng(7)
    bn, n = 5, 128
    pairs = [_boxes_scores(rng, n) for _ in range(bn)]
    boxes = np.stack([p[0] for p in pairs])
    scores = np.stack([p[1] for p in pairs])
    ref_idx, ref_valid = jax.vmap(
        lambda b, s: JN.nms_jax(b, s, 0.45, 32))(boxes, scores)
    idx, valid = TN.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                        0.45, 32)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


def test_nms_rejects_bad_shapes():
    with pytest.raises(ValueError):
        TN.nms(torch.zeros(4, 4), torch.zeros(4), 0.4, 8)
    with pytest.raises(ValueError):
        TN.nms(torch.zeros(1, 4, 4), torch.zeros(1, 5), 0.4, 8)


def _randomized_blocks(rng, c):
    """4 folded BasicBlocks with non-trivial BN statistics."""
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    blocks = []
    for _ in range(4):
        key, k = jax.random.split(key)
        p = JL.init_basic_block(k, c, c)
        for bn in ('bn1', 'bn2'):
            p[bn] = {'scale': rng.uniform(0.5, 1.5, c).astype(np.float32),
                     'bias': rng.uniform(-0.2, 0.2, c).astype(np.float32),
                     'mean': rng.uniform(-0.5, 0.5, c).astype(np.float32),
                     'var': rng.uniform(0.5, 2.0, c).astype(np.float32)}
        blocks.append(JL.fold_batch_norm(p))
    return blocks


def test_chain_plain_matches_jax_chain():
    rng = np.random.default_rng(11)
    c = 8
    blocks = _randomized_blocks(rng, c)
    x = rng.standard_normal((2, 16, 12, c)).astype(np.float32)

    wts, bias = JB.pack_chain_weights(blocks, jnp.float32, group=1)
    ref_pallas = np.asarray(JB.chain_pallas_grouped(jnp.asarray(x), wts,
                                                    bias))
    ref_blocks = jnp.asarray(x)
    for bp in blocks:
        ref_blocks = JL.basic_block(bp, ref_blocks)

    # the port's packing from OIHW weights reproduces the JAX layout
    convs = []
    for bp in blocks:
        for k in ('conv1', 'conv2'):
            convs.append((torch.from_numpy(np.transpose(
                np.asarray(bp[k]['kernel']), (3, 2, 0, 1)).copy()),
                torch.from_numpy(np.array(bp[k]['bias']))))
    w, b = TB.pack_chain_weights(convs, torch.float32)
    np.testing.assert_array_equal(w.numpy(), np.asarray(wts))
    np.testing.assert_array_equal(b.numpy(), np.asarray(bias))

    out = TB.basic_chain(torch.from_numpy(x), w, b).numpy()
    np.testing.assert_allclose(out, ref_pallas, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out, np.asarray(ref_blocks), atol=TOL,
                               rtol=TOL)


def test_chain_plain_bf16_rounds_at_the_kernel_cast_points():
    """bf16: the plain version equals an independent f32 loop that rounds
    each conv's output to bf16 (the Pallas kernel's cast points)."""
    rng = np.random.default_rng(12)
    c = 8
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, c)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.uniform(-0.2, 0.2, (8, 3, 3, c, c)).astype(
        np.float32)).bfloat16()
    b = torch.from_numpy(rng.uniform(-0.1, 0.1, (8, c)).astype(np.float32))
    out = TB.basic_chain(x, w, b)
    assert out.dtype == torch.bfloat16

    def conv(v, i):  # NHWC f32 direct conv
        vp = np.pad(v, ((0, 0), (1, 1), (1, 1), (0, 0)))
        wi = w[i].float().numpy()
        acc = np.broadcast_to(b[i].numpy(), v.shape).astype(np.float64)
        for ky in range(3):
            for kx in range(3):
                acc = acc + np.einsum('nhwc,co->nhwo',
                                      vp[:, ky:ky + 8, kx:kx + 8], wi[ky, kx])
        return acc

    def to_bf16(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float(
        ).numpy()

    v = x.float().numpy()
    for blk in range(4):
        mid = to_bf16(np.maximum(conv(v, 2 * blk), 0))
        v = to_bf16(np.maximum(conv(mid, 2 * blk + 1) + v, 0))
    np.testing.assert_allclose(out.float().numpy(), v, atol=2 ** -7,
                               rtol=2 ** -7)


@pytest.mark.parametrize('n_src', [1, 2, 3])
def test_fuse_up_plain_matches_jax_fuse_up(n_src):
    rng = np.random.default_rng(20 + n_src)
    c, h, w = 8, 16, 16
    base = rng.standard_normal((2, h, w, c)).astype(np.float32)
    ys, kernels, biases = [], [], []
    for j in range(1, n_src + 1):
        f, cj = 2 ** j, c * 2 ** j
        ys.append(rng.standard_normal((2, h // f, w // f, cj)).astype(
            np.float32))
        kernels.append(rng.uniform(-0.3, 0.3, (1, 1, cj, c)).astype(
            np.float32))
        biases.append(rng.uniform(-0.1, 0.1, c).astype(np.float32))
    assert JF.fuse_up_supported(base.shape, [y.shape for y in ys])
    ref = np.asarray(JF.fuse_up(jnp.asarray(base),
                                [jnp.asarray(y) for y in ys],
                                [jnp.asarray(k) for k in kernels],
                                [jnp.asarray(b) for b in biases]))
    bias_sum = np.zeros(c, np.float32)
    for bias in biases:
        bias_sum = bias_sum + bias
    out = TF.fuse_up(torch.from_numpy(base),
                     [torch.from_numpy(y) for y in ys],
                     [torch.from_numpy(k.reshape(k.shape[2], c))
                      for k in kernels],
                     torch.from_numpy(bias_sum)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_fuse_up_rejects_non_pyramid_source():
    base = torch.zeros(1, 16, 16, 8)
    with pytest.raises(ValueError):
        TF.fuse_up(base, [torch.zeros(1, 5, 5, 16)], [torch.zeros(16, 8)],
                   torch.zeros(8))
