"""The port's Winograd-H chain (B3) against the JAX package, on the CPU.

On CPU tensors ``wino_chain`` runs its plain PyTorch version, held here
against the Pallas ``chain_pallas_grouped_wino`` (G = 1, run interpreted as
tests/test_pallas.py runs it) and against an independent numpy loop that
rounds at ``_wino_kernel``'s cast points. Tolerances: f32 1e-4 (summation
order only; the transform's {0, +-1, +-0.5} coefficients are exact); bf16
2^-7 of max against the loop (one bf16 ulp at a conv output where the f32
sums round differently, carried by the later convs) and 2^-6 of max against
the Pallas kernel (the same, with XLA's dot order). Packing is bitwise.
The CUDA kernel is held against the plain version on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.ops.pallas import fused_block as JB
from simple_hrnet_tpu.ops.pallas import winograd_chain as JW

from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.ops.cuda import fused_block as TB
from simple_hrnet_tpu_torch.ops.cuda import winograd_chain as TW

from test_torch_kernels import _randomized_blocks


def _bf16_bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int16)


@pytest.fixture(scope='module')
def chain16():
    """4 folded BasicBlocks at C=16 and their packings in both packages."""
    rng = np.random.default_rng(40)
    blocks = _randomized_blocks(rng, 16)
    wts, bias = JB.pack_chain_weights(blocks, jnp.float32, group=1)
    convs = []
    for bp in blocks:
        for k in ('conv1', 'conv2'):
            convs.append((torch.from_numpy(np.transpose(
                np.asarray(bp[k]['kernel']), (3, 2, 0, 1)).copy()),
                torch.from_numpy(np.array(bp[k]['bias']))))
    w, b = TB.pack_chain_weights(convs, torch.float32)
    return rng, wts, bias, w, b


def test_pack_winograd_weights_bitwise(chain16):
    _, wts, _, w, _ = chain16
    ref32 = JW.pack_winograd_weights(wts, jnp.float32)
    np.testing.assert_array_equal(
        TW.pack_winograd_weights(w, torch.float32).numpy(),
        np.asarray(ref32))
    # U from the f32 weights, cast afterwards (hrnet_fast.py:150-157)
    ref16 = JW.pack_winograd_weights(wts, jnp.bfloat16)
    np.testing.assert_array_equal(
        TW.pack_winograd_weights(w, torch.bfloat16).view(torch.int16)
        .numpy(), _bf16_bits(ref16))
    with pytest.raises(ValueError, match='f32'):
        TW.pack_winograd_weights(w.bfloat16(), torch.bfloat16)


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -6)])
def test_wino_plain_matches_pallas_wino(chain16, dtype, tol):
    rng, wts, bias, w, b = chain16
    x = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
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


def test_wino_plain_bf16_rounds_at_the_kernel_cast_points():
    """bf16: the plain version equals an independent loop over row pairs
    that rounds the V terms and each conv's output to bf16."""
    rng = np.random.default_rng(41)
    c, h, wd = 8, 8, 6
    x = torch.from_numpy(rng.standard_normal((1, h, wd, c)).astype(
        np.float32)).bfloat16()
    w32 = torch.from_numpy(rng.uniform(-0.25, 0.25, (8, 3, 3, c, c)).astype(
        np.float32))
    b = torch.from_numpy(rng.uniform(-0.5, 0.5, (8, c)).astype(np.float32))
    ww = TW.pack_winograd_weights(w32, torch.bfloat16)
    out = TW.wino_chain(x, ww, b)

    def to_bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).bfloat16() \
            .float().numpy()

    u = ww.float().numpy().reshape(8, 4, 3, c, c)

    def conv(v, i):  # v (h, w, c) bf16 values; f64 sums
        vp = np.zeros((h + 2, wd + 2, c))
        vp[1:h + 1, 1:wd + 1] = v
        y = np.zeros((h, wd, c))
        for t in range(h // 2):
            r = [vp[2 * t + k] for k in range(4)]  # rows 2t-1 .. 2t+2
            terms = [to_bf16(r[0] - r[2]), to_bf16(r[1] + r[2]),
                     to_bf16(r[2] - r[1]), to_bf16(r[1] - r[3])]
            m = []
            for k in range(4):
                acc = np.zeros((wd, c))
                for kx in range(3):
                    acc += terms[k][kx:kx + wd] @ u[i, k, kx]
                m.append(acc)
            y[2 * t] = b[i].numpy() + m[0] + m[1] + m[2]
            y[2 * t + 1] = b[i].numpy() + m[1] - m[2] - m[3]
        return y

    v = x.float().numpy()[0]
    for blk in range(4):
        mid = to_bf16(np.maximum(conv(v, 2 * blk), 0))
        v = to_bf16(np.maximum(conv(mid, 2 * blk + 1) + v, 0))
    tol = 2.0 ** -7 * np.abs(v).max()
    np.testing.assert_allclose(out[0].float().numpy(), v, atol=tol, rtol=0)


def test_wino_chain_rejects_odd_height():
    with pytest.raises(ValueError, match='odd'):
        TW.wino_chain(torch.zeros(1, 7, 8, 8), torch.zeros(8, 4, 24, 8),
                      torch.zeros(8, 8))


@pytest.mark.parametrize('c,dtype,wino', [(32, torch.bfloat16, True),
                                          (32, torch.float32, False),
                                          (16, torch.bfloat16, False),
                                          (48, torch.bfloat16, False)])
def test_stage_module_chooses_the_jax_chain(c, dtype, wino):
    """bf16 at G * c == 128 (W32, W64) packs Winograd weights; f32 and
    the other widths keep the direct chain (hrnet_fast.py:144-157)."""
    m = TH.StageModule(2, 2, c).eval()
    TH.L.fold_batch_norm(m)
    m.pack(dtype)
    assert (m.chain[2] is not None) == wino and m.chain_int8 is None


def test_bf16_winograd_facade_matches_jax(tmp_path, monkeypatch):
    """SimpleHRNet(32, ..., dtype='bfloat16') runs wino_chain in every
    stage module, as the JAX facade runs its Winograd Pallas chain at W32
    (here interpreted, SHT_PALLAS_CPU_INTERPRET=1, inside its grouped
    trunk). Both compute in bf16 with roundings at different places (the
    block-diagonal trunk, XLA's bf16 conv and bias add), so the heatmaps
    agree to bf16 accuracy over ~90 layers: 2^-5 of their max."""
    monkeypatch.setenv('SHT_PALLAS_CPU_INTERPRET', '1')
    import jax as _jax
    from simple_hrnet_tpu import SimpleHRNet as JaxSimpleHRNet
    from simple_hrnet_tpu_torch import SimpleHRNet
    from test_torch_api import _JaxStub

    path = str(tmp_path / 'pose_hrnet_w32.pth')
    torch.save(TH.init(32, 17, seed=0).state_dict(), path)
    kw = dict(resolution=(64, 64), yolo_model_def='yolov3-tiny',
              return_heatmaps=True, return_bounding_boxes=True)
    port = SimpleHRNet(32, 17, path, device='cpu', dtype='bfloat16', **kw)
    ref = JaxSimpleHRNet(32, 17, path, dtype='bfloat16', **kw)
    assert all(m.chain[2] is not None for m in port.model.stage_modules())
    boxes = [np.array([[5, 5, 50, 80], [20, 10, 70, 95]], np.float32)]
    frames = np.random.default_rng(4).integers(
        0, 256, (1, 120, 160, 3)).astype(np.uint8)
    port.detector = _JaxStub(boxes, torch_out=True)
    ref.detector = _JaxStub(boxes, torch_out=False)
    launches = TW.wino_chain.launches
    hm, bx, _ = port.predict(frames)
    assert TW.wino_chain.launches == launches  # CPU: the plain version
    with _jax.enable_x64(True):  # exact PIL crops, as the port's
        rhm, rbx, _ = ref.predict(frames)
    np.testing.assert_array_equal(bx[0], rbx[0])
    assert hm[0].shape == rhm[0].shape == (2, 17, 16, 16)
    assert np.abs(hm[0] - rhm[0]).max() <= 2.0 ** -5 * np.abs(rhm[0]).max()
