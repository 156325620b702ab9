"""The port's space-to-depth phase stem against the JAX package's, on the CPU.

``ops/phase.py``'s transforms bit for bit against the JAX package's on
seeded kernels, and each rewritten conv against its full-resolution conv
in f32 (1e-5, summation order); ``letterbox_device_phase`` within 1e-6 of
the JAX package's, at odd pad offsets; YOLOv3-tiny at ``img_size`` 128 and
YOLOv3 at 64 (one seeded ``.npz`` each, read by both packages) with
``phase_stem`` None (on) and False against the JAX detector with the same
flag: detect rows (YOLOv3-tiny) or network outputs (YOLOv3) in f32 within
2e-4, validity equal; the int8 quantized convs and their activation
scales (1e-5) of YOLOv3 under both flags against the JAX package's
(yolov5n's are in ``tests/test_torch_yolov5.py``); the gating and the
errors of the JAX package's ``tests/test_detector.py``, messages word for
word.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.detectors import darknet as JD
from simple_hrnet_tpu.detectors import yolov3 as JY
from simple_hrnet_tpu.ops import phase as JP

from simple_hrnet_tpu_torch.detectors import darknet as TD
from simple_hrnet_tpu_torch.detectors import yolov3 as TY
from simple_hrnet_tpu_torch.detectors import yolov5 as T5
from simple_hrnet_tpu_torch.ops import phase as TP
from simple_hrnet_tpu_torch.utils import checkpoint as TK

TOL = 2e-4
# (model_def, img_size): the two darknet stems, conv + maxpool and conv +
# conv
SIZES = {'yolov3-tiny': 128, 'yolov3': 64}
# the random network's activations shrink through its convs, so that every
# candidate scores alike (YOLOv3-tiny would fill all 32 slots a frame, the
# order of its ties float noise); scaled heads score them apart
HEAD_SCALE = 30.0


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    """Seeded YOLOv3-tiny and YOLOv3 weights (the port's torch-default
    init, the linear head convs scaled by HEAD_SCALE) as ``.npz`` darknet
    trees, which both packages' detectors read: drawn by torch, they spare
    each JAX detector its random init."""
    out = {}
    for model_def in SIZES:
        blocks = (TD.yolov3_tiny_blocks() if 'tiny' in model_def
                  else TD.yolov3_blocks())
        net = TD.init(blocks, seed=0)
        with torch.no_grad():
            for i, blk in enumerate(blocks):
                if blk['type'] == 'convolutional' and not blk['bn']:
                    getattr(net, f'conv_{i}').weight.mul_(HEAD_SCALE)
        path = str(tmp_path_factory.mktemp('det') / f'{model_def}.npz')
        TK.save(path, net)
        out[model_def] = path
    return out


def _frames(n=2, hw=(120, 160), seed=3):
    return np.random.default_rng(seed).uniform(0, 255, (n, *hw, 3)).astype(
        np.uint8)


def test_transforms_match_jax():
    """Kernels, paddings, tiled biases, blocked rows and both relayouts bit
    for bit; ``hwio``/``oihw`` are inverse transposes."""
    rng = np.random.default_rng(0)
    for fn, kh, pad in ((TP.phase_kernel_s1, 3, 1),
                        (TP.phase_kernel_s2, 3, 1),
                        (TP.phase_kernel_s2, 6, 2)):
        k = rng.standard_normal((kh, kh, 3, 5)).astype(np.float32)
        got, got_pad = fn(k, pad=pad)
        want, want_pad = getattr(JP, fn.__name__)(k, pad=pad)
        np.testing.assert_array_equal(got, want)
        assert got_pad == want_pad and got.dtype == want.dtype
        assert TP.phase_paddings(kh, kh, pad) == JP.phase_paddings(kh, kh,
                                                                   pad)
    b = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_array_equal(TP.tile_phase_bias(b),
                                  JP.tile_phase_bias(b))
    w = rng.standard_normal((10, 7)).astype(np.float32)
    np.testing.assert_array_equal(TP.blocked_rows(w), JP.blocked_rows(w))
    x = rng.standard_normal((2, 6, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(TP.space_to_depth_host(x),
                                  JP.space_to_depth_host(x))
    np.testing.assert_array_equal(
        TP.phase_quadrants(torch.from_numpy(x)).numpy(),
        np.asarray(JP.phase_quadrants(jnp.asarray(x))))
    wt = torch.from_numpy(rng.standard_normal((5, 3, 6, 6)).astype(
        np.float32))
    assert TP.hwio(wt).shape == (6, 6, 3, 5)
    torch.testing.assert_close(TP.oihw(TP.hwio(wt)), wt, rtol=0, atol=0)


def test_phase_convs_match_full_resolution():
    """Each rewrite as the port runs it (OIHW ``F.conv2d``; the stride-2
    3x3's asymmetric pad by ``F.pad``) on the phase input against the
    full-resolution conv: the stride-1 3x3 stays in phase space, the
    stride-2 3x3 (darknet's ``conv_1``) and 6x6 (YOLOv5's stem) leave it."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 16, 3)).astype(np.float32)
    xp = torch.from_numpy(TP.space_to_depth_host(x)).permute(0, 3, 1, 2)
    xf = torch.from_numpy(x).permute(0, 3, 1, 2)
    for kh, stride, pad in ((3, 1, 1), (3, 2, 1), (6, 2, 2)):
        k = rng.standard_normal((kh, kh, 3, 5)).astype(np.float32)
        full = F.conv2d(xf, TP.oihw(k), stride=stride, padding=pad)
        fn = TP.phase_kernel_s1 if stride == 1 else TP.phase_kernel_s2
        kp, ((top, bottom), (left, right)) = fn(k, pad=pad)
        got = F.conv2d(F.pad(xp, (left, right, top, bottom)), TP.oihw(kp))
        want = full.permute(0, 2, 3, 1).numpy()
        if stride == 1:
            want = TP.space_to_depth_host(want)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   atol=1e-5)


def test_letterbox_phase_matches_jax():
    """Against the JAX package's ``letterbox_device_phase`` and the
    space-to-depth of the port's own ``letterbox_device``, within 1e-6 (the
    resize matmuls' shapes differ): an odd top pad and an odd left pad."""
    for hw in ((101, 160), (160, 101)):
        _, dw, dh, _ = TY.letterbox_params(hw, 128)
        assert int(round(dh - 0.1)) % 2 or int(round(dw - 0.1)) % 2
        frames = _frames(hw=hw, seed=2)
        got = TY.letterbox_device_phase(torch.from_numpy(frames),
                                        128).numpy()
        assert got.shape == (2, 64, 64, 12)
        want = np.asarray(JY.letterbox_device_phase(frames, 128, *hw))
        np.testing.assert_allclose(got, want, atol=1e-6)
        plain = TY.letterbox_device(torch.from_numpy(frames), 128).numpy()
        np.testing.assert_allclose(got, TP.space_to_depth_host(plain),
                                   atol=1e-6)


@pytest.mark.parametrize('phase_stem', [None, False])
@pytest.mark.parametrize('model_def', list(SIZES))
def test_detect_matches_jax(weights, model_def, phase_stem):
    """Against the JAX detector with the same flag, f32 within TOL:
    YOLOv3-tiny's ``detect_padded`` rows, validity equal; YOLOv3's network
    outputs on the detector's own input (the phase tensor when the stem is
    on), since its random weights keep nobody at 64."""
    size = SIZES[model_def]
    jdet = JY.YOLOv3(model_def, weights_path=weights[model_def],
                     img_size=size, phase_stem=phase_stem)
    tdet = TY.YOLOv3(model_def, weights_path=weights[model_def],
                     device='cpu', img_size=size, phase_stem=phase_stem)
    assert jdet.phase_stem == tdet.phase_stem == (phase_stem is None)
    frames = _frames()
    if model_def == 'yolov3':
        letterbox = (JY.letterbox_device_phase if jdet.phase_stem
                     else JY.letterbox_device)
        want = np.asarray(jax.jit(lambda p, v: JD.apply(
            p, jdet.blocks, v, size, phase_stem=jdet.phase_stem))(
                jdet.params, letterbox(frames, size, 120, 160)))
        with torch.no_grad():
            got = tdet.net(tdet._letterbox(torch.from_numpy(frames)), size,
                           tdet.phase_stem).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        return
    jr, jv = (np.asarray(a) for a in jdet.detect_padded(frames))
    tr, tv = (a.numpy() for a in tdet.detect_padded(frames))
    np.testing.assert_array_equal(tv, jv)
    assert jv.any()
    np.testing.assert_allclose(tr[jv], jr[jv], atol=TOL)


@pytest.mark.parametrize('phase_stem', [None, False])
def test_yolov3_int8_set_matches_jax(weights, phase_stem):
    """YOLOv3 under dtype='int8': the same quantized convs as the JAX
    detector with the same flag, with its activation scales to 1e-5. The
    phase stem's rewritten ``conv_1`` (2, 2, 128, 64) falls outside the
    policy, so ``conv_1`` is quantized only with the plain stem."""
    jq = JY.YOLOv3('yolov3', weights_path=weights['yolov3'], dtype='int8',
                   img_size=64, phase_stem=phase_stem)
    ref = {k: float(v['ascale']) for k, v in jq.params.items()
           if 'kernel_q' in v}
    det = TY.YOLOv3('yolov3', weights_path=weights['yolov3'], device='cpu',
                    dtype='int8', img_size=64, phase_stem=phase_stem)
    got = {n: m.qconv.ascale.item() for n, m in det.net.named_modules()
           if getattr(m, 'qconv', None) is not None}
    plain = ['conv_10', 'conv_3', 'conv_5', 'conv_7']
    assert sorted(got) == sorted(ref) == (
        sorted(plain + ['conv_1']) if phase_stem is False else plain)
    for k, a in ref.items():
        assert abs(got[k] - a) <= 1e-5 * a, k


def test_phase_stem_gating():
    """``stem_phaseable`` as the JAX package's on the built-in graphs and on
    altered stems; the default is on at an even size and off at an odd
    one, and an explicit False wins."""
    tiny = TD.yolov3_tiny_blocks()
    graphs = [TD.yolov3_blocks(), tiny,
              [tiny[0], dict(tiny[1], size=3)] + tiny[2:],
              [tiny[0], dict(tiny[0], stride=1)] + tiny[2:],
              tiny + [{'type': 'route', 'layers': [0]}], tiny[:1]]
    assert [TD.stem_phaseable(b) for b in graphs] == \
        [JD.stem_phaseable(b) for b in graphs] == \
        [True, True, False, False, False, False]
    assert TY.YOLOv3('yolov3-tiny', device='cpu').phase_stem
    assert not TY.YOLOv3('yolov3-tiny', device='cpu', img_size=127
                         ).phase_stem
    assert not TY.YOLOv3('yolov3-tiny', device='cpu', phase_stem=False
                         ).phase_stem
    assert not TY.YOLOv3('yolov3', device='cpu', phase_stem=False
                         ).phase_stem
    assert T5.YOLOv5('yolov5n', device='cpu', img_size=128).phase_stem
    assert not T5.YOLOv5('yolov5n', device='cpu', img_size=127).phase_stem


def test_phase_stem_invalid_request_raises(weights):
    """An explicit ``phase_stem=True`` at an odd size or on a stem that
    does not qualify raises the JAX package's ValueError, word for word
    (YOLOv5 raises at an odd size too, where the JAX detector goes on)."""
    with pytest.raises(ValueError) as want:
        JY.YOLOv3('yolov3-tiny', weights_path=weights['yolov3-tiny'],
                  phase_stem=True, img_size=127)
    with pytest.raises(ValueError, match='even img_size') as got:
        TY.YOLOv3('yolov3-tiny', device='cpu', phase_stem=True,
                  img_size=127)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match='even img_size'):
        T5.YOLOv5('yolov5n', device='cpu', phase_stem=True, img_size=127)
    blocks = TD.yolov3_tiny_blocks()
    blocks[1] = dict(blocks[1], size=3)  # a 3x3 stride-2 maxpool
    net = TD.init(blocks).fold()
    params = {k: {'kernel': jnp.asarray(TP.hwio(m.weight)),
                  'bias': jnp.asarray(m.bias.detach().numpy())}
              for k, m in net.named_children()}
    with pytest.raises(ValueError) as want:
        JD.phase_stem_params(params, blocks)
    with pytest.raises(ValueError, match='not qualify') as got:
        TD.phase_stem_params(net)
    assert str(got.value) == str(want.value)
    unfolded = TD.init(TD.yolov3_tiny_blocks())
    with pytest.raises(ValueError, match='folded, unquantized'):
        TD.phase_stem_params(unfolded)
