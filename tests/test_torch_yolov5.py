"""The port's YOLOv5 detector against the JAX package's, on the CPU.

Both packages load one seeded ultralytics-style ``.pt`` (the port's own
YOLOv5 network pickled as ``{'model': net}``, scaled so that the random
network finds people and scores them apart: ``torch_v5_weights``), at a
small ``img_size``: a 640 JAX detector
on the CPU is slow. f32 throughout, inputs from a numpy seed. Tolerances:
network outputs 2e-4 (the house tolerance, relative on box sizes of up to
~1500 px); detect rows the same valid slots with boxes within 2e-4 px
plus 2e-6 relative (the corners reach ~650 px) and scores within 1e-5; int8 operands and each quantized conv bit for bit
from the same calibration map; the facades as tests/test_torch_api.py
holds them.
"""

import pickle
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu import SimpleHRNet as JaxSimpleHRNet
from simple_hrnet_tpu.detectors import yolov5 as JY
from simple_hrnet_tpu.models import convert as JC
from simple_hrnet_tpu.models import layers as JL
from simple_hrnet_tpu.models import quantize as JQ

from simple_hrnet_tpu_torch import SimpleHRNet
from simple_hrnet_tpu_torch.detectors import yolov5 as TY
from simple_hrnet_tpu_torch.models import convert as TC
from simple_hrnet_tpu_torch.models import layers as TL
from simple_hrnet_tpu_torch.models import poseresnet as TP
from simple_hrnet_tpu_torch.models import quantize as TQ
from simple_hrnet_tpu_torch.models.layers import QConv2d

from test_torch_api import _assert_same_people
from torch_v5_weights import write_yolov5_pt

TOL = 2e-4
SIZE = 128  # the detectors' img_size
BOX_RTOL = 2e-6  # detect_padded's box corners, beside TOL


@pytest.fixture(scope='module')
def pt(tmp_path_factory):
    return write_yolov5_pt(
        str(tmp_path_factory.mktemp('det') / 'yolov5n_seed0.pt'))


def _frames(n=2, seed=3):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 120, 160, 3)).astype(np.uint8)


def test_config_matches_jax():
    """Variants, anchors, layer plans and the ultralytics state_dict names
    (model.0.conv.weight ... model.24.m.2.bias)."""
    assert TY.VARIANTS == JY.VARIANTS
    np.testing.assert_array_equal(TY.ANCHORS, JY.ANCHORS)
    for v in TY.VARIANTS:
        assert TY.build_config(v) == JY.build_config(v)
    cfg = TY.build_config('yolov5n')
    names = set(JC.tree_to_state_dict(JY.init(jax.random.PRNGKey(0), cfg)))
    port = {k for k in TY.YOLOv5Net(cfg).state_dict()
            if not k.endswith('num_batches_tracked')}
    assert port == names
    assert 'model.24.m.2.weight' in port and 'model.0.conv.weight' in port
    for model_def, variant in (('yolov5s', 'yolov5s'),
                               ('/w/yolov5x6.pt', 'yolov5x'),
                               ('yolov3', 'yolov5m')):
        assert TY._variant(model_def) == variant


def test_forward_matches_jax(pt):
    """yolov5n folded network + decode against ``yolov5.apply``."""
    params = JY._fold(JY.state_dict_to_tree(
        JY.load_ultralytics_state_dict(pt)))
    net = TL.fold_batch_norm(TC.load_into(
        TY.YOLOv5Net(TY.build_config('yolov5n')),
        TY.load_ultralytics_state_dict(pt)).eval())
    x = np.random.default_rng(1).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(
        np.float32)
    ref = np.asarray(JY.apply(params, JY.build_config('yolov5n'), x, SIZE))
    with torch.no_grad():
        out = net(torch.from_numpy(x), SIZE).numpy()
    assert out.shape == ref.shape == (2, 3 * (16 ** 2 + 8 ** 2 + 4 ** 2), 85)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_candidate_order():
    """The decode's flatten order: channel ``a * (5 + C) + k`` of the NCHW
    head at (gy, gx) is entry k of candidate ``a * gh * gw + gy * gw + gx``
    — the JAX package's (gh, gw, 3, 5 + C) split of its NHWC channels
    (the levels' order, P3, P4, P5, is the forward test's)."""
    rng = np.random.default_rng(2)
    gh, gw, nc = 4, 6, 80
    raw = rng.standard_normal((2, 3 * (5 + nc), gh, gw)).astype(np.float32)
    out = TY._detect_decode(torch.from_numpy(raw), 2, 192).numpy()
    ref = np.asarray(JY._detect_decode(
        jnp.asarray(raw.transpose(0, 2, 3, 1)), 2, 192))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-6)
    sig = 1 / (1 + np.exp(-raw.astype(np.float64)))
    for a, y, x, k in ((0, 0, 1, 4), (1, 3, 2, 5), (2, 2, 5, 84)):
        row = a * gh * gw + y * gw + x
        np.testing.assert_allclose(out[1, row, k], sig[1, a * 85 + k, y, x],
                                   rtol=1e-6)
    np.testing.assert_allclose(out[0, 1 * gh * gw + 2 * gw + 3, 0],
                               (2 * sig[0, 85, 2, 3] - 0.5 + 3) * 192 / gw,
                               rtol=1e-6)


class _Conv(torch.nn.Module):
    """An ultralytics-like Conv block whose class the loading side cannot
    import (tests/test_yolov5.py's pattern)."""

    def __init__(self, ci, co, k):
        super().__init__()
        self.conv = torch.nn.Conv2d(ci, co, k, bias=False)
        self.bn = torch.nn.BatchNorm2d(co, eps=1e-3)


def test_ultralytics_loader(tmp_path):
    """The stub-unpickler on a fake ultralytics .pt whose module class is
    gone on the loading side: the same flat state_dict as the JAX loader,
    fp16 tensors cast to f32, the anchors buffers dropped."""
    mod = sys.modules[__name__]
    _Conv.__qualname__ = _Conv.__name__ = '_PickleConv'
    mod._PickleConv = _Conv
    inner = torch.nn.Module()
    inner.model = torch.nn.ModuleList([_Conv(3, 8, 3), _Conv(8, 16, 1)])
    inner.model[1].half()
    inner.model[0].register_buffer('anchors', torch.ones(3, 2))
    path = tmp_path / 'fake.pt'
    torch.save({'model': inner}, path)
    del mod._PickleConv  # the loader cannot resolve the class: stub path
    with pytest.raises((AttributeError, pickle.UnpicklingError)):
        torch.load(path, weights_only=False)
    flat = TY.load_ultralytics_state_dict(str(path))
    ref = JY.state_dict_to_tree(JY.load_ultralytics_state_dict(str(path)))
    assert set(flat) == set(JC.tree_to_state_dict(ref)) | {
        'model.0.bn.num_batches_tracked', 'model.1.bn.num_batches_tracked'}
    assert 'model.0.anchors' not in flat
    assert flat['model.1.conv.weight'].dtype == torch.float32
    assert flat['model.1.conv.weight'].shape == (16, 8, 1, 1)
    np.testing.assert_array_equal(
        flat['model.0.conv.weight'].numpy(),
        np.transpose(np.asarray(ref['model']['0']['conv']['kernel']),
                     (3, 2, 0, 1)))


@pytest.mark.parametrize('phase_stem', [False, None])
def test_detect_padded_matches_jax(pt, phase_stem):
    """Rows and validity against the JAX detector with the same
    ``phase_stem``: off, and at the default (on: an exact rewrite of the
    same 6x6 conv over the phase tensor); the reference-compatible API on
    BGR frames."""
    jdet = JY.YOLOv5(pt, img_size=SIZE, phase_stem=phase_stem)
    tdet = TY.YOLOv5(pt, img_size=SIZE, device='cpu', phase_stem=phase_stem)
    assert jdet.phase_stem == tdet.phase_stem == (phase_stem is None)
    frames = _frames()
    jr, jv = (np.asarray(a) for a in jdet.detect_padded(frames))
    tr, tv = (a.numpy() for a in tdet.detect_padded(frames))
    assert tv.dtype == bool and tr.shape == jr.shape == (2, 32, 7)
    np.testing.assert_array_equal(tv, jv)
    assert 0 < jv.sum()
    # box corners reach ~650 px through the exp-like (2 s)^2 * anchor and
    # the letterbox un-scale: the raw head outputs of the two packages
    # already differ by tens of f32 ulps (their conv sums run in another
    # order), so the corners are held at TOL plus 2e-6 relative (~16 ulps
    # at their scale); the same rows shifted by 0.01 px must fail
    np.testing.assert_allclose(tr[jv][:, :4], jr[jv][:, :4], atol=TOL,
                               rtol=BOX_RTOL)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(tr[jv][:, :4] + 0.01, jr[jv][:, :4],
                                   atol=TOL, rtol=BOX_RTOL)
    np.testing.assert_allclose(tr[jv][:, 4:6], jr[jv][:, 4:6], atol=1e-5)
    assert (tr[jv][:, 6] == 0).all() and (jr[jv][:, 6] == 0).all()
    out = tdet.predict(frames[..., ::-1])
    assert [0 if o is None else len(o) for o in out] == list(jv.sum(1))
    np.testing.assert_allclose(tdet.predict_single(frames[0, ..., ::-1]),
                               tr[0][tv[0]], atol=TOL, rtol=1e-6)


def test_quantize_int8_matches_jax(pt):
    """``quantize_int8=True``: the same quantized convs as the JAX detector,
    calibrated alike; from the JAX calibration map, the same int8 operands
    and each quantized conv's output on one input bit for bit. Without it
    ``dtype='int8'`` is pure bf16 (the JAX package's policy). The whole
    quantized network is not held element by element: at these weights a
    one-bin flip from f32 summation order grows through the later layers,
    so it is held to differ from the JAX one by less than quantization
    itself moves the outputs."""
    jdet = JY.YOLOv5(pt, img_size=SIZE, dtype='int8', quantize_int8=True,
                     phase_stem=False)
    tdet = TY.YOLOv5(pt, img_size=SIZE, device='cpu', dtype='int8',
                     quantize_int8=True, phase_stem=False)
    assert tdet.quantized and tdet.dtype == torch.bfloat16
    q = [n for n, m in tdet.net.named_modules() if isinstance(m, QConv2d)]
    jq = sorted(p for i, p in JQ.node_paths(jdet.params).items()
                if 'kernel_q' in _node(jdet.params, p))
    assert q and sorted(q) == jq
    # the same recipe on the folded f32 network, from the JAX map
    folded = JY._fold(JY.state_dict_to_tree(
        JY.load_ultralytics_state_dict(pt)))
    cfg = JY.build_config('yolov5n')
    cal = np.asarray(TQ.smooth_frames((SIZE, SIZE)))
    jamax = JQ.calibrate_cpu(lambda p, v: JY.apply(p, cfg, v, SIZE), folded,
                             [cal])
    jparams = JQ.quantize_folded(folded, jamax)
    net = TL.fold_batch_norm(TC.load_into(TY.YOLOv5Net(cfg),
                                          TY.load_ultralytics_state_dict(pt)))
    net = TC.load_into(net, TC.from_jax_params(folded)).eval()
    amax = TQ.calibrate(net, [torch.from_numpy(cal)],
                        forward=lambda v: net(v, SIZE))
    carried = TC.amax_from_jax(folded, jamax)
    assert set(amax) == set(carried)
    for p, a in amax.items():
        assert abs(a - carried[p]) <= 1e-5 * carried[p]
    TQ.quantize_folded(net, carried)
    rng = np.random.default_rng(4)
    for path in q:
        node, m = _node(jparams, path), net.get_submodule(path)
        kq = np.asarray(node['kernel_q'])
        np.testing.assert_array_equal(
            m.wq.numpy(), np.transpose(kq, (3, 0, 1, 2)).reshape(
                kq.shape[3], -1))
        np.testing.assert_array_equal(m.wscale.numpy(),
                                      np.asarray(node['wscale']))
        assert m.ascale.item() == np.float32(node['ascale'])
        v = rng.uniform(-1, 1, (1, 12, 12, kq.shape[2])).astype(np.float32)
        v *= carried[path]
        with torch.no_grad():
            out = m(torch.from_numpy(v).permute(0, 3, 1, 2))
        # jitted, as the JAX detector runs it: XLA contracts the
        # dequantize and the bias add into one FMA, as the port's epilogue
        np.testing.assert_array_equal(
            out.permute(0, 2, 3, 1).numpy(),
            np.asarray(jax.jit(lambda a, n=node, s=m.stride, d=m.padding:
                               JL.conv2d(a, n, stride=s, padding=d))(v)))
    x = rng.uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        out = net(torch.from_numpy(x), SIZE).numpy()
    ref = np.asarray(JY.apply(jparams, cfg, x, SIZE))
    effect = np.abs(np.asarray(JY.apply(folded, cfg, x, SIZE)) - ref)
    gap = np.abs(out - ref)
    assert gap.max() < effect.max() and gap.mean() < effect.mean() / 2
    bf16 = TY.YOLOv5(pt, img_size=SIZE, device='cpu', dtype='int8')
    assert not bf16.quantized and bf16.dtype == torch.bfloat16
    assert not any(isinstance(m, QConv2d) for m in bf16.net.modules())
    with pytest.raises(ValueError, match='quantize_int8'):
        TY.YOLOv5(pt, device='cpu', quantize_int8=True)


def test_quantize_int8_phase_stem_matches_jax(pt):
    """``quantize_int8=True`` with both packages' default phase stem: each
    calibrates the graph that ships on the phase form of the frame, and
    quantizes the same convs (not ``model.0``, now 3x3 over 12 channels,
    outside the policy) with the same activation scales to 1e-5."""
    jdet = JY.YOLOv5(pt, img_size=SIZE, dtype='int8', quantize_int8=True)
    tdet = TY.YOLOv5(pt, img_size=SIZE, device='cpu', dtype='int8',
                     quantize_int8=True)
    assert jdet.phase_stem and tdet.phase_stem and tdet.quantized
    assert tuple(tdet.net.model['0'].conv.weight.shape) == (16, 12, 3, 3)
    ref = {p: float(_node(jdet.params, p)['ascale'])
           for p in JQ.node_paths(jdet.params).values()
           if 'kernel_q' in _node(jdet.params, p)}
    got = {n: m.ascale.item() for n, m in tdet.net.named_modules()
           if isinstance(m, QConv2d)}
    assert ref and sorted(got) == sorted(ref)
    for k, a in ref.items():
        assert abs(got[k] - a) <= 1e-5 * a, k


def _node(tree, path):
    for part in path.split('.'):
        tree = tree[part]
    return tree


@pytest.fixture(scope='module')
def facades(pt, tmp_path_factory):
    """PoseResNet-18 behind both facades with yolo_version='v5', each given
    the small-img_size yolov5n before its first call."""
    path = str(tmp_path_factory.mktemp('ckpt') / 'pose_resnet_18.pth')
    torch.save(TP.init(18, 17, seed=0).state_dict(), path)
    kw = dict(model_name='PoseResNet', resolution=(64, 64),
              yolo_version='v5', return_heatmaps=True,
              return_bounding_boxes=True)
    port = SimpleHRNet(18, 17, path, device='cpu', **kw)
    ref = JaxSimpleHRNet(18, 17, path, **kw)
    assert isinstance(port.detector, TY.YOLOv5)
    assert port.detector.cfg['variant'] == 'yolov5m'  # 'yolov3' -> yolov5m
    port.detector = TY.YOLOv5(pt, img_size=SIZE, device='cpu',
                              phase_stem=False, max_batch_size=32)
    ref.detector = JY.YOLOv5(pt, img_size=SIZE, phase_stem=False,
                             max_batch_size=32)
    return port, ref


def test_facade_v5_predict_matches_jax(facades):
    port, ref = facades
    frames = _frames(seed=5)
    out = port.predict(frames)
    with jax.enable_x64(True):  # exact PIL crops, as the port's
        expect = ref.predict(frames)
    assert sum(len(p) for p in out[2]) > 0
    for i in range(2):
        _assert_same_people([o[i] for o in out], [e[i] for e in expect])


def test_facade_v5_chunked_stream_matches_jax(facades):
    """One chunked predict_stream (2 frames a launch, a short last chunk)
    through both facades: the same people frame by frame."""
    port, ref = facades
    frames = list(_frames(3, seed=6))
    kw = dict(max_people=3, batch_frames=2)
    out = list(port.predict_stream(frames, **kw))
    with jax.enable_x64(True):
        expect = list(ref.predict_stream(frames, **kw))
    assert len(out) == len(expect) == 3
    assert all(o[2].shape[0] == 3 for o in out)  # 4 found, 3 kept
    for o, e in zip(out, expect):
        _assert_same_people(o, e)


def test_hrnet_v5_stream_modes_agree(pt, tmp_path):
    """HRNet with yolo_version='v5' through ``warmup`` and every
    predict_stream mode (port only): each mode equals the fixed chunked
    stream, whose frames hold the first people of ``predict(frame)``."""
    from simple_hrnet_tpu_torch.models import hrnet as TH
    path = str(tmp_path / 'pose_hrnet_w8.pth')
    torch.save(TH.init(8, 17, seed=0).state_dict(), path)
    port = SimpleHRNet(8, 17, path, resolution=(64, 64), yolo_version='v5',
                       return_heatmaps=True, return_bounding_boxes=True,
                       device='cpu')
    port.detector = TY.YOLOv5(pt, img_size=SIZE, device='cpu')
    sizes = port.warmup((120, 160), batch_sizes=(1,),
                        stream_max_people=('adaptive', 4),
                        stream_batch_frames=(1, 2))
    assert sizes['fused'] > 0
    frames = list(_frames(3, seed=7))
    modes = [dict(), dict(adaptive_slots=True, slot_window=2),
             dict(batch_frames=2, adaptive_slots=True, slot_window=2),
             dict(batch_frames=2, compact_crops=True)]
    ref = list(port.predict_stream(frames, max_people=4, batch_frames=2))
    single = [port.predict(f) for f in frames]
    for o, s in zip(ref, single):
        assert 0 < o[2].shape[0] <= 4
        np.testing.assert_array_equal(o[1], s[1][:4])
        np.testing.assert_allclose(o[0], s[0][:4], atol=1e-4)
    for kw in modes:
        out = list(port.predict_stream(frames, max_people=4, **kw))
        assert len(out) == 3
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o[1], r[1])
            np.testing.assert_allclose(o[0], r[0], atol=1e-4)
            np.testing.assert_allclose(o[2], r[2], atol=1e-4)
