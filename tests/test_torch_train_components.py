"""The port's training components against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages. Tolerances: the
numpy code the port copies (host targets, the three-point affine, the
host NMS tier, the native COCO AP) equal bit for bit, or list for list;
the losses and PCK at 1e-6 relative (the same f32 sums in another order);
the device targets within 1e-6 of the host stamp (exp of the same f32
arguments on two libraries: ulps); the decode within 1e-6 relative, 1e-5
absolute (a few f32 ulps of image coordinates of a few hundred pixels:
the closed-form affine and the einsum round in another order); the
optimizer within 1e-6 per parameter over six steps (parameters of order
1, so a few f32 ulps: the same update formulas, rounded in another
order).
"""

import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn as nn
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.data import target as JT
from simple_hrnet_tpu.ops import affine as JA
from simple_hrnet_tpu.ops import decode as JD
from simple_hrnet_tpu.ops import nms as JN
from simple_hrnet_tpu.train import losses as JLoss
from simple_hrnet_tpu.train import steps as JS
from simple_hrnet_tpu.utils import metrics as JM

from simple_hrnet_tpu_torch.data import target as TT
from simple_hrnet_tpu_torch.ops import affine as TA
from simple_hrnet_tpu_torch.ops import decode as TD
from simple_hrnet_tpu_torch.ops import nms as TN
from simple_hrnet_tpu_torch.train import losses as TLoss
from simple_hrnet_tpu_torch.train import steps as TS
from simple_hrnet_tpu_torch.utils import metrics as TM

FLIP_PAIRS = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
              [15, 16]]
STAT_KEYS = ['AP', 'Ap .5', 'AP .75', 'AP (M)', 'AP (L)',
             'AR', 'AR .5', 'AR .75', 'AR (M)', 'AR (L)']


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    out = rng.standard_normal((3, 16, 12, 17)).astype(np.float32)
    tgt = rng.uniform(0, 1, (3, 16, 12, 17)).astype(np.float32)
    tw = (rng.uniform(0, 1, (3, 17, 1)) > 0.3).astype(np.float32)
    t = [torch.from_numpy(a) for a in (out, tgt, tw)]
    for name in ('JointsMSELoss', 'JointsOHKMMSELoss'):
        for use_tw in (True, False):
            want = float(JLoss.get_loss(name)(out, tgt, tw,
                                              use_target_weight=use_tw))
            got = float(TLoss.get_loss(name)(*t, use_target_weight=use_tw))
            assert got == pytest.approx(want, rel=1e-6), (name, use_tw)
    with pytest.raises(NotImplementedError):
        TLoss.get_loss('L1')


def test_targets_host_equal_device_within_exp_ulps():
    rng = np.random.default_rng(1)
    n, j = 4, 17
    joints = rng.uniform(-30, 100, (n, j, 2)).astype(np.float32)
    vis = (rng.uniform(0, 1, (n, j, 2)) > 0.2).astype(np.float32)
    vis[..., 1] = vis[..., 0]
    hm, img = (16, 24), (64, 96)
    for sigma in (2, 3):
        for i in range(n):
            for jw in (None, TT.COCO_JOINTS_WEIGHT):
                want = JT.generate_target(joints[i], vis[i], hm, img, sigma,
                                          jw)
                got = TT.generate_target(joints[i], vis[i], hm, img, sigma,
                                         jw)
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)
        tgt, w = TT.generate_target_device(torch.from_numpy(joints),
                                           torch.from_numpy(vis), hm, img,
                                           sigma)
        jt, jw_ = JT.generate_target_device(jnp.asarray(joints),
                                            jnp.asarray(vis), hm, img, sigma)
        np.testing.assert_allclose(_np(tgt), np.asarray(jt), atol=1e-6)
        np.testing.assert_array_equal(_np(w), np.asarray(jw_))
        host = np.stack([JT.generate_target(joints[i], vis[i], hm, img,
                                            sigma)[0] for i in range(n)])
        np.testing.assert_allclose(_np(tgt), host.transpose(0, 2, 3, 1),
                                   atol=1e-6)
    np.testing.assert_array_equal(TT.COCO_JOINTS_WEIGHT,
                                  JT.COCO_JOINTS_WEIGHT)
    with pytest.raises(ValueError, match='integer'):
        TT.generate_target_device(torch.from_numpy(joints),
                                  torch.from_numpy(vis), hm, img, 2.5)


def test_pck_and_pckh_match_jax():
    rng = np.random.default_rng(2)
    out = rng.standard_normal((5, 16, 12, 17)).astype(np.float32)
    tgt = rng.uniform(0, 1, (5, 16, 12, 17)).astype(np.float32)
    tgt[0, :, :, 3] = 0.0       # a joint with no target: not evaluable
    tgt[:, :2, :, 5] = 2.0      # peaks on the border row: distance -1
    want = JM.evaluate_pck_accuracy(out, tgt)
    got = TM.evaluate_pck_accuracy(torch.from_numpy(out),
                                   torch.from_numpy(tgt))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)
    preds = rng.uniform(0, 100, (6, 16, 2))
    gts = preds + rng.normal(0, 5, preds.shape)
    vis = rng.uniform(0, 1, (6, 16)) > 0.2
    heads = rng.uniform(10, 30, 6)
    assert TM.evaluate_pckh(preds, gts, vis, heads) == \
        JM.evaluate_pckh(preds, gts, vis, heads)


def test_native_coco_ap_equals_jax_on_fixture_cases():
    spec = importlib.util.spec_from_file_location(
        'dump_fixture', os.path.join(os.path.dirname(__file__), '..',
                                     'scripts',
                                     'dump_pycocotools_fixture.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, gt, dts in mod.build_cases():
        want = JM.coco_eval_native(gt, dts)
        got = TM.coco_eval_native(gt, dts)
        for k in STAT_KEYS:
            assert got[k] == want[k], (name, k, got[k], want[k])
        # without pycocotools the front door is the native evaluator
        assert TM.coco_eval_from_results(gt, dts) == got


def _kpts_db(rng, n):
    """Detections clustered so that OKS suppression has work to do."""
    base = rng.uniform(50, 150, (3, 17, 2))
    db = []
    for i in range(n):
        kp = base[i % 3] + rng.normal(0, 3 + 6 * (i % 2), (17, 2))
        conf = rng.uniform(0, 1, (17, 1))
        db.append({'keypoints': np.concatenate([kp, conf], 1),
                   'score': float(rng.uniform(0.2, 1.0)),
                   'area': float(rng.uniform(2000, 6000))})
    return db


def test_host_nms_tier_keep_lists_equal_jax():
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 40):
        xy = rng.uniform(0, 200, (n, 2)).astype(np.float32)
        wh = rng.uniform(10, 80, (n, 2)).astype(np.float32)
        scores = rng.uniform(0, 1, (n, 1)).astype(np.float32)
        if n > 4:
            scores[3] = scores[4]  # a tie
        dets = np.concatenate([xy, xy + wh, scores], 1)
        for thr in (0.3, 0.5):
            assert TN.nms_numpy(dets, thr) == JN.nms_numpy(dets, thr)
    for n in (0, 5, 24):
        db = _kpts_db(rng, n)
        for thr in (0.5, 0.9):
            for vis in (None, 0.2):
                assert TN.oks_nms(db, thr, in_vis_thre=vis) == \
                    JN.oks_nms(db, thr, in_vis_thre=vis)
            for kind in ('gaussian', 'linear'):
                assert TN.soft_oks_nms(db, thr, rescore_type=kind) == \
                    JN.soft_oks_nms(db, thr, rescore_type=kind)


def test_decode_matches_jax():
    rng = np.random.default_rng(4)
    hm = rng.standard_normal((4, 16, 12, 17)).astype(np.float32)
    hm[0, :, :, 2] = -1.0                     # non-positive peak: zeroed
    hm[1, 0, 5, 4] = 9.0                      # a border peak: no shift
    hm_f = rng.standard_normal(hm.shape).astype(np.float32)
    center = rng.uniform(50, 300, (4, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (4, 2)).astype(np.float32)
    t = torch.from_numpy
    for post in (True, False):
        want = JD.get_final_preds(hm, center, scale, 200.0, post)
        got = TD.get_final_preds(t(hm), center, scale, 200.0, post)
        np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(_np(TD.flip_back(t(hm), FLIP_PAIRS)),
                                  np.asarray(JD.flip_back(hm, FLIP_PAIRS)))
    for shift in (False, True):
        np.testing.assert_array_equal(
            _np(TD.flip_test_average(t(hm), t(hm_f), FLIP_PAIRS, shift)),
            np.asarray(JD.flip_test_average(hm, hm_f, FLIP_PAIRS, shift)))


def test_affine_matrices_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(6):
        c = rng.uniform(0, 400, 2).astype(np.float32)
        s = rng.uniform(0.3, 3.0, 2).astype(np.float32)
        r = float(rng.uniform(-90, 90))
        for inv in (False, True):
            np.testing.assert_array_equal(
                TA.affine_matrix(c, s, r, (48, 64), inv=inv),
                JA.affine_matrix(c, s, r, (48, 64), inv=inv))
            got = TA.affine_matrix_batched(torch.from_numpy(c[None]),
                                           torch.from_numpy(s[None]), r,
                                           (48, 64), inv=inv)[0]
            want = JA.affine_matrix_jax(c, s, r, (48, 64), inv=inv)
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-5, atol=1e-4)
            # the closed form equals the three-point solve
            np.testing.assert_allclose(
                _np(got), JA.affine_matrix(c, s, r, (48, 64), inv=inv),
                rtol=1e-4, atol=1e-3)
        pts = rng.uniform(0, 400, (17, 2))
        m = JA.affine_matrix(c, s, r, (48, 64))
        np.testing.assert_array_equal(TA.apply_affine(pts, m),
                                      JA.apply_affine(pts, m))


class _Toy(nn.Module):
    """A conv weight and a BN, the leaves the optimizer and its decay mask
    treat differently."""

    def __init__(self, kernel, bn):
        super().__init__()
        self.kernel = nn.Parameter(torch.from_numpy(kernel.copy()))
        self.bn = nn.BatchNorm2d(kernel.shape[-1])
        with torch.no_grad():
            self.bn.weight.copy_(torch.from_numpy(bn['scale']))
            self.bn.bias.copy_(torch.from_numpy(bn['bias']))
            self.bn.running_mean.copy_(torch.from_numpy(bn['mean']))
            self.bn.running_var.copy_(torch.from_numpy(bn['var']))


@pytest.mark.parametrize('name,kw', [
    ('SGD', dict(momentum=0.9)),
    ('SGD', dict(momentum=0.9, nesterov=True, weight_decay=1e-2)),
    ('Adam', dict()),
    ('Adam', dict(weight_decay=1e-2)),
], ids=['sgd', 'sgd-nesterov-wd', 'adam', 'adam-wd'])
def test_make_optimizer_matches_optax(name, kw):
    """Six steps at two steps an epoch with milestones at epochs 1 and 2:
    the decayed rate starts at steps 2 and 4 (``count == boundary``), and
    BN running statistics stay untouched under weight decay."""
    rng = np.random.default_rng(6)
    c = 4
    tree = {'conv': {'kernel': rng.standard_normal((3, 3, 2, c))
                     .astype(np.float32)},
            'bn': {'scale': rng.uniform(0.5, 1.5, c).astype(np.float32),
                   'bias': rng.uniform(-0.2, 0.2, c).astype(np.float32),
                   'mean': rng.uniform(-0.5, 0.5, c).astype(np.float32),
                   'var': rng.uniform(0.5, 2.0, c).astype(np.float32)}}
    sched = dict(lr=0.05, lr_decay=True, lr_decay_steps=(1, 2),
                 lr_decay_gamma=0.5, steps_per_epoch=2)
    jopt = JS.make_optimizer(name, **sched, **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    toy = _Toy(tree['conv']['kernel'], tree['bn'])
    topt, tsched = TS.make_optimizer(toy, name, **sched, **kw)
    lrs = []
    for step in range(6):
        g = {'conv': {'kernel': rng.standard_normal((3, 3, 2, c))},
             'bn': {'scale': rng.standard_normal(c),
                    'bias': rng.standard_normal(c),
                    'mean': np.zeros(c), 'var': np.zeros(c)}}
        g = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), g)
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                  jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        toy.kernel.grad = torch.from_numpy(g['conv']['kernel'])
        toy.bn.weight.grad = torch.from_numpy(g['bn']['scale'])
        toy.bn.bias.grad = torch.from_numpy(g['bn']['bias'])
        lrs.append(topt.param_groups[0]['lr'])
        topt.step()
        tsched.step()
        for got, want in ((toy.kernel, jparams['conv']['kernel']),
                          (toy.bn.weight, jparams['bn']['scale']),
                          (toy.bn.bias, jparams['bn']['bias'])):
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
    assert lrs == pytest.approx([0.05, 0.05, 0.025, 0.025, 0.0125, 0.0125])
    np.testing.assert_array_equal(_np(toy.bn.running_mean), tree['bn']['mean'])
    np.testing.assert_array_equal(_np(toy.bn.running_var), tree['bn']['var'])
    np.testing.assert_array_equal(np.asarray(jparams['bn']['mean']),
                                  tree['bn']['mean'])
