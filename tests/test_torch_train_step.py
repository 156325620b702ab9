"""The port's train and eval steps against the JAX package's, on the CPU.

HRNet-W4 at 64x64, batch 4, weights and randomized BN statistics carried
across with ``convert.from_jax_params``; SGD at momentum 0 and lr 1e-2,
whose update is linear in the gradient, so the two packages' rounding
differences stay rounding differences in the parameters. PoseResNet-18 for
Adam over three steps and for bf16. The JAX steps are compiled once each
per module, at XLA's backend optimization level 0 (the same graph; it
halves the compile on a CPU host).

Tolerances: the loss within 1e-5 relative; heatmaps within 2e-4 of their
largest value (the house tolerance); running statistics within 1e-4 of
the leaf's largest value (a reading of 1.2e-5: batch statistics of
activations that carry the forward's rounding; JAX takes the variance as
E[x^2] - m^2, torch in two passes). Parameter updates: the whole
update vector within 3% (readings of 1.3% with two threads, 0.3% with
four), every leaf's within 25% of that leaf's largest update. The f32
backward through batch-statistics BN over the 2x2 branch of four images
is ill-conditioned: threading alone moves single leaves of the port's
update by a few percent, and both packages differ from an f64 step by
more than from each other (the f32 rounding of near-constant channels
loses the same information in both). The per-leaf bound still catches a
leaf left unchanged or stepped with another rate. The port's device targets within
1e-6 of the host stamp (exp ulps) and its image bit for bit the host
one, so its heatmaps equal the host-target step's. Adam over three steps:
the first loss within 1e-5, the next within 2e-3 (readings 2.4e-4 and
6.5e-4), every parameter within 3 lr per step taken (readings 2.0, 4.0
and 5.7e-3 at lr 1e-3). Adam's m / (sqrt(v) + eps) steps a parameter by
about lr whatever its gradient's size, so a gradient that rounds to the
other sign in one package moves that parameter about 2 lr away, and the
moved weights change the next gradients. bf16: the loss within 2% of the
JAX bf16 step's (JAX's own bf16 limit, tests/test_train_components.py).
"""

import functools

import numpy as np
import pytest

import jax
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.data import target as JT
from simple_hrnet_tpu.models import hrnet as JH
from simple_hrnet_tpu.models import poseresnet as JP
from simple_hrnet_tpu.train import losses as JLoss
from simple_hrnet_tpu.train import steps as JS

from simple_hrnet_tpu_torch.models import convert as TC
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.models import poseresnet as TP
from simple_hrnet_tpu_torch.ops.image import INV255_STD, MEAN255
from simple_hrnet_tpu_torch.train import losses as TLoss
from simple_hrnet_tpu_torch.train import steps as TS

from test_torch_models import _randomize_bn

XLA_OPTS = {'xla_backend_optimization_level': 0}
FLIP_PAIRS = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
              [15, 16]]
BN_MOMENTUM = 0.3
RES = 64


def _compiled(fn, *args):
    return fn.lower(*args).compile(compiler_options=XLA_OPTS)


def _batches(n=4, seed=0):
    """A host-target batch and its raw tail (device targets)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n, RES, RES, 3)).astype(np.float32)
    joints = rng.uniform(-4, RES + 4, (n, 17, 2)).astype(np.float32)
    vis = (rng.uniform(0, 1, (n, 17, 1)) > 0.2).astype(np.float32)
    vis = np.repeat(vis, 2, axis=2)
    hm = (RES // 4, RES // 4)
    tw = [JT.generate_target(joints[i], vis[i], hm, (RES, RES)) for i in
          range(n)]
    host = {'image': (raw - MEAN255) * INV255_STD,
            'target': np.stack([t.transpose(1, 2, 0) for t, _ in tw]),
            'target_weight': np.stack([w for _, w in tw])}
    dev = {'image': raw, 'joints': joints, 'joints_vis': vis}
    cfg = {'heatmap_size': hm, 'image_size': (RES, RES), 'heatmap_sigma': 3,
           'joints_weight': None}
    return host, dev, cfg


def _port(tree, build):
    model = build()
    TC.load_into(model, TC.from_jax_params(tree))
    return model


def _leaves(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f'{prefix}{k}|'))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _hrnet_tree(random_bn=False):
    """HRNet-W4's JAX tree; with ``random_bn`` the BN statistics and
    affine terms randomized (the eval step reads them all)."""
    tree = jax.device_get(JH.init(jax.random.PRNGKey(0), c=4,
                                  nof_joints=17))
    return _randomize_bn(tree, np.random.default_rng(0)) if random_bn \
        else tree


@pytest.fixture(scope='module')
def jax_hrnet_step():
    """The JAX HRNet-W4 train step on the host-target batch."""
    tree = _hrnet_tree()
    host, _, _ = _batches()
    opt = JS.make_optimizer('SGD', lr=1e-2, momentum=0.0)
    step = _compiled(JS.make_train_step(JH.apply, JLoss.joints_mse_loss, opt,
                                        donate=False,
                                        bn_momentum=BN_MOMENTUM),
                     tree, opt.init(tree), host)
    p1, _, loss, out = step(tree, opt.init(tree), host)
    return _leaves(jax.device_get(p1)), float(loss), np.asarray(out)


def _port_hrnet_step(mode):
    host, dev, cfg = _batches()
    model = _port(_hrnet_tree(), lambda: TH.HRNet(4, 17))
    opt, sched = TS.make_optimizer(model, 'SGD', lr=1e-2, momentum=0.0)
    step = TS.make_train_step(
        model, TLoss.joints_mse_loss, opt, sched,
        device_targets=cfg if mode == 'device' else None,
        bn_momentum=BN_MOMENTUM)
    res = step(dev if mode == 'device' else host)
    return model, res, host


def _check_step(model, loss, out, jax_step, tree):
    p1, jloss, jout = jax_step
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    np.testing.assert_allclose(out.numpy(), jout,
                               atol=2e-4 * np.abs(jout).max())
    p0 = _leaves(tree)
    got = _leaves(TC.to_jax_params(model.state_dict()))
    assert got.keys() == p1.keys()
    d_got, d_want = [], []
    for k, want in p1.items():
        if k.endswith(('|mean', '|var')):
            np.testing.assert_allclose(got[k], want,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=k)
            continue
        d_got.append(got[k] - p0[k])
        d_want.append(want - p0[k])
        assert np.abs(d_got[-1] - d_want[-1]).max() <= \
            0.25 * np.abs(d_want[-1]).max() + 1e-9, k
    d_got, d_want = (np.concatenate([d.ravel() for d in ds])
                     for ds in (d_got, d_want))
    assert np.linalg.norm(d_got - d_want) <= 3e-2 * np.linalg.norm(d_want)


def test_hrnet_train_step_host_targets(jax_hrnet_step):
    model, (loss, out), _ = _port_hrnet_step('host')
    assert all(m.momentum == BN_MOMENTUM for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d))
    # (the running statistics are held to JAX's at momentum 0.3: at the
    # default 0.1 they would differ by two thirds of their move)
    _check_step(model, loss, out, jax_hrnet_step, _hrnet_tree())


def test_hrnet_train_step_device_targets(jax_hrnet_step):
    model, (loss, out, target), host = _port_hrnet_step('device')
    np.testing.assert_allclose(target.numpy(), host['target'], atol=1e-6)
    _check_step(model, loss, out, jax_hrnet_step, _hrnet_tree())
    _, (_, out_host), _ = _port_hrnet_step('host')
    # the on-device normalize is the host one bit for bit
    np.testing.assert_array_equal(out.numpy(), out_host.numpy())


def test_eval_step_flip_test():
    tree = _hrnet_tree(random_bn=True)
    host, dev, cfg = _batches(3, seed=1)
    with jax.disable_jit():
        jloss, jout = JS.make_eval_step(JH.apply, JLoss.joints_mse_loss,
                                        flip_pairs=FLIP_PAIRS)(tree, host)
    jout = np.asarray(jout)
    model = _port(tree, lambda: TH.HRNet(4, 17))
    for batch, kw in ((host, {}), (dev, {'device_targets': cfg})):
        res = TS.make_eval_step(model, TLoss.joints_mse_loss,
                                flip_pairs=FLIP_PAIRS, **kw)(batch)
        assert not model.training
        assert float(res[0]) == pytest.approx(float(jloss), rel=1e-5)
        np.testing.assert_allclose(res[1].numpy(), jout,
                                   atol=2e-4 * np.abs(jout).max())
    # eval reads the running statistics and leaves them as they were
    np.testing.assert_array_equal(model.state_dict()['bn1.running_var']
                                  .numpy(), tree['bn1']['var'])


@functools.lru_cache(maxsize=None)
def _resnet18_tree():
    return _randomize_bn(JP.init(jax.random.PRNGKey(1), resnet_size=18,
                                 nof_joints=17), np.random.default_rng(1))


def _jax_resnet18(params, x, **kw):
    return JP.apply(params, x, resnet_size=18, **kw)


def test_poseresnet_adam_three_steps():
    tree = _resnet18_tree()
    batches = [_batches(4, seed=s)[0] for s in range(3)]
    lr = 1e-3
    jopt = JS.make_optimizer('Adam', lr=lr)
    jstep = _compiled(JS.make_train_step(_jax_resnet18,
                                         JLoss.joints_mse_loss, jopt,
                                         donate=False),
                      tree, jopt.init(tree), batches[0])
    model = _port(tree, lambda: TP.PoseResNet(18, 17))
    opt, sched = TS.make_optimizer(model, 'Adam', lr=lr)
    step = TS.make_train_step(model, TLoss.joints_mse_loss, opt, sched)
    params, state = tree, jopt.init(tree)
    for k, batch in enumerate(batches, start=1):
        params, state, jloss, _ = jstep(params, state, batch)
        loss, _ = step(batch)
        want = _leaves(jax.device_get(params))
        got = _leaves(TC.to_jax_params(model.state_dict()))
        # step 1 runs the same weights; later steps start from weights
        # that Adam's sign flips moved
        assert float(loss) == pytest.approx(float(jloss),
                                            rel=1e-5 if k == 1 else 2e-3)
        for key, w in want.items():
            if not key.endswith(('|mean', '|var')):
                assert np.abs(got[key] - w).max() <= 3 * lr * k, key


def test_poseresnet_bf16_step_within_jax_bf16_limit():
    tree = _resnet18_tree()
    host, _, _ = _batches(4, seed=5)
    jopt = JS.make_optimizer('SGD', lr=1e-3, momentum=0.9)
    jstep = _compiled(JS.make_train_step(_jax_resnet18,
                                         JLoss.joints_mse_loss, jopt,
                                         donate=False, dtype='bfloat16'),
                      tree, jopt.init(tree), host)
    _, _, jloss, _ = jstep(tree, jopt.init(tree), host)
    model = _port(tree, lambda: TP.PoseResNet(18, 17))
    opt, sched = TS.make_optimizer(model, 'SGD', lr=1e-3, momentum=0.9)
    loss, out = TS.make_train_step(model, TLoss.joints_mse_loss, opt, sched,
                                   dtype='bfloat16')(host)
    assert abs(float(loss) - float(jloss)) / abs(float(jloss)) < 2e-2
    assert out.dtype == torch.float32
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for p in model.parameters())
    assert model.compute_dtype == torch.float32
    with pytest.raises(ValueError, match='serving-only'):
        TS.make_train_step(model, TLoss.joints_mse_loss, opt, dtype='int8')
