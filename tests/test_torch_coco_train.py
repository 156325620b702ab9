"""The port's COCO training stack against the JAX package's, on the CPU,
over a 4-image mini COCO written with cv2 (tests/test_coco_pipeline.py).

``COCODataset`` items and the loader's order equal the JAX package's bit
for bit under the same ``random`` seed. One ``COCOTrain`` epoch of
PoseResNet-18 at 64x64 (SGD, momentum 0.9, flip test) from the same
weights: epoch losses within 1e-5 relative, PCK within 1e-6, the same
COCO AP, and the results files' keypoints within 1e-3 pixels and scores
within 1e-5 (heatmaps that agree to f32 rounding, decoded through the
same subpixel rule). Two epochs straight equal one epoch plus a resume
from ``checkpoint_last`` bit for bit. The port's ``params_last.npz``
drives the JAX package's ``Test`` to the port's ``Test`` numbers (loss
within 1e-5 relative, heatmaps within 2e-4 of max).
"""

import json
import os
import random
import shutil

import numpy as np
import pytest
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

import jax

from simple_hrnet_tpu.cli import train_coco as JCli
from simple_hrnet_tpu.data import coco as JCOCO
from simple_hrnet_tpu.data import loader as JLoader
from simple_hrnet_tpu.models import poseresnet as JP
from simple_hrnet_tpu.train import test as JTest
from simple_hrnet_tpu.train import trainer as JTrainer
from simple_hrnet_tpu.utils import checkpoint as JCkpt

from simple_hrnet_tpu_torch.cli import train_coco as TCli
from simple_hrnet_tpu_torch.data import coco as TCOCO
from simple_hrnet_tpu_torch.data import loader as TLoader
from simple_hrnet_tpu_torch.models import convert as TC
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.parallel import make_mesh
from simple_hrnet_tpu_torch.train.test import Test as TTest
from simple_hrnet_tpu_torch.train import trainer as TTrainer
from simple_hrnet_tpu_torch.utils import checkpoint as TCkpt

from test_coco_pipeline import mini_coco  # noqa: F401 (fixture)
from test_torch_models import _randomize_bn

RES = 64


@pytest.fixture(scope='module')
def coco_root(mini_coco, tmp_path_factory):  # noqa: F811
    """The mini COCO with a val2017 split (the same images)."""
    root = str(tmp_path_factory.mktemp('coco_tv') / 'coco')
    shutil.copytree(mini_coco, root)
    shutil.copytree(os.path.join(root, 'train2017'),
                    os.path.join(root, 'val2017'))
    ann = os.path.join(root, 'annotations', 'person_keypoints_%s.json')
    shutil.copy(ann % 'train2017', ann % 'val2017')
    return root


def _ds(mod, root, **kw):
    base = dict(root_path=root, data_version='train2017', image_width=RES,
                image_height=RES)
    base.update(kw)
    return mod.COCODataset(**base)


def test_dataset_items_match_jax(coco_root):
    for kw in (dict(is_train=True, half_body_prob=0.5),
               dict(is_train=True, device_targets=True),
               dict(is_train=False),
               dict(is_train=False, device_targets=True)):
        jds, tds = _ds(JCOCO, coco_root, **kw), _ds(TCOCO, coco_root, **kw)
        assert len(tds) == len(jds) == 8
        assert tds.flip_pairs == jds.flip_pairs
        for i in range(len(jds)):
            random.seed(100 + i)
            want = jds[i]
            random.seed(100 + i)
            got = tds[i]
            for a, b in zip(got[:3], want[:3]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert got[3].keys() == want[3].keys()
            for k, v in want[3].items():
                np.testing.assert_array_equal(np.asarray(got[3][k]),
                                              np.asarray(v), err_msg=k)


def test_loader_order_matches_jax(coco_root):
    class Index:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return np.int64(i)

    for drop_last in (False, True):
        jdl = JLoader.DataLoader(Index(), batch_size=3, shuffle=True,
                                 seed=7, drop_last=drop_last, num_workers=2)
        tdl = TLoader.DataLoader(Index(), batch_size=3, shuffle=True,
                                 seed=7, drop_last=drop_last, num_workers=2)
        assert len(tdl) == len(jdl)
        epochs = [[b.tolist() for b in jdl] for _ in range(3)]
        assert [[b.tolist() for b in tdl] for _ in range(3)] == epochs
        tdl.set_epoch(1)  # what a resumed run asks for
        assert [b.tolist() for b in tdl] == epochs[1]
    jds, tds = _ds(JCOCO, coco_root, is_train=False), \
        _ds(TCOCO, coco_root, is_train=False)
    got = list(TLoader.DataLoader(tds, batch_size=3, shuffle=True, seed=3,
                                  num_workers=2))
    want = list(JLoader.DataLoader(jds, batch_size=3, shuffle=True, seed=3,
                                   num_workers=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g[:3], w[:3]):
            np.testing.assert_array_equal(a, b)
        assert g[3]['imgPath'] == w[3]['imgPath']


def _trainer_kw(root, log, **over):
    kw = dict(exp_name='mini', epochs=1, batch_size=4, num_workers=1,
              lr=1e-3, lr_decay=False, optimizer='SGD', momentum=0.9,
              log_path=log, use_tensorboard=False, model_c=18,
              model_nof_joints=17, flip_test_images=True,
              model_name='PoseResNet')
    kw.update(over)
    return kw


@pytest.fixture(scope='module')
def epochs(coco_root, tmp_path_factory):
    """One COCOTrain epoch of each package from the same weights."""
    tmp = tmp_path_factory.mktemp('epochs')
    tree = _randomize_bn(jax.device_get(JP.init(jax.random.PRNGKey(3),
                                                resnet_size=18,
                                                nof_joints=17)),
                         np.random.default_rng(3))
    pre = str(tmp / 'pre.npz')
    JCkpt.save(pre, tree)
    runs = {}
    for name, coco, trainer, extra in (
            ('jax', JCOCO, JTrainer, {}),
            ('port', TCOCO, TTrainer, {'device': 'cpu'})):
        ds = _ds(coco, coco_root, is_train=True)
        ds_val = _ds(coco, coco_root, is_train=False)
        random.seed(0)
        t = trainer.COCOTrain(ds_train=ds, ds_val=ds_val,
                              **_trainer_kw(coco_root, str(tmp / name),
                                            pretrained_weight_path=pre,
                                            **extra))
        t.run()
        runs[name] = t
    return runs


def test_coco_train_epoch_matches_jax(epochs):
    j, t = epochs['jax'], epochs['port']
    for attr in ('mean_loss_train', 'mean_loss_val'):
        assert getattr(t, attr) == pytest.approx(getattr(j, attr), rel=1e-5)
    for attr in ('mean_acc_train', 'mean_acc_val'):
        assert getattr(t, attr) == pytest.approx(getattr(j, attr), abs=1e-6)
    assert t.mean_mAP_val == j.mean_mAP_val
    assert t.val_accs == j.val_accs
    res = {}
    for name, tr in epochs.items():
        # the val pass wrote it last (rank 0.: the reference's float)
        with open(os.path.join(tr.log_path, 'results',
                               'keypoints_train2017_results_0.0.json')) as f:
            res[name] = json.load(f)
    assert len(res['port']) == len(res['jax']) == 8
    for g, w in zip(res['port'], res['jax']):
        assert g['image_id'] == w['image_id']
        kg, kw = np.reshape(g['keypoints'], (17, 3)), \
            np.reshape(w['keypoints'], (17, 3))
        np.testing.assert_allclose(kg[:, :2], kw[:, :2], atol=1e-3)
        np.testing.assert_allclose(kg[:, 2], kw[:, 2], atol=1e-5)
        assert g['score'] == pytest.approx(w['score'], abs=1e-5)
    for f in ('params_last.npz', 'params_best_loss.npz',
              'params_best_acc.npz', 'params_best_mAP.npz', 'checkpoint_last',
              'parameters.txt'):
        assert os.path.exists(os.path.join(t.log_path, f)), f
    with open(os.path.join(t.log_path, 'checkpoint_last',
                           'config.json')) as f:
        cfg = json.load(f)
    assert cfg['epoch'] == 1 and cfg['best_loss'] == t.best_loss


def test_port_npz_drives_jax_test(epochs, coco_root):
    t = epochs['port']
    npz = os.path.join(t.log_path, 'params_last.npz')
    ds_t, ds_j = _ds(TCOCO, coco_root, is_train=False), \
        _ds(JCOCO, coco_root, is_train=False)
    port = TTest(ds_t, batch_size=4, num_workers=1, checkpoint_path=npz,
                 model_c=18, model_name='PoseResNet', device='cpu')
    ref = JTest.Test(ds_j, batch_size=4, num_workers=1, checkpoint_path=npz,
                     model_c=18, model_name='PoseResNet')
    loss, acc = port.run()
    jloss, jacc = ref.run()
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert acc == pytest.approx(jacc, abs=1e-6)
    # the trainer's last validation ran the same weights on the same items
    assert loss == pytest.approx(t.mean_loss_val, rel=1e-6)
    image, target, tw, _ = TLoader.default_collate([ds_t[i]
                                                    for i in range(4)])
    batch = {'image': image, 'target': target, 'target_weight': tw}
    _, want = ref._eval_step(ref.params, batch)
    _, got = port._eval_step(batch)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-4 * np.abs(want).max())


def test_resume_from_checkpoint_last_is_bitwise(coco_root, tmp_path):
    """Two epochs straight against one plus a resume: Adam with the LR
    decayed at epoch 1, so the optimizer's moments and the scheduler's
    count must both come back."""
    def train(log, epochs, **kw):
        ds = _ds(TCOCO, coco_root, is_train=False)
        t = TTrainer.COCOTrain(ds_train=ds, ds_val=ds, **_trainer_kw(
            coco_root, str(tmp_path / log), epochs=epochs, optimizer='Adam',
            lr_decay=True, lr_decay_steps=(1,), model_name='HRNet',
            model_c=4, model_bn_momentum=0.2, device='cpu', **kw))
        t.run()
        return t

    straight = train('a', 2)
    first = train('b', 1)
    resumed = train('c', 2, resume_dir=first.log_path)
    assert resumed.epoch == 1 and straight.epoch == 1
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i, st in sa['state'].items():
        for k, v in st.items():
            assert torch.equal(v, sb['state'][i][k]), (i, k)
    assert resumed.optimizer.param_groups[0]['lr'] == \
        straight.optimizer.param_groups[0]['lr'] == pytest.approx(1e-4)
    assert resumed.mean_loss_train == straight.mean_loss_train
    assert (resumed.best_loss, resumed.best_acc, resumed.best_mAP) == \
        (straight.best_loss, straight.best_acc, straight.best_mAP)
    # save_train keeps the newest three steps; load_train reads the newest
    step, state, cfg = TCkpt.load_train(os.path.join(resumed.log_path,
                                                     'checkpoint_last'))
    assert step == 2 and cfg['epoch'] == 2 and state['epoch'] == 2
    for k in a:
        assert torch.equal(state['model'][k], a[k]), k


def test_train_coco_cli_one_epoch(coco_root, tmp_path):
    jflags = {a.dest for a in JCli.build_parser()._actions}
    assert jflags <= {a.dest for a in TCli.build_parser()._actions}
    args = TCli.build_parser().parse_args([
        '-n', 'cli', '-e', '1', '-b', '4', '-w', '1', '--model_c', '4',
        '-r', f'({RES}, {RES})', '--coco_root_path', coco_root,
        '--log_path', str(tmp_path), '-u', '--device', 'cpu'])
    t = TCli.main(**vars(args))
    assert np.isfinite(t.mean_loss_train) and np.isfinite(t.mean_loss_val)
    assert 0.0 <= t.mean_mAP_val <= 1.0
    assert os.path.exists(os.path.join(t.log_path, 'params_last.npz'))


def test_unported_options_raise(coco_root, tmp_path):
    """``use_grouped_trunk`` with a batch its group (4 at W4) does not
    divide raises the JAX trainer's ``ValueError``, word for word; a
    training mesh over two local devices and ``--n_devices 2`` without a
    launcher raise, naming the one-process-a-device launch line."""
    ds = _ds(TCOCO, coco_root, is_train=False)
    kw = _trainer_kw(coco_root, str(tmp_path), device='cpu')
    with pytest.raises(ValueError, match='torchrun --nproc_per_node=2'):
        TTrainer.Train(ds_train=ds, ds_val=ds,
                       **dict(kw, mesh=make_mesh(2, device='cpu')))
    grouped = dict(kw, model_name='HRNet', model_c=4, batch_size=6,
                   use_grouped_trunk=True)
    with pytest.raises(ValueError) as want:
        JTrainer.Train(ds_train=ds, ds_val=ds, **{
            k: v for k, v in grouped.items() if k != 'device'})
    with pytest.raises(ValueError) as got:
        TTrainer.Train(ds_train=ds, ds_val=ds, **grouped)
    assert str(got.value) == str(want.value) == (
        'use_grouped_trunk needs batch_size divisible by 4 (got 6)')
    with pytest.raises(ValueError, match='torchrun --nproc_per_node=2'):
        TCli.main('x', n_devices=2, coco_root_path=coco_root)
    if not torch.cuda.is_available():
        # the card is the default; the host only when asked
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TTrainer.Train(ds_train=ds, ds_val=ds,
                           **dict(kw, device=None))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TTest(ds, model_c=4)


def test_grouped_trunk_step_matches_jax_grouped_forward(tmp_path):
    """One step of ``Train(use_grouped_trunk=True)`` (HRNet-W4, 64x64,
    batch 4, group 4, Adam) from seeded weights: its train-mode
    heatmaps and every BN's batch mean and variance against the JAX
    package's grouped trunk (``train/grouped.py`` ``make_apply``) on the
    same batch, at ``tests/test_train_grouped.py``'s tolerances (heatmaps
    and variances atol 1e-3, rtol 1e-4; means atol 1e-4), the loss within
    1e-4 relative, and the weights stepped. The JAX grouped step itself
    compiles for about 100 s on a CPU host, so its forward alone is
    compiled, at XLA's backend optimization level 0 (the same graph)."""
    from simple_hrnet_tpu.train import grouped as JG
    from simple_hrnet_tpu.train import losses as JLoss

    net = TH.init(4, 17, seed=5)
    pre = str(tmp_path / 'pre.pth')
    torch.save(net.state_dict(), pre)
    tree = TC.to_jax_params(net.state_dict())
    rng = np.random.default_rng(5)
    batch = {'image': rng.standard_normal((4, RES, RES, 3)).astype(
                 np.float32),
             'target': rng.uniform(0, 1, (4, RES // 4, RES // 4, 17)
                                   ).astype(np.float32),
             'target_weight': np.ones((4, 17, 1), np.float32)}
    def grouped(params, image):
        stats = {}
        return JG.make_apply(4)(params, image, train=True, stats=stats), \
            stats

    jout, jstats = jax.jit(grouped).lower(tree, batch['image']).compile(
        compiler_options={'xla_backend_optimization_level': 0})(
            tree, batch['image'])
    jloss = float(JLoss.joints_mse_loss(jout, batch['target'],
                                        batch['target_weight']))

    t = TTrainer.Train(ds_train=[0] * 4, ds_val=[0] * 4, **_trainer_kw(
        None, str(tmp_path), model_name='HRNet', model_c=4, optimizer='Adam',
        pretrained_weight_path=pre, use_grouped_trunk=True, device='cpu'))
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    stats, hooks = {}, []

    def record(name):
        def hook(_m, args):
            x = args[0].detach().float()
            stats[name] = (x.mean(dim=(0, 2, 3)),
                           x.var(dim=(0, 2, 3), unbiased=False))
        return hook

    for name, m in t.model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_pre_hook(record(name)))
    loss, out = t._train_step(batch)
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-3,
                               rtol=1e-4)
    assert float(loss) == pytest.approx(jloss, rel=1e-4)
    assert stats.keys() == jstats.keys()
    for name, (mean, var) in stats.items():
        jmean, jvar, _ = jstats[name]
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean),
                                   atol=1e-4, err_msg=name)
        np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-3,
                                   rtol=1e-4, err_msg=name)
    after = t.model.state_dict()
    assert not torch.equal(after['final_layer.weight'],
                           before['final_layer.weight'])
