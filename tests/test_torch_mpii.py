"""The port's MPII training stack (``data/mpii.py``, ``MPIITrain``,
``cli/train_mpii.py``) against the JAX package's, on the CPU, over seeded
``annot/train.json`` files and cv2-written images (the writer of
tests/test_mpii.py, copied: a test module is not imported).

``MPIIDataset`` items (image, targets, weights and every metadata entry,
``index`` included), the records' center/scale arithmetic and head sizes
equal the JAX package's bit for bit under the same ``random`` seed. PCKh,
positional and index-matched, equals JAX's. One ``MPIITrain`` epoch of
HRNet-W4 at 64x64 in f32 (two train steps of 2 with augmentation,
flip-test validation, checkpoints) from the same weights, at SGD lr 0:
the epoch's train and val losses within 1e-5 relative (the train-step
tolerance of tests/test_torch_train_step.py), PCK within 1e-6, the same
PCKh table. At lr 0 the loop, the data order, the running statistics
(which still move) and the metrics must agree to rounding; the update's
parity is tests/test_torch_train_step.py's (HRNet-W4's f32 backward is
ill-conditioned: at lr 1e-3 the losses after the first update differ by
2.7e-4 in training and 4.3e-3 in validation, the update's own
difference). The ``train_mpii`` parser carries every JAX flag with the
JAX defaults and trains one epoch.
"""

import json
import os
import random

import numpy as np
import pytest

import jax
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.cli import train_mpii as JCli
from simple_hrnet_tpu.data import mpii as JM
from simple_hrnet_tpu.models import hrnet as JH
from simple_hrnet_tpu.train import trainer as JTrainer
from simple_hrnet_tpu.utils import checkpoint as JCkpt

from simple_hrnet_tpu_torch.cli import train_mpii as TCli
from simple_hrnet_tpu_torch.data import mpii as TM
from simple_hrnet_tpu_torch.train import trainer as TTrainer

RES = 64


def _make_mpii_root(tmp_path, n=3, headbox=False):
    """tests/test_mpii.py's writer: ``n`` seeded 200x160 images and their
    annotations; with ``headbox`` every other record carries one."""
    import cv2

    root = tmp_path / 'MPII'
    (root / 'annot').mkdir(parents=True)
    (root / 'images').mkdir()
    rng = np.random.default_rng(0)
    annots = []
    for i in range(n):
        name = f'im{i}.jpg'
        img = rng.uniform(0, 255, (200, 160, 3)).astype(np.uint8)
        cv2.imwrite(str(root / 'images' / name), img)
        joints = rng.uniform(40, 120, (16, 2)).round(1)
        annots.append({
            'image': name,
            'center': [80.0, 100.0],
            'scale': 0.6,
            'joints': joints.tolist(),
            'joints_vis': [1] * 16,
        })
        if headbox and i % 2:
            annots[-1]['headbox'] = [60.0, 30.0, 90.0, 70.0]
    with open(root / 'annot' / 'train.json', 'w') as f:
        json.dump(annots, f)
    return str(root)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return _make_mpii_root(tmp_path_factory.mktemp('mpii'), n=4,
                           headbox=True)


def _ds(mod, root, **kw):
    base = dict(root_path=root, data_version='train', image_width=RES,
                image_height=RES)
    base.update(kw)
    return mod.MPIIDataset(**base)


def test_items_match_jax(root):
    for kw in (dict(is_train=True, half_body_prob=0.5),
               dict(is_train=True, device_targets=True),
               dict(is_train=False)):
        jds, tds = _ds(JM, root, **kw), _ds(TM, root, **kw)
        assert len(tds) == len(jds) == 4
        assert tds.flip_pairs == jds.flip_pairs
        for i in range(len(jds)):
            random.seed(10 + i)
            want = jds[i]
            random.seed(10 + i)
            got = tds[i]
            for a, b in zip(got[:3], want[:3]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert got[3].keys() == want[3].keys() and got[3]['index'] == i
            for k, v in want[3].items():
                if v is None:
                    assert got[3][k] is None, k
                    continue
                np.testing.assert_array_equal(np.asarray(got[3][k]),
                                              np.asarray(v), err_msg=k)


def test_records_and_head_sizes_match_jax(root):
    jds, tds = _ds(JM, root), _ds(TM, root)
    for a, b in zip(tds.data, jds.data):
        np.testing.assert_array_equal(a['center'], b['center'])
        np.testing.assert_array_equal(a['scale'], b['scale'])
        assert tds.head_size(a) == jds.head_size(b)
    np.testing.assert_allclose(tds.data[0]['center'],
                               [80.0 - 1, 100.0 + 15 * 0.6 - 1])
    np.testing.assert_allclose(tds.data[0]['scale'], [0.75, 0.75])


def test_pckh_matches_jax(root, tmp_path):
    jds, tds = _ds(JM, root, is_train=False), _ds(TM, root, is_train=False)
    rng = np.random.default_rng(1)
    preds = np.stack([np.concatenate(
        [d['joints'] + rng.normal(0, 4, (16, 2)), np.ones((16, 1))], axis=1)
        for d in tds.data])
    perm = np.asarray([2, 0, 3, 1])
    for p, idx in ((preds, None), (preds[perm], perm), (preds[perm], None)):
        got = tds.evaluate_overall_accuracy(p, None, None,
                                            str(tmp_path / 't'), indices=idx)
        want = jds.evaluate_overall_accuracy(p, None, None,
                                             str(tmp_path / 'j'),
                                             indices=idx)
        assert got == want
    assert os.path.exists(tmp_path / 't' / 'pckh_train_0.0.json')
    # index matching restores the unshuffled score
    assert tds.evaluate_overall_accuracy(
        preds[perm], None, None, str(tmp_path / 't'), indices=perm)[1] == \
        tds.evaluate_overall_accuracy(preds, None, None,
                                      str(tmp_path / 't'))[1]


@pytest.fixture(scope='module')
def epochs(root, tmp_path_factory):
    """One MPIITrain epoch of each package from the same weights."""
    tmp = tmp_path_factory.mktemp('mpii_epochs')
    tree = jax.device_get(JH.init(jax.random.PRNGKey(5), c=4, nof_joints=16))
    pre = str(tmp / 'pre.npz')
    JCkpt.save(pre, tree)
    runs = {}
    for name, mod, trainer, extra in (('jax', JM, JTrainer, {}),
                                      ('port', TM, TTrainer,
                                       {'device': 'cpu'})):
        random.seed(0)
        t = trainer.MPIITrain(
            exp_name='mini', ds_train=_ds(mod, root, is_train=True,
                                          rotate_prob=0.0),
            ds_val=_ds(mod, root, is_train=False), epochs=1, batch_size=2,
            num_workers=1, lr=0.0, lr_decay=False, optimizer='SGD',
            momentum=0.9, log_path=str(tmp / name), use_tensorboard=False,
            model_c=4, model_nof_joints=16, flip_test_images=True,
            model_name='HRNet', pretrained_weight_path=pre, **extra)
        t.run()
        runs[name] = t
    return runs


def test_mpii_train_epoch_matches_jax(epochs):
    j, t = epochs['jax'], epochs['port']
    assert t.len_dl_train == 2
    for attr in ('mean_loss_train', 'mean_loss_val'):
        assert getattr(t, attr) == pytest.approx(getattr(j, attr), rel=1e-5)
    for attr in ('mean_acc_train', 'mean_acc_val'):
        assert getattr(t, attr) == pytest.approx(getattr(j, attr), abs=1e-6)
    assert t.val_accs == j.val_accs and t.mean_mAP_val == j.mean_mAP_val
    assert t._indices == j._indices == [0, 1, 2, 3]  # the val pass, in order
    for f in ('params_last.npz', 'params_best_mAP.npz', 'checkpoint_last'):
        assert os.path.exists(os.path.join(t.log_path, f)), f


def test_train_mpii_parser_and_one_epoch(root, tmp_path):
    jp, tp = JCli.build_parser(), TCli.build_parser()
    jflags = {a.dest: a.default for a in jp._actions}
    tflags = {a.dest: a.default for a in tp._actions}
    assert jflags.keys() <= tflags.keys()
    assert {k: tflags[k] for k in jflags} == jflags
    assert (tflags['model_c'], tflags['model_nof_joints'],
            tflags['image_resolution'], tflags['epochs']) == \
        (32, 16, '(256, 256)', 210)
    args = tp.parse_args([
        '-n', 'cli', '-e', '1', '-b', '2', '-w', '1', '--model_c', '4',
        '-r', f'({RES}, {RES})', '--mpii_root_path', root, '--log_path',
        str(tmp_path), '-u', '--device', 'cpu'])
    os.makedirs(os.path.join(root, 'annot'), exist_ok=True)
    valid = os.path.join(root, 'annot', 'valid.json')
    if not os.path.exists(valid):
        with open(os.path.join(root, 'annot', 'train.json')) as f, \
                open(valid, 'w') as g:
            g.write(f.read())
    t = TCli.main(**vars(args))
    assert np.isfinite(t.mean_loss_train) and np.isfinite(t.mean_loss_val)
    assert 0.0 <= t.mean_mAP_val <= 1.0
