"""The port's data parallelism (``parallel/``) against the JAX package's,
on the CPU.

``make_mesh`` sizes and errors, ``shard_batch`` and ``replicate``. A
one-process train step of HRNet-W4 at 64x64 on 8 rows under a one-rank
gloo group, with ``GlobalBatchNorm2d`` swapped in (a one-rank step keeps
``BatchNorm2d`` by itself) and ``DistributedDataParallel`` over the group,
against the JAX package's 8-way sharded step on its 8 virtual CPU
devices (tests/test_parallel.py:18-61: SGD lr 1e-2, momentum 0.9; weights
carried by ``convert.from_jax_params``; compiled at XLA's backend
optimization level 0, as tests/test_torch_train_step.py compiles its
steps), at that test's tolerances: the
loss within 1e-5 relative, heatmaps within 5e-3 (absolute and relative),
updated parameters within 1e-2 absolute plus 5e-3 relative. The facade
on a two-replica CPU mesh with a stub detector against the JAX facade on
its 8-device mesh (tests/test_parallel.py:110-150) and against the port
without a mesh: f32 keypoints within 2e-4 of JAX's, and within 1e-6 of
the meshless port's (the replicas pose crop batches of other sizes, and
the CPU's convs round a batch's rows by its size). The chunked, compact
and adaptive streams on the mesh equal the meshless facade's within 1e-6
alike. ``Test``
on the mesh pads its last batch to a multiple of the mesh and drops the
padding: its loss and accuracy equal the meshless ``Test``'s within 1e-6
relative.
"""

import socket

import numpy as np
import pytest

import jax
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu import SimpleHRNet as JaxSimpleHRNet
from simple_hrnet_tpu import api as JA
from simple_hrnet_tpu.models import hrnet as JH
from simple_hrnet_tpu.parallel import make_mesh as jax_make_mesh
from simple_hrnet_tpu.parallel import replicate as jax_replicate
from simple_hrnet_tpu.parallel import shard_batch as jax_shard_batch
from simple_hrnet_tpu.train import losses as JLoss
from simple_hrnet_tpu.train import steps as JS
from simple_hrnet_tpu.utils import checkpoint as jckpt

from simple_hrnet_tpu_torch import SimpleHRNet
from simple_hrnet_tpu_torch import api as TA
from simple_hrnet_tpu_torch.data.base import HumanPoseEstimationDataset
from simple_hrnet_tpu_torch.models import convert as TC
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.parallel import (Mesh, distributed, make_mesh,
                                             replicate, shard_batch)
from simple_hrnet_tpu_torch.parallel import sync_bn
from simple_hrnet_tpu_torch.parallel.sync_bn import GlobalBatchNorm2d
from simple_hrnet_tpu_torch.train import losses as TLoss
from simple_hrnet_tpu_torch.train import steps as TS
from simple_hrnet_tpu_torch.train.test import Test as TTest

from test_torch_api import _JaxStub


def free_port() -> int:
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def one_rank_group():
    """A one-rank gloo process group for the test, destroyed after it."""
    distributed.initialize(f'127.0.0.1:{free_port()}', 1, 0, device='cpu')
    try:
        yield
    finally:
        distributed.shutdown()


def test_make_mesh_sizes_and_errors():
    mesh = make_mesh(2, device='cpu')
    assert mesh.size == mesh.local_size == 2 and mesh.shape == {'data': 2}
    assert mesh.devices == [torch.device('cpu')] * 2
    assert mesh.group is None and mesh.process_count == 1
    assert make_mesh(device='cpu').size == 1
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match='CUDA devices'):
            make_mesh()
    with pytest.raises(ValueError, match='need 512 CUDA devices'):
        make_mesh(512)  # the JAX test's count (tests/test_parallel.py:14)
    with pytest.raises(ValueError):
        Mesh([])


def test_shard_batch_and_replicate():
    mesh = make_mesh(2, device='cpu')
    batch = {'image': np.arange(24, dtype=np.float32).reshape(4, 3, 2),
             'w': torch.arange(4)}
    parts = shard_batch(batch, mesh)
    assert len(parts) == 2
    np.testing.assert_array_equal(parts[1]['image'].numpy(),
                                  batch['image'][2:])
    assert parts[0]['w'].tolist() == [0, 1]
    with pytest.raises(ValueError, match='does not divide'):
        shard_batch(np.zeros((3, 2)), mesh)
    model = TH.HRNet(4, 5)
    reps = replicate(model, mesh)
    assert reps[0] is model and reps[1] is model  # one device: one object
    sd = replicate({'a': torch.ones(2)}, mesh)
    assert len(sd) == 2 and torch.equal(sd[1]['a'], torch.ones(2))
    # each process's rows of a global batch
    two = Mesh(['cpu'])
    two.__class__ = type('TwoProcess', (Mesh,), {
        'process_count': 2, 'process_index': 1})
    np.testing.assert_array_equal(
        distributed.global_batch(np.arange(6), two), [3, 4, 5])
    with pytest.raises(ValueError, match='does not divide'):
        distributed.global_batch(np.arange(5), two)


def _jax_sharded_step(tree, batch):
    """The JAX package's 8-way data-parallel step (test_parallel.py)."""
    opt = JS.make_optimizer('SGD', lr=1e-2, momentum=0.9)
    mesh = jax_make_mesh(8)
    step = JS.make_train_step(JH.apply, JLoss.joints_mse_loss, opt,
                              mesh=mesh, donate=False)
    args = (jax_replicate(tree, mesh), jax_replicate(opt.init(tree), mesh),
            jax_shard_batch(batch, mesh))
    # XLA's backend optimization level 0: the same graph, half the compile
    step = step.lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': 0})
    p8, _, loss, out = step(*args)
    return jax.device_get(p8), float(loss), np.asarray(out)


def test_global_bn_step_matches_jax_sharded_step(one_rank_group):
    rng = np.random.default_rng(0)
    batch = {
        'image': rng.standard_normal((8, 64, 64, 3)).astype(np.float32),
        'target': rng.uniform(0, 1, (8, 16, 16, 5)).astype(np.float32),
        'target_weight': np.ones((8, 5, 1), np.float32),
    }
    tree = jax.device_get(JH.init(jax.random.PRNGKey(0), c=4, nof_joints=5))
    p8, jloss, jout = _jax_sharded_step(tree, batch)

    model = TH.HRNet(4, 5)
    TC.load_into(model, TC.from_jax_params(tree))
    opt, _ = TS.make_optimizer(model, 'SGD', lr=1e-2, momentum=0.9)
    mesh = make_mesh(device='cpu')
    assert mesh.group is not None and mesh.process_count == 1
    # a one-rank step keeps BatchNorm2d; the global BN is swapped in here
    # so that its all-reduce path runs against the JAX sharded step
    sync_bn.convert(model, mesh.group)
    step = TS.make_train_step(model, TLoss.joints_mse_loss, opt, mesh=mesh)
    assert all(type(m) is GlobalBatchNorm2d for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d))
    loss, out = step(batch)
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    np.testing.assert_allclose(out.numpy(), jout, atol=5e-3, rtol=5e-3)
    got = TC.to_jax_params(model.state_dict())
    flat_got = jax.tree_util.tree_leaves(got)
    flat_want = jax.tree_util.tree_leaves(p8)
    assert len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-2,
                                   rtol=5e-3)
    # a second step runs (DDP's reducer is ready again), and an eval step
    loss2, _ = step(batch)
    assert np.isfinite(float(loss2))
    ev_loss, ev_out = TS.make_eval_step(model, TLoss.joints_mse_loss,
                                        mesh=mesh)(batch)
    assert ev_out.shape == (8, 16, 16, 5) and np.isfinite(float(ev_loss))


@pytest.fixture(scope='module')
def w4(tmp_path_factory):
    """HRNet-W4 (17 joints) as a JAX .npz both facades load."""
    params = JH.init(jax.random.PRNGKey(0), c=4, nof_joints=17)
    path = str(tmp_path_factory.mktemp('w4') / 'w4.npz')
    jckpt.save(path, params)
    return path


BOXES = [np.array([[5, 5, 40, 70], [20, 10, 60, 90], [30, 5, 70, 80]],
                  np.float32)]


def _facade(cls, path, **kw):
    f = cls(4, 17, path, multiperson=False, resolution=(64, 64), **kw)
    f.multiperson = True
    return f


def test_facade_mesh_matches_jax_and_meshless(w4):
    frame = np.random.default_rng(0).uniform(
        0, 255, (100, 120, 3)).astype(np.uint8)
    single = _facade(SimpleHRNet, w4, device='cpu')
    single.detector = _JaxStub(BOXES, torch_out=True)
    meshed = _facade(SimpleHRNet, w4, mesh=make_mesh(2, device='cpu'))
    meshed.detector = _JaxStub(BOXES, torch_out=True)
    assert meshed.device == torch.device('cpu')
    ref = _facade(JaxSimpleHRNet, w4, mesh=jax_make_mesh(8))
    ref.detector = _JaxStub(BOXES, torch_out=False)
    pts1 = single.predict(frame)
    pts2 = meshed.predict(frame)
    with jax.enable_x64(True):  # exact PIL crops, as the port's
        pts8 = ref.predict(frame)
    assert pts2.shape == pts1.shape == pts8.shape == (3, 17, 3)
    np.testing.assert_allclose(pts2, pts1, atol=1e-6, rtol=0)
    np.testing.assert_allclose(pts2, pts8, atol=2e-4, rtol=2e-4)
    # the 3 people went in a bucket of 4: 2 crops a replica
    assert TA._buckets(3, 32, 2) == 4
    # a stack of 2 frames (the batch path clamps its boxes)
    frames = np.stack([frame, frame[::-1].copy()])
    meshed.detector = single.detector = _JaxStub(BOXES * 2, torch_out=True)
    for a, b in zip(meshed.predict(frames), single.predict(frames)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_buckets_with_a_mesh_match_jax():
    for n in range(0, 70):
        for cap in (1, 16, 20, 32):
            for mult in (1, 2, 8):
                assert TA._buckets(n, cap, mult) == JA._buckets(n, cap, mult)


class _FrameStub:
    """Boxes by frame content: a stand-in detector whose rows depend on
    the frames it is given (so a sharded detect must see its own)."""

    def detect_padded(self, frames_rgb):
        n = frames_rgb.shape[0]
        rows = torch.zeros((n, 8, 7))
        valid = torch.zeros((n, 8), dtype=torch.bool)
        for i in range(n):
            k = int(frames_rgb[i, 0, 0, 0]) % 3 + 1
            for j in range(k):
                rows[i, j, :4] = torch.tensor(
                    [5.0 + 7 * j, 5.0 + 3 * j, 50.0 + 5 * j, 80.0 + 2 * j])
            rows[i, :k, 4:6] = 0.9
            valid[i, :k] = True
        return rows, valid


def test_streams_on_the_mesh_equal_meshless(w4):
    frames = np.random.default_rng(1).integers(
        0, 256, (4, 100, 120, 3)).astype(np.uint8)
    single = _facade(SimpleHRNet, w4, device='cpu')
    meshed = _facade(SimpleHRNet, w4, mesh=make_mesh(2, device='cpu'))
    single.detector = meshed.detector = _FrameStub()
    for kw in (dict(batch_frames=2), dict(batch_frames=2,
                                           compact_crops=True),
               dict(batch_frames=2, adaptive_slots=True)):
        got = list(meshed.predict_stream(iter(frames), max_people=4, **kw))
        want = list(single.predict_stream(iter(frames), max_people=4, **kw))
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match='must divide the mesh'):
        list(meshed.predict_stream(iter(frames), batch_frames=3))


class _TinySet(HumanPoseEstimationDataset):
    """Five seeded (image, target, weight, meta) items at 64x64."""

    flip_pairs = [[1, 2], [3, 4]]

    def __init__(self):
        rng = np.random.default_rng(2)
        self.items = [(rng.standard_normal((64, 64, 3)).astype(np.float32),
                       rng.uniform(0, 1, (16, 16, 5)).astype(np.float32),
                       np.ones((5, 1), np.float32), {'index': i})
                      for i in range(5)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_test_harness_on_the_mesh_pads_and_trims(tmp_path):
    params = JH.init(jax.random.PRNGKey(1), c=4, nof_joints=5)
    path = str(tmp_path / 'w4_5.npz')
    jckpt.save(path, params)
    kw = dict(batch_size=4, num_workers=1, checkpoint_path=path, model_c=4,
              model_nof_joints=5)
    plain = TTest(_TinySet(), device='cpu', **kw)
    meshed = TTest(_TinySet(), mesh=make_mesh(2, device='cpu'), **kw)
    want = plain.run()
    got = meshed.run()  # batches of 4 and 1: the 1 padded to 2
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    assert got[1] == pytest.approx(want[1], rel=1e-6)
