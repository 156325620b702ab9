"""Multi-process data parallelism of the port (``parallel/distributed.py``),
on the CPU over gloo.

Two processes of ``python -m simple_hrnet_tpu_torch.parallel.distributed``
join a gloo group on a free port and run one PoseResNet-18 SGD step
(lr 1e-3, momentum 0.9) on a fixed 64x64 global batch of 8 rows, each
feeding its 4 rows, from weights the JAX package initialized (an
``.npz``). Their ``loss=`` lines must be equal; they equal the port's
one-process step on the whole global batch within 1e-6 relative and the
JAX package's one-process step within 1e-5 (tests/test_distributed.py's
spec: the topology changes nothing but rounding); the BN running
statistics after the two-process step (global statistics, the unbiased
variance) equal the one-process step's within 1e-6 absolute (the running
variances are near 1, the means near 0: a batch mean of near-cancelling
sums carries its rounding at that scale). Each child has a 240 s limit. The launch errors of the training
CLIs and ``initialize``'s idempotence close the file.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.models import poseresnet as JP
from simple_hrnet_tpu.train import losses as JLoss
from simple_hrnet_tpu.train import steps as JS
from simple_hrnet_tpu.utils import checkpoint as jckpt

from simple_hrnet_tpu_torch.cli import train_coco as TCoco
from simple_hrnet_tpu_torch.cli import train_mpii as TMpii
from simple_hrnet_tpu_torch.parallel import distributed as D
from simple_hrnet_tpu_torch.parallel import make_mesh
from simple_hrnet_tpu_torch.train import steps as TS

from test_torch_parallel import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    params = JP.init(jax.random.PRNGKey(0), resnet_size=18, nof_joints=17)
    path = str(tmp_path_factory.mktemp('dist') / 'resnet18.npz')
    jckpt.save(path, params)
    return path, params


def _jax_step_loss(params, batch):
    opt = JS.make_optimizer('SGD', lr=1e-3, momentum=0.9)
    step = JS.make_train_step(
        lambda p, x, **kw: JP.apply(p, x, resnet_size=18, **kw),
        JLoss.joints_mse_loss, opt, donate=False)
    args = (params, opt.init(params), batch)
    step = step.lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': 0})
    return float(step(*args)[2])


def test_two_process_step_matches_one_process(weights, tmp_path):
    path, params = weights
    stats_out = str(tmp_path / 'stats.pt')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    addr = f'127.0.0.1:{free_port()}'
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'simple_hrnet_tpu_torch.parallel.distributed',
         addr, '2', str(rank), path, stats_out],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
            assert p.returncode == 0, f'child failed:\n{out}'
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    losses = []
    for out in outs:
        m = re.search(r'loss=([0-9.eE+-]+)', out)
        assert m, f'no loss line in:\n{out}'
        losses.append(float(m.group(1)))
    assert losses[0] == losses[1]  # the all-reduced global mean

    # the port's one-process step on the whole global batch
    batch = D._selftest_batch()
    model, opt, loss_fn = D._selftest_setup(path)
    loss1, out1 = TS.make_train_step(model, loss_fn, opt)(batch)
    assert out1.shape == (D.SELFTEST_ROWS, 16, 16, 17)
    assert losses[0] == pytest.approx(float(loss1), rel=1e-6)
    got = torch.load(stats_out)
    want = D.running_stats(model)
    assert got.keys() == want.keys() and len(got) > 0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-6, rtol=0, err_msg=k)
    # the JAX package's one-process step
    assert losses[0] == pytest.approx(_jax_step_loss(params, batch),
                                      rel=1e-5)


def test_training_clis_name_the_launch_line():
    """``--n_devices`` above 1 without a launcher raises, naming the
    ``torchrun`` line of that CLI; 1 or None would train one process."""
    with pytest.raises(ValueError, match=r'torchrun --nproc_per_node=4 -m '
                       r'simple_hrnet_tpu_torch\.cli\.train_coco'):
        TCoco.main('x', n_devices=4)
    with pytest.raises(ValueError, match=r'torchrun --nproc_per_node=2 -m '
                       r'simple_hrnet_tpu_torch\.cli\.train_mpii'):
        TMpii.main('x', n_devices=2)
    assert D.cli_mesh(None) is None and D.cli_mesh(1) is None


def test_initialize_is_idempotent():
    assert not D.is_initialized() and D.process_count() == 1
    D.initialize(f'127.0.0.1:{free_port()}', 1, 0, device='cpu')
    try:
        D.initialize(f'127.0.0.1:{free_port()}', 1, 0, device='cpu')
        assert D.is_initialized() and D.process_count() == 1
        assert D.process_index() == 0
        mesh = make_mesh(device='cpu')
        assert mesh.group is not None and mesh.size == 1
        with pytest.raises(ValueError, match='together'):
            D.shutdown()
            D.initialize('127.0.0.1:1', None, 0)
    finally:
        D.shutdown()
    assert not D.is_initialized()
