"""The port's int8 engine against the JAX package's, on the CPU (a file of
its own: its export and load take most of a minute here).

``export_engine(..., int8=True, fused=True)`` at W16 64x64 (c = 16: the
int8 policy skips C < 16) against the JAX ``export_engine(...,
int8=True)``, which exports the JAX plain int8 graph: the precision mix
and, at c = 16, the int8 chain cast points that the port's facade is held
to in ``test_torch_api_int8.py``. Both calibrate themselves on the same
synthetic frames. Tolerance as there: the heatmaps within 4 activation
quanta of the last stage module (its largest activation scale) times the
largest row L1 norm of the head at any pixel, and within 1 on average.
"""

import numpy as np

import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.models import convert as JC
from simple_hrnet_tpu.utils import checkpoint as jckpt
from simple_hrnet_tpu.utils import export as JE

from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.utils import export as TE

RES = (64, 64)


def test_int8_engine_matches_jax(tmp_path):
    """A W16 int8 ``fused=True`` engine (the int8 chain and fuse ops, 8
    each) against the JAX int8 engine."""
    path = str(tmp_path / 'w16.npz')
    jckpt.save(path, JC.state_dict_to_tree(TH.init(16, 17, seed=0)
                                           .state_dict()))
    jeng = JE.Engine(JE.export_engine(str(tmp_path / 'w16i.jaxpose'), path,
                                      c=16, resolution=RES, batch_size=2,
                                      int8=True))
    teng = TE.Engine(TE.export_engine(str(tmp_path / 'w16i.torchpose'), path,
                                      c=16, resolution=RES, batch_size=2,
                                      int8=True, fused=True, device='cpu'),
                     device='cpu')
    ep = teng.program
    chains = [n for n in ep.graph.nodes
              if str(n.target) == 'sht.int8_chain.default']
    fuses = [n for n in ep.graph.nodes if str(n.target) == 'sht.fuse_up.default']
    assert len(chains) == len(fuses) == 8
    assert teng.meta['half'] and teng.meta['int8']
    # the last stage module's activation scales, an operand of its chain
    name = ep.graph_signature.inputs_to_lifted_tensor_constants[
        chains[-1].args[4].name]
    q = ep.constants[name].max().item()
    gain = ep.state_dict['final_layer.weight'].abs().sum(dim=1).max().item()
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    diff = np.abs(teng(torch.from_numpy(x)).numpy() - np.asarray(jeng(x)))
    assert diff.max() <= 4 * q * gain
    assert diff.mean() <= q * gain
