"""The int8 trace of ``tests/torch_goldens.py`` (``int8_trace``,
``first_departure``, ``amax_departure``), which ``chip_smoke.py`` phase 11
runs on the card's and the CPU's W32 int8 facades to find where their
answers part. On the CPU, at HRNet-W16 64x64 single-person (its stem,
layer1 and branch-0 chains int8): two runs of one facade do not part
anywhere, and one ulp added to one ``QConv2d``'s activation scale is
reported at that module, with every entry before it equal. JAX is not
imported.
"""

import numpy as np
import pytest
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

import torch_goldens as G
from simple_hrnet_tpu_torch import SimpleHRNet
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.models.layers import QConv2d


@pytest.fixture(scope='module')
def facade(tmp_path_factory):
    """A W16 int8 single-person facade, its calibration map, a frame that
    takes the resize, and one trace of it."""
    pth = str(tmp_path_factory.mktemp('trace') / 'w16.pth')
    torch.save(TH.init(16, 17, seed=0).state_dict(), pth)
    amax = {}
    with G.int8_calibration(record=amax):
        model = SimpleHRNet(16, 17, pth, multiperson=False,
                            resolution=(64, 64), dtype='int8',
                            return_heatmaps=True, device='cpu')
    frames = np.random.default_rng(0).integers(0, 256, (1, 96, 80, 3)
                                               ).astype(np.uint8)
    trace, outs = G.int8_trace(model, frames)
    return model, amax, frames, trace, outs


def test_two_runs_do_not_part(facade):
    """A second run, and a facade rebuilt from the first one's calibration
    map (``int8_calibration(replace=...)``), trace equal: no departure,
    equal maps, equal outputs. The trace holds the frame first, quantized
    inputs, the chains and the heatmaps last."""
    model, amax, frames, trace, outs = facade
    again, outs2 = G.int8_trace(model, frames)
    d = G.first_departure(trace, again)
    assert d['first'] is None, G.departure_line(d)
    kinds = {k for _, k, _ in trace['entries']}
    names = [n for n, _, _ in trace['entries']]
    assert kinds == {'frame', 'int8', 'float'}
    assert names[0] == 'frame' and names[-1] == 'heatmaps'
    assert 'stage2.0.chain:in:q' in names and 'conv2:q' in names
    for a, b in zip(outs, outs2):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    record = {}
    with G.int8_calibration(record=record, replace=amax):
        rebuilt = SimpleHRNet(16, 17, model.checkpoint_path,
                              multiperson=False, resolution=(64, 64),
                              dtype='int8', return_heatmaps=True,
                              device='cpu')
    a = G.amax_departure(record, amax)
    assert a['keys'] == len(amax) > 0 and a['differ'] == 0
    d = G.first_departure(G.int8_trace(rebuilt, frames)[0], trace)
    assert d['first'] is None, G.departure_line(d)


def test_one_ulp_of_one_scale_is_found_at_its_module(facade):
    """One ulp added to the activation scale of the first ``QConv2d``
    whose own output it changes (found by calling each module on its input
    from a plain run): the trace departs at that module's entries, its
    quantized input or its output, and nowhere before them."""
    model, _, frames, trace, _ = facade
    inputs, hooks = {}, []

    def keep(name):
        def hook(_m, args):
            inputs.setdefault(name, args[0].clone())
        return hook

    for name, m in model.model.named_modules():
        if isinstance(m, QConv2d):
            hooks.append(m.register_forward_pre_hook(keep(name)))
    try:
        model.predict(frames[0])
    finally:
        for h in hooks:
            h.remove()
    modules = dict(model.model.named_modules())
    target = None
    for name, x in inputs.items():   # in forward order
        m = modules[name]
        base = m(x)
        old = m.ascale.clone()
        m.ascale.copy_(torch.nextafter(old, torch.tensor(np.inf)))
        changed = not torch.equal(m(x), base)
        m.ascale.copy_(old)
        if changed:
            target = name
            break
    assert target is not None
    m = modules[target]
    old = m.ascale.clone()
    m.ascale.copy_(torch.nextafter(old, torch.tensor(np.inf)))
    try:
        bumped, _ = G.int8_trace(model, frames)
    finally:
        m.ascale.copy_(old)
    d = G.first_departure(bumped, trace)
    names = [r['name'] for r in d['rows']]
    at = names.index(f'{target}:q')
    assert d['first'] is not None and d['first']['name'] in (
        f'{target}:q', target), G.departure_line(d)
    assert not any(r['differ'] for r in d['rows'][:at])
