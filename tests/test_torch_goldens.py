"""The port against the JAX package's production-geometry goldens, on the
CPU.

``tests/torch_goldens.py`` writes the seeded weight files and holds the
port's facade, at full width and resolution, against
``tests/goldens/port_*.json`` (the JAX facade's answers on the same
weights and frames, computed once by that module's generator). JAX is
neither imported nor run here. The limits are the helper's ``LIMITS``:
f32 heatmap values within 2e-4 of their channel's max, boxes and decisive
keypoints within 1e-3 px, confidences within the heatmap limit; bf16 no
farther from the JAX golden in its dtype than twice the JAX package's own
distance between bf16 and f32, int8 no farther than twice the JAX
package's own spread between two computations of its int8 function, and
within 4 activation quanta at every recorded value and one on average
(``tests/test_torch_api_int8.py``'s contract), with the JAX package's set
of quantized convs and their activation scales.
"""

import json
import os

import pytest
import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

import torch_goldens as G

CPU_CONFIGS = [c for c, cfg in G.CONFIGS.items() if cfg['cpu']]


@pytest.fixture(scope='module')
def paths(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp('golden_weights'))
    need = sorted({w for c in CPU_CONFIGS for w in G.config_weights(c)})
    files = G.write_weights(tmp, need)
    return {k: v[0] for k, v in files.items()}


@pytest.fixture(scope='module')
def f32_runs(paths):
    """The port's f32 facade on each CPU config's frames, run once."""
    cache = {}

    def get(config):
        if config not in cache:
            n = G.CONFIGS[config]['cpu']['f32']
            frames = G.config_frames(config)[:n]
            model = G.port_facade(config, paths)
            rows = (G.detector_rows(model.detector, frames)
                    if model.detector is not None else None)
            cache[config] = (G.run_facade(model, config, frames), rows)
        return cache[config]
    return get


def test_weight_fingerprints():
    """numpy draws every seeded file's parameters as the generator drew
    them: each network's fingerprint equals the one its goldens record.
    Every BN of every file folds to a bias with no zero entry, so the
    goldens hold each conv's bias epilogue."""
    recorded = {}
    for config in G.CONFIGS:
        for name, w in G.load_golden(config)['weights'].items():
            assert recorded.setdefault(name, w['sha256']) == w['sha256']
            assert w['seed'] == G.WEIGHTS[name]['seed']
    assert set(recorded) == set(G.WEIGHTS)
    spreads = G.load_bn_spreads()
    for name, sha in recorded.items():
        net = G.seeded_network(name)
        assert G.fingerprint(net) == sha, name
        bns = G._bn_modules(net)
        assert len(bns) == len(spreads[name]) > 0
        for path, bn in bns:
            inv = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            folded = bn.bias - bn.running_mean * inv
            assert float(folded.abs().min()) > 0, (name, path)


def test_goldens_record_their_inputs():
    """Each golden names the JAX package's commit, its frames, the limits
    it was made for and every dtype it promises, with the JAX package's
    own distances that bound each low-precision gate; the set stays under
    1 MB."""
    total = os.path.getsize(G.BN_SPREADS_FILE)
    for config, cfg in G.CONFIGS.items():
        path = os.path.join(G.GOLDEN_DIR, f'port_{config}.json')
        total += os.path.getsize(path)
        with open(path) as f:
            golden = json.load(f)
        assert len(golden['jax_commit']) == 40
        assert golden['frame_seed'] == cfg['frame_seed']
        assert golden['frame_shape'] == [cfg['frames'], 480, 640, 3]
        assert golden['limits'] == G.LIMITS
        assert set(golden['dtypes']) == set(cfg['dtypes'])
        f32 = golden['dtypes']['f32']
        assert len(f32['frames']) == cfg['frames']
        assert sum(f['people'] for f in f32['frames']) > 0
        for dtype, entry in golden['dtypes'].items():
            if dtype == 'f32':
                continue
            assert 0 < entry['jax_vs_f32'] < 0.5
            if cfg['detector']:
                assert entry['jax_vs_f32_box_px'] >= 0
                assert entry['jax_vs_f32_det_px'] >= 0
            if dtype == 'int8':
                assert entry['jax_int8_spread'] == max(
                    entry['jax_int8_spreads'].values()) > 0
                nets = {'pose'} | ({'detector'} if cfg['detector'] else set())
                assert set(entry['jax_scales']) == nets
                assert all(entry['jax_scales'].values())
    assert total < 1_000_000


@pytest.mark.parametrize('config', [c for c in CPU_CONFIGS
                                    if 'f32' in G.CONFIGS[c]['cpu']])
def test_f32_matches_golden(f32_runs, config):
    """The port's plain f32 path at production geometry: the same people
    in order, boxes (and the detector's) within 1e-3 px, heatmap values
    within 2e-4 of max, decisive keypoints within 1e-3 px."""
    outs, rows = f32_runs(config)
    n = G.CONFIGS[config]['cpu']['f32']
    r = G.compare(outs, G.load_golden(config), 'f32', 'cpu', rows=rows,
                  frames=slice(0, n))
    print(G.report(r))
    assert r['ok'], G.report(r)
    assert r['decisive'] > 0


@pytest.mark.parametrize('dtype', ['bfloat16', 'int8'])
def test_low_precision_matches_golden(paths, dtype):
    """W32-256x192 in bf16 and int8: bf16 within twice the JAX package's
    own distance between bf16 and f32; int8 within twice the JAX
    package's own int8 spread (``INT8_SPREAD_FACTOR``; the old rule's
    bound is printed beside it), and within 4 quanta of the JAX int8
    golden at every recorded value and one on average (a quantum: the
    last stage module's largest activation scale through the head's
    largest row L1 norm), with the JAX package's quantized convs and
    activation scales (one conv fewer fails)."""
    config = 'w32_256x192_single'
    model = G.port_facade(config, paths, dtype)
    golden = G.load_golden(config)
    quantum = scales = None
    if dtype == 'int8':
        q = max(m.chain_int8['ascales'].max().item()
                for m in model.model.stage4)
        gain = model.model.final_layer.weight.abs().sum(dim=1).max().item()
        quantum = q * gain
        scales = G.quantized_scales(model)
    outs = G.run_facade(model, config, G.config_frames(config))
    r = G.compare(outs, golden, dtype, 'cpu', quantum=quantum,
                  scales=scales)
    print(G.report(r))
    assert r['ok'], G.report(r)
    if dtype == 'int8':
        fewer = {'pose': scales['pose'][1:]}
        assert not G.compare(outs, golden, dtype, 'cpu', quantum=quantum,
                             scales=fewer)['ok']


def test_controls_fail(paths, f32_runs):
    """Each gate fails on a wrong input: W48's frames 0-1 against the
    golden's frames 2-3 (other frames' answers), and W32's plain path with
    stage 3's first branch-0 chain output zeroed, in f32, bf16 and
    int8."""
    outs, _ = f32_runs('w48_384x288_batch16')
    golden = G.load_golden('w48_384x288_batch16')
    r = G.compare(outs, golden, 'f32', 'cpu', frames=slice(2, 4))
    assert not r['ok'] and r['heatmap_rel_max'] > G.LIMITS['cpu']['heatmap']
    config = 'w32_256x192_single'
    golden = G.load_golden(config)
    for dtype in ('f32', 'bfloat16', 'int8'):
        model = G.port_facade(config, paths, dtype, use_fused_kernels=False)
        hook = G.zero_chain(model.model)
        try:
            outs = G.run_facade(model, config, G.config_frames(config))
        finally:
            hook.remove()
        r = G.compare(outs, golden, dtype, 'cpu')
        print(G.report(r))
        assert not r['ok'], G.report(r)
