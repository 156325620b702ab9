"""The harness and the reference load no module of JAX or of the JAX
package, and the reference none of the program; top-level names are
compared whole (the program's name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PROBE = '''
import json, sys
sys.path.insert(0, {repo!r})
for m in {mods!r}:
    __import__(m)
print(json.dumps(sorted({{k.split('.')[0] for k in sys.modules}})))
'''


def _loaded(mods):
    out = subprocess.run([sys.executable, '-c',
                          PROBE.format(repo=REPO, mods=mods)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=''))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize('mods,forbidden', [
    (['port_bench.reference.nets', 'port_bench.reference.pipeline'],
     {'jax', 'jaxlib', 'flax', 'simple_hrnet_tpu', 'simple_hrnet_tpu_torch'}),
    (['port_bench.harness.runner', 'port_bench.control',
      'simple_hrnet_tpu_torch.api'],
     {'jax', 'jaxlib', 'flax', 'simple_hrnet_tpu'}),
])
def test_no_forbidden_top_level_modules(mods, forbidden):
    loaded = _loaded(mods)
    assert not loaded & forbidden, loaded & forbidden


def test_forbidden_check_compares_whole_names(monkeypatch):
    import types
    from port_bench.harness import runner
    monkeypatch.setitem(sys.modules, 'simple_hrnet_tpu_torchlike.x',
                        types.ModuleType('x'))
    monkeypatch.setitem(sys.modules, 'jaxish', types.ModuleType('jaxish'))
    assert 'simple_hrnet_tpu' not in runner.forbidden_modules()
    assert 'jax' not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'jaxlib.fake', types.ModuleType('f'))
    assert 'jaxlib' in runner.forbidden_modules()


def test_sources_name_no_reference_package():
    for sub in ('harness', 'reference', 'metrics'):
        for f in os.listdir(os.path.join(REPO, 'port_bench', sub)):
            if f.endswith('.py'):
                text = open(os.path.join(REPO, 'port_bench', sub, f)).read()
                assert 'import jax' not in text
                assert 'simple_hrnet_tpu ' not in text
                assert 'from simple_hrnet_tpu.' not in text
                assert 'import simple_hrnet_tpu\n' not in text
