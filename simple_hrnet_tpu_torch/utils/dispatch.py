"""Show that a facade's stream dispatch makes no host synchronization.

``predict_stream`` overlaps the host's reading of frame i with the card's
work on frames i+1..i+prefetch only if dispatching a launch — the upload
and the runner call — never waits for the card. ``strict_dispatch(model)``
runs every upload and runner call of ``model`` under
``torch.cuda.set_sync_debug_mode('error')``, so a synchronizing call
there raises; the reads of results stay outside it.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator

import torch

# the facade's runner getters: each returns a runner (see api.py)
RUNNER_GETTERS = ('_single', '_fused_frame', '_fused_frames',
                  '_detect_rows', '_detect_counts', '_gather_crop')


def _strict(fn, calls: Dict[str, int], name: str):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode('error')
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(before)
            calls[name] = calls.get(name, 0) + 1
    return run


@contextlib.contextmanager
def strict_dispatch(model) -> Iterator[Dict[str, int]]:
    """Within the block, each ``model._upload`` and each runner that
    ``model``'s getters hand out runs in sync-debug mode 'error'. Yields
    the count of guarded calls by name, filled as they run."""
    calls: Dict[str, int] = {}
    patched = {'_upload': _strict(model._upload, calls, '_upload')}
    for name in RUNNER_GETTERS:
        getter = getattr(model, name)
        patched[name] = functools.wraps(getter)(
            lambda *a, _g=getter, _n=name, **k: _strict(_g(*a, **k), calls,
                                                        _n))
    shadowed = {n: model.__dict__[n] for n in patched if n in model.__dict__}
    model.__dict__.update(patched)
    try:
        yield calls
    finally:
        for name in patched:
            del model.__dict__[name]
        model.__dict__.update(shadowed)
