"""Checkpoint I/O for the port.

Counterpart of ``load``/``save`` in ``simple_hrnet_tpu/utils/checkpoint.py``:
  * ``.pth``/``.pt``: official weight files (flat state_dicts) and
    training-harness checkpoints (``{'model': state_dict, ...}``), with
    ``module.`` prefixes stripped;
  * ``.npz``: the JAX package's own format, one array per leaf of its
    param tree under the leaf's path joined by ``|``. ``load`` maps the
    tree through ``models.convert.from_jax_params`` (HRNet, PoseResNet and
    darknet trees alike); ``save`` writes the tree of
    ``models.convert.to_jax_params``, which the JAX package's ``load``
    reads.
BN is folded later, by the models' ``prepare_inference``.

``save_train``/``load_train`` keep the whole training state (the JAX
package keeps it with orbax): a directory with one ``torch.save`` file a
step, ``<step>.pt`` holding the epoch, the model's ``state_dict`` (BN
running statistics included), the optimizer's and the scheduler's state
and the config (the best metrics among it), the newest ``keep`` kept, and
``config.json`` as the JAX package writes it. It reads no orbax directory.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from simple_hrnet_tpu_torch.models.convert import (clean_state_dict,
                                                   from_jax_params,
                                                   to_jax_params)

SEP = '|'  # path separator in flattened npz keys ('.' is in no key name)


def _flatten(tree: Any, prefix: str = '') -> Dict[str, np.ndarray]:
    """A nested dict of arrays as {'a|b|leaf': array} (the JAX package's
    ``_flatten``, with its guards)."""
    flat: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        if not tree:
            # an empty subtree would vanish from the npz and fail only
            # after reload
            raise ValueError(f'cannot save empty dict at {prefix[:-1]!r}')
        for k, v in tree.items():
            flat.update(_flatten(v, f'{prefix}{k}{SEP}'))
    elif isinstance(tree, (list, tuple)):
        # np.asarray would stack same-shape entries into one array, and the
        # reload would not give the container back
        raise TypeError(f'npz checkpoints hold nested dicts of arrays only; '
                        f'got {type(tree).__name__} at {prefix[:-1]!r}')
    else:
        flat[prefix[:-1]] = np.asarray(tree)
    return flat


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)
    return tree


def load(path: str) -> Dict[str, torch.Tensor]:
    """Load a ``.pth``/``.pt`` checkpoint, or else an ``.npz`` one, as a
    flat CPU state_dict (the JAX package's ``load`` rule)."""
    if path.endswith(('.pth', '.pt')):
        return clean_state_dict(torch.load(path, map_location='cpu',
                                           weights_only=True))
    with np.load(path) as f:
        return from_jax_params(_unflatten({k: f[k] for k in f.files}))


def save(path: str, model_or_state_dict: Union[nn.Module,
                                               Mapping[str, Any]]) -> None:
    """Save an (unfolded) model or state_dict as an ``.npz`` in the JAX
    package's layout."""
    sd = (model_or_state_dict.state_dict()
          if isinstance(model_or_state_dict, nn.Module)
          else model_or_state_dict)
    np.savez(path, **_flatten(to_jax_params(sd)))


def _steps(directory: str):
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := re.fullmatch(r'(\d+)\.pt', f)))


def save_train(directory: str, step: int, model: nn.Module,
               optimizer: torch.optim.Optimizer, scheduler=None,
               config: Optional[dict] = None, keep: int = 3) -> str:
    """Write the training state of ``step`` as ``directory/<step>.pt``,
    drop all but the newest ``keep`` steps, and write ``config.json``.
    Returns the file's path."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    state = {'epoch': step,
             'model': {k: v.detach().cpu()
                       for k, v in model.state_dict().items()},
             'optimizer': optimizer.state_dict(),
             'scheduler': None if scheduler is None
             else scheduler.state_dict(),
             'config': config}
    path = os.path.join(directory, f'{step}.pt')
    tmp = path + '.tmp'
    torch.save(state, tmp)
    os.replace(tmp, path)  # a crash never leaves a torn checkpoint
    for old in _steps(directory)[:-keep]:
        os.remove(os.path.join(directory, f'{old}.pt'))
    if config is not None:
        with open(os.path.join(directory, 'config.json'), 'w') as f:
            json.dump(config, f, indent=2, default=str)
    return path


def load_train(directory: str, step: Optional[int] = None,
               map_location: Union[str, torch.device] = 'cpu'
               ) -> Tuple[int, Dict[str, Any], Optional[dict]]:
    """(step, state, config) of ``directory``'s newest step, or of
    ``step``: state as ``save_train`` wrote it (keys epoch, model,
    optimizer, scheduler, config), config from ``config.json``."""
    directory = os.path.abspath(directory)
    if step is None:
        steps = _steps(directory)
        if not steps:
            raise FileNotFoundError(f'no training checkpoint in {directory}')
        step = steps[-1]
    state = torch.load(os.path.join(directory, f'{step}.pt'),
                       map_location=map_location, weights_only=True)
    config = None
    cfg_path = os.path.join(directory, 'config.json')
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = json.load(f)
    return step, state, config
