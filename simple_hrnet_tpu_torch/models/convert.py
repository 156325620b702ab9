"""Checkpoint name handling for the port, and the JAX-tree carry-across.

Counterpart of ``simple_hrnet_tpu/models/convert.py``. The port's modules
already use the official ``state_dict`` names, so loading an official
``.pth`` is ``load_state_dict`` after ``clean_state_dict`` (unwrap a
``{'model': ...}`` training checkpoint, strip ``module.`` prefixes).

``from_jax_params`` inverts the JAX package's ``state_dict_to_tree``: a
nested dict of numpy arrays (HWIO ``kernel``, BN ``scale``/``bias``/
``mean``/``var``) becomes a flat ``state_dict`` (OIHW ``weight``, BN
``weight``/``bias``/``running_mean``/``running_var``). It covers the HRNet
and PoseResNet trees, the darknet tree (``conv_<i>`` nodes with a nested
``bn``) and the YOLOv5 tree, so the tests can run both packages on the
same weights. PoseResNet's transposed convs (``deconv_layers.N``) are
stored by the JAX package spatially flipped, HWIO with I = C_in (its
``convert.state_dict_to_tree``); their torch weight (C_in, C_out, kh, kw)
is the flip undone and transposed. ``to_jax_params`` is the inverse
(the JAX package's ``state_dict_to_tree`` in numpy), so the port writes
``.npz`` checkpoints the JAX package reads. ``amax_from_jax`` carries a
JAX int8 calibration map across the same way.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def clean_state_dict(checkpoint: Any) -> Dict[str, torch.Tensor]:
    """Official weight file or ``{'model': state_dict, ...}`` harness
    checkpoint -> flat state_dict without ``module.`` prefixes."""
    if isinstance(checkpoint, dict) and 'model' in checkpoint:
        checkpoint = checkpoint['model']
    out = {}
    for key, value in checkpoint.items():
        if key.startswith('module.'):
            key = key[len('module.'):]
        out[key] = value
    return out


def load_into(model: nn.Module, state_dict: Mapping[str, torch.Tensor]
              ) -> nn.Module:
    """``load_state_dict`` that tolerates only missing BN
    ``num_batches_tracked`` counters (absent from older official files);
    any other missing or unexpected key raises."""
    result = model.load_state_dict(dict(state_dict), strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith('num_batches_tracked')]
    if missing or result.unexpected_keys:
        raise ValueError(f'checkpoint does not match the model: missing '
                         f'{missing[:8]}, unexpected '
                         f'{result.unexpected_keys[:8]}')
    return model


def _is_bn(node: Mapping) -> bool:
    return 'mean' in node and 'kernel' not in node


def from_jax_params(tree: Mapping[str, Any], prefix: str = ''
                    ) -> Dict[str, torch.Tensor]:
    """JAX param tree (nested dicts of arrays) -> flat torch state_dict."""
    flat: Dict[str, torch.Tensor] = {}

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a))  # a writable copy

    for k, v in tree.items():
        path = f'{prefix}{k}'
        if not isinstance(v, Mapping):
            raise TypeError(f'unexpected leaf {path!r} outside a conv/BN node')
        if _is_bn(v):
            flat[f'{path}.weight'] = t(v['scale'])
            flat[f'{path}.bias'] = t(v['bias'])
            flat[f'{path}.running_mean'] = t(v['mean'])
            flat[f'{path}.running_var'] = t(v['var'])
            continue
        if 'kernel' in v:
            k = np.asarray(v['kernel'])
            if 'deconv_layers' in path.split('.'):
                # flipped HWIO (I = C_in) -> ConvTranspose2d (I, O, kh, kw)
                flat[f'{path}.weight'] = t(np.transpose(k[::-1, ::-1],
                                                        (2, 3, 0, 1)))
            else:  # HWIO -> OIHW
                flat[f'{path}.weight'] = t(np.transpose(k, (3, 2, 0, 1)))
            if 'bias' in v:
                flat[f'{path}.bias'] = t(v['bias'])
            children = {ck: cv for ck, cv in v.items()
                        if ck not in ('kernel', 'bias')}
            flat.update(from_jax_params(children, prefix=f'{path}.'))
            continue
        flat.update(from_jax_params(v, prefix=f'{path}.'))
    return flat


def to_jax_params(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Flat torch state_dict -> JAX param tree of numpy arrays (the JAX
    package's ``state_dict_to_tree``, in numpy): OIHW conv weights become
    HWIO ``kernel``s (PoseResNet's ``deconv_layers`` transposed and flipped
    spatially), BN modules (those with ``running_mean``) ``scale``/
    ``bias``/``mean``/``var``, ``num_batches_tracked`` is dropped."""
    state_dict = clean_state_dict(state_dict)
    bn_modules = {k[:-len('.running_mean')] for k in state_dict
                  if k.endswith('.running_mean')}
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        parts = key.split('.')
        leaf, module = parts[-1], '.'.join(parts[:-1])
        if leaf == 'num_batches_tracked':
            continue
        arr = (value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
               else np.asarray(value))
        if module in bn_modules:
            leaf = {'weight': 'scale', 'bias': 'bias', 'running_mean': 'mean',
                    'running_var': 'var'}[leaf]
        elif leaf == 'weight':
            if arr.ndim == 4:
                arr = (np.transpose(arr, (2, 3, 0, 1))[::-1, ::-1]
                       if 'deconv_layers' in parts
                       else np.transpose(arr, (2, 3, 1, 0)))
            leaf = 'kernel'
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def conv_node_paths(tree: Mapping[str, Any], prefix: tuple = ()
                    ) -> Dict[int, str]:
    """{id(conv node): 'dotted.path'} for every node of a JAX-layout param
    tree that holds a ``kernel`` or ``kernel_q`` — the same walk as the JAX
    package's ``quantize.node_paths``, whose strings are the port's module
    paths (both mirror the ``state_dict``)."""
    out: Dict[int, str] = {}
    if isinstance(tree, Mapping):
        if 'kernel' in tree or 'kernel_q' in tree:
            out[id(tree)] = '.'.join(prefix)
        for k, v in tree.items():
            out.update(conv_node_paths(v, prefix + (str(k),)))
    return out


def amax_from_jax(jax_params: Mapping[str, Any], amax: Mapping[int, float]
                  ) -> Dict[str, float]:
    """A JAX calibration map ({id(conv node): input amax}, keyed by node
    identity in ``jax_params``) as the port's map {module path: amax}."""
    paths = conv_node_paths(jax_params)
    return {paths[i]: float(a) for i, a in amax.items() if i in paths}
