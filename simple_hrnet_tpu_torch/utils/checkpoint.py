"""Checkpoint loading for the port.

Counterpart of ``load`` in ``simple_hrnet_tpu/utils/checkpoint.py`` for
``.pth``/``.pt`` files: official weight files (flat state_dicts) and
training-harness checkpoints (``{'model': state_dict, ...}``), with
``module.`` prefixes stripped. BN is folded later, by
``models.hrnet.prepare_inference``.
"""

from __future__ import annotations

from typing import Dict

import torch

from simple_hrnet_tpu_torch.models.convert import clean_state_dict


def load(path: str) -> Dict[str, torch.Tensor]:
    """Load a ``.pth``/``.pt`` checkpoint as a flat CPU state_dict."""
    if not path.endswith(('.pth', '.pt')):
        raise NotImplementedError(
            f'{path!r}: the port loads .pth/.pt checkpoints only')
    return clean_state_dict(torch.load(path, map_location='cpu',
                                       weights_only=True))
