"""Weights between the JAX package's parameter trees and the port.

The port's module names are the reference checkpoints' state-dict keys,
so a reference state dict loads with `load_reference_state_dict`.
`from_jax_params` goes the other way from the JAX package's converter
(`nerf_from_image_tpu/utils/torch_convert.py:convert_generator`): it turns
a JAX `Generator`'s variables, as numpy arrays, into a reference-format
state dict. This module holds numpy only and imports no JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# JAX tree paths whose reference names differ (prefix renames).
_RENAMES = (
    ('mapping_network.', 'mapping_network.backbone.'),
    ('decoder.fc0.', 'decoder.net.0.'),
    ('decoder.fc1.', 'decoder.net.2.'),
)
# Reference keys that the JAX tree need not carry: the noise parameters
# and buffers exist only when the JAX model ran with noise, and the port's
# slice never reads them.
_OPTIONAL_SUFFIXES = ('.noise_strength', '.noise_const')


def _flatten(tree: Mapping[str, Any], prefix: str = ''
             ) -> Iterator[Tuple[str, Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, f'{prefix}{key}.')
        else:
            yield f'{prefix}{key}', value


def _bilinear_filter() -> np.ndarray:
    f = np.asarray([1.0, 3.0, 3.0, 1.0], np.float32)
    k = f[:, None] * f[None, :]
    return k / k.sum()


def from_jax_params(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX Generator variables -> reference-format state dict.

    Args:
      variables: {'params': tree[, 'buffers': tree]} of numpy arrays, as
        `Generator.init` returns them (after `jax.device_get`) or as
        `torch_convert.convert_generator` builds them.

    Returns:
      {reference key: float32 array}, with the constant `resample_filter`
      buffers of every synthesis block and conv layer added.
    """
    sd: Dict[str, np.ndarray] = {}
    for collection in ('params', 'buffers'):
        for key, value in _flatten(variables.get(collection, {})):
            for old, new in _RENAMES:
                if key.startswith(old):
                    key = new + key[len(old):]
                    break
            sd[key] = np.asarray(value, dtype=np.float32)
    filt = _bilinear_filter()
    owners = set()
    for key in sd:
        m = re.match(r'(synthesis_network\.b\d+)\.(conv[01]\.)?', key)
        if m:
            owners.add(m.group(1))
            if m.group(2):
                owners.add(m.group(1) + '.' + m.group(2)[:-1])
    for owner in owners:
        sd[f'{owner}.resample_filter'] = filt.copy()
    return sd


def load_reference_state_dict(model: nn.Module,
                              state_dict: Mapping[str, Any]) -> None:
    """Copies a reference-format state dict into `model` in place.

    Every key must match; only the noise parameters and buffers may be
    missing. Values keep the model's device and dtype.
    """
    tensors = {k: torch.tensor(np.asarray(v)) for k, v in
               state_dict.items()}
    missing, unexpected = model.load_state_dict(tensors, strict=False)
    missing = [k for k in missing if not k.endswith(_OPTIONAL_SUFFIXES)]
    if missing or unexpected:
        raise KeyError(f'state dict mismatch: missing {missing}, '
                       f'unexpected {unexpected}')
