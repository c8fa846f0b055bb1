"""Weights between the JAX package's parameter trees and the port.

The port's module names are the reference checkpoints' state-dict keys,
so a reference state dict loads with `load_reference_state_dict`.
`from_jax_params` goes the other way from the JAX package's converter
(`nerf_from_image_tpu/utils/torch_convert.py:convert_generator`): it turns
a JAX `Generator`'s variables, as numpy arrays, into a reference-format
state dict, and `from_jax_discriminator` does the same for a JAX
`Discriminator` (the other way from `convert_discriminator`).
`random_discriminator_state_dict` draws a reference-format discriminator
state dict from a seed. The LPIPS leg builds reference-format LPIPS
weights from a seed (`random_lpips_state_dicts`) and loads reference LPIPS
weights into the port (`load_lpips_state_dicts`): the same two dicts that
the JAX package's `convert_lpips` takes. `random_encoder_state_dict` draws
a reference-format bootstrap encoder state dict from a seed, for
`BootstrapEncoder.load_state_dict` here and `convert_bootstrap_encoder`
in the JAX package. This module holds numpy only and imports no JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from nerf_from_image_tpu_torch.models import lpips
from nerf_from_image_tpu_torch.models import stylegan

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


# Discriminator convolutions: each holds the reference's resample_filter.
_DISC_CONV = re.compile(
    r'(backbone\.b\d+\.(?:fromrgb|skip|conv0|conv1|conv))\.weight$')


def from_jax_discriminator(variables: Mapping[str, Any]
                           ) -> Dict[str, np.ndarray]:
    """JAX Discriminator variables ({'params': tree} of numpy arrays) ->
    reference-format state dict, with the `resample_filter` buffer of
    every convolution added."""
    sd = {key: np.asarray(value, dtype=np.float32)
          for key, value in _flatten(variables['params'])}
    for key in list(sd):
        m = _DISC_CONV.match(key)
        if m:
            sd[f'{m.group(1)}.resample_filter'] = _bilinear_filter()
    return sd


def random_discriminator_state_dict(seed: int, resolution: int, nc: int,
                                    channel_base: int = 32768,
                                    channel_max: int = 512
                                    ) -> Dict[str, np.ndarray]:
    """A reference-format discriminator state dict drawn from `seed`:
    standard-normal weights (divided by the mapping's lr multiplier 0.01,
    as the reference initializes them), small random biases."""
    rng = np.random.default_rng(seed)
    shapes = stylegan.DiscriminatorBackbone(
        13, resolution, nc, channel_base=channel_base,
        channel_max=channel_max).state_dict()
    sd = {}
    for key, value in shapes.items():
        if key.endswith('resample_filter'):
            sd[f'backbone.{key}'] = _bilinear_filter()
            continue
        draw = rng.standard_normal(tuple(value.shape))
        if key.endswith('bias'):
            draw = draw * 0.1
        elif key.startswith('mapping.'):
            draw = draw / 0.01
        sd[f'backbone.{key}'] = draw.astype(np.float32)
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


# torchvision `vgg16().features` indices of the 13 convolutions.
VGG_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def random_lpips_state_dicts(seed: int
                             ) -> Tuple[Dict[str, np.ndarray],
                                        Dict[str, np.ndarray]]:
    """Reference-format LPIPS weights drawn from `seed`.

    Returns (vgg_sd, lin_sd): torchvision `features.<i>.{weight,bias}`
    (He-normal kernels, small biases) and lpips `lin<i>.model.1.weight`
    (non-negative, as lpips' are).
    """
    rng = np.random.default_rng(seed)
    vgg_sd: Dict[str, np.ndarray] = {}
    in_ch = 3
    widths = [w for block in lpips.VGG_BLOCKS for w in block]
    for idx, out_ch in zip(VGG_CONV_INDICES, widths):
        fan_in = in_ch * 9
        vgg_sd[f'features.{idx}.weight'] = (
            rng.standard_normal((out_ch, in_ch, 3, 3)) *
            np.sqrt(2.0 / fan_in)).astype(np.float32)
        vgg_sd[f'features.{idx}.bias'] = (
            rng.standard_normal(out_ch) * 0.01).astype(np.float32)
        in_ch = out_ch
    lin_sd = {f'lin{i}.model.1.weight':
              (np.abs(rng.standard_normal((c, ))) * 0.1).astype(
                  np.float32).reshape(1, c, 1, 1)
              for i, c in enumerate(lpips.LIN_CHANNELS)}
    return vgg_sd, lin_sd


def load_lpips_state_dicts(model: nn.Module,
                           vgg_sd: Mapping[str, Any],
                           lin_sd: Mapping[str, Any]) -> None:
    """Copies reference LPIPS weights into a port `LPIPS` in place.

    Takes what `convert_lpips` takes: torchvision `features.*` and lpips
    `lin<i>.model.1.weight`. Other VGG keys (the classifier) are ignored;
    every key of the model must be present.
    """
    tensors = {}
    for key, value in list(vgg_sd.items()) + list(lin_sd.items()):
        if key.startswith(('features.', 'lin')):
            tensors[key] = torch.tensor(np.asarray(value, np.float32))
    model.load_state_dict(tensors, strict=True)


def random_encoder_state_dict(seed: int, latent_dim: int = 512,
                              **sizes) -> Dict[str, np.ndarray]:
    """Reference-format `BootstrapEncoder` weights drawn from `seed`.

    `sizes` are `BootstrapEncoder`'s options (`separate_backbones`,
    `depths`, `embed_dims`, `num_heads`, `sr_ratios`, `head_width`);
    the defaults give MiT-B5. Convolutions are He-normal over their fan
    in, linear layers normal with std 1 / sqrt(fan in), LayerNorm scales
    1 + N(0, 0.1^2) and every bias N(0, 0.02^2), so that each key carries
    distinct values.
    """
    from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
    shapes = {k: tuple(v.shape) for k, v in BootstrapEncoder(
        latent_dim, device='meta', **sizes).state_dict().items()}
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for key, shape in shapes.items():
        draw = rng.standard_normal(shape)
        if key.endswith('.bias'):
            draw = draw * 0.02
        elif len(shape) == 1:  # LayerNorm scale
            draw = 1.0 + 0.1 * draw
        elif len(shape) == 4:  # convolution (out, in / groups, kh, kw)
            draw = draw * np.sqrt(2.0 / np.prod(shape[1:]))
        else:  # linear (out, in)
            draw = draw / np.sqrt(shape[1])
        sd[key] = draw.astype(np.float32)
    return sd
