"""The published weight files, loaded straight into the port's modules.

The JAX package converts each published file to an .npz first
(`scripts/convert_weights.py`); the port's modules carry the reference's
own state-dict keys, so it reads the raw files. They live under
`{root_path}/weights/` by their published names (SETUP.md):

  vgg16.pth + lpips_lins.pth   torchvision VGG16 + lpips' linear heads
                               -> `LPIPS`
  pt_inception.pth             pytorch-fid's FID InceptionV3
                               -> `InceptionV3FID`
  mit_b5.pth                   SegFormer's MiT-B5 ImageNet backbone
                               -> the encoder's backbone(s)

A missing file is handled as the JAX CLI handles it, with a printed
warning: random LPIPS, a random backbone; FID off in the inversion, a
random Inception in GAN training's evaluation.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from nerf_from_image_tpu_torch.device import DeviceLike
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.models.inception import InceptionV3FID
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.utils import convert

LPIPS_FILES = ('vgg16.pth', 'lpips_lins.pth')
INCEPTION_FILE = 'pt_inception.pth'
MIT_FILE = 'mit_b5.pth'


def weights_dir(root_path: str) -> str:
    return os.path.join(root_path, 'weights')


def load_state_dict_file(path: str) -> Dict[str, np.ndarray]:
    """A torch state dict file as numpy arrays, unwrapped from a
    'state_dict' entry and a DataParallel 'module.' prefix when it has
    them."""
    with open(path, 'rb') as f:
        obj = torch.load(f, map_location='cpu', weights_only=False)
    if isinstance(obj, dict) and 'state_dict' in obj:
        obj = obj['state_dict']
    sd = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else
          np.asarray(v) for k, v in obj.items()}
    if sd and all(k.startswith('module.') for k in sd):
        sd = {k[len('module.'):]: v for k, v in sd.items()}
    return sd


def load_lpips(root_path: str, device: DeviceLike = None) -> LPIPS:
    """`LPIPS` with the published weights, or random ones (seed 0) with a
    warning when either file is missing."""
    lpips = LPIPS(device=device).eval()
    paths = [os.path.join(weights_dir(root_path), n) for n in LPIPS_FILES]
    if all(os.path.exists(p) for p in paths):
        convert.load_lpips_state_dicts(
            lpips, *(load_state_dict_file(p) for p in paths))
    else:
        print('WARNING: LPIPS weights not found at', ' and '.join(paths),
              '- using random weights')
        convert.load_lpips_state_dicts(lpips,
                                       *convert.random_lpips_state_dicts(0))
    return lpips


def load_inception(root_path: str, device: DeviceLike = None,
                   random_if_missing: bool = False
                   ) -> Optional[InceptionV3FID]:
    """`InceptionV3FID` with the published weights. When the file is
    missing: None (FID off), or with `random_if_missing` random weights
    (seed 0), each with a warning."""
    path = os.path.join(weights_dir(root_path), INCEPTION_FILE)
    if not os.path.exists(path):
        if not random_if_missing:
            print('WARNING: Inception weights not found at', path,
                  '- FID reporting disabled')
            return None
        print('WARNING: Inception weights not found at', path, '- FID '
              'uses a randomly initialized Inception (numbers are '
              'self-consistent only)')
        sd = convert.random_inception_state_dict(0)
    else:
        sd = load_state_dict_file(path)
    net = InceptionV3FID(device=device).eval()
    convert.load_inception_state_dict(net, sd)
    return net


def graft_mit_backbone(encoder: BootstrapEncoder,
                       mit_sd: Dict[str, np.ndarray]) -> int:
    """Copies MiT-B5 ImageNet weights into the encoder's backbone(s) in
    place (the counterpart of the JAX package's
    `cli/train_encoder.graft_segformer_backbone`): every key the backbone
    shares with the file; the decode layers, absent from the file, keep
    their values. Returns the number of tensors copied; raises when a
    shape differs or nothing matches."""
    copied = 0
    for name in ('backbone', 'backbone_latent'):
        module = getattr(encoder, name, None)
        if module is None:
            continue
        own = module.state_dict()
        with torch.no_grad():
            for key, value in mit_sd.items():
                if key not in own:
                    continue
                if tuple(own[key].shape) != tuple(value.shape):
                    raise ValueError(
                        f'mit_b5 weights do not fit the encoder: {name}.'
                        f'{key} has shape {tuple(value.shape)}, the encoder '
                        f'expects {tuple(own[key].shape)}')
                own[key].copy_(torch.as_tensor(value))
                copied += 1
    if copied == 0:
        raise ValueError('mit_b5 weights matched no encoder backbone keys')
    return copied


def load_mit_backbone(encoder: BootstrapEncoder, root_path: str) -> bool:
    """Grafts `{root_path}/weights/mit_b5.pth` into the encoder, or warns
    that the backbone starts from random weights when it is missing.
    Returns whether it grafted."""
    path = os.path.join(weights_dir(root_path), MIT_FILE)
    if not os.path.exists(path):
        print(f'WARNING: no pretrained SegFormer at {path}; the encoder '
              'backbone trains from random init (the reference starts from '
              'mit_b5.pth - see SETUP.md)')
        return False
    graft_mit_backbone(encoder, load_state_dict_file(path))
    print('Initialized SegFormer backbone(s) from', path)
    return True
