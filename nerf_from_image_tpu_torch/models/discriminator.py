"""Pose-conditioned StyleGAN2 discriminator (PyTorch port of
`nerf_from_image_tpu/models/discriminator.py`).

The conditioning is the 13-D pose vector (log f, t2, s, flattened world2cam
rotation) of `core.pose.matrix_to_conditioning_vector`. Parameter names
follow the reference checkpoints (`backbone.b<res>.*`, `backbone.mapping.*`,
`backbone.b4.*`), so a reference-format state dict loads with
`load_state_dict`. Parameters stay float32; activations run in `dtype`
(bfloat16 on the card). It is always pose-conditioned, as the reference
trainer's `--conditional_pose` always is; the image-encoder and class
conditionings are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.device import DeviceLike, resolve_device
from nerf_from_image_tpu_torch.models import stylegan


class Discriminator(nn.Module):
    """D(x, pose, focal) -> logits (B, 1).

    Parameters are drawn from `torch.Generator().manual_seed(seed)` on the
    CPU, then moved to `device` (None: CUDA, raising when it is absent).
    """

    def __init__(self, resolution: int, nc: int, camera_flipped: bool,
                 use_encoder: bool = False,
                 num_classes: Optional[int] = None,
                 channel_base: int = 32768, channel_max: int = 512,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        if use_encoder or num_classes:
            raise NotImplementedError('the image-encoder and class '
                                      'conditionings are not ported yet')
        if nc not in (3, 4):
            raise ValueError(f'nc must be 3 or 4, got {nc}')
        self.camera_flipped = camera_flipped
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed)
        self.backbone = stylegan.DiscriminatorBackbone(
            c_dim=13, img_resolution=resolution,
            img_channels=nc, channel_base=channel_base,
            channel_max=channel_max, dtype=dtype, generator=gen)
        self.to(device)

    def forward(self, x: torch.Tensor, pose: torch.Tensor,
                image: Optional[torch.Tensor] = None,
                focal: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, nc, H, W); pose: (B, 4, 4) cam2world; focal: (B,) or
        None; image: the conditioning image of the unported modes, None."""
        if image is not None:
            raise NotImplementedError('image conditioning is not ported yet')
        cond = pose_lib.matrix_to_conditioning_vector(
            pose, focal, self.camera_flipped).to(self.dtype)
        return self.backbone(x, cond)
