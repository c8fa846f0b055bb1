"""The pose-conditioned StyleGAN2 discriminator, plain: a frozen copy of
the program's `models/discriminator.py` for the unconditional
configurations the benchmark's cells train. The conditioning is the 13-D
pose vector (log f, t2, s, flattened world2cam rotation) of
`pose.matrix_to_conditioning_vector`; names follow the program's
state-dict keys.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from port_bench.reference import pose as pose_lib
from port_bench.reference import stylegan
from port_bench.reference.device import DeviceLike, resolve_device


class Discriminator(nn.Module):
    """D(x, pose, focal) -> logits (B, 1)."""

    def __init__(self, resolution: int, nc: int, camera_flipped: bool,
                 channel_base: int = 32768, channel_max: int = 512,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        self.camera_flipped = camera_flipped
        self.dtype = dtype
        self.backbone = stylegan.DiscriminatorBackbone(
            c_dim=13, img_resolution=resolution, img_channels=nc,
            channel_base=channel_base, channel_max=channel_max, dtype=dtype,
            generator=torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor, pose: torch.Tensor,
                image: Optional[torch.Tensor] = None,
                focal: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, nc, H, W); pose: (B, 4, 4) cam2world; focal: (B,) or
        None; `image` (a conditional D's) is not read."""
        c = pose_lib.matrix_to_conditioning_vector(pose, focal,
                                                   self.camera_flipped)
        return self.backbone(x, c.to(self.dtype))
