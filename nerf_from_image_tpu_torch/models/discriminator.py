"""Pose-conditioned StyleGAN2 discriminator (PyTorch port of
`nerf_from_image_tpu/models/discriminator.py`).

The conditioning is the 13-D pose vector (log f, t2, s, flattened world2cam
rotation) of `core.pose.matrix_to_conditioning_vector`. Parameter names
follow the reference checkpoints (`backbone.b<res>.*`, `backbone.mapping.*`,
`backbone.b4.*`), so a reference-format state dict loads with
`load_state_dict`. Parameters stay float32; activations run in `dtype`
(bfloat16 on the card). It is always pose-conditioned, as the reference
trainer's `--conditional_pose` always is. An image-conditional
discriminator (`use_encoder`) also embeds its conditioning image with a
`ResidualEncoder` without instance norm (`emb`); a class-conditional one
(`num_classes`) embeds class labels (`label_embedding`), and then takes
the labels in place of the image, which the class embedding overrides,
as the reference's does. The embedding comes before the pose vector.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.device import DeviceLike, resolve_device
from nerf_from_image_tpu_torch.models import stylegan
from nerf_from_image_tpu_torch.models.generator import ResidualEncoder


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
        if nc not in (3, 4):
            raise ValueError(f'nc must be 3 or 4, got {nc}')
        self.camera_flipped = camera_flipped
        self.dtype = dtype
        self.use_encoder = use_encoder
        self.num_classes = num_classes
        gen = torch.Generator().manual_seed(seed)
        # One embedding at most: the class table wins over the image, and
        # then D has no image encoder (the JAX package's never runs it).
        c_dim = 13 + (512 if use_encoder or num_classes else 0)
        # Drawn first, so that an unconditional D keeps its weights;
        # registered last, after the embeddings, in the reference's
        # parameter order.
        backbone = stylegan.DiscriminatorBackbone(
            c_dim=c_dim, img_resolution=resolution,
            img_channels=nc, channel_base=channel_base,
            channel_max=channel_max, dtype=dtype, generator=gen)
        if use_encoder and not num_classes:
            self.emb = ResidualEncoder(dtype=dtype, generator=gen)
        if num_classes:
            self.label_embedding = nn.Embedding(num_classes, 512)
            with torch.no_grad():
                self.label_embedding.weight.copy_(torch.randn(
                    (num_classes, 512), generator=gen))
        self.backbone = backbone
        self.to(device)

    def forward(self, x: torch.Tensor, pose: torch.Tensor,
                image: Optional[torch.Tensor] = None,
                focal: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, nc, H, W); pose: (B, 4, 4) cam2world; focal: (B,) or
        None; image: the conditioning, read only by a conditional D: class
        labels (B,) when it has `num_classes`, else with `use_encoder`
        images (B, 3, H', W') in [-1, 1]."""
        parts = []
        if self.num_classes:
            parts.append(self.label_embedding(image.long()).to(self.dtype))
        elif self.use_encoder:
            parts.append(self.emb(image).to(self.dtype))
        parts.append(pose_lib.matrix_to_conditioning_vector(
            pose, focal, self.camera_flipped).to(self.dtype))
        return self.backbone(x, torch.cat(parts, dim=-1))
