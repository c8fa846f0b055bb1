"""Bootstrap encoder: SegFormer -> (canonical coordinates, mask, latent w)
(PyTorch port of `nerf_from_image_tpu/models/encoder.py`).

A 4x-upsampled convolution head regresses three channels of canonical
coordinates and a sigmoid mask; a pooled head regresses the StyleGAN
latent w. `separate_backbones` gives the latent head its own SegFormer
(the CLI's `--inv_use_separate`). Module names are the reference state
dict's (`backbone.*`, `backbone_latent.*`, `post.{0,2,4}`,
`w_regressor_pre.0`, `w_regressor_post.{0,2}`), the keys
`nerf_from_image_tpu/utils/torch_convert.convert_bootstrap_encoder`
reads. The backbone's size options let tests run a tiny one; the
defaults are MiT-B5.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nerf_from_image_tpu_torch.device import DeviceLike, resolve_device
from nerf_from_image_tpu_torch.models.segformer import Segformer


class BootstrapEncoder(nn.Module):
    """(B, 3, H, W) images in [-1, 1] -> (coords (B, H, W, 3), mask
    (B, H, W), w (B, 1, latent_dim)), all float32.

    Parameters take PyTorch's default initialisation; a reference-format
    state dict (`utils.convert.random_encoder_state_dict`, or a trained
    encoder's) replaces them through `load_state_dict`. The module is
    built on `device` (None: CUDA, raising when it is absent).
    """

    def __init__(self, latent_dim: int, separate_backbones: bool = False,
                 depths: Sequence[int] = (3, 6, 40, 3),
                 embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 drop_path_rate: float = 0.1, head_width: int = 512,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)

        def backbone():
            return Segformer(
                out_features=head_width, embed_dims=embed_dims,
                num_heads=num_heads, drop_path_rate=drop_path_rate,
                depths=depths, sr_ratios=sr_ratios,
                decoder_dim=768 if head_width == 512 else 2 * head_width)

        self.backbone = backbone()
        if separate_backbones:
            self.backbone_latent = backbone()
        self.post = nn.Sequential(
            nn.Conv2d(head_width, head_width, 3, padding=1), nn.ReLU(),
            nn.Conv2d(head_width, head_width, 3, padding=1), nn.ReLU(),
            nn.Conv2d(head_width, 4, 3, padding=1))
        self.w_regressor_pre = nn.Sequential(
            nn.Conv2d(head_width, head_width, 3, padding=1))
        self.w_regressor_post = nn.Sequential(
            nn.Linear(head_width, head_width), nn.ReLU(),
            nn.Linear(head_width, latent_dim))
        self.to(device)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        features = self.backbone(x)

        f = F.interpolate(features, size=(4 * features.shape[2],
                                          4 * features.shape[3]),
                          mode='bilinear', align_corners=False)
        maps = self.post(F.relu(f))
        coords = maps[:, :3].permute(0, 2, 3, 1).float()
        mask = torch.sigmoid(maps[:, 3]).float()

        if hasattr(self, 'backbone_latent'):
            features = self.backbone_latent(x)
        fl = F.relu(self.w_regressor_pre(F.relu(features)))
        w = self.w_regressor_post(fl.mean(dim=(2, 3)))
        w = F.leaky_relu(w, 0.2)[:, None, :].float()
        return coords, mask, w
