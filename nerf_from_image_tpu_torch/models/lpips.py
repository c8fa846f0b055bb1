"""LPIPS perceptual distance with a VGG16 backbone (PyTorch port of
`nerf_from_image_tpu/models/lpips.py`).

Scaling layer -> VGG16 conv features at relu{1_2,2_2,3_3,4_3,5_3} ->
unit-normalize -> squared difference -> non-negative 1x1 `lin` weights ->
spatial mean -> sum over the five layers.

State-dict keys are the reference checkpoints' own: torchvision's
`features.<i>.{weight,bias}` and the lpips package's
`lin<i>.model.1.weight`, the two dicts that the JAX package's
`utils/torch_convert.py:convert_lpips` takes. The convolutions are
PyTorch's (cuDNN on the card), as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from nerf_from_image_tpu_torch.device import DeviceLike, resolve_device

# VGG16 conv widths per block (torchvision `vgg16().features`).
VGG_BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
              (512, 512, 512))
LIN_CHANNELS = (64, 128, 256, 512, 512)

# ImageNet scaling used by LPIPS (inputs in [-1, 1]).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16 conv tower (`features.0` to `features.29`, torchvision's layer
    indices) returning the five LPIPS feature maps. NCHW in and out."""

    def __init__(self):
        super().__init__()
        layers = []
        self.taps = []
        in_ch = 3
        for b, widths in enumerate(VGG_BLOCKS):
            if b > 0:
                layers.append(nn.MaxPool2d(2, 2))
            for w in widths:
                layers += [nn.Conv2d(in_ch, w, 3, padding=1), nn.ReLU()]
                in_ch = w
            self.taps.append(len(layers) - 1)
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                feats.append(x)
        return tuple(feats)


class _NetLin(nn.Module):
    """lpips' NetLinLayer: `model.1` is the 1x1 conv (`model.0` is its
    dropout, which LPIPS never runs)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / (norm + eps)


class LPIPS(VGG16Features):
    """Full LPIPS distance, inputs NCHW in [-1, 1]; returns (B, 1, 1, 1)
    distances, as lpips does (the JAX package returns (B, 1)).

    Built on `device` (None: CUDA, raising when it is absent), with
    PyTorch's default initialisation; load weights with
    `utils.convert.load_lpips_state_dicts`.
    """

    def __init__(self, device: DeviceLike = None):
        device = resolve_device(device)
        super().__init__()
        for i, c in enumerate(LIN_CHANNELS):
            setattr(self, f'lin{i}', _NetLin(c))
        self.register_buffer('shift', torch.tensor(_SHIFT).reshape(
            1, 3, 1, 1), persistent=False)
        self.register_buffer('scale', torch.tensor(_SCALE).reshape(
            1, 3, 1, 1), persistent=False)
        self.to(device)

    def layer_features(self, im: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Scaled VGG features, unit-normalized per layer."""
        feats = super().forward((im - self.shift) / self.scale)
        return tuple(normalize_tensor(f) for f in feats)

    def forward(self, in0: torch.Tensor,
                in1: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for i, (x, y) in enumerate(zip(self.layer_features(in0),
                                       self.layer_features(in1))):
            d = getattr(self, f'lin{i}')((x - y) ** 2)
            total = total + d.mean(dim=(2, 3), keepdim=True)
        return total
