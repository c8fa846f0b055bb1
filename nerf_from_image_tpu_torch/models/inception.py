"""InceptionV3 for FID (PyTorch port of
`nerf_from_image_tpu/models/inception.py`).

pytorch-fid's `FIDInceptionA/C/E` topology on torchvision's InceptionV3:
the A, C and E blocks average-pool without counting the padding, and the
last E block (Mixed_7c) max-pools in its pool branch. Input (B, 3, H, W)
in [0, 1] of any size, resized to 299^2 as `jax.image.resize` resizes
(bilinear, half-pixel centres, antialiased down) and scaled to [-1, 1];
output the (B, 2048) pooled activations. Module names are pytorch-fid's
state-dict keys (`Conv2d_1a_3x3.conv.weight`,
`Mixed_5b.branch1x1.bn.running_mean`, ...), the keys
`nerf_from_image_tpu/utils/torch_convert.convert_inception` reads,
so one reference-format state dict feeds both packages. Batch norm is
inference-only (eps 1e-3) and computed as the JAX package computes it.
The convolutions run in cuDNN (the JAX package leaves them to XLA).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from nerf_from_image_tpu_torch.device import DeviceLike, resolve_device

FID_SIZE = 299
BN_EPS = 1e-3

Pair = Union[int, Tuple[int, int]]


class FrozenBatchNorm(nn.Module):
    """Inference batch norm from stored statistics: x * inv + (bias -
    mean * inv), inv = rsqrt(var + 1e-3) * weight."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


class BasicConv2d(nn.Module):
    """Convolution without bias, batch norm, ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Pair, stride: int = 1,
                 padding: Pair = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = FrozenBatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_no_pad(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.branch1x1(x),
            self.branch5x5_2(self.branch5x5_1(x)),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            self.branch_pool(_avg_pool_no_pad(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.branch3x3(x),
            self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x))),
            F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dbl = x
        for i in range(1, 6):
            dbl = getattr(self, f'branch7x7dbl_{i}')(dbl)
        return torch.cat([
            self.branch1x1(x),
            self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x))),
            dbl,
            self.branch_pool(_avg_pool_no_pad(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f'branch7x7x3_{i}')(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """`pool` 'avg' (Mixed_7b, padding not counted) or 'max' (Mixed_7c)."""

    def __init__(self, cin: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        if self.pool == 'avg':
            bp = _avg_pool_no_pad(x)
        else:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         1)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size, size), `jax.image.resize`'s 'bilinear'
    (antialias on): bilinear with half-pixel centres and edge clamping
    for a resize up, and for a resize down along an axis the triangle
    filter widened by the scale (antialiased), as
    `F.interpolate(..., antialias=True)` computes it."""
    if x.shape[-2:] == (size, size):
        return x
    down = x.shape[-2] > size or x.shape[-1] > size
    return F.interpolate(x, size=(size, size), mode='bilinear',
                         align_corners=False, antialias=down)


class InceptionV3FID(nn.Module):
    """(B, 3, H, W) in [0, 1], any H and W (resized to 299^2 by
    `resize_bilinear`) -> (B, 2048) float32 pool3 activations.

    Parameters and statistics start at identity batch norms; a
    reference-format state dict (`utils.convert.random_inception_state_dict`
    or the TF-FID weights' pytorch-fid form) replaces them through
    `utils.convert.load_inception_state_dict`. The module is built on
    `device` (None: CUDA, raising when it is absent) in eval mode.
    """

    def __init__(self, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, 'avg')
        self.Mixed_7c = InceptionE(2048, 'max')
        self.to(device)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = 2.0 * resize_bilinear(x.float(), FID_SIZE) - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ('Mixed_5b', 'Mixed_5c', 'Mixed_5d', 'Mixed_6a',
                     'Mixed_6b', 'Mixed_6c', 'Mixed_6d', 'Mixed_6e',
                     'Mixed_7a', 'Mixed_7b', 'Mixed_7c'):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))
