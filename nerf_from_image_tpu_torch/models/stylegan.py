"""StyleGAN2 backbone: equalized layers, modulated conv, mapping and
synthesis (PyTorch port of `nerf_from_image_tpu/models/stylegan.py`).

Module and parameter names follow the reference checkpoints, so a
reference-format state dict loads with `load_state_dict` as it is,
including the `resample_filter` and `noise_const` buffers. Parameters stay
float32; activations run in the module's `dtype` (bfloat16 on the card).
Each module draws its initial values from the `torch.Generator` it is
given. The slice runs without noise injection (the generator's default),
so `noise_strength` and `noise_const` are held but not read; the
discriminator parts wait for a later slice.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nerf_from_image_tpu_torch.ops import resample


def conv_resampled2d(x: torch.Tensor, w: torch.Tensor, up: bool = False,
                     padding: int = 0) -> torch.Tensor:
    """Conv, or transposed conv + bilinear filter for 2x upsampling."""
    w = w.to(x.dtype)
    if up:
        x = F.conv_transpose2d(x, w.transpose(0, 1), stride=2)
        return resample.filter2d(x, gain=4.0)
    return F.conv2d(x, w, padding=padding)


def conv_modulated2d(x: torch.Tensor, weight: torch.Tensor,
                     styles: torch.Tensor, up: bool = False,
                     padding: int = 0, demodulate: bool = True
                     ) -> torch.Tensor:
    """Style-modulated conv: scale the input, run one conv with the shared
    weight, demodulate the output."""
    bs = x.shape[0]
    dcoefs = None
    if demodulate:
        w = weight[None] * styles.reshape(bs, 1, -1, 1, 1).to(weight.dtype)
        dcoefs = torch.rsqrt(w.square().sum(dim=(2, 3, 4)) + 1e-8)
    x = x * styles.reshape(bs, -1, 1, 1).to(x.dtype)
    x = conv_resampled2d(x, weight, up=up, padding=padding)
    if demodulate:
        x = x * dcoefs.reshape(bs, -1, 1, 1).to(x.dtype)
    return x


class EqualizedLinear(nn.Module):
    """Linear layer with runtime weight scaling."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 activate: bool = False, lr_multiplier: float = 1.0,
                 bias_init: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activate = activate
        self.lr_multiplier = lr_multiplier
        self.gain = lr_multiplier / math.sqrt(in_channels)
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.randn((out_channels, in_channels), generator=generator) /
            lr_multiplier)
        self.bias = (nn.Parameter(torch.full((out_channels,), bias_init))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype),
                     (self.weight * self.gain).to(self.dtype))
        if self.bias is not None:
            y = y + (self.bias * self.lr_multiplier).to(self.dtype)
        if self.activate:
            y = F.leaky_relu(y * math.sqrt(2.0), 0.2)
        return y


def normalize_latent(x: torch.Tensor, dim: int = -1,
                     eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


class MappingNetwork(nn.Module):
    """z -> w, broadcast to `num_ws` (unconditional)."""

    def __init__(self, z_dim: int, w_dim: int, num_ws: Optional[int],
                 num_layers: int = 8, lr_multiplier: float = 0.01,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_ws = num_ws
        self.num_layers = num_layers
        self.dtype = dtype
        for idx in range(num_layers):
            setattr(self, f'fc{idx}', EqualizedLinear(
                z_dim if idx == 0 else w_dim, w_dim, activate=True,
                lr_multiplier=lr_multiplier, dtype=dtype,
                generator=generator))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = normalize_latent(z.to(self.dtype))
        for idx in range(self.num_layers):
            x = getattr(self, f'fc{idx}')(x)
        if self.num_ws is not None:
            x = x[:, None, :].expand(-1, self.num_ws, -1)
        return x


class SynthesisLayer(nn.Module):
    """Modulated conv + bias + lrelu."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, kernel_size: int = 3, up: bool = False,
                 activate: bool = True, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.up = up
        self.activate = activate
        self.padding = kernel_size // 2
        self.dtype = dtype
        self.affine = EqualizedLinear(w_dim, in_channels, bias_init=1.0,
                                      dtype=dtype, generator=generator)
        self.weight = nn.Parameter(torch.randn(
            (out_channels, in_channels, kernel_size, kernel_size),
            generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        # Held so reference state dicts load; noise injection is not ported.
        self.noise_strength = nn.Parameter(torch.zeros(()))
        self.register_buffer('noise_const', torch.randn(
            (resolution, resolution), generator=generator))
        self.register_buffer('resample_filter', resample.bilinear_filter())

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w)
        x = conv_modulated2d(x, self.weight.to(self.dtype), styles,
                             up=self.up, padding=self.padding)
        x = x + self.bias.reshape(1, -1, 1, 1).to(self.dtype)
        if self.activate:
            x = F.leaky_relu(x * math.sqrt(2.0), 0.2)
        return x


class OutputLayer(nn.Module):
    """toRGB: modulated 1x1 conv without demodulation."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight_gain = 1.0 / math.sqrt(in_channels)
        self.dtype = dtype
        self.affine = EqualizedLinear(w_dim, in_channels, bias_init=1.0,
                                      dtype=dtype, generator=generator)
        self.weight = nn.Parameter(torch.randn(
            (out_channels, in_channels, 1, 1), generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w) * self.weight_gain
        x = conv_modulated2d(x, self.weight.to(self.dtype), styles,
                             demodulate=False)
        return x + self.bias.reshape(1, -1, 1, 1).to(self.dtype)


class SynthesisBlock(nn.Module):
    """One resolution level: (up-)conv0, conv1, toRGB skip accumulation."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, img_channels: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.dtype = dtype
        if in_channels == 0:
            self.const = nn.Parameter(torch.randn(
                (out_channels, resolution, resolution), generator=generator))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim,
                                        resolution, up=True, dtype=dtype,
                                        generator=generator)
        self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim,
                                    resolution, dtype=dtype,
                                    generator=generator)
        self.torgb = OutputLayer(out_channels, img_channels, w_dim,
                                 dtype=dtype, generator=generator)
        self.register_buffer('resample_filter', resample.bilinear_filter())

    @property
    def num_conv(self) -> int:
        return 1 if self.in_channels == 0 else 2

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                ws: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """ws: (B, num_conv + 1, w_dim), the last one for toRGB."""
        if self.in_channels == 0:
            x = self.const.to(self.dtype)[None].expand(
                (ws.shape[0],) + self.const.shape)
        else:
            x = self.conv0(x, ws[:, 0])
        x = self.conv1(x, ws[:, self.num_conv - 1])
        y = self.torgb(x, ws[:, self.num_conv])
        img = y if img is None else resample.upsample2d(img) + y
        return x, img


def synthesis_channels(img_resolution: int, channel_base: int = 32768,
                       channel_max: int = 512
                       ) -> Tuple[List[int], Dict[int, int]]:
    resolutions = [2 ** i
                   for i in range(2, int(math.log2(img_resolution)) + 1)]
    channels = {r: min(channel_base // r, channel_max) for r in resolutions}
    return resolutions, channels


class SynthesisNetwork(nn.Module):
    """4x4 const -> img_resolution feature image; blocks b4, b8, ..."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.resolutions, channels = synthesis_channels(
            img_resolution, channel_base, channel_max)
        for res in self.resolutions:
            in_ch = channels[res // 2] if res > 4 else 0
            setattr(self, f'b{res}', SynthesisBlock(
                in_ch, channels[res], w_dim, res, img_channels, dtype=dtype,
                generator=generator))

    def forward(self, ws: torch.Tensor) -> torch.Tensor:
        x = img = None
        w_idx = 0
        for res in self.resolutions:
            block = getattr(self, f'b{res}')
            x, img = block(x, img, ws[:, w_idx:w_idx + block.num_conv + 1])
            w_idx += block.num_conv
        return img
