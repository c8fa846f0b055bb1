"""StyleGAN2 backbone: equalized layers, modulated conv, mapping,
synthesis and the discriminator (PyTorch port of
`nerf_from_image_tpu/models/stylegan.py`).

Module and parameter names follow the reference checkpoints, so a
reference-format state dict loads with `load_state_dict` as it is,
including the `resample_filter` and `noise_const` buffers. Parameters stay
float32; activations run in the module's `dtype` (bfloat16 on the card).
Each module draws its initial values from the `torch.Generator` it is
given. Each synthesis conv adds StyleGAN noise times its `noise_strength`
after demodulation, before the bias, in one of three modes: 'none',
'const' (its `noise_const` buffer) or 'random' (fresh per-layer draws
from a `torch.Generator`, or injected per-layer values). The
convolutions are PyTorch's (cuDNN on the card), as JAX leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from nerf_from_image_tpu_torch.ops import resample

NOISE_MODES = ('none', 'const', 'random')
# A noise source of the 'random' mode: a generator to draw from, or one
# value per noise-bearing conv layer, outermost first, each broadcastable
# to (B, 1, res, res) (the JAX package's injected form).
NoiseSource = Union[torch.Generator, Sequence[torch.Tensor]]


def conv_resampled2d(x: torch.Tensor, w: torch.Tensor, up: bool = False,
                     down: bool = False, padding: int = 0) -> torch.Tensor:
    """Conv, with 2x bilinear upsampling (transposed conv, then the
    filter) or downsampling (a 1x1 conv after `downsample2d`, or the
    transposed filter then a stride-2 conv)."""
    w = w.to(x.dtype)
    if down:
        if w.shape[-1] == 1:
            return F.conv2d(resample.downsample2d(x), w)
        return F.conv2d(resample.filter2d(x, transpose=True), w, stride=2)
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


class EqualizedConv2d(nn.Module):
    """Conv layer with runtime weight scaling and optional 2x downsampling.

    Holds the reference's `resample_filter` buffer (the bilinear filter
    the resampling applies), so reference state dicts load as they are.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, bias: bool = True, activate: bool = False,
                 down: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activate = activate
        self.down = down
        self.padding = kernel_size // 2
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.randn(
            (out_channels, in_channels, kernel_size, kernel_size),
            generator=generator))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if bias
                     else None)
        self.register_buffer('resample_filter', resample.bilinear_filter())

    def forward(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        w = (self.weight * self.weight_gain).to(self.dtype)
        x = conv_resampled2d(x.to(self.dtype), w, down=self.down,
                             padding=self.padding)
        if self.bias is not None:
            x = x + self.bias.reshape(1, -1, 1, 1).to(self.dtype)
        act_gain = (math.sqrt(2.0) if self.activate else 1.0) * gain
        if act_gain != 1.0:
            x = x * act_gain
        if self.activate:
            x = F.leaky_relu(x, 0.2)
        return x


def normalize_latent(x: torch.Tensor, dim: int = -1,
                     eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


class MappingNetwork(nn.Module):
    """z (normalized) and/or a conditioning vector c (as it is, the
    reference's `normalize_c=False`) -> w, broadcast to `num_ws`."""

    def __init__(self, z_dim: int, w_dim: int, num_ws: Optional[int],
                 num_layers: int = 8, lr_multiplier: float = 0.01,
                 c_dim: int = 0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_dim, self.c_dim = z_dim, c_dim
        self.num_ws = num_ws
        self.num_layers = num_layers
        self.dtype = dtype
        for idx in range(num_layers):
            setattr(self, f'fc{idx}', EqualizedLinear(
                z_dim + c_dim if idx == 0 else w_dim, w_dim, activate=True,
                lr_multiplier=lr_multiplier, dtype=dtype,
                generator=generator))

    def forward(self, z: Optional[torch.Tensor],
                c: Optional[torch.Tensor] = None) -> torch.Tensor:
        parts = []
        if self.z_dim > 0:
            parts.append(normalize_latent(z.to(self.dtype)))
        if self.c_dim > 0:
            parts.append(c.to(self.dtype))
        x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        for idx in range(self.num_layers):
            x = getattr(self, f'fc{idx}')(x)
        if self.num_ws is not None:
            x = x[:, None, :].expand(-1, self.num_ws, -1)
        return x


class SynthesisLayer(nn.Module):
    """Modulated conv + noise + bias + lrelu."""

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
        self.resolution = resolution
        self.noise_strength = nn.Parameter(torch.zeros(()))
        self.register_buffer('noise_const', torch.randn(
            (resolution, resolution), generator=generator))
        self.register_buffer('resample_filter', resample.bilinear_filter())

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                noise_mode: str = 'none',
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`noise`: the 'random' mode's values, broadcastable to (B, 1,
        res, res); 'const' reads `noise_const`, 'none' adds nothing."""
        styles = self.affine(w)
        x = conv_modulated2d(x, self.weight.to(self.dtype), styles,
                             up=self.up, padding=self.padding)
        if noise_mode == 'random':
            x = x + (noise.float() * self.noise_strength).to(x.dtype)
        elif noise_mode == 'const':
            x = x + (self.noise_const * self.noise_strength).to(x.dtype)
        elif noise_mode != 'none':
            raise ValueError(f'noise_mode must be one of {NOISE_MODES}, '
                             f'got {noise_mode!r}')
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
                ws: torch.Tensor, noise_mode: str = 'none',
                noise: Sequence[Optional[torch.Tensor]] = (None, None)
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ws: (B, num_conv + 1, w_dim), the last one for toRGB; `noise`:
        the 'random' mode's values of the block's convs, in order."""
        if self.in_channels == 0:
            x = self.const.to(self.dtype)[None].expand(
                (ws.shape[0],) + self.const.shape)
        else:
            x = self.conv0(x, ws[:, 0], noise_mode, noise[0])
        x = self.conv1(x, ws[:, self.num_conv - 1], noise_mode,
                       noise[self.num_conv - 1])
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

    @property
    def num_noise_layers(self) -> int:
        """The noise-bearing convs: one in b4, two in every other block."""
        return 2 * len(self.resolutions) - 1

    def noise_values(self, batch: int, source: NoiseSource,
                     device: torch.device) -> List[torch.Tensor]:
        """The 'random' mode's per-layer values, outermost layer first: the
        given sequence, or fresh float32 (batch, 1, res, res) normal draws
        from the generator, one layer after another."""
        if not isinstance(source, torch.Generator):
            values = list(source)
            if len(values) != self.num_noise_layers:
                raise ValueError(f'{len(values)} noise values for '
                                 f'{self.num_noise_layers} layers')
            return values
        return [torch.randn((batch, 1, res, res), generator=source,
                            device=device)
                for res in self.resolutions
                for _ in range(1 if res == 4 else 2)]

    def forward(self, ws: torch.Tensor, noise_mode: str = 'none',
                noise: Optional[NoiseSource] = None) -> torch.Tensor:
        """ws (B, n, w_dim) -> the feature image. A layer whose w lies past
        the n given reads the last one, as the JAX package's clamped
        indexing does: the generator passes 14, so at 512^2 every layer of
        the last block reads the 14th. `noise` is the 'random' mode's
        source (see `noise_values`); the other modes take none."""
        values = None
        if noise_mode == 'random':
            if noise is None:
                raise ValueError("noise_mode 'random' needs a noise source")
            values = self.noise_values(ws.shape[0], noise, ws.device)
        x = img = None
        w_idx = 0
        for res in self.resolutions:
            block = getattr(self, f'b{res}')
            block_noise = ((None, None) if values is None else
                           [values.pop(0) for _ in range(block.num_conv)])
            block_ws = ws[:, w_idx:w_idx + block.num_conv + 1]
            short = block.num_conv + 1 - block_ws.shape[1]
            if short > 0:
                block_ws = torch.cat(
                    (block_ws, ws[:, -1:].expand(-1, short, -1)), dim=1)
            x, img = block(x, img, block_ws, noise_mode, block_noise)
            w_idx += block.num_conv
        return img


class DiscriminatorBlock(nn.Module):
    """Residual down block: fromRGB (first block only), a 1x1 skip that
    downsamples, and two 3x3 convs, the second downsampling."""

    def __init__(self, in_channels: int, tmp_channels: int,
                 out_channels: int, img_channels: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        if in_channels == 0:
            self.fromrgb = EqualizedConv2d(img_channels, tmp_channels, 1,
                                           activate=True, dtype=dtype,
                                           generator=generator)
        self.skip = EqualizedConv2d(tmp_channels, out_channels, 1,
                                    bias=False, down=True, dtype=dtype,
                                    generator=generator)
        self.conv0 = EqualizedConv2d(tmp_channels, tmp_channels, 3,
                                     activate=True, dtype=dtype,
                                     generator=generator)
        self.conv1 = EqualizedConv2d(tmp_channels, out_channels, 3,
                                     activate=True, down=True, dtype=dtype,
                                     generator=generator)

    def forward(self, x: Optional[torch.Tensor],
                img: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if self.in_channels == 0:
            y = self.fromrgb(img)
            x = x + y if x is not None else y
            img = None
        y = self.skip(x, gain=math.sqrt(2.0) / 2.0)
        x = self.conv0(x)
        x = self.conv1(x, gain=math.sqrt(2.0) / 2.0)
        return y + x, img


def minibatch_std(x: torch.Tensor, group_size: int,
                  num_channels: int = 1) -> torch.Tensor:
    """Appends per-group feature stddev channels.

    Sample i falls in group i % (B / group_size), as in the JAX package;
    the statistics are float32.
    """
    bs, nc, h, w = x.shape
    ng, f = group_size, num_channels
    y = x.reshape(ng, bs // ng, f, nc // f, h, w).float()
    y = y - y.mean(dim=0, keepdim=True)
    y = torch.sqrt(y.square().mean(dim=0) + 1e-8)
    y = y.mean(dim=(2, 3, 4))  # (bs // ng, f)
    y = y.reshape(-1, f, 1, 1).to(x.dtype).repeat(ng, 1, h, w)
    return torch.cat((x, y), dim=1)


class DiscriminatorOutput(nn.Module):
    """4x4 head: minibatch-std over groups of 4, conv, fc, out, and the
    projection onto the conditioning's mapped vector."""

    def __init__(self, in_channels: int, cmap_dim: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cmap_dim = cmap_dim
        self.conv = EqualizedConv2d(in_channels + 1, in_channels, 3,
                                    activate=True, dtype=dtype,
                                    generator=generator)
        self.fc = EqualizedLinear(in_channels * 16, in_channels,
                                  activate=True, dtype=dtype,
                                  generator=generator)
        self.out = EqualizedLinear(in_channels, cmap_dim, dtype=dtype,
                                   generator=generator)

    def forward(self, x: torch.Tensor, cmap: torch.Tensor) -> torch.Tensor:
        x = self.conv(minibatch_std(x, 4))
        x = self.out(self.fc(x.reshape(x.shape[0], -1)))
        return (x * cmap).sum(dim=1, keepdim=True) / math.sqrt(self.cmap_dim)


class DiscriminatorBackbone(nn.Module):
    """Conditional residual discriminator: blocks b<res> down to b8, the
    conditioning's two-layer mapping network, and the b4 head."""

    def __init__(self, c_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.resolutions = [2 ** i for i in range(
            int(math.log2(img_resolution)), 2, -1)]
        channels = {r: min(channel_base // r, channel_max)
                    for r in self.resolutions + [4]}
        for res in self.resolutions:
            in_ch = channels[res] if res < img_resolution else 0
            setattr(self, f'b{res}', DiscriminatorBlock(
                in_ch, channels[res], channels[res // 2], img_channels,
                dtype=dtype, generator=generator))
        self.mapping = MappingNetwork(0, channels[4], None, num_layers=2,
                                      lr_multiplier=0.01, c_dim=c_dim,
                                      dtype=dtype, generator=generator)
        self.b4 = DiscriminatorOutput(channels[4], channels[4], dtype=dtype,
                                      generator=generator)

    def forward(self, img: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        x = None
        for res in self.resolutions:
            x, img = getattr(self, f'b{res}')(x, img)
        return self.b4(x, self.mapping(None, c))
