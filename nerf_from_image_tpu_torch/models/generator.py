"""Triplane SDF radiance-field generator (PyTorch port of
`nerf_from_image_tpu/models/generator.py`).

z -> mapping -> StyleGAN2 synthesis -> a 96-channel feature image, read as
three 32-channel planes -> per point: triplane sample, decoder MLP,
SDF -> density, attention-palette colour.

Names follow the reference's state-dict keys (`mapping_network.backbone.*`,
`synthesis_network.b*`, `decoder.net.{0,2}`, `texture_mapper.*`, `beta`,
`alpha`), so a reference-format state dict loads unchanged. The slice
ports the configuration every reference dataset trains: an SDF field
(`--use_sdf` is always true there) with an attention palette. View
directions, encoder, class embedding, noise injection, normals and SDF
regularizers wait for later slices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nerf_from_image_tpu_torch.device import DeviceLike, resolve_device
from nerf_from_image_tpu_torch.models import stylegan
from nerf_from_image_tpu_torch.ops import triplane
from nerf_from_image_tpu_torch.ops import triplane_cuda

PLANE_CHANNELS = 32


def laplace_cdf(x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    return 0.5 + 0.5 * torch.sign(x) * (1.0 - torch.exp(-x.abs() / beta))


def wide_sigmoid_rescaled(x: torch.Tensor) -> torch.Tensor:
    """MipNeRF wide sigmoid rescaled to ~[-1, 1]."""
    return torch.sigmoid(x) * 2.004 - 1.002


class ConditionalLayerNorm(nn.Module):
    """LayerNorm with latent-conditioned scale and shift."""

    def __init__(self, ch: int, cond_dim: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.fc_gamma = stylegan.EqualizedLinear(cond_dim, ch, dtype=dtype,
                                                 generator=generator)
        self.fc_beta = stylegan.EqualizedLinear(cond_dim, ch, dtype=dtype,
                                                generator=generator)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        # flax LayerNorm's epsilon, without scale or bias.
        x = F.layer_norm(x.to(self.dtype), x.shape[-1:], eps=1e-6)
        gamma = self.fc_gamma(z)
        beta = self.fc_beta(z)
        while beta.ndim < x.ndim:
            beta = beta[..., None, :]
            gamma = gamma[..., None, :]
        return beta + (1.0 + gamma) * x


class AttentionMapper(nn.Module):
    """w_tex -> K RGB palette values."""

    def __init__(self, num_values: int, cond_dim: int = 512,
                 hidden_size: int = 512, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_values = num_values
        self.dtype = dtype
        self.const = nn.Parameter(torch.randn((1, hidden_size),
                                              generator=generator))
        for i in range(1, 5):
            setattr(self, f'fc{i}', stylegan.EqualizedLinear(
                hidden_size, hidden_size, bias=False, dtype=dtype,
                generator=generator))
            setattr(self, f'norm{i}', ConditionalLayerNorm(
                hidden_size, cond_dim, dtype=dtype, generator=generator))
        self.fc5 = stylegan.EqualizedLinear(hidden_size, hidden_size,
                                            dtype=dtype, generator=generator)
        self.fc_values = stylegan.EqualizedLinear(
            hidden_size, num_values * 3, dtype=dtype, generator=generator)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        scale = math.sqrt(2.0) / 2.0

        def layer(i, v):
            v = getattr(self, f'fc{i}')(v)
            return F.leaky_relu(getattr(self, f'norm{i}')(v, c), 0.2)

        x = self.const.to(self.dtype).expand(c.shape[0], -1)
        shortcut = x
        x = layer(2, layer(1, x))
        x = (x + shortcut) * scale
        shortcut = x
        x = layer(4, layer(3, x))
        x = (x + shortcut) * scale
        x = F.leaky_relu(self.fc5(x), 0.2)
        values = self.fc_values(x)
        return wide_sigmoid_rescaled(values.reshape(-1, self.num_values, 3))


class TriplanarDecoder(nn.Module):
    """Two-layer Softplus MLP on the sampled triplane features;
    `net.0` and `net.2` as in the reference."""

    def __init__(self, num_input_features: int = PLANE_CHANNELS,
                 num_output_features: int = 3, hidden_dim: int = 64,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = nn.Sequential(
            stylegan.EqualizedLinear(num_input_features, hidden_dim,
                                     dtype=dtype, generator=generator),
            nn.Softplus(),
            stylegan.EqualizedLinear(hidden_dim, 1 + num_output_features,
                                     dtype=dtype, generator=generator))

    def mlp(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Features (..., C) -> dict(features, density_or_distance)."""
        x = self.net(x)
        return {'features': x[..., 1:], 'density_or_distance': x[..., :1]}


@dataclass
class GeneratorState:
    """What `synthesize` hands to `sample`."""
    planes: torch.Tensor  # (B, 3, 32, R, R), the JAX package's layout
    planes_cl: torch.Tensor  # (B, 3, R, R, 32) channel-last, for sampling
    attention_values: torch.Tensor  # (B, K, 3)


Sampler = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class Generator(nn.Module):
    """Triplane generator; see the module docstring.

    map(z) -> ws (B, 15, 512); synthesize(ws) -> GeneratorState;
    sample(state, points, requests) -> dict of per-point outputs.

    Parameters are drawn from `torch.Generator().manual_seed(seed)` on the
    CPU, then moved to `device` (None: CUDA, raising when it is absent).
    Parameters stay float32; activations run in `dtype`.
    """

    def __init__(self, latent_dim: int, scene_range: float,
                 attention_values: int = 10,
                 img_resolution: int = 256, channel_base: int = 32768,
                 channel_max: int = 512, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        if attention_values < 1:
            raise NotImplementedError('the port needs attention_values >= 1')
        gen = torch.Generator().manual_seed(seed)
        w_dim = 512
        self.scene_range = scene_range
        self.dtype = dtype
        self.num_ws = 15  # 14 for synthesis, the last for the palette
        self.mapping_network = nn.ModuleDict({
            'backbone': stylegan.MappingNetwork(
                latent_dim, w_dim, self.num_ws, num_layers=2,
                lr_multiplier=0.01, dtype=dtype, generator=gen)})
        self.synthesis_network = stylegan.SynthesisNetwork(
            w_dim, img_resolution, 3 * PLANE_CHANNELS,
            channel_base=channel_base, channel_max=channel_max, dtype=dtype,
            generator=gen)
        self.decoder = TriplanarDecoder(PLANE_CHANNELS, attention_values,
                                        dtype=dtype, generator=gen)
        self.beta = nn.Parameter(torch.tensor([0.1]))
        self.alpha = nn.Parameter(torch.tensor([1.0]))
        self.texture_mapper = AttentionMapper(attention_values, w_dim,
                                              dtype=dtype, generator=gen)
        self.to(device)

    def map(self, z: torch.Tensor) -> torch.Tensor:
        return self.mapping_network['backbone'](z)

    def synthesize(self, ws: torch.Tensor) -> GeneratorState:
        att = self.texture_mapper(ws[:, 14])
        planes = self.synthesis_network(ws[:, :14])
        planes = planes.reshape(ws.shape[0], 3, PLANE_CHANNELS,
                                planes.shape[-2], planes.shape[-1])
        return GeneratorState(planes=planes,
                              planes_cl=triplane.planes_channel_last(planes),
                              attention_values=att)

    def sdf_to_sigma(self, density_or_distance: torch.Tensor,
                     out_of_bounds_mask: torch.Tensor) -> torch.Tensor:
        density_prealpha = laplace_cdf(-density_or_distance[..., -1],
                                       self.beta) * (1.0 - out_of_bounds_mask)
        return (1.0 / self.alpha) * density_prealpha

    def sample(self, state: GeneratorState, x_in: torch.Tensor,
               requests: Sequence[str] = ('sigma', 'rgb'),
               sampler: Sampler = triplane_cuda.sample_triplane
               ) -> Dict[str, torch.Tensor]:
        """Evaluates the field at world points.

        Args:
          x_in: (B, ..., 3) world-space points, float32.
          requests: a subset of {'sigma', 'rgb'}.
          sampler: the triplane sampler; the default takes the CUDA kernel
            for CUDA tensors and the plain version for CPU tensors.

        Returns values flattened over the non-batch dims: sigma (B, N),
        rgb (B, N, 3), and overflow_resid, a 0
        int32 scalar (the JAX package's windowed-sampler overflow count,
        which a direct gather never has).
        """
        unknown = set(requests) - {'sigma', 'rgb'}
        if unknown:
            raise NotImplementedError(f'requests not ported yet: {unknown}')
        bs = x_in.shape[0]
        x = x_in.reshape(bs, -1, 3) / self.scene_range
        oob = (x.abs() > 1.0).any(dim=-1).to(x.dtype)

        feats = sampler(state.planes_cl, x.contiguous())
        dec = self.decoder.mlp(feats.to(self.dtype))
        outputs = {'overflow_resid': torch.zeros((), dtype=torch.int32,
                                                 device=x.device)}
        if 'sigma' in requests:
            outputs['sigma'] = self.sdf_to_sigma(dec['density_or_distance'],
                                                 oob)
        if 'rgb' in requests:
            probs = torch.softmax(dec['features'], dim=-1)
            outputs['rgb'] = torch.bmm(
                probs, state.attention_values.to(probs.dtype))
        return outputs
