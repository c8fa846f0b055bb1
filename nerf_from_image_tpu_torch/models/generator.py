"""Triplane SDF radiance-field generator (PyTorch port of
`nerf_from_image_tpu/models/generator.py`).

z -> mapping -> StyleGAN2 synthesis -> a 96-channel feature image, read as
three 32-channel planes -> per point: triplane sample, decoder MLP,
SDF -> density, attention-palette colour.

Names follow the reference's state-dict keys (`mapping_network.backbone.*`,
`synthesis_network.b*`, `decoder.net.{0,2}`, `texture_mapper.*`, `beta`,
`alpha`), so a reference-format state dict loads unchanged. The slice
ports the configuration every reference dataset trains: an SDF field
(`--use_sdf` is always true there) with an attention palette, and the SDF
regularizers of GAN training (eikonal, total variation, entropy). View
directions, encoder, class embedding, noise injection and normals wait for
later slices.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from nerf_from_image_tpu_torch.core import grids
from nerf_from_image_tpu_torch.device import DeviceLike, resolve_device
from nerf_from_image_tpu_torch.models import stylegan
from nerf_from_image_tpu_torch.ops import triplane
from nerf_from_image_tpu_torch.ops import triplane_cuda

PLANE_CHANNELS = 32
# Points per batch entry of the palette product (see `palette_rgb`).
PALETTE_CHUNK = 4096


def laplace_pdf(x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.exp(-x.abs() / beta) / beta


def laplace_cdf(x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    return 0.5 + 0.5 * torch.sign(x) * (1.0 - torch.exp(-x.abs() / beta))


def wide_sigmoid_rescaled(x: torch.Tensor) -> torch.Tensor:
    """MipNeRF wide sigmoid rescaled to ~[-1, 1]."""
    return torch.sigmoid(x) * 2.004 - 1.002


def palette_rgb(probs: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """Per-point colour: (B, N, K) palette probabilities times the (B, K, 3)
    palette -> (B, N, 3), in the probabilities' dtype.

    The points are split into chunks of PALETTE_CHUNK (or of the largest
    power of two that divides N, if that is at least an eighth of it),
    each a batch entry of one product against its image's palette. The
    product's backward to the palette is then a sum over each chunk's
    points, run by many blocks at once, and a sum of the (B, chunks, K, 3)
    partials, where one product per image would reduce all N points into
    a K x 3 output on a handful of blocks.
    """
    b, n, k = probs.shape
    chunk = math.gcd(n, PALETTE_CHUNK)
    palette = palette.to(probs.dtype)
    if chunk < PALETTE_CHUNK // 8:
        return torch.bmm(probs, palette)
    per_chunk = palette[:, None].expand(b, n // chunk, k, 3).reshape(-1, k, 3)
    return torch.bmm(probs.reshape(-1, chunk, k), per_chunk).reshape(b, n, 3)


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
    # With `fuse_decode`: (w0, b0, w1, b1, palette) in the fused call's
    # types, built once per `synthesize` rather than on every pass.
    fused_tail: Optional[Tuple[torch.Tensor, ...]] = None


Sampler = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class Generator(nn.Module):
    """Triplane generator; see the module docstring.

    map(z) -> ws (B, 15, 512); synthesize(ws) -> GeneratorState;
    sample(state, points, requests) -> dict of per-point outputs.

    Parameters are drawn from `torch.Generator().manual_seed(seed)` on the
    CPU, then moved to `device` (None: CUDA, raising when it is absent).
    Parameters stay float32; activations run in `dtype`.

    `fuse_decode` (the JAX package's field of that name) is off;
    `fused_view()` returns the generator with it on, which makes `sample`
    run the triplane sample and the decoder tail as one forward-only call
    (kernel B5a on the card); it raises when autograd would need the
    sample's gradient.
    """

    def __init__(self, latent_dim: int, scene_range: float,
                 attention_values: int = 10,
                 img_resolution: int = 256, channel_base: int = 32768,
                 channel_max: int = 512, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        self.fuse_decode = False
        device = resolve_device(device)
        if attention_values < 1:
            raise NotImplementedError('the port needs attention_values >= 1')
        gen = torch.Generator().manual_seed(seed)
        w_dim = 512
        self.scene_range = scene_range
        self.latent_dim = latent_dim
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

    def average_w(self, generator: torch.Generator,
                  n_samples: int = 10000) -> torch.Tensor:
        """Mean w over `n_samples` latents drawn from `generator` (on the
        parameters' device): (1, num_ws, 512)."""
        device = self.beta.device
        z = torch.randn((n_samples, self.latent_dim), generator=generator,
                        device=device)
        return self.map(z).float().mean(dim=0, keepdim=True)

    def fused_view(self) -> 'Generator':
        """A shallow copy with `fuse_decode` on: the same parameter and
        buffer tensors, sampled and decoded in one forward-only call."""
        view = copy.copy(self)
        view.fuse_decode = True
        return view

    def fused_decode_weights(self):
        """The decoder's equalized weights as the fused call takes them:
        (w0 (32, 64), b0 (64,), w1 (64, 1 + K), b1 (1 + K,)), input index
        first, as `nerf_from_image_tpu/models/generator.py` builds them
        for its fused kernel."""
        first, second = self.decoder.net[0], self.decoder.net[2]
        return ((first.weight * first.gain).t(),
                first.bias * first.lr_multiplier,
                (second.weight * second.gain).t(),
                second.bias * second.lr_multiplier)

    def synthesize(self, ws: torch.Tensor) -> GeneratorState:
        att = self.texture_mapper(ws[:, 14])
        planes = self.synthesis_network(ws[:, :14])
        planes = planes.reshape(ws.shape[0], 3, PLANE_CHANNELS,
                                planes.shape[-2], planes.shape[-1])
        fused_tail = None
        if self.fuse_decode:
            w0, b0, w1, b1 = self.fused_decode_weights()
            fused_tail = tuple(
                t.to(dtype).contiguous() for t, dtype in (
                    (w0, torch.bfloat16), (b0, torch.float32),
                    (w1, torch.bfloat16), (b1, torch.float32),
                    (att, torch.bfloat16)))
        return GeneratorState(planes=planes,
                              planes_cl=triplane.planes_channel_last(planes),
                              attention_values=att, fused_tail=fused_tail)

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
          sampler: the triplane sampler; the default runs the CUDA
            kernels (forward B1, backward B2) for CUDA tensors and their
            plain versions for CPU tensors, differentiable to the planes
            and the points either way. With `fuse_decode`,
            `triplane_cuda.sample_triplane_fused` (B5a on the card)
            samples and decodes on bf16 planes, as the JAX package's
            fused kernel reads them, and another sampler raises.

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

        outputs = {'overflow_resid': torch.zeros((), dtype=torch.int32,
                                                 device=x.device)}
        if self.fuse_decode:
            if sampler is not triplane_cuda.sample_triplane:
                raise ValueError('fuse_decode samples through the fused '
                                 'call; sample another way without it')
            if state.fused_tail is None:
                raise ValueError('the state was synthesized without '
                                 'fuse_decode')
            out4 = triplane_cuda.sample_triplane_fused(
                state.planes_cl, x.contiguous(), *state.fused_tail)
            if 'sigma' in requests:
                outputs['sigma'] = self.sdf_to_sigma(
                    out4[..., :1].to(self.dtype), oob)
            if 'rgb' in requests:
                outputs['rgb'] = out4[..., 1:].to(self.dtype)
            return outputs

        feats = sampler(state.planes_cl, x.contiguous())
        dec = self.decoder.mlp(feats.to(self.dtype))
        if 'sigma' in requests:
            outputs['sigma'] = self.sdf_to_sigma(dec['density_or_distance'],
                                                 oob)
        if 'rgb' in requests:
            probs = torch.softmax(dec['features'], dim=-1)
            outputs['rgb'] = palette_rgb(probs, state.attention_values)
        return outputs

    def sdf_losses(self, planes_cl: torch.Tensor,
                   rng: Union[torch.Generator, Dict[str, torch.Tensor]],
                   requests: Sequence[str] = ('sdf_eikonal_loss',),
                   nstrata: int = 32) -> Dict[str, torch.Tensor]:
        """Eikonal, total-variation and entropy losses on stratified
        volume samples, each (B,).

        The decodes run on `ops.triplane.sample_triplane_gather`, which
        autograd differentiates twice: the eikonal loss is a function of
        the SDF's gradient to the points, and the step differentiates it
        again to the planes and the decoder.

        Args:
          planes_cl: (B, 3, R, R, 32) channel-last planes.
          rng: a `torch.Generator` (the strata jitter, then the
            perturbation, on its device), or the draws themselves,
            {'strata': uniform (B, n, n, n, 3), 'perturb': normal
            (B, n^3, 3)} with n = nstrata - 1.
          requests: a subset of {'sdf_eikonal_loss',
            'total_variation_loss', 'entropy_loss'}.
        """
        unknown = set(requests) - {'sdf_eikonal_loss',
                                   'total_variation_loss', 'entropy_loss'}
        if unknown:
            raise NotImplementedError(f'requests not ported yet: {unknown}')
        bs = planes_cl.shape[0]
        strata = rng['strata'] if isinstance(rng, dict) else rng
        bins_in = grids.sample_volume_stratified(strata, bs, nstrata,
                                                 self.scene_range)

        def decode_d(pts):
            feats = triplane.sample_triplane_gather(
                planes_cl, (pts / self.scene_range).contiguous())
            return self.decoder.mlp(feats.to(self.dtype))[
                'density_or_distance'][..., -1]

        outputs = {}
        if 'sdf_eikonal_loss' in requests:
            pts = bins_in.requires_grad_()
            d = decode_d(pts)
            grad, = torch.autograd.grad(d.sum(), pts, create_graph=True)
            magnitude = torch.linalg.vector_norm(grad, dim=-1)
            outputs['sdf_eikonal_loss'] = (magnitude - 1.0).square().reshape(
                bs, -1).mean(dim=1)
        else:
            d = decode_d(bins_in)

        def mean(x):
            return x.reshape(bs, -1).mean(dim=1)

        if 'total_variation_loss' in requests:
            if isinstance(rng, dict):
                noise = rng['perturb'].reshape(bins_in.shape)
            else:
                noise = torch.randn(bins_in.shape, generator=rng,
                                    device=bins_in.device)
            perturbed = bins_in.detach() + noise * 0.004 * self.scene_range
            d_perturb = decode_d(perturbed)
            outputs['total_variation_loss'] = mean(
                (laplace_cdf(-d, self.beta) -
                 laplace_cdf(-d_perturb, self.beta)).abs())
        if 'entropy_loss' in requests:
            outputs['entropy_loss'] = mean(laplace_pdf(-d, self.beta))
        return outputs
