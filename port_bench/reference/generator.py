"""The triplane SDF radiance-field generator, plain: a frozen copy of the
program's `models/generator.py` with the configurations the benchmark's
cells run (an SDF field with an attention palette, with or without
StyleGAN noise) and the plain samplers in place of the kernels.

z -> mapping -> StyleGAN2 synthesis -> a 96-channel feature image, read as
three 32-channel planes -> per point: triplane sample, decoder MLP,
SDF -> density, attention-palette colour. Names follow the program's
state-dict keys, so the same seeded state dict loads into both.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.device import DeviceLike, resolve_device
from port_bench.reference import grids
from port_bench.reference import stylegan
from port_bench.reference import triplane

PLANE_CHANNELS = 32


def sample_bf16(planes_cl: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The sampler as the configuration states it: the planes rounded to
    bf16, sampled in float32, the features rounded to bf16. The roundings
    are casts, so autograd rounds the gradients at the same boundaries."""
    planes = planes_cl.to(torch.bfloat16).float()
    return triplane.plain_sampler(planes, coords).to(torch.bfloat16)


def sample_fused(planes_cl, coords, w0, b0, w1, b1, palette):
    """The fused sample-and-decode on bf16 planes, weights and palette."""
    bf = torch.bfloat16
    return triplane.sample_triplane_fused_plain(
        planes_cl.to(bf), coords, w0.to(bf), b0.float(), w1.to(bf),
        b1.float(), palette.to(bf))
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
    attention_values: Optional[torch.Tensor]  # (B, K, 3); None for K = 0
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

    `fuse_decode` is off; `fused_view()` returns the generator with it
    on, which makes `sample` run the triplane sample and the decoder tail
    in one forward (`sample_fused`, the roundings of the program's fused
    kernel).

    `use_stylegan_noise` is the model's noise policy (`noise_mode`):
    'random' when a noise source is given, 'const' when none is, 'none'
    for a model built without noise.
    """

    def __init__(self, latent_dim: int, scene_range: float,
                 attention_values: int = 10,
                 img_resolution: int = 256, channel_base: int = 32768,
                 channel_max: int = 512, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, seed: int = 0,
                 use_stylegan_noise: bool = False):
        super().__init__()
        self.fuse_decode = False
        # The unfused sampler: the configuration's bf16 roundings on the
        # card; `triplane.plain_sampler` (float32 throughout) is what the
        # program runs on the CPU.
        self.plane_sampler = sample_bf16
        self.use_stylegan_noise = use_stylegan_noise
        self.attention_values = attention_values
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        w_dim = 512
        self.scene_range = scene_range
        self.latent_dim = latent_dim
        self.dtype = dtype
        # 14 ws for synthesis, and with a palette a 15th for it.
        self.num_ws = 14 + (1 if attention_values > 0 else 0)
        self.mapping_network = nn.ModuleDict({
            'backbone': stylegan.MappingNetwork(
                latent_dim, w_dim, self.num_ws, num_layers=2,
                lr_multiplier=0.01, dtype=dtype,
                generator=gen)})
        self.synthesis_network = stylegan.SynthesisNetwork(
            w_dim, img_resolution, 3 * PLANE_CHANNELS,
            channel_base=channel_base, channel_max=channel_max, dtype=dtype,
            generator=gen)
        colours = attention_values if attention_values > 0 else 3
        self.decoder = TriplanarDecoder(PLANE_CHANNELS, colours, dtype=dtype,
                                        generator=gen)
        self.beta = nn.Parameter(torch.tensor([0.1]))
        self.alpha = nn.Parameter(torch.tensor([1.0]))
        if attention_values > 0:
            self.texture_mapper = AttentionMapper(attention_values, w_dim,
                                                  dtype=dtype, generator=gen)
        self.to(device)

    def map(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, latent) -> ws (B, num_ws, 512)."""
        return self.mapping_network['backbone'](z)

    @property
    def fuses(self) -> bool:
        """Whether `sample` runs the fused call: `fuse_decode` on a
        generator with a palette."""
        return self.fuse_decode and self.attention_values > 0

    def noise_mode(self, noise: Optional[stylegan.NoiseSource]) -> str:
        """The noise policy: 'none' for a model built without noise, else
        'random' with a noise source and 'const' without one."""
        if not self.use_stylegan_noise:
            return 'none'
        return 'random' if noise is not None else 'const'

    def synthesize_planes(self, ws: torch.Tensor,
                          noise: Optional[stylegan.NoiseSource] = None
                          ) -> torch.Tensor:
        """The synthesis ws (B, 14, 512) -> planes (B, 3, 32, R, R), with
        the noise of `noise_mode(noise)`."""
        planes = self.synthesis_network(ws, self.noise_mode(noise), noise)
        return planes.reshape(ws.shape[0], 3, PLANE_CHANNELS,
                              planes.shape[-2], planes.shape[-1])

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

    def synthesize(self, ws: torch.Tensor,
                   noise: Optional[stylegan.NoiseSource] = None
                   ) -> GeneratorState:
        """ws (B, num_ws, 512) -> the state `sample` reads. `noise`: a
        `torch.Generator` or per-layer values for the 'random' mode (see
        `noise_mode`). The 15th w makes the palette; without one
        (attention_values 0) all ws go to the synthesis."""
        att = None
        if self.attention_values > 0:
            att = self.texture_mapper(ws[:, 14])
            ws = ws[:, :14]
        planes = self.synthesize_planes(ws, noise)
        fused_tail = None
        if self.fuses:
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
               sampler: Optional[Sampler] = None
               ) -> Dict[str, torch.Tensor]:
        """Evaluates the field at world points x_in (B, ..., 3).

        `requests`: a subset of {'sigma', 'rgb', 'coords'}; `sampler`: the
        triplane sampler (`plane_sampler` when None); with `fuse_decode`
        the fused sample-and-decode. Returns values flattened over the
        non-batch dims: sigma (B, N), rgb (B, N, 3), coords (B, N, 3) (the
        world points themselves), and overflow_resid, a 0 int32 scalar.
        """
        sampler = self.plane_sampler if sampler is None else sampler
        bs = x_in.shape[0]
        x = x_in.reshape(bs, -1, 3) / self.scene_range
        oob = (x.abs() > 1.0).any(dim=-1).to(x.dtype)

        outputs = {'overflow_resid': torch.zeros((), dtype=torch.int32,
                                                 device=x.device)}
        if 'coords' in requests:
            outputs['coords'] = x_in.reshape(bs, -1, 3)
        if self.fuses:
            out4 = sample_fused(
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

    def field(self, state: GeneratorState,
              sampler: Optional[Sampler] = None):
        """The `sample_fn` of `render` for `state`."""
        def sample_fn(pts, reqs, viewdirs):
            return self.sample(state, pts, reqs, sampler=sampler)
        return sample_fn

    def sdf_losses(self, planes_cl: torch.Tensor,
                   rng: Union[torch.Generator, Dict[str, torch.Tensor]],
                   requests: Sequence[str] = ('sdf_eikonal_loss',),
                   nstrata: int = 32) -> Dict[str, torch.Tensor]:
        """Eikonal, distance, total-variation and entropy losses on
        stratified volume samples, each (B,).

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
          requests: a subset of {'sdf_eikonal_loss', 'sdf_distance_loss',
            'total_variation_loss', 'entropy_loss'}. The distance loss is
            the MSE of the decoded distance to a detached ||x|| - 1, the
            signed distance of the unit sphere (SDF pretraining).
        """
        unknown = set(requests) - {'sdf_eikonal_loss', 'sdf_distance_loss',
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

        if 'sdf_distance_loss' in requests:
            target = torch.linalg.vector_norm(bins_in.detach(), dim=-1) - 1.0
            outputs['sdf_distance_loss'] = mean((d - target).square())
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
