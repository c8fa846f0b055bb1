"""Triplane SDF radiance-field generator (PyTorch port of
`nerf_from_image_tpu/models/generator.py`).

z -> mapping -> StyleGAN2 synthesis -> a 96-channel feature image, read as
three 32-channel planes -> per point: triplane sample, decoder MLP,
SDF -> density, attention-palette colour.

Names follow the reference's state-dict keys (`mapping_network.backbone.*`,
`synthesis_network.b*`, `decoder.net.{0,2}`, `texture_mapper.*`, `beta`,
`alpha`, `viewdir_mapper.*`), so a reference-format state dict loads
unchanged. The port has the configurations the reference datasets train:
an SDF field (`--use_sdf` is always true there) with an attention
palette, StyleGAN noise (`use_stylegan_noise`: cub, imagenet_elephant),
the view-direction mapper (`use_viewdir`: carla), the SDF regularizers of
GAN training (eikonal, total variation, entropy) and the distance loss of
SDF pretraining, and as per-point outputs the normals and the palette
probabilities (the GAN evaluation's images) and the world points (the
encoder distillation's coordinate render). The flag-only modes of GAN
training are here too: the image encoder (`use_encoder`, `emb`, a
`ResidualEncoder` with instance norm) and the class embedding
(`num_classes`, `class_embedding`), whose 512-wide output conditions the
mapping, and `attention_values` 0, where the decoder emits the colour
itself (3 channels through the wide sigmoid) and there is no palette.
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


class ResidualEncoder(nn.Module):
    """Image (B, 3, H, W) -> 512-wide embedding: ten equalized convs in
    three residual stages, four 2x2 average pools, a spatial mean. With
    `use_instance_norm` (the generator's, `emb`) the middle convs lose
    their bias and an affine instance norm follows each of them; without
    it (the discriminator's) they keep it."""

    def __init__(self, use_instance_norm: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_instance_norm = use_instance_norm
        self.dtype = dtype
        mid_bias = not use_instance_norm
        layers = [('conv1', 3, 64, 3, True), ('conv2', 64, 128, 3, True),
                  ('conv3', 128, 128, 3, mid_bias),
                  ('conv4', 128, 128, 3, mid_bias),
                  ('conv5', 128, 256, 3, mid_bias),
                  ('conv6', 256, 256, 3, mid_bias),
                  ('shortcut', 128, 256, 1, False),
                  ('conv7', 256, 256, 3, mid_bias),
                  ('conv8', 256, 256, 3, mid_bias),
                  ('conv9', 256, 512, 3, True),
                  ('conv10', 512, 512, 3, True)]
        for name, cin, cout, k, bias in layers:
            setattr(self, name, stylegan.EqualizedConv2d(
                cin, cout, k, bias=bias, dtype=dtype, generator=generator))
            if use_instance_norm and name[4:].isdigit() and (
                    3 <= int(name[4:]) <= 8):
                setattr(self, f'norm{name[4:]}',
                        nn.InstanceNorm2d(cout, affine=True))

    def _norm(self, x: torch.Tensor, i: int) -> torch.Tensor:
        if not self.use_instance_norm:
            return x
        norm = getattr(self, f'norm{i}')
        return F.instance_norm(x, weight=norm.weight.to(x.dtype),
                               bias=norm.bias.to(x.dtype), eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Four stride-2 pools: below 16 pixels the final mean has nothing
        # to average.
        if x.shape[2] < 16 or x.shape[3] < 16:
            raise ValueError(f'ResidualEncoder needs input resolution >= 16,'
                             f' got {x.shape[2]}x{x.shape[3]}')
        scale = math.sqrt(2.0) / 2.0

        def act(v):
            return F.leaky_relu(v, 0.2)

        def block(v, i):
            return act(self._norm(getattr(self, f'conv{i}')(v), i))

        x = act(self.conv2(act(self.conv1(x.to(self.dtype)))))
        x = F.avg_pool2d(x, 2)
        x = F.avg_pool2d(block(block(x, 3), 4) + x, 2) * scale
        s = self.shortcut(x)
        x = F.avg_pool2d(block(block(x, 5), 6) + s, 2) * scale
        x = F.avg_pool2d(block(block(x, 7), 8) + x, 2) * scale
        x = act(self.conv10(act(self.conv9(x))))
        return x.mean(dim=(2, 3))


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


class ViewDirectionMapper(nn.Module):
    """Per-ray view-direction features and the output head: seven
    equalized linears (fc0 and fc5 with a bias), four LayerNorms and a
    zero-initialized output layer, in the reference's order."""

    def __init__(self, output_size: int, num_features: int = 32,
                 hidden_size: int = 64, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc0 = stylegan.EqualizedLinear(3, hidden_size, dtype=dtype,
                                            generator=generator)
        for i in range(1, 5):
            setattr(self, f'fc{i}', stylegan.EqualizedLinear(
                hidden_size, hidden_size, bias=False, dtype=dtype,
                generator=generator))
            setattr(self, f'norm{i}', nn.LayerNorm(hidden_size, eps=1e-6))
        self.fc5 = stylegan.EqualizedLinear(hidden_size, hidden_size,
                                            dtype=dtype, generator=generator)
        self.fc6 = stylegan.EqualizedLinear(hidden_size, num_features,
                                            dtype=dtype, generator=generator)
        self.output = stylegan.EqualizedLinear(num_features, output_size,
                                               dtype=dtype,
                                               generator=generator)
        with torch.no_grad():
            self.output.weight.zero_()

    def _norm(self, i: int, x: torch.Tensor) -> torch.Tensor:
        # flax's LayerNorm (epsilon 1e-6), in the activations' dtype.
        norm = getattr(self, f'norm{i}')
        return F.layer_norm(x, x.shape[-1:], norm.weight.to(x.dtype),
                            norm.bias.to(x.dtype), norm.eps)

    def embed(self, viewdir: torch.Tensor) -> torch.Tensor:
        """Directions (..., 3) -> features (..., num_features)."""
        scale = math.sqrt(2.0) / 2.0
        x = F.leaky_relu(self.fc0(viewdir), 0.2)
        for first in (1, 3):
            shortcut = x
            x = F.leaky_relu(self._norm(first, getattr(
                self, f'fc{first}')(x)), 0.2)
            x = F.leaky_relu(self._norm(first + 1, getattr(
                self, f'fc{first + 1}')(x)), 0.2)
            x = (x + shortcut) * scale
        x = F.leaky_relu(self.fc5(x), 0.2)
        return self.fc6(x)

    def apply_features(self, embedding: torch.Tensor,
                       features: torch.Tensor) -> torch.Tensor:
        """embedding (..., 1, F) + per-sample features (..., S, F) ->
        (..., S, output_size)."""
        return self.output(F.leaky_relu(embedding + features, 0.2))

    def forward(self, viewdir: torch.Tensor,
                features: torch.Tensor) -> torch.Tensor:
        return self.apply_features(self.embed(viewdir), features)


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

    `fuse_decode` (the JAX package's field of that name) is off;
    `fused_view()` returns the generator with it on, which makes `sample`
    run the triplane sample and the decoder tail as one forward-only call
    (kernel B5a on the card); it raises when autograd would need the
    sample's gradient. A view-direction generator decodes unfused even
    then, as the JAX package's gate has it (`fuses`).

    `use_stylegan_noise` is the model's noise policy (`noise_mode`):
    'random' when a noise source is given, 'const' when none is, 'none'
    for a model built without noise. `use_viewdir` builds the
    view-direction mapper; the decoder then emits 32 features, which the
    mapper turns into the palette logits with the embedding of each ray's
    direction (`sample(..., viewdirs=)`, which `field` passes on).
    """

    def __init__(self, latent_dim: int, scene_range: float,
                 attention_values: int = 10,
                 img_resolution: int = 256, channel_base: int = 32768,
                 channel_max: int = 512, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, seed: int = 0,
                 use_viewdir: bool = False,
                 use_stylegan_noise: bool = False,
                 use_encoder: bool = False,
                 num_classes: Optional[int] = None):
        super().__init__()
        self.fuse_decode = False
        self.use_viewdir = use_viewdir
        self.use_stylegan_noise = use_stylegan_noise
        self.use_encoder = use_encoder
        self.num_classes = num_classes
        self.attention_values = attention_values
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        w_dim = 512
        # The conditioning vector: an image's embedding or a class's, both
        # 512 wide, concatenated to the normalized latent unnormalized.
        c_dim = w_dim if (use_encoder or num_classes) else 0
        self.scene_range = scene_range
        self.latent_dim = latent_dim
        self.dtype = dtype
        # 14 ws for synthesis, and with a palette a 15th for it.
        self.num_ws = 14 + (1 if attention_values > 0 else 0)
        self.mapping_network = nn.ModuleDict({
            'backbone': stylegan.MappingNetwork(
                latent_dim, w_dim, self.num_ws, num_layers=2,
                lr_multiplier=0.01, c_dim=c_dim, dtype=dtype,
                generator=gen)})
        self.synthesis_network = stylegan.SynthesisNetwork(
            w_dim, img_resolution, 3 * PLANE_CHANNELS,
            channel_base=channel_base, channel_max=channel_max, dtype=dtype,
            generator=gen)
        colours = attention_values if attention_values > 0 else 3
        self.decoder = TriplanarDecoder(
            PLANE_CHANNELS, PLANE_CHANNELS if use_viewdir else colours,
            dtype=dtype, generator=gen)
        if use_viewdir:
            self.viewdir_mapper = ViewDirectionMapper(
                colours, PLANE_CHANNELS, dtype=dtype, generator=gen)
        self.beta = nn.Parameter(torch.tensor([0.1]))
        self.alpha = nn.Parameter(torch.tensor([1.0]))
        if attention_values > 0:
            self.texture_mapper = AttentionMapper(attention_values, w_dim,
                                                  dtype=dtype, generator=gen)
        if use_encoder:
            self.emb = ResidualEncoder(use_instance_norm=True, dtype=dtype,
                                       generator=gen)
        if num_classes:
            self.class_embedding = nn.Embedding(num_classes, w_dim)
            with torch.no_grad():
                self.class_embedding.weight.copy_(torch.randn(
                    (num_classes, w_dim), generator=gen))
        self.to(device)

    def map(self, z: torch.Tensor,
            c: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z (B, latent) and, for a conditional generator, the embedding c
        (B, 512) of `embed_image` or `embed_class` -> ws (B, num_ws,
        512). A conditional mapping raises without c, as the JAX
        package's does."""
        backbone = self.mapping_network['backbone']
        if backbone.c_dim and c is None:
            raise ValueError('this generator maps z with a conditioning '
                             'embedding c (use_encoder or num_classes)')
        return backbone(z, c)

    def embed_image(self, img: torch.Tensor) -> torch.Tensor:
        """Images (B, 3, H, W) in [-1, 1], H, W >= 16 -> (B, 512)."""
        return self.emb(img)

    def embed_class(self, labels: torch.Tensor) -> torch.Tensor:
        """Class labels (B,) -> (B, 512)."""
        return self.class_embedding(labels.long())

    def average_w(self, generator: torch.Generator,
                  n_samples: int = 10000) -> torch.Tensor:
        """Mean w over `n_samples` latents drawn from `generator` (on the
        parameters' device): (1, num_ws, 512)."""
        device = self.beta.device
        z = torch.randn((n_samples, self.latent_dim), generator=generator,
                        device=device)
        return self.map(z).float().mean(dim=0, keepdim=True)

    @property
    def fuses(self) -> bool:
        """Whether `sample` runs the fused call: `fuse_decode` on a
        generator with a palette and without view directions, as the JAX
        package's gate has it."""
        return (self.fuse_decode and not self.use_viewdir and
                self.attention_values > 0)

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
               sampler: Sampler = triplane_cuda.sample_triplane,
               viewdirs: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """Evaluates the field at world points.

        Args:
          x_in: (B, ..., 3) world-space points, float32.
          requests: a subset of {'sigma', 'rgb', 'normals', 'semantics',
            'coords'}; with `fuse_decode`, of {'sigma', 'rgb'} (the JAX
            package fuses no other request).
          sampler: the triplane sampler; the default runs the CUDA
            kernels (forward B1, backward B2) for CUDA tensors and their
            plain versions for CPU tensors, differentiable to the planes
            and the points either way. With `fuse_decode`,
            `triplane_cuda.sample_triplane_fused` (B5a on the card)
            samples and decodes on bf16 planes, as the JAX package's
            fused kernel reads them, and another sampler raises.
          viewdirs: (B, rays..., 3) each ray's normalized direction, x_in
            being (B, rays..., S, 3); a view-direction generator needs
            them for rgb and semantics, and any other ignores them.

        Returns values flattened over the non-batch dims: sigma (B, N),
        rgb (B, N, 3), normals (B, N, 3) (the normalized gradient of the
        summed SDF to the world points, taken under `enable_grad` even in
        a gradient-free render and detached: on the card the default
        sampler's forward B1, then B2's coordinate gradient; undefined
        outside the box, as in the JAX package), semantics (B, N, K) (the
        palette softmax; none without a palette), coords (B, N, 3) (the world points themselves),
        and overflow_resid, a 0
        int32 scalar (the JAX package's windowed-sampler overflow count,
        which a direct gather never has).
        """
        unknown = set(requests) - {'sigma', 'rgb', 'normals', 'semantics',
                                   'coords'}
        if unknown:
            raise NotImplementedError(f'requests not ported yet: {unknown}')
        if 'semantics' in requests and self.attention_values == 0:
            raise ValueError('a generator without a palette '
                             '(attention_values 0) has no semantics')
        bs = x_in.shape[0]
        x = x_in.reshape(bs, -1, 3) / self.scene_range
        oob = (x.abs() > 1.0).any(dim=-1).to(x.dtype)

        outputs = {'overflow_resid': torch.zeros((), dtype=torch.int32,
                                                 device=x.device)}
        if 'coords' in requests:
            outputs['coords'] = x_in.reshape(bs, -1, 3)
        if self.fuses:
            if not set(requests) <= {'sigma', 'rgb'}:
                raise ValueError(f'fuse_decode decodes sigma and rgb only, '
                                 f'not {set(requests) - {"sigma", "rgb"}}')
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

        if 'normals' in requests:
            with torch.enable_grad():
                pts = x_in.detach().reshape(bs, -1, 3).requires_grad_()
                d = self.decoder.mlp(sampler(
                    state.planes_cl, (pts / self.scene_range).contiguous()
                ).to(self.dtype))['density_or_distance'][..., -1]
                grad, = torch.autograd.grad(d.sum(), pts)
            outputs['normals'] = grad / torch.linalg.vector_norm(
                grad, dim=-1, keepdim=True).clamp_min(1e-12)
        feats = sampler(state.planes_cl, x.contiguous())
        dec = self.decoder.mlp(feats.to(self.dtype))
        if 'sigma' in requests:
            outputs['sigma'] = self.sdf_to_sigma(dec['density_or_distance'],
                                                 oob)
        if 'rgb' in requests or 'semantics' in requests:
            features = dec['features']
            if self.use_viewdir:
                features = self._apply_viewdirs(features, viewdirs, x_in)
            if self.attention_values == 0:
                # No palette: the decoder's 3 channels are the colour, and
                # there are no semantics.
                if 'rgb' in requests:
                    outputs['rgb'] = wide_sigmoid_rescaled(features)
                return outputs
            probs = torch.softmax(features, dim=-1)
            if 'semantics' in requests:
                outputs['semantics'] = probs
            if 'rgb' in requests:
                outputs['rgb'] = palette_rgb(probs, state.attention_values)
        return outputs

    def field(self, state: GeneratorState,
              sampler: Sampler = triplane_cuda.sample_triplane):
        """The `sample_fn` of `render` for `state`."""
        def sample_fn(pts, reqs, viewdirs):
            return self.sample(state, pts, reqs, sampler=sampler,
                               viewdirs=viewdirs)
        return sample_fn

    def _apply_viewdirs(self, features: torch.Tensor,
                        viewdirs: Optional[torch.Tensor],
                        x_in: torch.Tensor) -> torch.Tensor:
        """The decoder's 32 features (B, N, 32) through the mapper with
        each ray's embedding -> the palette logits (B, N, K); the points
        x_in are (B, rays..., S, 3), S samples a ray."""
        if viewdirs is None:
            raise ValueError('a view-direction generator needs the rays\' '
                             'directions for rgb and semantics')
        bs, s = x_in.shape[0], x_in.shape[-2]
        emb = self.viewdir_mapper.embed(
            viewdirs.reshape(bs, -1, 1, 3).to(self.dtype))
        feat = features.reshape(bs, -1, s, features.shape[-1])
        out = self.viewdir_mapper.apply_features(emb, feat)
        return out.reshape(bs, -1, out.shape[-1])

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
