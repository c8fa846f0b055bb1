"""Model FLOPs of the triplane StyleGAN generator, VGG LPIPS and the
inversion, from shapes alone.

The convention is torch.utils.flop_counter's: the multiply-adds of
convolutions and matrix products, two FLOPs each; elementwise work,
norms, pooling and the triplane sampler's taps are not counted. A
transposed convolution counts its input's pixels. The forward of a part
is F. Its backward is counted as the gradients the inversion needs: the
data gradient alone (F) where the weights are constants, as all of the
inversion's are; the weights' gradient would be another F. Work done
twice to save memory is counted once.

Training's G + D pair counts the backward of a trained part as 2F (data
and weight gradients), R1's gradient of the real logits as F of the
discriminator and its backward as 2F more, and leaves out the SDF
regularizers' decodes (under 1% of a pair). FlopCounterMode counts a
discriminator step of the reference 2% below this convention: the first
layer needs no data gradient.

The inversion's batch: two checkpoint evaluations (each the front render
and the render from the permuted cameras, synthesis and decode, and
LPIPS of the front render against the target) and the refinement steps
(the render and LPIPS of the image and its crops against the target's,
forward, and the backward of the rendered side). The encoder's one
forward a batch is not counted: it is under 0.1% of the batch's FLOPs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

PLANE_CHANNELS = 32
VGG = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
       (512, 512, 512))
LPIPS_TAPS = (64, 128, 256, 512, 512)


def synthesis_channels(res: int, base: int, cmax: int
                       ) -> Tuple[List[int], Dict[int, int]]:
    resolutions = [2 ** i for i in range(2, int(math.log2(res)) + 1)]
    return resolutions, {r: min(base // r, cmax) for r in resolutions}


def synthesis(res: int, base: int, cmax: int, w_dim: int = 512,
              img_channels: int = 3 * PLANE_CHANNELS) -> int:
    """One image's synthesis forward: each layer's affine and modulated
    conv (the up-convolution transposed, then the 4x4 filter), toRGB, and
    the skip image's upsampling."""
    resolutions, ch = synthesis_channels(res, base, cmax)
    flops = 0
    for r in resolutions:
        c = ch[r]
        if r > 4:
            cin = ch[r // 2]
            flops += 2 * w_dim * cin                       # conv0 affine
            flops += 2 * 9 * cin * c * (r // 2) ** 2       # transposed conv
            flops += 2 * 16 * c * r * r                    # 4x4 filter
            flops += 2 * 16 * img_channels * (r // 2) ** 2  # skip upsample
        flops += 2 * w_dim * c + 2 * 9 * c * c * r * r     # conv1
        flops += 2 * w_dim * c + 2 * c * img_channels * r * r  # toRGB
    return flops


def palette(width: int = 512, values: int = 10) -> int:
    """The attention palette's mapper, one image."""
    return 13 * 2 * width * width + 2 * width * values * 3


def palette_grad(width: int = 512, values: int = 10) -> int:
    """The palette mapper's data gradient: every product but the first
    layer's, whose input is the learnt constant."""
    return palette(width, values) - 2 * width * width


def decode_point(hidden: int = 64, values: int = 10) -> int:
    """The decoder MLP and the palette product at one point."""
    return (2 * PLANE_CHANNELS * hidden + 2 * hidden * (1 + values) +
            2 * values * 3)


def vgg(h: int, w: int) -> int:
    """VGG16's convolutions on one image of h x w."""
    flops, cin = 0, 3
    for block, widths in enumerate(VGG):
        s = 2 ** block
        for c in widths:
            flops += 2 * 9 * cin * c * (h // s) * (w // s)
            cin = c
    return flops


def lpips_lins(h: int, w: int) -> int:
    """LPIPS's five 1x1 'lin' layers on one pair's feature differences."""
    return sum(2 * c * (h // 2 ** i) * (w // 2 ** i)
               for i, c in enumerate(LPIPS_TAPS))


def mapping(z_dim: int = 512, w_dim: int = 512, layers: int = 2) -> int:
    """The mapping network, one latent."""
    return 2 * z_dim * w_dim + (layers - 1) * 2 * w_dim * w_dim


def discriminator(res: int, nc: int, base: int, cmax: int,
                  c_dim: int = 13) -> int:
    """The pose-conditioned discriminator's forward, one image: each
    block's fromRGB (the first), its 1x1 skip after the 4x4 downsampling
    filter, its 3x3 conv and its downsampling 3x3 conv after the
    transposed filter; the head's conv and two products; the conditioning's
    two-layer mapping."""
    ch = lambda r: min(base // r, cmax)  # noqa: E731
    flops, r = 0, res
    while r > 4:
        tmp, out = ch(r), ch(r // 2)
        if r == res:
            flops += 2 * nc * tmp * r * r
        flops += 2 * 16 * tmp * (r // 2) ** 2 + 2 * tmp * out * (r // 2) ** 2
        flops += 2 * 9 * tmp * tmp * r * r
        flops += 2 * 16 * tmp * (r + 1) ** 2 + 2 * 9 * tmp * out * (r // 2) ** 2
        r //= 2
    c4 = ch(4)
    flops += 2 * 9 * (c4 + 1) * c4 * 16 + 2 * c4 * 16 * c4 + 2 * c4 * c4
    return flops + 2 * c_dim * c4 + 2 * c4 * c4


def render(cfg: dict, images: int, grad: bool = False) -> int:
    """Synthesis, palette and decode of `images` renders, forward, and
    with `grad` the data gradient to the latent and the points too."""
    points = cfg['resolution'] ** 2 * cfg['samples_per_ray']
    synth = synthesis(cfg['plane_resolution'], cfg['channel_base'],
                      cfg['channel_max'])
    forward = synth + palette() + points * decode_point()
    # The palette product's gradient goes to the probabilities and to the
    # palette: one product more a point.
    backward = synth + palette_grad() + points * (decode_point() + 2 * 10 * 3)
    return images * (forward + (backward if grad else 0))


def lpips(h: int, w: int, pairs: int) -> int:
    """LPIPS forward of `pairs` image pairs."""
    return pairs * (2 * vgg(h, w) + lpips_lins(h, w))


def inversion_batch(cfg: dict) -> Dict[str, int]:
    """FLOPs of one inverted batch at float32, by part. `cfg`: batch,
    resolution, plane_resolution, channel_base, channel_max,
    samples_per_ray (coarse + fine), crops, steps."""
    b, res = cfg['batch'], cfg['resolution']
    views = b * (1 + cfg['crops'])
    step_render = render(cfg, b, grad=True)
    step_lpips = (lpips(res, res, views) +           # forward
                  views * (vgg(res, res) + lpips_lins(res, res)))  # grad
    evaluation = 2 * render(cfg, b) + lpips(res, res, b)
    return {'steps': cfg['steps'] * (step_render + step_lpips),
            'evaluations': 2 * evaluation}


def training_pair(cfg: dict) -> Dict[str, int]:
    """FLOPs of one G + D pair, by part. `cfg`: batch, resolution,
    plane_resolution, channel_base, channel_max, samples_per_ray (coarse +
    fine), channels (the discriminator's input: 4 with the mask)."""
    b, res = cfg['batch'], cfg['resolution']
    gen = render(cfg, b) + b * mapping()
    disc = b * discriminator(res, cfg['channels'], cfg['channel_base'],
                             cfg['channel_max'])
    return {'g_step': 3 * gen + 2 * disc, 'd_step': gen + 9 * disc}
