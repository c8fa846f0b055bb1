"""What the drivers and checks share: the configuration's flags as the
CLI parses them, the GAN configuration, the plain generator of its
widths, the seeded cameras, the surface's offset, the set-up's phase
timer, the device's description."""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import torch

from port_bench import weights as weights_lib
from port_bench.reference import generator as ref_generator
from port_bench.reference import pose as ref_pose
from port_bench.reference.renderer import render
from nerf_from_image_tpu_torch import config as config_lib
from nerf_from_image_tpu_torch.cli import run as cli_run


def parse_flags(config: dict):
    """The CLI's arguments for the configuration's flags, after the
    dataset's overrides, and the dataset's rendering configuration."""
    args = config_lib.parse_args(list(config['flags']))
    config_lib.override_default_args(args)
    return args, config_lib.get_dataset_config(args.dataset)


def gan_config(config: dict, args, dataset_config: dict):
    """The CLI's GAN configuration, with the configuration's widths."""
    cfg = cli_run.make_gan_config(args, dataset_config)
    return dataclasses.replace(cfg, **config.get('gan', {}))


def reference_generator(cfg, device) -> ref_generator.Generator:
    """The plain generator of the GAN configuration's widths, float32."""
    return ref_generator.Generator(
        latent_dim=cfg.latent_dim, scene_range=cfg.scene_range,
        attention_values=cfg.attention_values,
        img_resolution=cfg.plane_resolution, channel_base=cfg.channel_base,
        channel_max=cfg.channel_max, device=device,
        use_stylegan_noise=cfg.use_stylegan_noise)


@contextlib.contextmanager
def phase(name: str):
    """Prints the seconds a part of a run took to standard error."""
    t = time.perf_counter()
    yield
    print(f'set-up {name} {time.perf_counter() - t:.3f} s', file=sys.stderr,
          flush=True)


def sync(device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def device_info(device, peak: int, tracer, count: int = 1) -> dict:
    """The result's `device`: the platform, the card's name, the cards
    used, the memory peak, and in a traced run the busy and window
    seconds."""
    info = {'platform': 'gpu' if device.type == 'cuda' else 'cpu',
            'kind': (torch.cuda.get_device_name(device)
                     if device.type == 'cuda' else 'cpu'),
            'count': count, 'memory_peak_bytes': int(peak)}
    if tracer.enabled:
        with phase('after the window: trace'):
            info['busy_s'] = tracer.busy_s()
            info['window_s'] = tracer.window_s
    return info


def sample_cameras(traffic: dict, n: int, perspective: bool, flipped: bool,
                   gen: torch.Generator, device):
    """Seeded cameras: a uniform rotation, the scale, the image-plane
    offset and (perspective) the focal exponent drawn from the mix's
    ranges. Returns (cam2world (n, 4, 4), focal (n,) or None)."""
    cam = traffic['cameras']

    def uniform(lo_hi):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand((n,), generator=gen,
                                           device=device)
    q = torch.randn((n, 4), generator=gen, device=device)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    s = uniform(cam['scale'])
    t2 = torch.randn((n, 2), generator=gen, device=device) * cam['offset_std']
    z0 = uniform(cam['focal_exponent']) if perspective else None
    return ref_pose.pose_to_matrix(z0, t2, s, q, flipped)


# The generator's leaf that shifts the field's signed distance: the
# decoder's output bias. Its other entries feed a softmax, which a shift
# common to all of them leaves as it is.
DISTANCE_BIAS = 'decoder.net.2.bias'
# The views that place the surface, the share of the frame their median
# covers, and the resolution at which a view's coverage is read.
SURFACE_VIEWS = 32
SURFACE_COVERAGE = 0.5
COVERAGE_RESOLUTION = 32


@torch.no_grad()
def place_surface(recipe: weights_lib.Recipe, seed: int, cfg, traffic: dict,
                  perspective: bool, device):
    """A trained field's surface lies inside the frame, with the object
    on a background; a random draw's signed distance sits anywhere, so
    that a view is all object or all background. This sets the distance's
    offset (`DISTANCE_BIAS`) so that the median of `SURFACE_VIEWS` seeded
    views (latents, and cameras from the mix's ranges) covers
    `SURFACE_COVERAGE` of the frame (the mean of its mask), by bisection,
    rounded to 1e-3. Returns (the recipe with that leaf set, the plain
    generator loaded with its draw)."""
    ref_gen = reference_generator(cfg, device)
    weights_lib.load(ref_gen, recipe.draw(seed, device))
    gen = torch.Generator(device=device).manual_seed(
        weights_lib.sub_seed(seed, 12))
    z = torch.randn((SURFACE_VIEWS, cfg.latent_dim), generator=gen,
                    device=device)
    cam, focal = sample_cameras(traffic, SURFACE_VIEWS, perspective,
                                cfg.camera_flipped, gen, device)
    state = ref_gen.synthesize(ref_gen.map(z))
    bias = dict(ref_gen.named_parameters())[DISTANCE_BIAS]

    def median_coverage(offset: float) -> float:
        bias.fill_(offset)
        out = render(ref_gen.field(state), COVERAGE_RESOLUTION,
                     COVERAGE_RESOLUTION, cam, focal, cfg.scene_range,
                     cfg.white_background, cfg.depth_samples_per_ray)
        return float(out.mask.float().mean(dim=(1, 2)).median())

    target = SURFACE_COVERAGE
    lo, hi = -4.0, 4.0  # the distance's offset: all object, all background
    if not median_coverage(lo) > target > median_coverage(hi):
        raise RuntimeError(f'no offset in [{lo}, {hi}] gives a median mask '
                           f'coverage of {target}')
    for _ in range(16):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if median_coverage(mid) > target else (lo, mid)
    offset = round((lo + hi) / 2, 3)
    bias.fill_(offset)
    placed = dataclasses.replace(
        recipe, set_leaves={**recipe.set_leaves, DISTANCE_BIAS: offset})
    print(f'set-up surface: distance offset {offset}', file=sys.stderr,
          flush=True)
    return placed, ref_gen
