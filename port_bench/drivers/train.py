"""The `train` window: GAN training as the training CLI runs it.

The window drives `train/loop.train_gan` itself, one G + D pair a call,
each call with its own loop seed from the run's seed (so that its draws
do not repeat), from the mix's start iteration: past the blur and lr
warm-ups, so that every D step takes R1, every fourth D step moves ADA's
p and every G step the EMA, and no evaluation or checkpoint falls in the
window (no `eval_fn`, `ckpt_manager` or `writer`). Batches are drawn on
the host from the real split, as the loop draws them.

Set-up makes everything from the seed: the train state as the CLI builds
it (`gan.init_train_state` in the CLI's compute type), its weights drawn
on the card (`port_bench/weights.py`) with the surface placed in the
frame (`common.place_surface`), the state's generator, and the
real split on the host: seeded images (smooth colour fields under
elliptical masks, at twice the resolution for ADA and pooled to it),
with seeded cameras. The first two pairs are the warm-up, through the
same call at the same batch as the window's; the loop's own logging, on
for them alone, gives the first three steps' losses, and the optimizers'
states the first gradients. The plain reference follows those three
steps once the window has closed (`port_bench/checks/train.py`). The
window's own pairs run with logging off, so their losses are not read:
a pair whose loss or gradient is not finite leaves G, its EMA or D not
finite (no step skips or repairs one), so the state after the window is
checked, and if it is not finite every image of the window counts as
failed.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import trace as trace_lib
from port_bench import weights as weights_lib
from port_bench.checks import train as check_lib
from port_bench.common import device_info, gan_config, parse_flags, phase
from port_bench.common import place_surface, sample_cameras, sync

from nerf_from_image_tpu_torch.data import loaders
from nerf_from_image_tpu_torch.train import gan as gan_lib
from nerf_from_image_tpu_torch.train import loop as loop_lib

FIRST_STEPS = 3


@dataclasses.dataclass
class Setup:
    args: object
    cfg: gan_lib.GANConfig
    state: gan_lib.GANTrainState
    split: Dict[str, np.ndarray]
    program_split: loaders.DatasetSplit
    weights: Dict[str, Tuple[weights_lib.Recipe, int]]
    rng_seed: int
    seed: int
    dtype: torch.dtype
    start_iteration: int
    augment_p: float
    optimizer_count: int

    def free_program(self) -> None:
        """Drops the program's train state (its memory goes back)."""
        self.state = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def state_dict(self, name: str, device) -> Dict[str, torch.Tensor]:
        recipe, seed = self.weights[name]
        return recipe.draw(seed, device)

    def loop_seed(self, call: int) -> int:
        """The loop seed of the run's `call`-th call (a 31-bit number, as
        numpy's RandomState takes)."""
        return weights_lib.sub_seed(self.seed, 100 + call) % (2**31 - 2)


class Recorder:
    """A writer for the loop's logging: keeps each step's scalars."""

    def __init__(self):
        self.scalars: Dict[int, Dict[str, float]] = {}

    def add_scalar(self, tag: str, value, step: int) -> None:
        self.scalars.setdefault(int(step), {})[tag] = float(value)


@torch.no_grad()
def make_split(traffic: dict, cfg, perspective: bool, gen: torch.Generator,
               device) -> Dict[str, np.ndarray]:
    """The real split: `traffic['real_images']` seeded images at twice the
    resolution (RGB times the mask, then the mask, in [-1, 1] and [0, 1])
    and pooled to it, with seeded cameras, on the host."""
    n, res = traffic['real_images'], 2 * cfg.resolution
    highres, at = [], 0
    while at < n:
        b = min(256, n - at)
        colour = torch.rand((b, 3, 8, 8), generator=gen, device=device)
        colour = F.interpolate(colour * 2 - 1, size=(res, res),
                               mode='bilinear', align_corners=False)
        c = torch.rand((b, 2, 1, 1), generator=gen, device=device) * 0.4 + 0.3
        r = torch.rand((b, 2, 1, 1), generator=gen, device=device) * 0.2 + 0.2
        ys, xs = torch.meshgrid(torch.linspace(0, 1, res, device=device),
                                torch.linspace(0, 1, res, device=device),
                                indexing='ij')
        d = ((xs - c[:, 0:1]) / r[:, 0:1]) ** 2 + \
            ((ys - c[:, 1:2]) / r[:, 1:2]) ** 2
        mask = (d < 1).float()
        img = torch.cat((colour * mask, mask), dim=1).permute(0, 2, 3, 1)
        highres.append(img.cpu().numpy())
        at += b
    highres = np.concatenate(highres)
    cam, focal = sample_cameras(traffic, n, perspective, cfg.camera_flipped,
                                gen, device)
    b, h, w, ch = highres.shape
    return {'images_highres': highres,
            'images': highres.reshape(b, h // 2, 2, w // 2, 2, ch).mean(
                axis=(2, 4)),
            'tform_cam2world': cam.cpu().numpy(),
            'focal_length': None if focal is None else focal.cpu().numpy()}


def setup(spec: dict, seed: int, device) -> Setup:
    config, traffic = spec['config'], spec['traffic']
    args, dataset_config = parse_flags(config)
    cfg = gan_config(config, args, dataset_config)
    dtype = (torch.bfloat16 if args.compute_dtype == 'bfloat16' else
             torch.float32)
    with phase('models'):
        state = gan_lib.init_train_state(cfg, dtype, device)
    weights = {}
    for k, (name, module) in enumerate((('generator', state.gen),
                                        ('discriminator', state.disc))):
        weights[name] = (weights_lib.Recipe.of(
            module, config.get('set_leaves', {}).get(name),
            config.get('non_negative_leaves', {}).get(name)),
                         weights_lib.sub_seed(seed, k + 1))
    perspective = dataset_config['camera_projection_model'] != 'ortho'
    with phase('surface'):
        recipe, _ = place_surface(*weights['generator'], cfg, traffic,
                                  perspective, device)
        weights['generator'] = (recipe, weights['generator'][1])
    gen_state = recipe.draw(weights['generator'][1], device)
    weights_lib.load(state.gen, gen_state)
    weights_lib.load(state.gen_ema, gen_state)
    del gen_state
    weights_lib.load(state.disc, weights['discriminator'][0].draw(
        weights['discriminator'][1], device))
    state.iteration = traffic['start_iteration']
    state.augment_p = traffic['augment_p']
    rng_seed = weights_lib.sub_seed(seed, 20)
    state.rng = torch.Generator(device=device).manual_seed(rng_seed)
    for opt in (state.opt_g, state.opt_d):
        opt.param_groups[0]['count'] = traffic['optimizer_count']
    with phase('split'):
        draws = torch.Generator(device=device).manual_seed(
            weights_lib.sub_seed(seed, 10))
        split = make_split(traffic, cfg, perspective, draws, device)
        program_split = loaders.DatasetSplit(
            images=split['images'], images_highres=split['images_highres'],
            tform_cam2world=split['tform_cam2world'],
            focal_length=split['focal_length'])
    return Setup(args=args, cfg=cfg, state=state, split=split,
                 program_split=program_split, weights=weights,
                 rng_seed=rng_seed, seed=seed, dtype=dtype,
                 start_iteration=traffic['start_iteration'],
                 augment_p=traffic['augment_p'],
                 optimizer_count=traffic['optimizer_count'])


def pair(s: Setup, call: int, writer=None) -> None:
    """One G + D pair through the training loop."""
    with trace_lib.span('pair'):
        loop_lib.train_gan(s.state, s.cfg, s.program_split,
                           s.state.iteration + 2, writer=writer,
                           log_every=1, seed=s.loop_seed(call))


def _leaf_norms(tensors) -> List[float]:
    return [float('nan') if t is None else
            float(torch.linalg.vector_norm(t.double())) for t in tensors]


@torch.no_grad()
def _change_norms(module, start: Dict[str, torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm((p - start[n]).double()))
            for n, p in sorted(module.named_parameters())]


def _first_grads(opt, module) -> List[float]:
    params = [p for _, p in sorted(module.named_parameters())]
    return _leaf_norms([opt.state[p]['exp_avg'] if p in opt.state else None
                        for p in params])


def warm_up(s: Setup, device) -> dict:
    """The first two pairs, with the loop's logging on: the first three
    steps' losses, the first gradients of G and D (their optimizers'
    states after one step), and the change the three steps made to G, its
    EMA and D, each by leaf."""
    writer = Recorder()
    start = s.state.iteration
    pair(s, 0, writer)
    d_start = s.state_dict('discriminator', device)
    first = {'grad_g': _first_grads(s.state.opt_g, s.state.gen),
             'grad_d': _first_grads(s.state.opt_d, s.state.disc),
             'change_d': _change_norms(s.state.disc, d_start)}
    del d_start
    pair(s, 1, writer)
    g_start = s.state_dict('generator', device)
    first['change_g'] = _change_norms(s.state.gen, g_start)
    first['change_ema'] = _change_norms(s.state.gen_ema, g_start)
    del g_start
    first['losses'] = [writer.scalars[start + k]
                       for k in range(FIRST_STEPS)]
    return first


@torch.no_grad()
def state_finite(state) -> bool:
    """Whether every parameter of G, its EMA and D, and ADA's p, is
    finite."""
    flags = [torch.isfinite(p).all() for module in
             (state.gen, state.gen_ema, state.disc)
             for p in module.parameters()]
    return bool(torch.stack(flags).all()) and math.isfinite(float(state.augment_p))


def work_done(s: Setup, spec: dict, pairs: int) -> dict:
    """What the window's pairs did, for `port_bench/work/`: each pair's
    model FLOPs in the compute type, and the calls of B1 (a coarse and a
    fine pass a render: the G step's render and the D step's fakes) and
    B4 (the G step's two passes) with their shapes."""
    cfg = s.cfg
    points = cfg.resolution ** 2 * cfg.depth_samples_per_ray
    shape = (cfg.batch_size, points, cfg.plane_resolution)
    passes = 2 if cfg.fine_sampling else 1
    precision = 'bfloat16' if s.dtype == torch.bfloat16 else 'float32'
    return {'model': spec['config']['work_model'], 'unit': 'training_pair',
            'precision': precision, 'units': pairs,
            'shapes': {'batch': cfg.batch_size, 'resolution': cfg.resolution,
                       'plane_resolution': cfg.plane_resolution,
                       'channel_base': cfg.channel_base,
                       'channel_max': cfg.channel_max,
                       'samples_per_ray': passes * cfg.depth_samples_per_ray,
                       'channels': 4 if cfg.supervise_alpha else 3},
            'kernels': {'triplane_sample': {'count': 2 * passes * pairs,
                                            'shape': shape},
                        'triplane_grad_planes': {'count': passes * pairs,
                                                 'shape': shape}}}


def run(spec: dict, args, t_process: float, device) -> dict:
    tracer = trace_lib.Tracer(bool(args.trace))
    s = setup(spec, args.seed, device)
    with phase('warm-up pairs'):
        first = warm_up(s, device)
        sync(device)
    setup_s = time.perf_counter() - t_process
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    calls = 2
    with tracer.window():
        t0 = time.perf_counter()
        while True:
            pair(s, calls)
            calls += 1
            if time.perf_counter() - t0 >= args.seconds:
                break
        sync(device)
        window_s = time.perf_counter() - t0
    pairs = calls - 2
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    images = pairs * s.cfg.batch_size
    finite = state_finite(s.state)
    print(f'window: {pairs} pairs, {images} images in {window_s:.3f} s; '
          f'state finite after the window {finite}; first steps '
          f'{first["losses"]}', file=sys.stderr, flush=True)
    with phase('after the window: check'):
        checks, correct = check_lib.check(s, first, spec, device)
    context = {'tracer': tracer, 'setup': s, 'spec': spec,
               'window_s': window_s, 'pairs': pairs,
               'work': work_done(s, spec, pairs)}
    return {'correct': correct, 'attempted': images,
            'failed': 0 if finite else images,
            'end_to_end': {'trained_images_per_s': images / window_s,
                           'setup_s': setup_s},
            'device': device_info(device, peak, tracer), 'checks': checks,
            'context': context}
