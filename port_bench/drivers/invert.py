"""The `invert` window: test-set inversion as the inversion CLI runs it.

Per batch, in the order and with the overlap of the CLI's loop
(`nerf_from_image_tpu_torch/cli/inversion.py`, `run_inversion_cli`):
the encoder's forward and the host copies of its outputs
(`pipeline.bootstrap_dispatch`, `bootstrap_to_host`), PnP (`_timed_pnp`,
for the next batch on one worker thread), the refinement's start
(`init_inversion_params`), the checkpoint metrics at step 0
(`evaluate_checkpoint`), the refinement steps (`optimizer.run_inversion`)
and the checkpoint metrics at the last step. The CLI's loop runs a whole
test set and cannot be driven one batch at a time, so the same calls are
composed here.

Set-up makes everything from the seed: the models' weights on the card
(`port_bench/weights.py`) with the surface placed in the frame
(`common.place_surface`), and a pool of target batches that the plain
reference generator renders from seeded latents and cameras, each
covering the mix's share of the frame, with their masks, in the form the
CLI's loader hands to its loop (RGB times the mask, then the mask). Warm-up is one whole batch with its PnP run in
line, plus the dispatch of the next batch's encoder forward and PnP, so
that the window starts in the CLI's steady state. The window runs whole
batches until `seconds` have passed; the rate is the images of the
batches it completed over the time to the last one's end.

Once the window has closed, one of its batches, drawn from the seed, is
held against the plain reference (`port_bench/checks/invert.py`).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from port_bench import trace as trace_lib
from port_bench.common import device_info, gan_config, parse_flags, phase
from port_bench.common import COVERAGE_RESOLUTION, place_surface
from port_bench.common import sample_cameras, sync
from port_bench import weights as weights_lib
from port_bench.checks import invert as check_lib
from port_bench.reference.renderer import render

from nerf_from_image_tpu_torch import config as config_lib
from nerf_from_image_tpu_torch.cli import inversion as cli_inversion
from nerf_from_image_tpu_torch.invert import optimizer as inv_opt
from nerf_from_image_tpu_torch.invert import pipeline as pipe
from nerf_from_image_tpu_torch.invert import pnp
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.train import gan as gan_lib


@dataclasses.dataclass
class Setup:
    """The program's objects and the run's inputs."""
    args: object
    dataset_config: dict
    cfg: gan_lib.GANConfig
    inv_cfg: inv_opt.InversionConfig
    gen: object
    encoder: BootstrapEncoder
    lpips: LPIPS
    z_avg: torch.Tensor
    focal_guesses: Optional[np.ndarray]
    crops_rng: torch.Generator
    pool: List[Dict[str, object]]
    weights: Dict[str, Tuple[weights_lib.Recipe, int]]
    batch_size: int
    niter: int

    def state_dict(self, name: str, device) -> Dict[str, torch.Tensor]:
        """The seeded weights of model `name`, drawn again."""
        recipe, seed = self.weights[name]
        return recipe.draw(seed, device)

    def free_program(self) -> None:
        """Drops the program's models (their memory goes back)."""
        self.gen = self.encoder = self.lpips = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


@dataclasses.dataclass
class Record:
    """What one batch took and produced."""
    targets: Dict[str, object]
    enc_out: tuple  # the encoder's own outputs
    pnp_out: tuple
    init: inv_opt.InversionParams
    crops_state: torch.Tensor
    step_metrics: Dict[str, torch.Tensor]
    report: Dict[int, Dict[str, list]]
    refine_ms: float
    pnp_wait_s: Optional[float]


# Targets are screened in draws of this many.
SCREEN_BATCH = 8
# Draws allowed per target before set-up gives up.
MAX_DRAWS_PER_TARGET = 64


def _one(state, i: int):
    """Row i of a generator state, as a state of one."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[i:i + 1]
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


@torch.no_grad()
def make_targets(ref_gen, cfg, traffic: dict, batch: int, n_batches: int,
                 perspective: bool, gen: torch.Generator, device):
    """`n_batches` target batches rendered by the plain generator from
    seeded latents and cameras, each {'target_img' (B, H, W, 4): RGB
    times the mask, then the mask; 'pnp_coords' (B, H, W, 3) and
    'pnp_mask' (B, H, W): the render's world points and mask, what a
    trained encoder predicts; 'gt_cam2world'; 'perm_cameras': other
    seeded cameras (cam2world, focal, None, None)}.

    A test image shows its object on a background, so a latent and camera
    become a target only where the render's mask covers the mix's share
    of the frame (`mask_coverage`, the mean of the mask): pairs are drawn
    and screened at a low resolution, then rendered at the cell's and
    held to the same range. Set-up fails when the generator does not reach
    that share within `MAX_DRAWS_PER_TARGET` draws a target."""
    res = cfg.resolution
    lo, hi = traffic['mask_coverage']
    need = batch * n_batches
    found = {'rgb': [], 'mask': [], 'coords': [], 'cam': []}
    draws = 0

    def view(state, cam, focal, size, coords):
        return render(ref_gen.field(state), size, size, cam, focal,
                      cfg.scene_range, cfg.white_background,
                      cfg.depth_samples_per_ray, compute_coords=coords)

    while len(found['rgb']) < need:
        if draws >= MAX_DRAWS_PER_TARGET * need:
            raise RuntimeError(
                f'{len(found["rgb"])} of {need} targets cover {lo}-{hi} of '
                f'the frame after {draws} draws')
        z = torch.randn((SCREEN_BATCH, cfg.latent_dim), generator=gen,
                        device=device)
        cam, focal = sample_cameras(traffic, SCREEN_BATCH, perspective,
                                    cfg.camera_flipped, gen, device)
        draws += SCREEN_BATCH
        state = ref_gen.synthesize(ref_gen.map(z))
        screen = view(state, cam, focal, COVERAGE_RESOLUTION, False)
        cover = screen.mask.float().mean(dim=(1, 2))
        for i in range(SCREEN_BATCH):
            if not lo <= float(cover[i]) <= hi or len(found['rgb']) == need:
                continue
            f_i = None if focal is None else focal[i:i + 1]
            out = view(_one(state, i), cam[i:i + 1], f_i, res, True)
            if not lo <= float(out.mask.float().mean()) <= hi:
                continue
            found['rgb'].append(out.rgb.float())
            found['mask'].append(out.mask.float())
            found['coords'].append(out.semantics.float())
            found['cam'].append(cam[i:i + 1])
    pool = []
    for k in range(n_batches):
        rows = slice(k * batch, (k + 1) * batch)
        rgb, mask = (torch.cat(found[n][rows]) for n in ('rgb', 'mask'))
        pcam, pfocal = sample_cameras(traffic, batch, perspective,
                                      cfg.camera_flipped, gen, device)
        pool.append({
            'target_img': torch.cat((rgb * mask[..., None], mask[..., None]),
                                    dim=-1).contiguous(),
            'pnp_coords': torch.cat(found['coords'][rows]).contiguous(),
            'pnp_mask': mask.contiguous(),
            'gt_cam2world': torch.cat(found['cam'][rows]),
            'perm_cameras': (pcam, pfocal, None, None)})
    print(f'set-up targets: {need} of {draws} draws cover {lo}-{hi} of the '
          f'frame', file=sys.stderr, flush=True)
    return pool


def setup(spec: dict, seed: int, device) -> Setup:
    config, traffic = spec['config'], spec['traffic']
    args, dataset_config = parse_flags(config)
    cfg = gan_config(config, args, dataset_config)
    if device.type == 'cuda':
        # The CLI's precision: float32 stays float32 (`cli/run.py`).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(weights_lib.sub_seed(seed, 0))

    # The program's models, as the CLI builds them, with seeded weights.
    with phase('models'):
        gen, _ = gan_lib.make_models(cfg, torch.float32, device)
        encoder = BootstrapEncoder(args.latent_dim,
                                   separate_backbones=args.inv_use_separate,
                                   device=device, **config.get('encoder', {}))
        lpips = LPIPS(device)
    perspective = dataset_config['camera_projection_model'] != 'ortho'
    weights = {}
    for k, (name, module) in enumerate((('generator', gen),
                                        ('encoder', encoder),
                                        ('lpips', lpips))):
        recipe = weights_lib.Recipe.of(
            module, config.get('set_leaves', {}).get(name),
            config.get('non_negative_leaves', {}).get(name))
        weights[name] = (recipe, weights_lib.sub_seed(seed, k + 1))
    with phase('surface'):
        recipe, ref_gen = place_surface(*weights['generator'], cfg, traffic,
                                        perspective, device)
        weights['generator'] = (recipe, weights['generator'][1])
    for name, module in (('generator', gen), ('encoder', encoder),
                         ('lpips', lpips)):
        weights_lib.load(module, weights[name][0].draw(weights[name][1],
                                                       device))
    encoder.eval()

    batch_size = max(args.batch_size // 4, 1)
    niter = args.inv_steps or 30
    inv_cfg = inv_opt.InversionConfig(
        resolution=args.resolution,
        depth_samples_per_ray=config_lib.depth_samples(args),
        fine_sampling=args.fine_sampling,
        scene_range=dataset_config['scene_range'],
        white_background=dataset_config['white_background'],
        camera_flipped=dataset_config['camera_flipped'],
        lr_gain_z=float(args.inv_gain_z), loss_type=args.inv_loss,
        optimize_pose=not args.inv_no_optimize_pose)

    # The inputs: targets from the plain generator, the focal guesses
    # from seeded training focals (perspective datasets).
    draws = torch.Generator(device=device).manual_seed(
        weights_lib.sub_seed(seed, 10))
    with phase('targets'):
        pool = make_targets(ref_gen, cfg, traffic, batch_size,
                            traffic['target_batches'], perspective, draws,
                            device)
        del ref_gen
    focal_guesses = None
    if perspective:
        _, focals = sample_cameras(traffic, traffic['training_focals'], True,
                                   cfg.camera_flipped, draws, device)
        focal_guesses = pnp.get_focal_guesses(focals.cpu().numpy())

    with phase('pnp_library'):
        pnp.load_library()
    with phase('z_avg'), torch.no_grad():
        z_avg = gen.average_w(
            torch.Generator(device=device).manual_seed(1234), 10000)
    crops_rng = torch.Generator(device=device).manual_seed(
        weights_lib.sub_seed(seed, 11))
    return Setup(args=args, dataset_config=dataset_config, cfg=cfg,
                 inv_cfg=inv_cfg,
                 gen=gen, encoder=encoder, lpips=lpips, z_avg=z_avg,
                 focal_guesses=focal_guesses, crops_rng=crops_rng, pool=pool,
                 weights=weights, batch_size=batch_size, niter=niter)


def _pnp_on_worker(host, focal_guesses):
    return cli_inversion._timed_pnp(host, focal_guesses)


class Loop:
    """The CLI's per-batch loop, one `batch()` call a batch."""

    def __init__(self, s: Setup, device):
        self.s = s
        self.device = device
        self.idx = 0
        self.pending = None
        self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self.ctx = pipe.EvalContext(gen=s.gen, lpips=s.lpips,
                                    has_mask=s.dataset_config['has_mask'],
                                    inception=None)
        self.compute_rot_error = not (s.args.dataset == 'p3d_car' and
                                      s.args.inv_use_testset)

    def targets(self, idx: int) -> Dict[str, object]:
        return self.s.pool[idx % len(self.s.pool)]

    @staticmethod
    def pnp_input(enc_out, tsel):
        """The encoder's latent, with the coordinates and the mask that PnP
        solves from taken from the target's render: the random encoder's
        own would give PnP no pose to find."""
        return tsel['pnp_coords'], tsel['pnp_mask'], enc_out[2]

    def _event(self):
        if self.device.type != 'cuda':
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def batch(self) -> Record:
        s, span = self.s, trace_lib.span
        tsel = self.targets(self.idx)
        target_img = tsel['target_img']
        if self.pending is None:
            with span('encoder'):
                enc_out = pipe.bootstrap_dispatch(s.encoder, target_img)
            with span('pnp'):
                pnp_out, _, _ = cli_inversion._timed_pnp(
                    pipe.bootstrap_to_host(self.pnp_input(enc_out, tsel)),
                    s.focal_guesses)
            wait_s = None
        else:
            (enc_out, future), self.pending = self.pending, None
            tw = time.perf_counter()
            with span('pnp_wait'):
                pnp_out, _, _ = future.result()
            wait_s = time.perf_counter() - tw
        _, _, cam2world, focal, _ = pnp_out
        with span('init'):
            params = pipe.init_inversion_params(
                pipe.initial_latent(enc_out, s.z_avg, s.inv_cfg.lr_gain_z),
                cam2world, focal, s.dataset_config['camera_flipped'])

        # The next batch's encoder forward and copies go on the stream
        # before this batch's work; its PnP runs on the worker.
        with span('encoder'):
            ntsel = self.targets(self.idx + 1)
            nxt = pipe.bootstrap_dispatch(s.encoder, ntsel['target_img'])
            host = pipe.bootstrap_to_host(self.pnp_input(nxt, ntsel))
        self.pending = (nxt, self.pool.submit(_pnp_on_worker, host,
                                              s.focal_guesses))

        report = pipe.make_report([0, s.niter])

        def evaluate(step, p):
            with span('evaluate'):
                pipe.evaluate_checkpoint(
                    self.ctx, s.inv_cfg, p, report[step], target_img, None,
                    None, tsel['gt_cam2world'],
                    perm_cameras=tsel['perm_cameras'],
                    target_img_random=None,
                    compute_rot_error=self.compute_rot_error)

        evaluate(0, params)
        crops_state = s.crops_rng.get_state()
        start = self._event()
        with span('refine'):
            final, step_metrics = inv_opt.run_inversion(
                s.gen, s.lpips, params, target_img[..., :3], s.inv_cfg,
                s.niter, generator=s.crops_rng,
                gt_cam2world=tsel['gt_cam2world'])
        end = self._event()
        evaluate(s.niter, final)
        refine_ms = (start.elapsed_time(end) if start is not None else
                     float('nan'))
        self.idx += 1
        return Record(targets=tsel, enc_out=enc_out, pnp_out=pnp_out,
                      init=params, crops_state=crops_state,
                      step_metrics=step_metrics, report=report,
                      refine_ms=refine_ms, pnp_wait_s=wait_s)

    def close(self) -> None:
        """Waits for the pending PnP and stops the worker."""
        if self.pending is not None:
            self.pending[1].result()
            self.pending = None
        self.pool.shutdown(wait=True)


def non_finite(record: Record, niter: int) -> int:
    """Images of the batch whose final parameters or metrics are not
    finite."""
    bad = np.zeros(len(record.targets['target_img']), dtype=bool)
    for k, values in record.report[niter].items():
        for v in values:
            v = np.asarray(v, dtype=np.float64)
            bad |= ~np.isfinite(v.reshape(len(bad), -1)).all(axis=1)
    return int(bad.sum())


def measure(spec: dict, seed: int, seconds: float, device, t_process: float,
            tracer: trace_lib.Tracer):
    """Set-up, warm-up and the window. Returns (setup, records of the
    window's batches, setup_s, window_s, memory peak)."""
    s = setup(spec, seed, device)
    loop = Loop(s, device)
    try:
        with phase('warm-up batch'):
            loop.batch()  # PnP in line, the next batch dispatched
            sync(device)
        setup_s = time.perf_counter() - t_process
        if device.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(device)
        records = []
        with tracer.window():
            t0 = time.perf_counter()
            while True:
                records.append(loop.batch())
                if time.perf_counter() - t0 >= seconds:
                    break
            sync(device)
            window_s = time.perf_counter() - t0
    finally:
        loop.close()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    return s, records, setup_s, window_s, peak


def work_done(s: Setup, spec: dict, batches: int) -> dict:
    """What the window's batches did, for the work counts of
    `port_bench/work/`: the model's FLOPs of each inverted batch (float32,
    the CLI's inversion precision), and the calls of B1 and B2 (a coarse
    and a fine pass a step) with their shapes."""
    c, cfg = s.inv_cfg, s.cfg
    samples = c.depth_samples_per_ray * c.ray_multiplier
    passes = 2 if c.fine_sampling else 1
    shape = (s.batch_size, c.resolution ** 2 * samples, cfg.plane_resolution)
    calls = {'count': passes * s.niter * batches, 'shape': shape}
    return {'model': spec['config']['work_model'], 'unit': 'inversion_batch',
            'precision': 'float32', 'units': batches,
            'shapes': {'batch': s.batch_size, 'resolution': c.resolution,
                       'plane_resolution': cfg.plane_resolution,
                       'channel_base': cfg.channel_base,
                       'channel_max': cfg.channel_max,
                       'samples_per_ray': passes * samples,
                       'crops': c.num_augmentations, 'steps': s.niter},
            'kernels': {'triplane_sample': calls, 'triplane_grad': calls}}


def run(spec: dict, args, t_process: float, device) -> dict:
    tracer = trace_lib.Tracer(bool(args.trace))
    s, records, setup_s, window_s, peak = measure(
        spec, args.seed, args.seconds, device, t_process, tracer)
    images = sum(len(r.targets['target_img']) for r in records)

    coverage = [float(b['pnp_mask'].mean()) for b in s.pool]
    fallbacks = sum(int(np.sum(r.pnp_out[4] == pnp.DUMMY_ERROR))
                    for r in records)
    print(f'window: {len(records)} batches, {images} images, PnP '
          f'fallbacks {fallbacks}, target mask coverage '
          f'{[round(c, 3) for c in coverage]}, PnP wait '
          f'{[r.pnp_wait_s for r in records]} s, step-0 and last losses '
          f'{[(float(r.step_metrics["loss"][0]), float(r.step_metrics["loss"][-1])) for r in records]}',
          file=sys.stderr, flush=True)
    # The check, once the window has closed and the peak has been read.
    pick = int(np.random.RandomState(args.seed % 2**32).randint(len(records)))
    with phase('after the window: check'):
        checks, correct = check_lib.check(s, records[pick], spec, device)

    context = {'records': records, 'setup': s, 'spec': spec,
               'window_s': window_s, 'images': images, 'tracer': tracer,
               'device': device, 'work': work_done(s, spec, len(records))}
    info = device_info(device, peak, tracer)
    return {'correct': correct, 'attempted': images,
            'failed': sum(non_finite(r, s.niter) for r in records),
            'end_to_end': {'inverted_images_per_s': images / window_s,
                           'setup_s': setup_s},
            'device': info, 'checks': checks, 'context': context}
