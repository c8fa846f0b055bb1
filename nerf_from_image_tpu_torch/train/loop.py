"""GAN training loop: the host's side of the G and D steps (PyTorch port
of `nerf_from_image_tpu/train/loop.py`).

The reference loop's structure: G steps on even iterations and D steps on
odd ones (R1 on every D step, the warmup blur while i < 12,500), the
iteration-3 evaluation that finds an out-of-memory early, an evaluation
and a `latest` checkpoint every 5000 iterations (`best` when the FID is
the best so far, a numbered one every 50,000), and images per second.
Batches are assembled on the host from the preloaded split and copied to
the card; the latents come from the loop's own `torch.Generator` (seed +
1) on the card, the batch indices from a numpy RandomState (seed) and,
for the real images, an `EndlessSampler` over it, in the JAX loop's
order: a G step's batch (then, in dual-D mode, the second batch's poses),
a D step's real batch, fake batch (then the second real and fake
batches). All three go into the checkpoints, so a run resumed from one
draws the batches the uninterrupted run draws. Every batch carries its
images (the encoder's conditioning) and, under class conditioning, its
class labels.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nerf_from_image_tpu_torch.train import gan as gan_lib
from nerf_from_image_tpu_torch.utils import checkpoint as ckpt_lib
from nerf_from_image_tpu_torch.utils import profiling
from nerf_from_image_tpu_torch.utils.io import EndlessSampler

DISPLAY_EVERY = 5000
KEEP_EVERY = 50000


def metric_tag(key: str, dual: bool) -> str:
    """The reference's tensorboard tag of a step metric. In dual-D mode the
    first discriminator is the conditional one (`_cond`)."""
    fixed = {
        'loss_eikonal': 'loss/eikonal',
        'loss_tv': 'loss/tv',
        'loss_entropy': 'loss/entropy',
        'loss_ppl': 'ppl/loss',
        'grad_norm_g': 'grad_norm/g',
        'grad_norm_d': 'grad_norm/d',
        'grad_norm_d2': 'grad_norm/d2',
        'sign_real': 'augment/sign_real',
        'loss_g': 'loss/g_cond' if dual else 'loss/g',
        'loss_g_uncond': 'loss/g',
        'loss_r1': 'loss/r1_cond' if dual else 'loss/r1',
        'loss_r1_uncond': 'loss/r1',
        'loss_d_real_cond': 'loss/d_real_cond',
        'loss_d_fake_cond': 'loss/d_fake_cond',
        'loss_d_real': 'loss/d_real',
        'loss_d_fake': 'loss/d_fake',
    }
    return fixed.get(key, f'loss/{key}')


def log_train_scalars(writer, metrics: Dict[str, torch.Tensor],
                      state: gan_lib.GANTrainState, cfg: gan_lib.GANConfig,
                      i: int, elapsed_ips: float) -> None:
    """The step's metrics, images per second, ADA's p and the SDF field's
    beta and alpha of G and of its EMA."""
    for k, v in metrics.items():
        writer.add_scalar(metric_tag(k, cfg.dual_discriminator), float(v), i)
    writer.add_scalar('img_per_sec', elapsed_ips, i)
    if cfg.augment_p_max > 0:
        writer.add_scalar('augment/p', state.augment_p, i)
    if cfg.path_length_regularization:
        writer.add_scalar('ppl/running_avg', state.ppl_running_avg, i)
    for suffix, gen in (('', state.gen), ('_ema', state.gen_ema)):
        writer.add_scalar(f'sdf/beta{suffix}', gen.beta.item(), i)
        writer.add_scalar(f'sdf/alpha{suffix}', gen.alpha.item(), i)


def sample_batch(train_split, batch_size: int, rng: np.random.RandomState,
                 cfg: gan_lib.GANConfig,
                 train_sampler: Optional[EndlessSampler] = None,
                 latent_rng: Optional[torch.Generator] = None,
                 is_highres: bool = False,
                 device: Optional[torch.device] = None):
    """(indices, batch): the split's rows at indices from `train_sampler`
    (or drawn from `rng`), as float32 tensors on `device` (the class
    labels, where the split has them, as int64), and with `latent_rng`
    the latents 'z' drawn from it."""
    if train_sampler is not None:
        idx = train_sampler(batch_size)
    else:
        idx = rng.randint(train_split.images.shape[0], size=(batch_size,))

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)

    batch = {'image': tensor(train_split.images[idx]),
             'pose': tensor(train_split.tform_cam2world[idx])}
    for key, name in (('focal', 'focal_length'), ('bbox', 'bbox'),
                      ('center', 'center')):
        if getattr(train_split, name) is not None:
            batch[key] = tensor(getattr(train_split, name)[idx])
    if getattr(train_split, 'classes', None) is not None:
        batch['class'] = torch.as_tensor(
            np.asarray(train_split.classes[idx]), dtype=torch.int64,
            device=device)
    if is_highres and train_split.images_highres is not None:
        batch['image_highres'] = tensor(train_split.images_highres[idx])
    if latent_rng is not None:
        batch['z'] = torch.randn((batch_size, cfg.latent_dim),
                                 generator=latent_rng, device=device)
    return idx, batch


def train_gan(state: gan_lib.GANTrainState, cfg: gan_lib.GANConfig,
              train_split, num_iters: int, writer=None, ckpt_manager=None,
              eval_fn: Optional[Callable] = None, log_every: int = 100,
              seed: int = 1234, host_state: Optional[dict] = None,
              host_state_extra: Optional[Callable[[], dict]] = None,
              profile_trace_at: int = 0, trace_dir: str = ''
              ) -> gan_lib.GANTrainState:
    """Trains `state` in place from `state.iteration` to `num_iters`.

    `eval_fn(state, i)` returns (FID or None, is_best); `ckpt_manager` is
    a `utils.checkpoint.CheckpointManager`. `host_state` (a checkpoint's
    `random_state`) restores the loop's RandomState, sampler and latent
    generator; `host_state_extra()` gives the checkpoints' best_fid.
    With `profile_trace_at` > 0 and a `trace_dir`, the G step of iteration
    `profile_trace_at` (with its synchronisation) is traced into one
    Chrome trace under `trace_dir` (`utils/profiling.trace`); an odd
    iteration is a D step and traces nothing, as in the JAX loop.
    """
    device = state.gen.beta.device
    rng_np = np.random.RandomState(seed)
    train_sampler = EndlessSampler(len(train_split.images), rng_np)
    latent_rng = torch.Generator(device=device).manual_seed(seed + 1)
    ckpt_lib.restore_loop_state(host_state, rng_np, train_sampler,
                                latent_rng)
    hires = cfg.is_highres and cfg.augment_p_max > 0
    dual = cfg.dual_discriminator

    def draw(**kwargs):
        return sample_batch(train_split, cfg.batch_size, rng_np, cfg,
                            device=device, **kwargs)[1]

    i = state.iteration
    t1 = time.time()
    elapsed_ips = 0.0
    while i < num_iters:
        if i % 2 == 0:
            batch = draw(latent_rng=latent_rng)
            batch2 = draw() if dual else None
            t1 = time.time()
            traced = bool(profile_trace_at and i == profile_trace_at and
                          trace_dir)
            with profiling.trace(trace_dir, traced, device):
                metrics = gan_lib.g_step(state, batch, cfg, batch2=batch2)
                if device.type == 'cuda':
                    torch.cuda.synchronize(device)
        else:
            real = draw(train_sampler=train_sampler, is_highres=hires)
            fake = draw(latent_rng=latent_rng)
            real2 = fake2 = None
            if dual:
                real2 = draw(is_highres=hires)
                fake2 = draw(latent_rng=latent_rng)
            metrics = gan_lib.d_step(state, real, fake, cfg, batch2=real2,
                                     fake_batch2=fake2)
            elapsed_ips = cfg.batch_size / max(time.time() - t1, 1e-9)

        if writer is not None and i % log_every == 0:
            log_train_scalars(writer, metrics, state, cfg, i, elapsed_ips)

        if i == 3 or (i + 1) % DISPLAY_EVERY == 0:
            is_best = False
            if eval_fn is not None:
                _, is_best = eval_fn(state, i)
            if ckpt_manager is not None:
                extra = host_state_extra() if host_state_extra else {}
                ckpt = ckpt_lib.gan_checkpoint(
                    state, extra.get('best_fid'), rng_np, train_sampler,
                    latent_rng)
                ckpt_manager.save(ckpt, 'latest')
                if is_best:
                    ckpt_manager.save(ckpt, 'best')
                if (i + 1) % KEEP_EVERY == 0:
                    ckpt_manager.save(ckpt, f'{i + 1}')
        i += 1
    return state
