"""GAN training: one generator step and one discriminator step (PyTorch
port of `nerf_from_image_tpu/train/gan.py`).

The G step maps latents, synthesizes triplanes, renders them from data
poses (ADA-augmented) with jittered depths and random PDF draws, scores
the image (with the mask as a fourth channel under `supervise_alpha`)
with the pose-conditioned discriminator, adds the SDF regularizers
(eikonal, and the warmup-weighted total variation and entropy), clips the
global gradient norm, takes an Adam step, clamps beta/alpha and updates
the EMA copy. The D step scores ADA-augmented (and, during warmup,
blurred) real images with R1, and fakes rendered without a graph.

The poses are data, so no coordinate of the render carries a gradient:
autograd asks the triplane sampler for the planes' gradient only, and on
the card its backward runs kernel B4 (`ops/csrc/triplane_sample_grad_planes
.cu`), the port's form of the JAX package's `coord_grads=False`. The
forward runs kernel B1. The regularizers decode on the gather sampler,
which autograd differentiates twice. `sampler=` names the render's
sampler, so a step can be held against the same step on the plain
versions.

The state is updated in place. Every random draw comes from the state's
`torch.Generator`, or from arrays injected as the JAX package injects
them: `batch['noise']` ('depth', 'pdf_u', 'strata', 'perturb', and
'sg_noise', the per-layer StyleGAN noise of a noise-enabled generator,
which otherwise draws fresh noise on every forward) and
`batch['aug_tform']`. A view-direction generator (carla) renders with
its rays' directions. Path-length regularization, dual discriminators,
and encoder or class conditioning are not ported yet.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from nerf_from_image_tpu_torch.core import augment
from nerf_from_image_tpu_torch.core import grids
from nerf_from_image_tpu_torch.device import DeviceLike, resolve_device
from nerf_from_image_tpu_torch.models.discriminator import Discriminator
from nerf_from_image_tpu_torch.models.generator import Generator, Sampler
from nerf_from_image_tpu_torch.ops import triplane_cuda
from nerf_from_image_tpu_torch.render.renderer import RenderOutput, render

BLUR_WARMUP_ITERS = 12500
LR_WARMUP_ITERS = 2000

Batch = Dict[str, object]


def gan_loss(logits: torch.Tensor, target_positive: bool) -> torch.Tensor:
    """Non-saturating softplus GAN loss."""
    return F.softplus(-logits if target_positive else logits).mean()


def blur_image(img_nchw: torch.Tensor, iteration: int,
               white_background: bool) -> torch.Tensor:
    """The warmup blur at `iteration`; the image itself once it is over."""
    return grids.blur(img_nchw, grids.blur_kernel_1d(
        iteration, BLUR_WARMUP_ITERS, img_nchw.device), white_background)


@dataclasses.dataclass(frozen=True)
class GANConfig:
    """Static training configuration: the fields of the JAX package's
    `GANConfig` that this port reads."""
    resolution: int = 128
    latent_dim: int = 512
    depth_samples_per_ray: int = 64
    scene_range: float = 0.55
    white_background: bool = True
    camera_flipped: bool = False
    supervise_alpha: bool = False
    attention_values: int = 10
    is_highres: bool = False  # real images carry a 2x copy for ADA
    r1: float = 5.0
    tv: float = 0.5
    entropy: float = 0.05
    eikonal: float = 0.1
    augment_ada: bool = False
    augment_p_max: float = 0.0
    ada_target: float = 0.6  # the mean sign of the real logits ADA steers to
    clip_gradient_norm: float = 100.0
    lr_g: float = 0.0025
    lr_d: float = 0.002
    batch_size: int = 32  # the global batch, read by the ADA controller
    plane_resolution: int = 256
    channel_base: int = 32768
    channel_max: int = 512
    use_viewdir: bool = False  # carla's view-direction mapper
    # = not --disable_stylegan_noise (cub, imagenet_elephant): fresh
    # per-layer noise on every forward.
    use_stylegan_noise: bool = False
    # Not ported yet: g_step and d_step raise when one is set.
    path_length_regularization: bool = False
    dual_discriminator: bool = False
    use_encoder: bool = False
    use_class: bool = False


@dataclasses.dataclass
class GANTrainState:
    gen: Generator
    gen_ema: Generator
    disc: Discriminator
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    iteration: int  # the global i: G steps even, D steps odd
    rng: torch.Generator
    augment_p: float  # the ADA probability
    ppl_running_avg: float  # < 0: not started (PPL is not ported yet)


def _check_supported(cfg: GANConfig) -> None:
    for name in ('path_length_regularization', 'dual_discriminator',
                 'use_encoder', 'use_class'):
        if getattr(cfg, name):
            raise NotImplementedError(f'{name} is not ported yet')


def make_models(cfg: GANConfig, dtype: torch.dtype = torch.float32,
                device: DeviceLike = None, seed: int = 0
                ) -> Tuple[Generator, Discriminator]:
    """The generator (from `seed`) and the discriminator (from seed + 1),
    on `device` (None: CUDA)."""
    gen = Generator(latent_dim=cfg.latent_dim, scene_range=cfg.scene_range,
                    attention_values=cfg.attention_values,
                    img_resolution=cfg.plane_resolution,
                    channel_base=cfg.channel_base,
                    channel_max=cfg.channel_max, dtype=dtype, device=device,
                    seed=seed, use_viewdir=cfg.use_viewdir,
                    use_stylegan_noise=cfg.use_stylegan_noise)
    disc = Discriminator(resolution=cfg.resolution,
                         nc=4 if cfg.supervise_alpha else 3,
                         camera_flipped=cfg.camera_flipped,
                         channel_base=cfg.channel_base,
                         channel_max=cfg.channel_max, dtype=dtype,
                         device=device, seed=seed + 1)
    return gen, disc


def _lr(base_lr: float, count: int) -> float:
    """Linear warmup from lr / 10 to lr over the first 1000 optimizer
    steps, read at the optimizer's count before the step."""
    frac = min(count / (LR_WARMUP_ITERS / 2), 1.0)
    return base_lr / 10.0 + (base_lr - base_lr / 10.0) * frac


def make_optimizers(cfg: GANConfig, gen: Generator, disc: Discriminator
                    ) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """Adam(b1 = 0, b2 = 0.99, eps = 1e-8) for G and D; each keeps its step
    count in its param group's 'count', for the lr warmup."""
    opts = []
    for module, base_lr in ((gen, cfg.lr_g), (disc, cfg.lr_d)):
        opt = torch.optim.Adam(module.parameters(),
                               lr=_lr(base_lr, 0),
                               betas=(0.0, 0.99), eps=1e-8)
        opt.param_groups[0]['count'] = 0
        opts.append(opt)
    return opts[0], opts[1]


def init_train_state(cfg: GANConfig, dtype: torch.dtype = torch.float32,
                     device: DeviceLike = None, seed: int = 0
                     ) -> GANTrainState:
    """A fresh state at iteration 0 on `device` (None: CUDA, raising when
    it is absent); the EMA generator starts as a copy of G."""
    _check_supported(cfg)
    device = resolve_device(device)
    gen, disc = make_models(cfg, dtype, device, seed)
    gen_ema = copy.deepcopy(gen).requires_grad_(False)
    opt_g, opt_d = make_optimizers(cfg, gen, disc)
    return GANTrainState(
        gen=gen, gen_ema=gen_ema, disc=disc, opt_g=opt_g, opt_d=opt_d,
        iteration=0, rng=torch.Generator(device=device).manual_seed(seed),
        augment_p=0.0, ppl_running_avg=-1.0)


def _adam_step(opt: torch.optim.Adam, params: Sequence[torch.Tensor],
               grads: Sequence[Optional[torch.Tensor]], base_lr: float,
               cfg: GANConfig) -> torch.Tensor:
    """Clips the gradients to a global norm as optax does (g * max / norm
    when norm > max, no epsilon) and takes one Adam step at the warmup's
    lr. Parameters without a gradient are left out. Returns the global
    norm before clipping."""
    pairs = [(p, g) for p, g in zip(params, grads) if g is not None]
    gs = [g for _, g in pairs]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in gs]))
    factor = torch.where(norm < cfg.clip_gradient_norm,
                         torch.ones_like(norm), cfg.clip_gradient_norm / norm)
    group = opt.param_groups[0]
    for p, g in pairs:
        p.grad = g * factor
    group['lr'] = _lr(base_lr, group['count'])
    opt.step()
    group['count'] += 1
    for p, _ in pairs:
        p.grad = None
    return norm


def _ema_alpha(iteration: int) -> float:
    """EMA decay, faster early in training."""
    alpha = 0.5 ** (32.0 / 10000.0)
    power = 100.0 if iteration < 1000 else 10.0 if iteration < 10000 else 1.0
    return alpha ** power


@torch.no_grad()
def _update_ema(ema: Generator, model: Generator, alpha: float) -> None:
    """ema = ema * alpha + model * (1 - alpha), parameter by parameter."""
    e, m = list(ema.parameters()), list(model.parameters())
    torch._foreach_mul_(e, alpha)
    torch._foreach_add_(e, m, alpha=1.0 - alpha)


def generator_forward(gen: Generator, z: torch.Tensor, pose: torch.Tensor,
                      focal: Optional[torch.Tensor], cfg: GANConfig,
                      rng: torch.Generator, requests: Sequence[str] = (),
                      noise: Optional[Dict[str, torch.Tensor]] = None,
                      sampler: Sampler = triplane_cuda.sample_triplane
                      ) -> Tuple[RenderOutput, Dict[str, torch.Tensor]]:
    """Maps z, synthesizes, renders; with `requests` (regularizers of
    `Generator.sdf_losses`), also runs those. `noise` replaces the draws
    of `rng` with the injected arrays it holds ('sg_noise', the per-layer
    StyleGAN noise, outermost layer first; 'depth', 'pdf_u' for the
    render; 'strata', 'perturb' for the regularizers). A noise-enabled
    generator draws its StyleGAN noise from `rng` first, then the render
    draws. Returns (render, regularizers)."""
    sg_noise = rng
    if noise is not None and 'sg_noise' in noise:
        sg_noise = noise['sg_noise']
    state = gen.synthesize(gen.map(z), noise=sg_noise)
    render_rng = rng
    if noise is not None and ('depth' in noise or 'pdf_u' in noise):
        render_rng = {k: noise[k] for k in ('depth', 'pdf_u') if k in noise}
    out = render(gen.field(state, sampler), cfg.resolution, cfg.resolution,
                 pose, focal, cfg.scene_range, cfg.white_background,
                 cfg.depth_samples_per_ray, rng=render_rng)
    extra = {}
    if requests:
        reg_rng = rng
        if noise is not None and 'strata' in noise:
            reg_rng = {k: noise[k] for k in ('strata', 'perturb')
                       if k in noise}
        extra = gen.sdf_losses(state.planes_cl, reg_rng, requests)
    return out, extra


def _image(out: RenderOutput, cfg: GANConfig) -> torch.Tensor:
    """The rendered batch as the discriminator sees it: (B, 3 or 4, H, W),
    the mask as the fourth channel under `supervise_alpha`."""
    rgb = out.rgb
    if cfg.supervise_alpha:
        rgb = torch.cat((rgb, out.mask[..., None]), dim=-1)
    return rgb.permute(0, 3, 1, 2)


def generator_loss(state: GANTrainState, batch: Batch, cfg: GANConfig,
                   sampler: Sampler = triplane_cuda.sample_triplane
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The G step's loss, with a graph to G's parameters, and its metrics;
    `batch` holds 'z', 'pose', 'focal' and optionally 'noise' and
    'aug_tform'. Changes nothing in the state but its generator's
    draws."""
    _check_supported(cfg)
    i = state.iteration
    pose, focal = batch['pose'], batch.get('focal')
    if cfg.augment_p_max > 0:
        _, pose, focal, _ = augment.augment(
            state.rng, None, pose, focal, state.augment_p,
            cfg.white_background, cached_tform=batch.get('aug_tform'))
    requests = ['sdf_eikonal_loss']
    if cfg.tv > 0:
        requests.append('total_variation_loss')
    if cfg.entropy > 0:
        requests.append('entropy_loss')

    out, extra = generator_forward(state.gen, batch['z'], pose, focal, cfg,
                                   state.rng, requests, batch.get('noise'),
                                   sampler)
    logits = state.disc(_image(out, cfg), pose, None, focal)
    loss = gan_loss(logits, True)
    metrics = {'loss_g': loss}
    eik = extra['sdf_eikonal_loss'].mean()
    loss = loss + cfg.eikonal * eik
    metrics['loss_eikonal'] = eik
    warm = min(i / BLUR_WARMUP_ITERS, 1.0)
    if cfg.tv > 0:
        tv = extra['total_variation_loss'].mean()
        loss = loss + cfg.tv * warm * tv
        metrics['loss_tv'] = tv
    if cfg.entropy > 0:
        ent = extra['entropy_loss'].mean()
        loss = loss + cfg.entropy * warm * ent
        metrics['loss_entropy'] = ent
    return loss, metrics


def g_step(state: GANTrainState, batch: Batch, cfg: GANConfig,
           sampler: Sampler = triplane_cuda.sample_triplane
           ) -> Dict[str, torch.Tensor]:
    """One generator update (see `generator_loss` for `batch`): Adam on the
    clipped gradients, the beta/alpha clamp, the EMA, i + 1. Returns the
    step's metrics."""
    loss, metrics = generator_loss(state, batch, cfg, sampler)
    i = state.iteration
    params = list(state.gen.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    metrics['grad_norm_g'] = _adam_step(state.opt_g, params, grads,
                                        cfg.lr_g, cfg)
    with torch.no_grad():
        state.gen.beta.clamp_(min=1e-3)
        state.gen.alpha.clamp_(min=1e-3)
    _update_ema(state.gen_ema, state.gen, _ema_alpha(i))
    state.iteration = i + 1
    return {k: v.detach() for k, v in metrics.items()}


def _prepare_d_real(state: GANTrainState, batch: Batch, cfg: GANConfig,
                    blur_active: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """The real images (NCHW) and their poses: ADA on the 2x copy (then its
    2x2 mean) when there is one, then the warmup blur."""
    pose, focal = batch['pose'], batch.get('focal')
    if cfg.augment_p_max > 0:
        use_highres = cfg.is_highres and 'image_highres' in batch
        img = batch['image_highres' if use_highres else 'image']
        img, pose, focal, _ = augment.augment(
            state.rng, img.permute(0, 3, 1, 2), pose, focal,
            state.augment_p, cfg.white_background,
            cached_tform=batch.get('aug_tform'))
        if use_highres:
            b, c, h, w = img.shape
            img = img.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))
    else:
        img = batch['image'].permute(0, 3, 1, 2)
    if blur_active:
        img = blur_image(img, state.iteration, cfg.white_background)
    return img, pose, focal


@torch.no_grad()
def _render_fake(state: GANTrainState, fake_batch: Batch, cfg: GANConfig,
                 sampler: Sampler
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """Fakes rendered by G (not its EMA) without a graph, from ADA-augmented
    poses."""
    pose, focal = fake_batch['pose'], fake_batch.get('focal')
    if cfg.augment_p_max > 0:
        _, pose, focal, _ = augment.augment(
            state.rng, None, pose, focal, state.augment_p,
            cfg.white_background, cached_tform=fake_batch.get('aug_tform'))
    out, _ = generator_forward(state.gen, fake_batch['z'], pose, focal, cfg,
                               state.rng, noise=fake_batch.get('noise'),
                               sampler=sampler)
    return _image(out, cfg), pose, focal


def _d_phase_loss(disc: Discriminator, real, fake, cfg: GANConfig,
                  use_r1_now: bool):
    """Real + R1 + fake losses. Returns (loss, loss_real, loss_fake,
    r1 penalty, mean sign of the real logits)."""
    real_img, pose_r, focal_r = real
    fake_img, pose_f, focal_f = fake
    if use_r1_now:
        real_img = real_img.detach().requires_grad_()
    logits_real = disc(real_img, pose_r, None, focal_r)
    loss_real = gan_loss(logits_real, True)
    penalty = torch.zeros((), device=real_img.device)
    if use_r1_now:
        g, = torch.autograd.grad(logits_real.sum(), real_img,
                                 create_graph=True)
        penalty = g.reshape(g.shape[0], -1).square().sum(dim=1).mean()
    loss_fake = gan_loss(disc(fake_img, pose_f, None, focal_f), False)
    loss = loss_real + (cfg.r1 / 2.0) * penalty + loss_fake
    return (loss, loss_real, loss_fake, penalty,
            torch.sign(logits_real.detach()).float().mean())


def d_step(state: GANTrainState, batch: Batch, fake_batch: Batch,
           cfg: GANConfig, sampler: Sampler = triplane_cuda.sample_triplane
           ) -> Dict[str, torch.Tensor]:
    """One discriminator update. `batch` is the real phase ('image', with
    'image_highres' under `is_highres`, 'pose', 'focal', optionally
    'aug_tform'); `fake_batch` gives the fakes' 'z', 'pose', 'focal' and
    optionally 'noise' and 'aug_tform'. R1 runs on odd iterations (every
    D step) and the blur while i < 12,500; the ADA controller moves p on
    every fourth D step and holds it at 0 during the blur warmup. Returns
    the step's metrics."""
    _check_supported(cfg)
    i = state.iteration
    real = _prepare_d_real(state, batch, cfg, i < BLUR_WARMUP_ITERS)
    fake = _render_fake(state, fake_batch, cfg, sampler)
    loss, loss_real, loss_fake, penalty, sign_real = _d_phase_loss(
        state.disc, real, fake, cfg, cfg.r1 > 0 and i % 2 == 1)
    params = list(state.disc.parameters())
    grads = torch.autograd.grad(loss, params)
    metrics = {'loss_d_real': loss_real, 'loss_d_fake': loss_fake,
               'loss_r1': penalty, 'sign_real': sign_real}
    metrics['grad_norm_d'] = _adam_step(state.opt_d, params, grads,
                                        cfg.lr_d, cfg)
    if cfg.augment_ada and cfg.augment_p_max > 0 and i % 8 == 7:
        if i < BLUR_WARMUP_ITERS:
            state.augment_p = 0.0
        else:
            ada_interval, ada_rampup = 4, 500000.0
            step = (cfg.batch_size * ada_interval) / ada_rampup
            delta = step if float(sign_real) > cfg.ada_target else (
                -step if float(sign_real) < cfg.ada_target else 0.0)
            state.augment_p = min(max(state.augment_p + delta, 0.0),
                                  cfg.augment_p_max)
    state.iteration = i + 1
    return {k: v.detach() for k, v in metrics.items()}
