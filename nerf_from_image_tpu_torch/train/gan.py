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

The flag-only modes of the reference trainer:
- encoder or class conditioning (`use_encoder`, `use_class`): G maps z
  with the embedding of the batch's image or class (`embed_condition`),
  and D1 sees the same image or class;
- path-length regularization: the norm of the gradient of random
  projections of the planes and palette to the ws
  (`compute_path_length`), against a running average, in its own
  backward pass whose gradients are summed into G's;
- dual discriminators: G renders the same latents (and conditioning) a
  second time from a second batch's poses for a second D, each
  adversarial loss halved. D2 is D1 itself without an encoder
  (`'shared'`), else a D that does not see the image. The L1 and MSE
  modes replace D1 by 10 x the L1 or MSE of the render against the
  blurred conditioning image (and the G batch is not augmented; under
  `supervise_alpha` the mask against the image's alpha); without
  an encoder no D is left at all, and the G step fails as the JAX
  package's does.

The poses are data, so no coordinate of the render carries a gradient:
autograd asks the triplane sampler for the planes' gradient only, and on
the card its backward runs kernel B4 (`ops/csrc/triplane_sample_grad_planes
.cu`), the port's form of the JAX package's `coord_grads=False`. The
forward runs kernel B1. The regularizers decode on the gather sampler,
which autograd differentiates twice; path-length regularization
differentiates the synthesis twice and samples nothing. `sampler=` names
the render's sampler, so a step can be held against the same step on the
plain versions.

The state is updated in place. Every random draw comes from the state's
`torch.Generator`, or from arrays injected as the JAX package injects
them: `batch['noise']` ('depth', 'pdf_u', 'strata', 'perturb',
'ppl_planes', 'ppl_attn', and 'sg_noise', the per-layer StyleGAN noise of
a noise-enabled generator, which otherwise draws fresh noise on every
forward, the same for a step's render and its path length) and
`batch['aug_tform']`. A view-direction generator (carla) renders with
its rays' directions.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

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
    # The reference always samples fine (--fine_sampling parses as true);
    # without it a pass of depth_samples_per_ray stratified samples only.
    fine_sampling: bool = True
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
    path_length_regularization: bool = False
    use_encoder: bool = False  # G and D1 conditioned on an image
    use_class: bool = False  # G and D conditioned on a class label
    # The train split's with use_class, else None (the models' class
    # tables follow it).
    num_classes: Optional[int] = None
    dual_discriminator: bool = False
    dual_discriminator_l1: bool = False  # D1 replaced by 10 x L1 recon
    dual_discriminator_mse: bool = False  # D1 replaced by 10 x MSE recon

    @property
    def recon_mode(self) -> bool:
        """Whether a reconstruction loss takes D1's place."""
        return self.dual_discriminator_l1 or self.dual_discriminator_mse


@dataclasses.dataclass
class GANTrainState:
    gen: Generator
    gen_ema: Generator
    disc: Optional[Discriminator]  # None in the recon modes
    opt_g: torch.optim.Adam
    opt_d: Optional[torch.optim.Adam]
    iteration: int  # the global i: G steps even, D steps odd
    rng: torch.Generator
    augment_p: float  # the ADA probability
    ppl_running_avg: float  # < 0: not started
    # The separate second discriminator of dual-D mode with an encoder.
    disc2: Optional[Discriminator] = None
    opt_d2: Optional[torch.optim.Adam] = None


def second_discriminator(cfg: GANConfig) -> Optional[str]:
    """The dual-D mode's second discriminator: None (single D, or the
    recon modes without an encoder, where no D is left), 'shared' (D1's
    parameters over a second batch) without an encoder, 'separate' (a
    D that does not see the image) with one."""
    if not cfg.dual_discriminator:
        return None
    if not cfg.use_encoder:
        return None if cfg.recon_mode else 'shared'
    return 'separate'


def _discriminator(cfg: GANConfig, use_encoder: bool, dtype: torch.dtype,
                   device: DeviceLike, seed: int) -> Discriminator:
    return Discriminator(resolution=cfg.resolution,
                         nc=4 if cfg.supervise_alpha else 3,
                         camera_flipped=cfg.camera_flipped,
                         use_encoder=use_encoder,
                         num_classes=cfg.num_classes,
                         channel_base=cfg.channel_base,
                         channel_max=cfg.channel_max, dtype=dtype,
                         device=device, seed=seed)


def make_models(cfg: GANConfig, dtype: torch.dtype = torch.float32,
                device: DeviceLike = None, seed: int = 0
                ) -> Tuple[Generator, Optional[Discriminator]]:
    """The generator (from `seed`) and the discriminator (from seed + 1;
    None in the recon modes, where a loss takes its place), on `device`
    (None: CUDA)."""
    gen = Generator(latent_dim=cfg.latent_dim, scene_range=cfg.scene_range,
                    attention_values=cfg.attention_values,
                    img_resolution=cfg.plane_resolution,
                    channel_base=cfg.channel_base,
                    channel_max=cfg.channel_max, dtype=dtype, device=device,
                    seed=seed, use_viewdir=cfg.use_viewdir,
                    use_stylegan_noise=cfg.use_stylegan_noise,
                    use_encoder=cfg.use_encoder,
                    num_classes=cfg.num_classes)
    disc = (None if cfg.recon_mode else
            _discriminator(cfg, cfg.use_encoder, dtype, device, seed + 1))
    return gen, disc


def make_second_discriminator(cfg: GANConfig,
                              dtype: torch.dtype = torch.float32,
                              device: DeviceLike = None, seed: int = 0
                              ) -> Optional[Discriminator]:
    """The separate second discriminator (from seed + 2) when
    `second_discriminator(cfg)` is 'separate', else None."""
    if second_discriminator(cfg) != 'separate':
        return None
    return _discriminator(cfg, False, dtype, device, seed + 2)


def _lr(base_lr: float, count: int) -> float:
    """Linear warmup from lr / 10 to lr over the first 1000 optimizer
    steps, read at the optimizer's count before the step."""
    frac = min(count / (LR_WARMUP_ITERS / 2), 1.0)
    return base_lr / 10.0 + (base_lr - base_lr / 10.0) * frac


def make_optimizer(module: Optional[torch.nn.Module], base_lr: float
                   ) -> Optional[torch.optim.Adam]:
    """Adam(b1 = 0, b2 = 0.99, eps = 1e-8) over `module`'s parameters
    (None for no module); it keeps its step count in its param group's
    'count', for the lr warmup."""
    if module is None:
        return None
    opt = torch.optim.Adam(module.parameters(), lr=_lr(base_lr, 0),
                           betas=(0.0, 0.99), eps=1e-8)
    opt.param_groups[0]['count'] = 0
    return opt


def init_train_state(cfg: GANConfig, dtype: torch.dtype = torch.float32,
                     device: DeviceLike = None, seed: int = 0
                     ) -> GANTrainState:
    """A fresh state at iteration 0 on `device` (None: CUDA, raising when
    it is absent); the EMA generator starts as a copy of G."""
    device = resolve_device(device)
    gen, disc = make_models(cfg, dtype, device, seed)
    disc2 = make_second_discriminator(cfg, dtype, device, seed)
    gen_ema = copy.deepcopy(gen).requires_grad_(False)
    return GANTrainState(
        gen=gen, gen_ema=gen_ema, disc=disc,
        opt_g=make_optimizer(gen, cfg.lr_g),
        opt_d=make_optimizer(disc, cfg.lr_d),
        iteration=0, rng=torch.Generator(device=device).manual_seed(seed),
        augment_p=0.0, ppl_running_avg=-1.0, disc2=disc2,
        opt_d2=make_optimizer(disc2, cfg.lr_d))


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


def embed_condition(gen: Generator, cfg: GANConfig, batch: Batch
                    ) -> Optional[torch.Tensor]:
    """G's conditioning embedding of a batch: its image's (NHWC, the RGB
    channels) with `use_encoder`, its class's with `use_class`, else
    None."""
    if cfg.use_encoder and 'image' in batch:
        return gen.embed_image(batch['image'][..., :3].permute(0, 3, 1, 2))
    if cfg.use_class and 'class' in batch:
        return gen.embed_class(batch['class'])
    return None


def _d_condition(cfg: GANConfig, batch: Batch, see_image: bool = True):
    """What a discriminator is conditioned on besides the pose: the class
    labels with `use_class`, else (for a D that sees it) the image, NCHW."""
    if cfg.use_class:
        return batch.get('class')
    if cfg.use_encoder and see_image:
        return batch['image'][..., :3].permute(0, 3, 1, 2)
    return None


def stylegan_noise(gen: Generator, batch_size: int, rng: torch.Generator,
                   noise: Optional[Dict[str, object]]):
    """The StyleGAN noise of one forward: the injected per-layer values
    ('sg_noise'), else, for a noise-enabled generator, fresh values from
    `rng` (which the step's path length then reuses), else None."""
    if noise is not None and 'sg_noise' in noise:
        return noise['sg_noise']
    if gen.noise_mode(rng) != 'random':
        return None
    return gen.synthesis_network.noise_values(batch_size, rng,
                                              gen.beta.device)


def generator_forward(gen: Generator, z: torch.Tensor, pose: torch.Tensor,
                      focal: Optional[torch.Tensor], cfg: GANConfig,
                      rng: torch.Generator, requests: Sequence[str] = (),
                      noise: Optional[Dict[str, torch.Tensor]] = None,
                      sampler: Sampler = triplane_cuda.sample_triplane,
                      cond: Optional[torch.Tensor] = None,
                      center: Optional[torch.Tensor] = None,
                      bbox: Optional[torch.Tensor] = None
                      ) -> Tuple[RenderOutput, Dict[str, torch.Tensor]]:
    """Maps z (with the conditioning embedding `cond`), synthesizes,
    renders (through the principal point `center` and the crop `bbox` of
    the batch, where it has them); with `requests` (regularizers of
    `Generator.sdf_losses`), also runs those. `noise` replaces the draws of
    `rng` with the injected arrays it holds ('sg_noise', the per-layer
    StyleGAN noise, outermost layer first; 'depth', 'pdf_u' for the render;
    'strata', 'perturb' for the regularizers). A noise-enabled generator
    draws its StyleGAN noise from `rng` first, then the render draws.
    Returns (render, regularizers)."""
    sg_noise = stylegan_noise(gen, z.shape[0], rng, noise)
    state = gen.synthesize(gen.map(z, cond), noise=sg_noise)
    render_rng = rng
    if noise is not None and ('depth' in noise or 'pdf_u' in noise):
        render_rng = {k: noise[k] for k in ('depth', 'pdf_u') if k in noise}
    out = render(gen.field(state, sampler), cfg.resolution, cfg.resolution,
                 pose, focal, cfg.scene_range, cfg.white_background,
                 cfg.depth_samples_per_ray, rng=render_rng, center=center,
                 bbox=bbox, fine_sampling=cfg.fine_sampling)
    extra = {}
    if requests:
        reg_rng = rng
        if noise is not None and 'strata' in noise:
            reg_rng = {k: noise[k] for k in ('strata', 'perturb')
                       if k in noise}
        extra = gen.sdf_losses(state.planes_cl, reg_rng, requests)
    return out, extra


def compute_path_length(gen: Generator, ws: torch.Tensor, rng:
                        torch.Generator, sg_noise=None,
                        noise: Optional[Dict[str, torch.Tensor]] = None
                        ) -> torch.Tensor:
    """Path length (B,): the norm, averaged over the ws, of the gradient
    to `ws` of sum(planes * n1) / R + sum(palette * n2), n1 and n2
    standard normal (injected as 'ppl_planes' and 'ppl_attn', else drawn
    from `rng` in that order), synthesized with the StyleGAN noise
    `sg_noise` of the step's forward. The gradient keeps its graph, so
    the result differentiates to G's parameters."""
    state = gen.synthesize(ws, noise=sg_noise)
    planes, att = state.planes, state.attention_values
    if noise is not None and 'ppl_planes' in noise:
        n1 = noise['ppl_planes'].reshape(planes.shape).to(planes.device)
    else:
        n1 = torch.randn(planes.shape, generator=rng, device=planes.device)
    total = (planes * (n1 / math.sqrt(planes.shape[-2] *
                                      planes.shape[-1])).to(
        planes.dtype)).float().sum()
    if att is not None:
        if noise is not None and 'ppl_attn' in noise:
            n2 = noise['ppl_attn'].reshape(att.shape).to(att.device)
        else:
            n2 = torch.randn(att.shape, generator=rng, device=att.device)
        total = total + (att * n2.to(att.dtype)).float().sum()
    grad, = torch.autograd.grad(total, ws, create_graph=True)
    return grad.float().square().sum(dim=-1).mean(dim=-1).sqrt()


def _image(out: RenderOutput, cfg: GANConfig) -> torch.Tensor:
    """The rendered batch as the discriminator sees it: (B, 3 or 4, H, W),
    the mask as the fourth channel under `supervise_alpha`."""
    rgb = out.rgb
    if cfg.supervise_alpha:
        rgb = torch.cat((rgb, out.mask[..., None]), dim=-1)
    return rgb.permute(0, 3, 1, 2)


def _augment_poses(state: GANTrainState, batch: Batch, cfg: GANConfig,
                   augmented: bool = True):
    pose, focal = batch['pose'], batch.get('focal')
    if cfg.augment_p_max > 0 and augmented:
        _, pose, focal, _ = augment.augment(
            state.rng, None, pose, focal, state.augment_p,
            cfg.white_background, cached_tform=batch.get('aug_tform'))
    return pose, focal


def _check_g_mode(cfg: GANConfig) -> Optional[str]:
    """Refuses the G step's modes where the JAX package fails; returns
    `second_discriminator(cfg)`."""
    kind2 = second_discriminator(cfg)
    if cfg.dual_discriminator and kind2 is None:
        # The JAX package's G step calls a second discriminator that does
        # not exist here (train/gan.py:561-567) and fails.
        raise ValueError('dual_discriminator_l1/_mse without use_encoder '
                         'leaves no discriminator for the second pass')
    if cfg.recon_mode and cfg.supervise_alpha:
        # The JAX package subtracts the conditioning image's three channels
        # from the render's four (the mask the fourth) and fails.
        raise ValueError('dual_discriminator_l1/_mse compare the render '
                         'with the RGB image and cannot take '
                         'supervise_alpha')
    return kind2


def generator_loss(state: GANTrainState, batch: Batch, cfg: GANConfig,
                   sampler: Sampler = triplane_cuda.sample_triplane,
                   batch2: Optional[Batch] = None,
                   sg_noise: Optional[List[torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The G step's loss, with a graph to G's parameters, and its metrics;
    `batch` holds 'z', 'pose', 'focal', with conditioning 'image' or
    'class', and optionally 'noise' and 'aug_tform'; `batch2` the second
    poses of dual-D mode ('pose', 'focal', optionally 'noise' and
    'aug_tform'); `sg_noise` the forward's StyleGAN noise (see
    `stylegan_noise`; None: the batch's or the generator's own draws).
    Changes nothing in the state but its generator's draws."""
    i = state.iteration
    kind2 = _check_g_mode(cfg)
    pose, focal = _augment_poses(state, batch, cfg, not cfg.recon_mode)
    pose2 = focal2 = None
    if cfg.dual_discriminator:
        pose2, focal2 = _augment_poses(state, batch2, cfg)
    requests = ['sdf_eikonal_loss']
    if cfg.tv > 0:
        requests.append('total_variation_loss')
    if cfg.entropy > 0:
        requests.append('entropy_loss')

    noise = dict(batch.get('noise') or {})
    if sg_noise is not None:
        noise['sg_noise'] = sg_noise
    cond = embed_condition(state.gen, cfg, batch)
    out, extra = generator_forward(state.gen, batch['z'], pose, focal, cfg,
                                   state.rng, requests, noise, sampler,
                                   cond, batch.get('center'),
                                   batch.get('bbox'))
    img = _image(out, cfg)
    if cfg.recon_mode:
        target = blur_image(batch['image'][..., :3].permute(0, 3, 1, 2), i,
                            cfg.white_background)
        diff = img - target
        loss = 10.0 * (diff.square().mean() if cfg.dual_discriminator_mse
                       else diff.abs().mean())
    else:
        logits = state.disc(img, pose, _d_condition(cfg, batch), focal)
        loss = gan_loss(logits, True)
    metrics = {'loss_g': loss}
    if cfg.dual_discriminator:
        # The same latents and conditioning from the second poses, for
        # the second discriminator, which keeps class labels but never
        # sees the image.
        out2, _ = generator_forward(state.gen, batch['z'], pose2, focal2,
                                    cfg, state.rng, (), batch2.get('noise'),
                                    sampler, cond, batch2.get('center'),
                                    batch2.get('bbox'))
        disc2 = state.disc if kind2 == 'shared' else state.disc2
        logits2 = disc2(_image(out2, cfg), pose2,
                        _d_condition(cfg, batch2, see_image=False), focal2)
        loss2 = gan_loss(logits2, True)
        metrics['loss_g_uncond'] = loss2
        loss = loss / 2.0 + loss2 / 2.0
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


def path_length_loss(state: GANTrainState, batch: Batch, cfg: GANConfig,
                     sg_noise: Optional[List[torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """The path-length penalty of a G step, with a graph to G's
    parameters: (weighted penalty, penalty, the new running average).
    The batch's latents and conditioning are mapped again, and the
    synthesis takes the forward's StyleGAN noise `sg_noise`. The running
    average starts at the first batch's mean and moves by 0.01 of each
    batch's mean; it is a constant of the penalty."""
    ws = state.gen.map(batch['z'], embed_condition(state.gen, cfg, batch))
    ppl = compute_path_length(state.gen, ws, state.rng, sg_noise,
                              batch.get('noise'))
    pl_decay = 0.01
    pl_weight = 2.0 * min(state.iteration / LR_WARMUP_ITERS, 1.0)
    mean = ppl.detach().mean()
    avg0 = mean if state.ppl_running_avg < 0 else state.ppl_running_avg
    avg = avg0 * (1 - pl_decay) + mean * pl_decay
    penalty = (ppl - avg).square().mean()
    return pl_weight * penalty, penalty, float(avg)


def g_step(state: GANTrainState, batch: Batch, cfg: GANConfig,
           sampler: Sampler = triplane_cuda.sample_triplane,
           batch2: Optional[Batch] = None) -> Dict[str, torch.Tensor]:
    """One generator update (see `generator_loss` for `batch` and
    `batch2`): with path-length regularization its penalty's gradients
    (own backward pass) are added to the loss's; then Adam on the clipped
    gradients, the beta/alpha clamp, the EMA, i + 1. Returns the step's
    metrics."""
    _check_g_mode(cfg)
    sg_noise = stylegan_noise(state.gen, batch['z'].shape[0], state.rng,
                              batch.get('noise'))
    loss, metrics = generator_loss(state, batch, cfg, sampler, batch2,
                                   sg_noise)
    i = state.iteration
    params = list(state.gen.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    del loss
    if cfg.path_length_regularization:
        weighted, penalty, avg = path_length_loss(state, batch, cfg,
                                                  sg_noise)
        ppl_grads = torch.autograd.grad(weighted, params, allow_unused=True)
        grads = [a if b is None else b if a is None else a + b
                 for a, b in zip(grads, ppl_grads)]
        metrics['loss_ppl'] = penalty
        state.ppl_running_avg = avg
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
                 sampler: Sampler, conditional: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """Fakes rendered by G (not its EMA) without a graph, from ADA-augmented
    poses, conditioned on the fake batch's image or class when
    `conditional`."""
    pose, focal = _augment_poses(state, fake_batch, cfg)
    cond = (embed_condition(state.gen, cfg, fake_batch) if conditional
            else None)
    out, _ = generator_forward(state.gen, fake_batch['z'], pose, focal, cfg,
                               state.rng, noise=fake_batch.get('noise'),
                               sampler=sampler, cond=cond,
                               center=fake_batch.get('center'),
                               bbox=fake_batch.get('bbox'))
    return _image(out, cfg), pose, focal


def _d_phase_loss(disc: Discriminator, real, fake, cond_real, cond_fake,
                  cfg: GANConfig, use_r1_now: bool):
    """Real + R1 + fake losses. Returns (loss, loss_real, loss_fake,
    r1 penalty, mean sign of the real logits)."""
    real_img, pose_r, focal_r = real
    fake_img, pose_f, focal_f = fake
    if use_r1_now:
        real_img = real_img.detach().requires_grad_()
    logits_real = disc(real_img, pose_r, cond_real, focal_r)
    loss_real = gan_loss(logits_real, True)
    penalty = torch.zeros((), device=real_img.device)
    if use_r1_now:
        g, = torch.autograd.grad(logits_real.sum(), real_img,
                                 create_graph=True)
        penalty = g.reshape(g.shape[0], -1).square().sum(dim=1).mean()
    loss_fake = gan_loss(disc(fake_img, pose_f, cond_fake, focal_f), False)
    loss = loss_real + (cfg.r1 / 2.0) * penalty + loss_fake
    return (loss, loss_real, loss_fake, penalty,
            torch.sign(logits_real.detach()).float().mean())


def discriminator_loss(state: GANTrainState, batch: Batch,
                       fake_batch: Batch, cfg: GANConfig,
                       sampler: Sampler = triplane_cuda.sample_triplane,
                       batch2: Optional[Batch] = None,
                       fake_batch2: Optional[Batch] = None
                       ) -> Tuple[Optional[torch.Tensor],
                                  Dict[str, torch.Tensor]]:
    """The D step's loss, with a graph to the discriminators' parameters
    (None when there is no D), and its metrics; see `d_step` for the
    batches. Changes nothing in the state but its generator's draws."""
    i = state.iteration
    use_r1_now = cfg.r1 > 0 and i % 2 == 1
    blur_active = i < BLUR_WARMUP_ITERS
    kind2 = second_discriminator(cfg)
    metrics = {}
    total = None
    sign_real = None
    if not cfg.recon_mode:
        real = _prepare_d_real(state, batch, cfg, blur_active)
        fake = _render_fake(state, fake_batch, cfg, sampler, True)
        total, loss_real, loss_fake, penalty, sign_real = _d_phase_loss(
            state.disc, real, fake, _d_condition(cfg, batch),
            _d_condition(cfg, fake_batch), cfg, use_r1_now)
        suffix = '_cond' if kind2 is not None else ''
        metrics.update({f'loss_d_real{suffix}': loss_real,
                        f'loss_d_fake{suffix}': loss_fake,
                        'loss_r1': penalty})
    if kind2 is not None:
        b2 = batch2 if batch2 is not None else batch
        fb2 = fake_batch2 if fake_batch2 is not None else fake_batch
        real2 = _prepare_d_real(state, b2, cfg, blur_active)
        fake2 = _render_fake(state, fb2, cfg, sampler, cfg.use_encoder)
        disc2 = state.disc if kind2 == 'shared' else state.disc2
        loss2, loss_real, loss_fake, penalty, sign_real = _d_phase_loss(
            disc2, real2, fake2, _d_condition(cfg, b2, see_image=False),
            _d_condition(cfg, fb2, see_image=False), cfg, use_r1_now)
        metrics.update({'loss_d_real': loss_real, 'loss_d_fake': loss_fake,
                        'loss_r1_uncond': penalty})
        total = loss2 if total is None else total + loss2
    if sign_real is None:
        sign_real = torch.zeros((), device=state.gen.beta.device)
    metrics['sign_real'] = sign_real
    return total, metrics


def discriminator_params(state: GANTrainState) -> list:
    """(parameters, optimizer, metric key) of each discriminator the D
    step trains: D1, then the separate D2."""
    return [(list(module.parameters()), opt, key) for module, opt, key in
            ((state.disc, state.opt_d, 'grad_norm_d'),
             (state.disc2, state.opt_d2, 'grad_norm_d2'))
            if module is not None]


def d_step(state: GANTrainState, batch: Batch, fake_batch: Batch,
           cfg: GANConfig, sampler: Sampler = triplane_cuda.sample_triplane,
           batch2: Optional[Batch] = None,
           fake_batch2: Optional[Batch] = None) -> Dict[str, torch.Tensor]:
    """One discriminator update. `batch` is the real phase ('image', with
    'image_highres' under `is_highres`, 'pose', 'focal', with class
    conditioning 'class', optionally 'aug_tform'); `fake_batch` gives the
    fakes' 'z', 'pose', 'focal', the conditioning 'image' or 'class', and
    optionally 'noise' and 'aug_tform'. In dual-D mode `batch2` and
    `fake_batch2` (default: the first ones) feed the second
    discriminator: its fakes are rendered with the conditioning only with
    an encoder, and its metrics are the plain names (D1's take `_cond`);
    ADA listens to it. R1 runs on odd iterations (every D step) and the
    blur while i < 12,500; the ADA controller moves p on every fourth D
    step and holds it at 0 during the blur warmup. In the recon modes
    without an encoder there is no D and the step only counts. Returns
    the step's metrics."""
    i = state.iteration
    total, metrics = discriminator_loss(state, batch, fake_batch, cfg,
                                        sampler, batch2, fake_batch2)
    updates = discriminator_params(state)
    if updates:
        grads = list(torch.autograd.grad(
            total, [p for params, _, _ in updates for p in params],
            allow_unused=True))
        for params, opt, key in updates:
            metrics[key] = _adam_step(opt, params, grads[:len(params)],
                                      cfg.lr_d, cfg)
            grads = grads[len(params):]
    sign_real = metrics['sign_real']
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
