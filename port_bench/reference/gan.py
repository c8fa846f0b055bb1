"""GAN training's first steps in plain PyTorch, float32: the loop's
batches, the G step and the D step of the measured program's
configuration (one pose-conditioned discriminator, R1 on every D step,
ADA on the real images and on the poses, the SDF regularizers, Adam on
the clipped gradients, the beta/alpha clamp and the EMA), on this
folder's plain modules.

The draws: the loop draws its batches from a numpy RandomState and a
latent generator seeded from the loop's seed (`LoopDraws`); a step draws
from the state's generator in the order the step makes them
(`g_draws`, `d_draws`), here all before the step, so that the renders
can run in blocks of rows with their rows' draws. The step's
discriminator sees the whole batch (its minibatch deviation mixes the
rows): the images are rendered without a graph, the discriminator's
gradient to them taken on the whole batch, and each block rendered again
with its graph to carry that gradient to the generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import augment
from port_bench.reference.renderer import render

BLUR_WARMUP_ITERS = 12500
LR_WARMUP_ITERS = 2000
NSTRATA = 32


class EndlessSampler:
    """A shuffled endless index stream over a RandomState."""

    def __init__(self, size: int, rng: np.random.RandomState):
        self.size, self.rng = size, rng
        self.perm, self.pos = rng.permutation(size), 0

    def __call__(self, n: int) -> np.ndarray:
        out = []
        while len(out) < n:
            if self.pos >= self.size:
                self.perm, self.pos = self.rng.permutation(self.size), 0
            take = min(n - len(out), self.size - self.pos)
            out.extend(self.perm[self.pos:self.pos + take].tolist())
            self.pos += take
        return np.asarray(out)


class LoopDraws:
    """The batches one call of the training loop draws, from its seed:
    a G step's (indices from the RandomState, latents), a D step's real
    (indices from the sampler) and fake (indices, latents)."""

    def __init__(self, split, batch: int, latent_dim: int, seed: int,
                 device):
        self.split, self.batch, self.latent_dim = split, batch, latent_dim
        self.rng = np.random.RandomState(seed)
        self.sampler = EndlessSampler(len(split['images']), self.rng)
        self.latents = torch.Generator(device=device).manual_seed(seed + 1)
        self.device = device

    def _rows(self, idx, highres=False, latents=False) -> Dict:
        def tensor(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=torch.float32, device=self.device)
        out = {'image': tensor(self.split['images'][idx]),
               'pose': tensor(self.split['tform_cam2world'][idx])}
        if self.split.get('focal_length') is not None:
            out['focal'] = tensor(self.split['focal_length'][idx])
        if highres:
            out['image_highres'] = tensor(self.split['images_highres'][idx])
        if latents:
            out['z'] = torch.randn((self.batch, self.latent_dim),
                                   generator=self.latents,
                                   device=self.device)
        return out

    def g_batch(self) -> Dict:
        return self._rows(self.rng.randint(len(self.split['images']),
                                           size=(self.batch,)),
                          latents=True)

    def d_batches(self, highres: bool) -> Tuple[Dict, Dict]:
        real = self._rows(self.sampler(self.batch), highres=highres)
        fake = self._rows(self.rng.randint(len(self.split['images']),
                                           size=(self.batch,)),
                          latents=True)
        return real, fake


def _tform(gen: torch.Generator, b: int, p: float):
    return augment.sample_transform(gen, b, p)


def _render_draws(gen: torch.Generator, b: int, res: int, s: int) -> Dict:
    dev = gen.device
    return {'depth': torch.rand((b, res, res, s), generator=gen, device=dev),
            'pdf_u': torch.rand((b * res * res, s), generator=gen,
                                device=dev)}


def g_draws(gen: torch.Generator, cfg, p: float) -> Dict:
    """A G step's draws in its order: the poses' transform, the render's
    depths and PDF draws, the regularizers' strata and perturbation."""
    b, dev, n = cfg.batch_size, gen.device, NSTRATA - 1
    out = {'tform': _tform(gen, b, p)}
    out.update(_render_draws(gen, b, cfg.resolution,
                             cfg.depth_samples_per_ray))
    out['strata'] = torch.rand((b, n, n, n, 3), generator=gen, device=dev)
    out['perturb'] = torch.randn((b, n ** 3, 3), generator=gen, device=dev)
    return out


def d_draws(gen: torch.Generator, cfg, p: float) -> Dict:
    """A D step's draws in its order: the real images' transform, the
    fakes' pose transform, the fakes' render draws."""
    b = cfg.batch_size
    out = {'real_tform': _tform(gen, b, p), 'tform': _tform(gen, b, p)}
    out.update(_render_draws(gen, b, cfg.resolution,
                             cfg.depth_samples_per_ray))
    return out


def _rows_of(draws: Dict, rows: slice, pixels: int) -> Dict:
    out = {}
    for k in ('depth', 'strata', 'perturb'):
        if k in draws:
            out[k] = draws[k][rows]
    out['pdf_u'] = draws['pdf_u'][rows.start * pixels:rows.stop * pixels]
    return out


def _forward(gen, z, pose, focal, cfg, draws: Dict, rows: slice,
             regularize: bool):
    """The render of `rows` (and with `regularize` their SDF terms)."""
    state = gen.synthesize(gen.map(z[rows]))
    d = _rows_of(draws, rows, cfg.resolution ** 2)
    out = render(gen.field(state), cfg.resolution, cfg.resolution,
                 pose[rows], None if focal is None else focal[rows],
                 cfg.scene_range, cfg.white_background,
                 cfg.depth_samples_per_ray,
                 rng={'depth': d['depth'], 'pdf_u': d['pdf_u']},
                 fine_sampling=cfg.fine_sampling)
    img = out.rgb
    if cfg.supervise_alpha:
        img = torch.cat((img, out.mask[..., None]), dim=-1)
    img = img.permute(0, 3, 1, 2)
    extra = {}
    if regularize:
        requests = ['sdf_eikonal_loss']
        if cfg.tv > 0:
            requests.append('total_variation_loss')
        if cfg.entropy > 0:
            requests.append('entropy_loss')
        extra = gen.sdf_losses(state.planes_cl,
                               {'strata': d['strata'],
                                'perturb': d['perturb']}, requests)
    return img, extra


def _blocks(b: int, block: int):
    return [slice(s, min(s + block, b)) for s in range(0, b, block)]


def _lr(base: float, count: int) -> float:
    frac = min(count / (LR_WARMUP_ITERS / 2), 1.0)
    return base / 10.0 + (base - base / 10.0) * frac


def adam_step(opt: torch.optim.Adam, params, grads, base_lr: float,
              clip: float) -> torch.Tensor:
    """Clips to a global norm (g * clip / norm above it) and takes one
    Adam step at the warmup's lr (the group's 'count')."""
    pairs = [(p, g) for p, g in zip(params, grads) if g is not None]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for _, g in pairs]))
    factor = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
    group = opt.param_groups[0]
    for p, g in pairs:
        p.grad = g * factor
    group['lr'] = _lr(base_lr, group['count'])
    opt.step()
    group['count'] += 1
    for p, _ in pairs:
        p.grad = None
    return norm


def ema_alpha(iteration: int) -> float:
    alpha = 0.5 ** (32.0 / 10000.0)
    power = 100.0 if iteration < 1000 else 10.0 if iteration < 10000 else 1.0
    return alpha ** power


@dataclasses.dataclass
class State:
    gen: torch.nn.Module
    gen_ema: torch.nn.Module
    disc: torch.nn.Module
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    iteration: int
    augment_p: float


def g_step(st: State, batch: Dict, draws: Dict, cfg, block: int
           ) -> Dict[str, torch.Tensor]:
    b, i = cfg.batch_size, st.iteration
    pose, focal = augment.augment_pose(batch['pose'], batch.get('focal'),
                                       draws['tform'])
    with torch.no_grad():
        imgs = torch.cat([_forward(st.gen, batch['z'], pose, focal, cfg,
                                   draws, r, False)[0]
                          for r in _blocks(b, block)])
    imgs.requires_grad_()
    loss_g = F.softplus(-st.disc(imgs, pose, None, focal)).mean()
    g_img, = torch.autograd.grad(loss_g, imgs)
    params = list(st.gen.parameters())
    grads: List[Optional[torch.Tensor]] = [None] * len(params)
    warm = min(i / BLUR_WARMUP_ITERS, 1.0)
    sums = {'sdf_eikonal_loss': 0.0, 'total_variation_loss': 0.0,
            'entropy_loss': 0.0}
    for rows in _blocks(b, block):
        img, extra = _forward(st.gen, batch['z'], pose, focal, cfg, draws,
                              rows, True)
        total = (img * g_img[rows]).sum()
        total = total + cfg.eikonal * extra['sdf_eikonal_loss'].sum() / b
        if cfg.tv > 0:
            total = total + cfg.tv * warm * \
                extra['total_variation_loss'].sum() / b
        if cfg.entropy > 0:
            total = total + cfg.entropy * warm * \
                extra['entropy_loss'].sum() / b
        for k in extra:
            sums[k] = sums[k] + extra[k].detach().sum()
        gs = torch.autograd.grad(total, params, allow_unused=True)
        grads = [a if g is None else g if a is None else a + g
                 for a, g in zip(grads, gs)]
    adam_step(st.opt_g, params, grads, cfg.lr_g, cfg.clip_gradient_norm)
    with torch.no_grad():
        st.gen.beta.clamp_(min=1e-3)
        st.gen.alpha.clamp_(min=1e-3)
        e, m = list(st.gen_ema.parameters()), list(st.gen.parameters())
        a = ema_alpha(i)
        torch._foreach_mul_(e, a)
        torch._foreach_add_(e, m, alpha=1.0 - a)
    st.iteration = i + 1
    metrics = {'loss_g': loss_g.detach(),
               'loss_eikonal': sums['sdf_eikonal_loss'] / b}
    if cfg.tv > 0:
        metrics['loss_tv'] = sums['total_variation_loss'] / b
    if cfg.entropy > 0:
        metrics['loss_entropy'] = sums['entropy_loss'] / b
    return metrics


def d_step(st: State, real: Dict, fake: Dict, draws: Dict, cfg, block: int
           ) -> Dict[str, torch.Tensor]:
    b, i = cfg.batch_size, st.iteration
    if i < BLUR_WARMUP_ITERS:
        raise NotImplementedError('the reference follows steps past the '
                                  'warmup blur')
    hires = cfg.is_highres and 'image_highres' in real
    img = real['image_highres' if hires else 'image'].permute(0, 3, 1, 2)
    img = augment.augment_impl(img, draws['real_tform'], cfg.white_background)
    if hires:
        c, h, w = img.shape[1:]
        img = img.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))
    pose_r, focal_r = augment.augment_pose(real['pose'], real.get('focal'),
                                           draws['real_tform'])
    pose_f, focal_f = augment.augment_pose(fake['pose'], fake.get('focal'),
                                           draws['tform'])
    with torch.no_grad():
        fakes = torch.cat([_forward(st.gen, fake['z'], pose_f, focal_f, cfg,
                                    draws, r, False)[0]
                           for r in _blocks(b, block)])
    real_img = img.detach().requires_grad_()
    logits_real = st.disc(real_img, pose_r, None, focal_r)
    loss_real = F.softplus(-logits_real).mean()
    g, = torch.autograd.grad(logits_real.sum(), real_img, create_graph=True)
    penalty = g.reshape(b, -1).square().sum(dim=1).mean()
    loss_fake = F.softplus(st.disc(fakes, pose_f, None, focal_f)).mean()
    total = loss_real + (cfg.r1 / 2.0) * penalty + loss_fake
    params = list(st.disc.parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    adam_step(st.opt_d, params, grads, cfg.lr_d, cfg.clip_gradient_norm)
    st.iteration = i + 1
    return {'loss_d_real': loss_real.detach(),
            'loss_d_fake': loss_fake.detach(), 'loss_r1': penalty.detach()}


def optimizer(module, base_lr: float, count: int) -> torch.optim.Adam:
    opt = torch.optim.Adam(module.parameters(), lr=_lr(base_lr, count),
                           betas=(0.0, 0.99), eps=1e-8)
    opt.param_groups[0]['count'] = count
    return opt
