"""Hybrid-inversion refinement: latent + pose Adam steps (PyTorch port of
`nerf_from_image_tpu/invert/optimizer.py`).

Each step renders from the current parameters, scores the render against
the target (VGG LPIPS on the image and on 15 random affine crops of it, or
l1 / mse / mixed), differentiates to the latent and the camera, takes an
Adam step and projects (R renormalized, s -> |s|, z0 clamped to +-4).
The latent is stored divided by `lr_gain_z`, so Adam's effective rate on
it is gain times larger. The JAX package runs the steps as one
`lax.scan`; here they are a Python loop of eager steps.

On the card the render's triplane sampler runs the CUDA kernels B1
(forward) and B2 (backward, with the coordinate gradients that the camera
needs), and the crops run kernel B3 forward and backward. `sampler` and
`warp` name those functions, so that a step can be held against the same
step on their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from nerf_from_image_tpu_torch.core import augment
from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.models.generator import Generator, Sampler
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.ops import triplane_cuda
from nerf_from_image_tpu_torch.ops import warp as warp_lib
from nerf_from_image_tpu_torch.render.renderer import RenderOutput, render

Warp = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
LOSS_TYPES = ('vgg', 'vgg_nocrop', 'l1', 'mse', 'mixed')


@dataclasses.dataclass
class InversionParams:
    """Optimizable inversion state. z is stored pre-gain (w = z * gain)."""
    z: torch.Tensor  # (B, num_ws or 1, 512)
    R: torch.Tensor  # (B, 4) quaternion
    s: torch.Tensor  # (B,)
    t2: torch.Tensor  # (B, 2)
    z0: Optional[torch.Tensor] = None  # (B,) perspective only

    def named(self) -> List[Tuple[str, torch.Tensor]]:
        """(name, tensor) of the parameters, z0 last and only if set."""
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None]

    def copy(self, requires_grad: bool) -> 'InversionParams':
        """Detached copies, as leaves that require grad or not."""
        return InversionParams(**{
            name: t.detach().clone().requires_grad_(requires_grad)
            for name, t in self.named()})


@dataclasses.dataclass(frozen=True)
class InversionConfig:
    """Static inversion configuration."""
    resolution: int = 128
    depth_samples_per_ray: int = 64
    scene_range: float = 0.55
    white_background: bool = True
    camera_flipped: bool = False
    lr_gain_z: float = 5.0
    loss_type: str = 'vgg'  # one of LOSS_TYPES
    num_augmentations: int = 15
    optimize_pose: bool = True
    lr: float = 2e-3


def make_camera(params: InversionParams, camera_flipped: bool
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    r = params.R / torch.linalg.vector_norm(params.R, dim=-1, keepdim=True)
    return pose_lib.pose_to_matrix(params.z0, params.t2, params.s, r,
                                   camera_flipped)


def render_from_params(gen: Generator, params: InversionParams,
                       cfg: InversionConfig,
                       sampler: Sampler = triplane_cuda.sample_triplane,
                       center: Optional[torch.Tensor] = None,
                       bbox: Optional[torch.Tensor] = None,
                       render_rng: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Tuple[RenderOutput, torch.Tensor, torch.Tensor]:
    """Renders the parameters' latent from their camera.

    `center` (B, 2) and `bbox` (B, 2, 2) crop the camera as in `render`;
    `render_rng` is None (deterministic depths) or the render's draws
    {'depth', 'pdf_u'}, as the JAX package injects them.

    Returns (render, cam2world (B, 4, 4), focal (B,)).
    """
    if params.z0 is None:
        raise NotImplementedError('orthographic cameras are not ported yet')
    cam, focal = make_camera(params, cfg.camera_flipped)
    ws = params.z * cfg.lr_gain_z
    if ws.shape[1] == 1:
        ws = ws.expand(-1, gen.num_ws, -1)
    state = gen.synthesize(ws)
    out = render(lambda pts, reqs: gen.sample(state, pts, reqs,
                                              sampler=sampler),
                 cfg.resolution, cfg.resolution, cam, focal,
                 cfg.scene_range, cfg.white_background,
                 cfg.depth_samples_per_ray, render_rng, center, bbox)
    return out, cam, focal


def inversion_loss(gen: Generator, lpips: LPIPS, params: InversionParams,
                   target_img: torch.Tensor, cfg: InversionConfig,
                   generator: Optional[torch.Generator] = None,
                   tform: Optional[augment.AffineTransform] = None,
                   sampler: Sampler = triplane_cuda.sample_triplane,
                   warp: Warp = warp_lib.grid_sample_zeros,
                   render_rng: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The refinement loss (reference run.py:2202-2254).

    Args:
      target_img: (B, H, W, 3+) in [-1, 1]; only its RGB is read.
      generator: draws the crops' transforms when `tform` is None.
      tform: the transforms of the B * num_augmentations crops (crop k of
        image b is row b * num_augmentations + k), shared by prediction
        and target.
      render_rng: the render's injected draws, or None (deterministic).

    Returns (loss, monitor): the loss sums over the batch (mean LPIPS over
    images and crops, times B); monitor holds the per-image psnr, the
    mean LPIPS of the uncropped pairs and the camera, all detached.
    """
    if cfg.loss_type not in LOSS_TYPES:
        raise ValueError(f'unknown loss_type {cfg.loss_type!r}')
    out, cam, _ = render_from_params(gen, params, cfg, sampler,
                                     render_rng=render_rng)
    pred = out.rgb  # (B, H, W, 3)
    target = target_img[..., :3].detach()
    b = pred.shape[0]
    pred_nchw = pred.permute(0, 3, 1, 2)
    target_nchw = target.permute(0, 3, 1, 2)

    loss = pred.new_zeros(())
    if cfg.loss_type in ('vgg', 'vgg_nocrop', 'mixed'):
        n_aug = 0 if cfg.loss_type == 'vgg_nocrop' else cfg.num_augmentations
        if n_aug > 0:
            h, w = pred.shape[1], pred.shape[2]
            if tform is None:
                tform = augment.sample_transform(generator, b * n_aug, 1.0)
            grid = augment.image_warp_grid(tform, h, w).reshape(
                b, n_aug, h, w, 2)

            def crops(images):
                if cfg.white_background:
                    return (warp(images - 1.0, grid) + 1.0).reshape(
                        b * n_aug, -1, h, w)
                return warp(images, grid).reshape(b * n_aug, -1, h, w)

            pred_aug = crops(pred_nchw)
            with torch.no_grad():
                target_aug = crops(target_nchw)
            pred_all = torch.cat((pred_nchw, pred_aug), dim=0)
            target_all = torch.cat((target_nchw, target_aug), dim=0)
        else:
            pred_all, target_all = pred_nchw, target_nchw
        lp = lpips(pred_all, target_all).reshape(-1)
        loss = loss + lp.mean() * b
        # The first B pairs are the uncropped ones: the reference's
        # lpips monitor (run.py:2249-2252).
        lpips_monitor = lp[:b].mean().detach()
    else:
        with torch.no_grad():
            lpips_monitor = lpips(pred_nchw, target_nchw).mean()
    if cfg.loss_type in ('l1', 'mixed'):
        loss = loss + (pred - target).abs().mean() * b
    if cfg.loss_type == 'mse':
        loss = ((pred - target) ** 2).mean() * b
    if cfg.loss_type == 'mixed':
        loss = loss / 2.0

    # The reference monitor clamps both operands to [0, 1] and caps each
    # image at 60 dB (lib/metrics.py:30-44).
    with torch.no_grad():
        p01 = (pred / 2.0 + 0.5).clamp(0.0, 1.0)
        t01 = (target / 2.0 + 0.5).clamp(0.0, 1.0)
        mse = ((p01 - t01) ** 2).mean(dim=(1, 2, 3))
        psnr = (-10.0 * torch.log10(mse)).clamp_max(60.0)
    return loss, {'psnr': psnr, 'lpips': lpips_monitor, 'cam': cam.detach()}


def make_optimizer(params: InversionParams,
                   cfg: InversionConfig) -> torch.optim.Adam:
    """Adam as optax.adam(lr, b1=0.9, b2=0.95): eps 1e-8 outside the
    square root of the bias-corrected second moment, as both place it."""
    return torch.optim.Adam([t for _, t in params.named()], lr=cfg.lr,
                            betas=(0.9, 0.95), eps=1e-8)


def project(params: InversionParams) -> None:
    """In place: R renormalized, s -> |s|, z0 clamped to [-4, 4]."""
    with torch.no_grad():
        params.R.div_(torch.linalg.vector_norm(params.R, dim=-1,
                                               keepdim=True))
        params.s.abs_()
        if params.z0 is not None:
            params.z0.clamp_(-4.0, 4.0)


def make_inversion_step(gen: Generator, lpips: LPIPS, cfg: InversionConfig,
                        gt_cam2world: Optional[torch.Tensor] = None,
                        sampler: Sampler = triplane_cuda.sample_triplane,
                        warp: Warp = warp_lib.grid_sample_zeros):
    """Returns step(params, optimizer, target, generator=None, tform=None,
    render_rng=None) -> metrics.

    A step differentiates the loss to the parameters only (the generator's
    and LPIPS' weights are constants here), zeroes the pose gradients when
    `optimize_pose` is false, updates `params` in place through the Adam
    `optimizer` (from `make_optimizer`) and projects them. Its metrics are
    device scalars: loss, psnr, lpips, grad_norm_{z,R,s,t,f} (t is t2, f
    is z0) and, when `gt_cam2world` is given, rot_error (degrees, of the
    camera the step rendered from).
    """
    norm_names = {'z': 'z', 'R': 'R', 's': 's', 't2': 't', 'z0': 'f'}

    def step(params: InversionParams, optimizer: torch.optim.Adam,
             target: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             tform: Optional[augment.AffineTransform] = None,
             render_rng: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        loss, monitor = inversion_loss(gen, lpips, params, target, cfg,
                                       generator, tform, sampler, warp,
                                       render_rng)
        named = params.named()
        grads = torch.autograd.grad(loss, [t for _, t in named])
        metrics = {'loss': loss.detach(), 'psnr': monitor['psnr'].mean(),
                   'lpips': monitor['lpips']}
        for (name, t), g in zip(named, grads):
            if not cfg.optimize_pose and name != 'z':
                g = torch.zeros_like(g)
            t.grad = g
            metrics[f'grad_norm_{norm_names[name]}'] = torch.sqrt(
                torch.sum(g * g))
        optimizer.step()
        project(params)
        if gt_cam2world is not None:
            metrics['rot_error'] = pose_lib.rotation_matrix_distance(
                monitor['cam'], gt_cam2world).mean()
        return metrics

    return step


def run_inversion(gen: Generator, lpips: LPIPS,
                  init_params: InversionParams, target_img: torch.Tensor,
                  cfg: InversionConfig, n_steps: int,
                  generator: Optional[torch.Generator] = None,
                  gt_cam2world: Optional[torch.Tensor] = None,
                  tforms: Optional[Sequence[augment.AffineTransform]] = None,
                  render_noise: Optional[Sequence[Dict[str,
                                                       torch.Tensor]]] = None
                  ) -> Tuple[InversionParams, Dict[str, torch.Tensor]]:
    """`n_steps` refinement steps from `init_params` (left unchanged).

    The crops' transforms come from `tforms[i]` at step i when given, else
    from `generator` (None: a generator seeded 0 on the target's device).
    Step i renders with the draws `render_noise[i]` when given, else
    deterministically.
    Returns (the final parameters, detached; the metrics stacked per
    step, each (n_steps,)).
    """
    params = init_params.copy(requires_grad=True)
    optimizer = make_optimizer(params, cfg)
    step = make_inversion_step(gen, lpips, cfg, gt_cam2world)
    if generator is None and tforms is None:
        generator = torch.Generator(device=target_img.device).manual_seed(0)
    history = [step(params, optimizer, target_img, generator,
                    None if tforms is None else tforms[i],
                    None if render_noise is None else render_noise[i])
               for i in range(n_steps)]
    metrics = {k: torch.stack([m[k] for m in history]) for k in history[0]}
    return params.copy(requires_grad=False), metrics
