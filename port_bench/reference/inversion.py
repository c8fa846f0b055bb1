"""The inversion's refinement and checkpoint evaluation in plain PyTorch.

The same mathematics as the refinement steps and the checkpoint metrics
of the measured program (latent and pose Adam steps on VGG LPIPS over the
image and 15 affine crops; psnr, ssim, lpips and the mask IoU of the
front view, the render from the permuted cameras, the rotation error),
written on this folder's plain modules. Parameters are a dict of tensors
named z, R, s, t2 and z0 (perspective only), z stored divided by the
latent gain.

Every image's parameters take gradients from that image's terms alone,
so a batch is refined and evaluated in blocks of rows, each with its
rows' draws, and gives what the whole batch gives.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from port_bench.reference import augment
from port_bench.reference import image_metrics
from port_bench.reference import pose as pose_lib
from port_bench.reference.renderer import render

Params = Dict[str, torch.Tensor]
# A step's draws: the StyleGAN noise of each layer (None without noise)
# and the crops' transforms.
Draw = Tuple[Optional[List[torch.Tensor]], augment.AffineTransform]


@dataclasses.dataclass(frozen=True)
class Config:
    resolution: int
    depth_samples_per_ray: int
    scene_range: float
    white_background: bool
    camera_flipped: bool
    lr_gain_z: float
    num_augmentations: int = 15
    optimize_pose: bool = True
    lr: float = 2e-3


def camera(params: Params, cfg: Config):
    r = params['R'] / torch.linalg.vector_norm(params['R'], dim=-1,
                                               keepdim=True)
    return pose_lib.pose_to_matrix(params.get('z0'), params['t2'],
                                   params['s'], r, cfg.camera_flipped)


def render_params(gen, params: Params, cfg: Config, noise=None,
                  fused: bool = False, cam: Optional[torch.Tensor] = None,
                  focal: Optional[torch.Tensor] = None,
                  center: Optional[torch.Tensor] = None,
                  bbox: Optional[torch.Tensor] = None):
    """The render of the parameters' latent from their camera, or from
    `cam` and `focal`; returns (render, the parameters' camera)."""
    own, own_focal = camera(params, cfg)
    if cam is None:
        cam, focal = own, own_focal
    ws = params['z'] * cfg.lr_gain_z
    if ws.shape[1] == 1:
        ws = ws.expand(-1, gen.num_ws, -1)
    g = gen.fused_view() if fused else gen
    state = g.synthesize(ws, noise=noise)
    out = render(g.field(state), cfg.resolution, cfg.resolution, cam, focal,
                 cfg.scene_range, cfg.white_background,
                 cfg.depth_samples_per_ray, None, center, bbox)
    return out, own


def warp(images: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Images (B, C, H, W) into crops (B, N, C, H', W') at grids (B, N,
    H', W', 2): bilinear, zeros outside, align_corners=False."""
    b, n, oh, ow, _ = grid.shape
    rep = images.repeat_interleave(n, dim=0)
    out = augment._grid_sample_zeros(rep, grid.reshape(b * n, oh, ow, 2))
    return out.reshape(b, n, images.shape[1], oh, ow)


def loss(gen, lpips, params: Params, target: torch.Tensor, cfg: Config,
         draw: Draw) -> torch.Tensor:
    """The refinement loss: LPIPS of the render and its crops against the
    target's, the mean over images and crops times the batch."""
    noise, tform = draw
    out, _ = render_params(gen, params, cfg, noise)
    b, h, w = out.rgb.shape[:3]
    pred = out.rgb.permute(0, 3, 1, 2)
    tgt = target[..., :3].permute(0, 3, 1, 2)
    grid = augment.image_warp_grid(tform, h, w).reshape(
        b, cfg.num_augmentations, h, w, 2)

    def crops(images):
        if cfg.white_background:
            return (warp(images - 1.0, grid) + 1.0).reshape(b * cfg.num_augmentations, -1, h, w)
        return warp(images, grid).reshape(b * cfg.num_augmentations, -1, h, w)

    with torch.no_grad():
        tgt_all = torch.cat((tgt, crops(tgt)), dim=0)
    pred_all = torch.cat((pred, crops(pred)), dim=0)
    return lpips(pred_all, tgt_all).reshape(-1).mean() * b


def draws(gen, generator: torch.Generator, batch: int, n_steps: int,
          cfg: Config) -> List[Draw]:
    """Each step's draws from `generator`, in the order the refinement
    draws them: the noise of every layer (a generator with StyleGAN
    noise), then the crops' transforms."""
    out = []
    for _ in range(n_steps):
        noise = (gen.synthesis_network.noise_values(batch, generator,
                                                    generator.device)
                 if gen.use_stylegan_noise else None)
        tform = augment.sample_transform(
            generator, batch * cfg.num_augmentations, 1.0)
        out.append((noise, tform))
    return out


def draw_rows(draw: Draw, rows: slice, n_aug: int) -> Draw:
    noise, tform = draw
    crop_rows = slice(rows.start * n_aug, rows.stop * n_aug)
    return ((None if noise is None else [v[rows] for v in noise]),
            augment.AffineTransform(rot=tform.rot[crop_rows],
                                    scale=tform.scale[crop_rows],
                                    translation=tform.translation[crop_rows]))


def project(params: Params) -> None:
    with torch.no_grad():
        params['R'].div_(torch.linalg.vector_norm(params['R'], dim=-1,
                                                  keepdim=True))
        params['s'].abs_()
        if 'z0' in params:
            params['z0'].clamp_(-4.0, 4.0)


def refine(gen, lpips, init: Params, target: torch.Tensor, cfg: Config,
           step_draws: Sequence[Draw]
           ) -> Tuple[Params, torch.Tensor, Dict[str, torch.Tensor]]:
    """Adam(lr, b1 0.9, b2 0.95, eps 1e-8) steps from `init`, one a draw,
    each followed by the projection (R renormalized, s -> |s|, z0 in
    [-4, 4]). Returns the final parameters, each step's loss and each
    step's squared gradient norm of each parameter."""
    params = {k: v.detach().clone().requires_grad_() for k, v in init.items()}
    opt = torch.optim.Adam(list(params.values()), lr=cfg.lr,
                           betas=(0.9, 0.95), eps=1e-8)
    losses, grad_sq = [], {k: [] for k in params}
    for draw in step_draws:
        value = loss(gen, lpips, params, target, cfg, draw)
        grads = torch.autograd.grad(value, list(params.values()))
        for (name, t), g in zip(params.items(), grads):
            if not (cfg.optimize_pose or name == 'z'):
                g = torch.zeros_like(g)
            t.grad = g
            grad_sq[name].append(g.double().square().sum())
        opt.step()
        project(params)
        losses.append(value.detach())
    return ({k: v.detach() for k, v in params.items()}, torch.stack(losses),
            {k: torch.stack(v) for k, v in grad_sq.items()})


def refine_rows(gen, lpips, init: Params, target: torch.Tensor, cfg: Config,
                step_draws: Sequence[Draw], block: int
                ) -> Tuple[Params, torch.Tensor, Dict[str, torch.Tensor]]:
    """`refine` in blocks of `block` rows; the losses and the squared
    gradient norms are summed over the blocks, as the whole batch's sum
    over its images."""
    b = target.shape[0]
    parts, losses, grad_sq = [], 0.0, {}
    for start in range(0, b, block):
        rows = slice(start, min(start + block, b))
        p, l, g = refine(gen, lpips, {k: v[rows] for k, v in init.items()},
                         target[rows], cfg,
                         [draw_rows(d, rows, cfg.num_augmentations)
                          for d in step_draws])
        parts.append(p)
        losses = losses + l
        grad_sq = {k: grad_sq.get(k, 0.0) + v for k, v in g.items()}
    return ({k: torch.cat([p[k] for p in parts]) for k in init}, losses,
            grad_sq)


def _front(lpips, rgb, target, mask=None):
    pred = rgb.clamp(-1.0, 1.0).permute(0, 3, 1, 2)
    tgt = target.permute(0, 3, 1, 2)
    p01, t01 = pred[:, :3] / 2 + 0.5, tgt[:, :3] / 2 + 0.5
    out = {'psnr': image_metrics.psnr(p01, t01, reduction='none'),
           'ssim': image_metrics.ssim(p01, t01, reduction='none'),
           'lpips': lpips(pred[:, :3], tgt[:, :3]).flatten()}
    if mask is not None:
        out['iou'] = image_metrics.iou(mask, tgt[:, 3], reduction='none')
    return out


@torch.no_grad()
def evaluate(gen, lpips, params: Params, cfg: Config, target: torch.Tensor,
             has_mask: bool, gt_cam2world: Optional[torch.Tensor],
             perm_cameras, target_random: Optional[torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """A checkpoint's per-image metrics: the front view (fused decode,
    the 'const' noise) against `target`, the rotation error against
    `gt_cam2world` when given, and the render from `perm_cameras` (cam,
    focal, center, bbox) against `target_random` when given."""
    out, cam = render_params(gen, params, cfg, fused=True)
    with_iou = has_mask and target.shape[-1] > 3
    metrics = _front(lpips, out.rgb, target, out.mask if with_iou else None)
    if gt_cam2world is not None:
        metrics['rot_error'] = pose_lib.rotation_matrix_distance(
            cam, gt_cam2world)
    if target_random is not None:
        pc, pf, pcen, pbox = perm_cameras
        out_r, _ = render_params(gen, params, cfg, fused=True, cam=pc,
                                 focal=pf, center=pcen, bbox=pbox)
        for k, v in _front(lpips, out_r.rgb, target_random).items():
            metrics[k + '_random'] = v
    return metrics


def initial_params(w: torch.Tensor, num_ws: int, cam2world: torch.Tensor,
                   focal: Optional[torch.Tensor], cfg: Config) -> Params:
    """The refinement's start from the encoder's w and PnP's camera."""
    z0, t2, s, quat = pose_lib.matrix_to_pose(cam2world, focal,
                                              cfg.camera_flipped)
    params = {'z': w.float().expand(-1, num_ws, -1) / cfg.lr_gain_z,
              'R': quat, 's': s, 't2': t2}
    if z0 is not None:
        params['z0'] = z0
    return params
