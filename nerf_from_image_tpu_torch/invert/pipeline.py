"""Hybrid inversion of a batch: encoder bootstrap -> PnP -> refinement ->
report (PyTorch port of `nerf_from_image_tpu/invert/pipeline.py`, less
the FID statistics).

Per batch of target images, the bootstrap encoder predicts canonical
coordinates, a mask and a latent w (`bootstrap_dispatch`, on the card);
the native PnP solver recovers each camera on the host
(`bootstrap_finish`); `init_inversion_params` turns both into the
refinement's parameters; `evaluate_checkpoint` records the parameters
and the front-view and novel-view metrics at a checkpoint step; and
`consolidate_report` averages them into the reference's report schema.

The checkpoint renders take no gradient, so they run under
`torch.no_grad()` on `Generator.fused_view()` of the refinement
generator, which shares its parameters: on the card they sample and
decode through the fused kernel (B5a), while the refinement steps keep
the differentiable sampler (B1 forward, B2 backward).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.invert import optimizer as inv_opt
from nerf_from_image_tpu_torch.invert import pnp
from nerf_from_image_tpu_torch.metrics import image as image_metrics
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.render.renderer import render

REPORT_SCALARS = ('psnr', 'psnr_random', 'lpips', 'lpips_random', 'ssim',
                  'ssim_random', 'iou', 'rot_error')

EncoderOutput = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def make_report(checkpoint_steps) -> Dict[int, Dict[str, list]]:
    return {
        step: {
            'ws': [], 'z0': [], 'R': [], 's': [], 't2': [],
            'psnr': [], 'psnr_random': [], 'lpips': [], 'lpips_random': [],
            'ssim': [], 'ssim_random': [], 'iou': [], 'rot_error': [],
        } for step in checkpoint_steps
    }


@torch.no_grad()
def bootstrap_dispatch(encoder: BootstrapEncoder,
                       target_img: torch.Tensor) -> EncoderOutput:
    """Device half of the bootstrap: the encoder forward on the RGB of
    `target_img` (B, H, W, 3+) in [-1, 1], queued without waiting.
    Returns (coords (B, H, W, 3), mask (B, H, W), w (B, 1, 512))."""
    return encoder(target_img[..., :3].permute(0, 3, 1, 2).contiguous())


def bootstrap_finish(enc_out: EncoderOutput, focal_guesses: Optional[
        np.ndarray], z_avg: torch.Tensor, lr_gain_z: float):
    """Host half: waits for the encoder's outputs, then runs PnP.

    Returns (coords, mask) as numpy arrays, z_init (B, num_ws, 512) on
    the encoder's device (the encoder's w over every slot of `z_avg`,
    divided by the gain), and the PnP results (cam2world (B, 4, 4),
    focal (B,) or None, errors (B,)) as numpy.
    """
    coords, mask, w = enc_out
    coords_np = coords.cpu().numpy()
    mask_np = mask.cpu().numpy()
    cam2world, focal, errors = pnp.estimate_poses_batch(coords_np, mask_np,
                                                        focal_guesses)
    z_init = w.float().expand(-1, z_avg.shape[1], -1) / lr_gain_z
    return coords_np, mask_np, z_init, cam2world, focal, errors


def bootstrap_batch(encoder: BootstrapEncoder, target_img: torch.Tensor,
                    focal_guesses: Optional[np.ndarray],
                    z_avg: torch.Tensor, lr_gain_z: float):
    """Encoder forward, then PnP: `bootstrap_finish`'s results."""
    return bootstrap_finish(bootstrap_dispatch(encoder, target_img),
                            focal_guesses, z_avg, lr_gain_z)


def init_inversion_params(z_init: torch.Tensor, cam2world: np.ndarray,
                          focal: Optional[np.ndarray],
                          camera_flipped: bool) -> inv_opt.InversionParams:
    """The refinement's starting parameters from the bootstrap."""
    device = z_init.device
    cam = torch.as_tensor(cam2world, dtype=torch.float32, device=device)
    f = (None if focal is None else
         torch.as_tensor(focal, dtype=torch.float32, device=device))
    z0, t2, s, quat = pose_lib.matrix_to_pose(cam, f, camera_flipped)
    return inv_opt.InversionParams(z=z_init, R=quat, s=s, t2=t2, z0=z0)


@dataclasses.dataclass
class EvalContext:
    """What `evaluate_checkpoint` uses: the refinement's generator, LPIPS,
    and whether the dataset has masks (then the IoU is recorded)."""
    gen: Generator
    lpips: LPIPS
    has_mask: bool


def _front_metrics(ctx: EvalContext, rgb: torch.Tensor, mask: torch.Tensor,
                   target: torch.Tensor, with_iou: bool,
                   suffix: str = '') -> Dict[str, torch.Tensor]:
    """psnr, ssim and lpips of the clipped render against the target
    (both (B, H, W, C) in [-1, 1]), and the IoU of the masks."""
    pred = rgb.clamp(-1.0, 1.0).permute(0, 3, 1, 2)
    tgt = target.permute(0, 3, 1, 2)
    pred01 = pred[:, :3] / 2 + 0.5
    tgt01 = tgt[:, :3] / 2 + 0.5
    out = {
        'psnr' + suffix: image_metrics.psnr(pred01, tgt01, reduction='none'),
        'ssim' + suffix: image_metrics.ssim(pred01, tgt01, reduction='none'),
        'lpips' + suffix: ctx.lpips(pred[:, :3], tgt[:, :3]).flatten(),
    }
    if with_iou:
        out['iou'] = image_metrics.iou(mask, tgt[:, 3], reduction='none')
    return out


@torch.no_grad()
def evaluate_checkpoint(ctx: EvalContext, cfg: inv_opt.InversionConfig,
                        params: inv_opt.InversionParams, report_entry,
                        target_img_fid: torch.Tensor,
                        target_center_fid: Optional[torch.Tensor],
                        target_bbox_fid: Optional[torch.Tensor],
                        gt_cam2world: Optional[torch.Tensor],
                        perm_cameras=None,
                        target_img_random: Optional[torch.Tensor] = None
                        ) -> None:
    """Appends the metrics of one checkpoint step to `report_entry`.

    The front view renders the parameters from their own camera (with
    the target's center and bbox, where given) and scores it against
    `target_img_fid` (B, H, W, 3 or 4; the fourth channel is the mask,
    for the IoU); the rotation error is against `gt_cam2world`. With
    `perm_cameras` = (cam2world, focal, center, bbox), the latent is also
    rendered from those cameras and scored against `target_img_random`.
    Every value is appended as a numpy array.
    """
    def app(key, value):
        report_entry[key].append(value.detach().cpu().numpy())

    app('ws', params.z * cfg.lr_gain_z)
    if params.z0 is not None:
        app('z0', params.z0)
    app('R', params.R)
    app('s', params.s)
    app('t2', params.t2)

    gen = ctx.gen.fused_view()
    out, cam, _ = inv_opt.render_from_params(
        gen, params, cfg, center=target_center_fid, bbox=target_bbox_fid)
    with_iou = ctx.has_mask and target_img_fid.shape[-1] > 3
    for k, v in _front_metrics(ctx, out.rgb, out.mask, target_img_fid,
                               with_iou).items():
        app(k, v)
    if gt_cam2world is not None:
        app('rot_error', pose_lib.rotation_matrix_distance(cam, gt_cam2world))

    if perm_cameras is None:
        return
    perm_cam, perm_focal, perm_center, perm_bbox = perm_cameras
    ws = params.z * cfg.lr_gain_z
    if ws.shape[1] == 1:
        ws = ws.expand(-1, gen.num_ws, -1)
    state = gen.synthesize(ws)
    out_r = render(lambda pts, reqs: gen.sample(state, pts, reqs),
                   cfg.resolution, cfg.resolution, perm_cam, perm_focal,
                   cfg.scene_range, cfg.white_background,
                   cfg.depth_samples_per_ray, center=perm_center,
                   bbox=perm_bbox)
    if target_img_random is not None:
        for k, v in _front_metrics(ctx, out_r.rgb, out_r.mask,
                                   target_img_random, False,
                                   '_random').items():
            app(k, v)


def consolidate_report(report) -> Tuple[Dict[int, Dict[str, object]], str]:
    """Joins each entry's batches and adds `<metric>_avg` for the report's
    scalars. Returns (report, report text); FID is not computed."""
    lines: List[str] = []
    for iter_num, entry in report.items():
        for k in list(entry.keys()):
            if isinstance(entry[k], list):
                if len(entry[k]) == 0:
                    del entry[k]
                else:
                    entry[k] = np.concatenate(entry[k], axis=0)
        line = f'[{iter_num} iterations]'
        for elem in REPORT_SCALARS:
            if elem in entry:
                val = float(np.mean(entry[elem]))
                line += f' {elem} {val:.05f}'
                entry[f'{elem}_avg'] = val
        lines.append(line + '\n')
    return report, ''.join(lines)
