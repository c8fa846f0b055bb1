"""Hybrid inversion of a batch: encoder bootstrap -> PnP -> refinement ->
report (PyTorch port of `nerf_from_image_tpu/invert/pipeline.py`).

Per batch of target images, the bootstrap encoder predicts canonical
coordinates, a mask and a latent w (`bootstrap_dispatch`, on the card);
the native PnP solver recovers each camera on the host
(`bootstrap_finish`, or its two halves: `bootstrap_to_host` queues the
copies of the coordinates and the mask behind the encoder and records an
event, `bootstrap_pnp` waits for that event alone and solves, so that
another thread can solve while the card runs later work);
`init_inversion_params` turns both into the refinement's parameters;
`evaluate_checkpoint` records the parameters and the front-view and
novel-view metrics at a checkpoint step (the first `valid` rows of a
padded batch only), with the Inception activations of both renders when
the context holds an `InceptionV3FID`; `consolidate_report` averages them
into the reference's report schema, turns the activations into FIDs
against the real images' statistics (`compute_real_fid_stats`) and logs
the means under `report/*` to a writer; `save_report` writes the
report's files, and `save_report_checkpoint`/`load_report_checkpoint`
keep a run's accumulated report for a resume.

The checkpoint renders take no gradient, so they run under
`torch.no_grad()` on `Generator.fused_view()` of the refinement
generator, which shares its parameters: on the card they sample and
decode through the fused kernel (B5a), while the refinement steps keep
the differentiable sampler (B1 forward, B2 backward). A view-direction
generator (carla) decodes its checkpoint renders unfused (B1), as the JAX
package's fused gate has it; a noise-enabled one renders them with its
'const' noise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.invert import optimizer as inv_opt
from nerf_from_image_tpu_torch.invert import pnp
from nerf_from_image_tpu_torch.metrics import fid as fid_lib
from nerf_from_image_tpu_torch.metrics import image as image_metrics
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.models.inception import InceptionV3FID
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.render.renderer import render
from nerf_from_image_tpu_torch.utils import io as io_lib

REPORT_SCALARS = ('psnr', 'psnr_random', 'lpips', 'lpips_random', 'ssim',
                  'ssim_random', 'iou', 'rot_error')

EncoderOutput = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def make_report(checkpoint_steps) -> Dict[int, Dict[str, list]]:
    return {
        step: {
            'ws': [], 'z0': [], 'R': [], 's': [], 't2': [],
            'psnr': [], 'psnr_random': [], 'lpips': [], 'lpips_random': [],
            'ssim': [], 'ssim_random': [], 'iou': [], 'rot_error': [],
            'inception_activations_front': [],
            'inception_activations_random': [],
        } for step in checkpoint_steps
    }


@torch.no_grad()
def bootstrap_dispatch(encoder: BootstrapEncoder,
                       target_img: torch.Tensor) -> EncoderOutput:
    """Device half of the bootstrap: the encoder forward on the RGB of
    `target_img` (B, H, W, 3+) in [-1, 1], queued without waiting.
    Returns (coords (B, H, W, 3), mask (B, H, W), w (B, 1, 512))."""
    return encoder(target_img[..., :3].permute(0, 3, 1, 2).contiguous())


HostCopy = Tuple[torch.Tensor, torch.Tensor, Optional[torch.cuda.Event]]


def bootstrap_to_host(enc_out: EncoderOutput) -> HostCopy:
    """Queues the host copies of the encoder's coordinates and mask on the
    current stream, directly behind the encoder: on the card into pinned
    buffers without waiting, with an event recorded after them; on the
    CPU the tensors themselves and no event. Returns (coords, mask,
    event)."""
    coords, mask, _ = enc_out
    if not coords.is_cuda:
        return coords, mask, None
    host = []
    for t in (coords, mask):
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        host.append(buf)
    event = torch.cuda.Event()
    event.record()
    return host[0], host[1], event


def bootstrap_pnp(host: HostCopy, focal_guesses: Optional[np.ndarray]):
    """Waits for `bootstrap_to_host`'s copies (its event alone, not for
    work queued after it), then runs PnP on the host; callable from any
    thread. Returns (coords, mask) as numpy and PnP's (cam2world,
    focal, errors)."""
    coords, mask, event = host
    if event is not None:
        event.synchronize()
    coords_np, mask_np = coords.numpy(), mask.numpy()
    return (coords_np, mask_np,
            *pnp.estimate_poses_batch(coords_np, mask_np, focal_guesses))


def initial_latent(enc_out: EncoderOutput, z_avg: torch.Tensor,
                   lr_gain_z: float) -> torch.Tensor:
    """z_init (B, num_ws, 512) on the encoder's device: the encoder's w
    over every slot of `z_avg`, divided by the gain."""
    return enc_out[2].float().expand(-1, z_avg.shape[1], -1) / lr_gain_z


def bootstrap_finish(enc_out: EncoderOutput, focal_guesses: Optional[
        np.ndarray], z_avg: torch.Tensor, lr_gain_z: float):
    """Host half: waits for the encoder's outputs, then runs PnP.

    Returns (coords, mask) as numpy arrays, z_init (`initial_latent`),
    and the PnP results (cam2world (B, 4, 4), focal (B,) or None, errors
    (B,)) as numpy.
    """
    coords_np, mask_np, cam2world, focal, errors = bootstrap_pnp(
        bootstrap_to_host(enc_out), focal_guesses)
    return (coords_np, mask_np, initial_latent(enc_out, z_avg, lr_gain_z),
            cam2world, focal, errors)


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
    whether the dataset has masks (then the IoU is recorded), and the FID
    network (None: no activations are recorded)."""
    gen: Generator
    lpips: LPIPS
    has_mask: bool
    inception: Optional[InceptionV3FID] = None


def _to01(rgb: torch.Tensor) -> torch.Tensor:
    """A render (B, H, W, C) in [-1, 1] -> clipped (B, 3, H, W) in [0, 1],
    as the Inception network takes it."""
    return rgb.clamp(-1.0, 1.0).permute(0, 3, 1, 2)[:, :3] / 2 + 0.5


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
                        target_img_random: Optional[torch.Tensor] = None,
                        compute_rot_error: bool = True,
                        valid: Optional[int] = None) -> None:
    """Appends the metrics of one checkpoint step to `report_entry`.

    The front view renders the parameters from their own camera (with
    the target's center and bbox, where given) and scores it against
    `target_img_fid` (B, H, W, 3 or 4; the fourth channel is the mask,
    for the IoU); the rotation error is against `gt_cam2world`. With
    `perm_cameras` = (cam2world, focal, center, bbox), the latent is also
    rendered from those cameras and scored against `target_img_random`.
    With `ctx.inception`, each render's Inception activations are
    recorded too. Every value is appended as a numpy array, of its first
    `valid` rows when given: a straggler batch is padded to the batch
    size, and the padding never enters the report.
    """
    def app(key, value):
        arr = value.detach().cpu().numpy()
        report_entry[key].append(arr if valid is None else arr[:valid])

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
    if ctx.inception is not None:
        app('inception_activations_front', ctx.inception(_to01(out.rgb)))
    if compute_rot_error and gt_cam2world is not None:
        app('rot_error', pose_lib.rotation_matrix_distance(cam, gt_cam2world))

    if perm_cameras is None:
        return
    perm_cam, perm_focal, perm_center, perm_bbox = perm_cameras
    ws = params.z * cfg.lr_gain_z
    if ws.shape[1] == 1:
        ws = ws.expand(-1, gen.num_ws, -1)
    state = gen.synthesize(ws)
    out_r = render(gen.field(state), cfg.resolution, cfg.resolution,
                   perm_cam, perm_focal, cfg.scene_range,
                   cfg.white_background,
                   cfg.depth_samples_per_ray * cfg.ray_multiplier,
                   center=perm_center, bbox=perm_bbox,
                   fine_sampling=cfg.fine_sampling)
    if target_img_random is not None:
        for k, v in _front_metrics(ctx, out_r.rgb, out_r.mask,
                                   target_img_random, False,
                                   '_random').items():
            app(k, v)
    if ctx.inception is not None:
        app('inception_activations_random', ctx.inception(_to01(out_r.rgb)))


def consolidate_report(report, train_fid_stats=None, test_fid_stats=None,
                       writer=None
                       ) -> Tuple[Dict[int, Dict[str, object]], str]:
    """Joins each entry's batches, adds `<metric>_avg` for the report's
    scalars, and, with `train_fid_stats` (mu, sigma), `fid_front` and
    `fid_random` from the recorded activations (and their `_test` forms
    against `test_fid_stats`); the activations are dropped either way.
    With `writer` (`utils.logging.SummaryWriter`), each mean and FID is
    also logged as `report/<name>` at the entry's step (reference
    run.py:2366, 2379-2386). Returns (report, report text)."""
    def log(name, value, step):
        if writer is not None:
            writer.add_scalar(f'report/{name}', value, step)

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
                log(elem, val, iter_num)
        for src_key, dst_key in (('inception_activations_front', 'fid_front'),
                                 ('inception_activations_random',
                                  'fid_random')):
            acts = entry.pop(src_key, None)
            if acts is None or train_fid_stats is None:
                continue
            stats = fid_lib.calculate_stats(acts)
            val = fid_lib.calculate_frechet_distance(*stats,
                                                     *train_fid_stats)
            entry[dst_key] = val
            line += f' {dst_key} {val:.02f}'
            log(dst_key, val, iter_num)
            if test_fid_stats is not None:
                val_t = fid_lib.calculate_frechet_distance(*stats,
                                                           *test_fid_stats)
                entry[dst_key + '_test'] = val_t
                line += f' {dst_key}_test {val_t:.02f}'
                log(dst_key + '_test', val_t, iter_num)
        lines.append(line + '\n')
    return report, ''.join(lines)


def save_report_checkpoint(path: str, report, idx: int, key) -> None:
    """A run's resume state: the accumulated (unconsolidated) report, the
    next batch index and `key` (the draws' state, any array, e.g. a
    `torch.Generator`'s `get_state()`), into one compressed .npz."""
    flat = {'__idx__': np.asarray(idx), '__key__': np.asarray(key)}
    for step, entry in report.items():
        for k, v in entry.items():
            for i, arr in enumerate(v):
                flat[f'{step}/{k}/{i}'] = np.asarray(arr)
    io_lib.save_npz(path, compressed=True, **flat)


def load_report_checkpoint(path: str, report):
    """Restores `save_report_checkpoint`'s report into `report` (made by
    `make_report` with the same steps), each list in append order.
    Returns (idx, key), or (0, None) when there is no file."""
    if not os.path.exists(path):
        return 0, None
    data = io_lib.load_npz(path)
    for step in report:
        for k in report[step]:
            names = sorted((n for n in data if n.startswith(f'{step}/{k}/')),
                           key=lambda n: int(n.rsplit('/', 1)[1]))
            report[step][k] = [data[n] for n in names]
    return int(data['__idx__']), data.get('__key__')


@torch.no_grad()
def compute_real_fid_stats(images: np.ndarray,
                           inception: Optional[InceptionV3FID],
                           batch_size: int = 8,
                           cache_path: Optional[str] = None):
    """(mu, sigma) of the Inception activations of real images (N, H, W,
    3+) in [-1, 1], in batches of `batch_size` (the last one padded with
    its last image, whose padding rows are dropped), or None without a
    network. With `cache_path`, read from there when the file exists and
    written there otherwise."""
    if inception is None:
        return None
    if cache_path is not None and os.path.exists(cache_path):
        data = io_lib.load_npz(cache_path)
        return data['mu'], data['sigma']
    device = next(inception.parameters()).device
    acts = []
    for i in range(0, len(images), batch_size):
        im = images[i:i + batch_size]
        pad = batch_size - len(im)
        if pad:
            im = np.concatenate([im, np.repeat(im[-1:], pad, 0)], 0)
        im01 = torch.as_tensor(
            np.ascontiguousarray(im[..., :3].transpose(0, 3, 1, 2)),
            dtype=torch.float32, device=device) / 2 + 0.5
        a = inception(im01).cpu().numpy()
        acts.append(a[:batch_size - pad] if pad else a)
    stats = fid_lib.calculate_stats(np.concatenate(acts, 0))
    if cache_path is not None:
        io_lib.save_npz(cache_path, mu=stats[0], sigma=stats[1])
    return stats


def save_report(report, report_str: str, out_dir: str,
                header: str = '') -> None:
    """The consolidated report as `out_dir/report.npz` (one array per
    '<step>/<key>') and `out_dir/report.txt` (the header, then the
    text)."""
    os.makedirs(out_dir, exist_ok=True)
    flat = {f'{step}/{k}': np.asarray(v)
            for step, entry in report.items() for k, v in entry.items()}
    io_lib.save_npz(os.path.join(out_dir, 'report.npz'), compressed=True,
                    **flat)
    with open(os.path.join(out_dir, 'report.txt'), 'w') as f:
        if header:
            f.write(header + '\n')
        f.write(report_str)
