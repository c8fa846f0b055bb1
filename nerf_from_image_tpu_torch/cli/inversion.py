"""Inversion CLI: the --run_inversion workload end to end (PyTorch port of
`nerf_from_image_tpu/cli/inversion.py`).

Mirrors the reference's run.py:1743-2404 in the JAX CLI's order: the
config string and report directory, the encoder (loaded, or distilled by
`cli/train_encoder.py`), the focal guesses, the evaluation indices and
view permutations, `z_avg` from 10,000 samples, the real images' FID
statistics, then the batched loop (bootstrap -> PnP -> refinement steps
-> checkpoint metrics) with the report checkpoint saved every 512 images
and resumed from, and the consolidated report with its files.

PnP overlaps the card's work as the JAX CLI's asynchronous dispatch lets
it: each batch, directly after its own parameters are set, the next
batch's encoder forward is queued with the host copies of its outputs
and an event behind them, and a one-worker thread waits for that event
and runs the next batch's PnP (a ctypes call, which releases the GIL)
while this thread queues this batch's evaluations and refinement steps.
The next batch takes the worker's result. The first batch has no
prefetch, so its PnP runs here. The PnP inputs are the same tensors
either way, so its results are those of the serial path, bit for bit.
On the CPU the same loop runs, with plain copies and no event.

Each batch's times are printed and returned: wall time, encoder,
evaluations and steps (CUDA events on the card), PnP's time on the thread
that ran it (its wait for the copies apart) and this thread's wait for
its result.

The demo (--inv_export_demo_sample, and --inv_manual_input_path, which
inverts a user's image at batch 1): the evaluation indices are shuffled
with RandomState(1) (not for a manual image), no real statistics are
computed and no report checkpoint is read, the first batch is inverted
without a prefetch, its strip [input | coords | recon | normals | novel
view at 50 degrees about y] is written to `outputs/{demo_manual|sample}_
<dataset>_<steps>it.png` (`export_demo`) and the run stops there, with no
report.
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from nerf_from_image_tpu_torch import config as config_lib
from nerf_from_image_tpu_torch.data import image_io
from nerf_from_image_tpu_torch.invert import optimizer as inv_opt
from nerf_from_image_tpu_torch.invert import pipeline as pipe
from nerf_from_image_tpu_torch.invert import pnp
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.train.eval import compute_view_perm
from nerf_from_image_tpu_torch.utils import checkpoint as ckpt_lib
from nerf_from_image_tpu_torch.utils import weights as weights_lib
from nerf_from_image_tpu_torch.utils.logging import SummaryWriter

N_IMAGES_FID_MAX = 8000
REPORT_CHECKPOINT_EVERY = 512


def build_eval_indices(split, n_images_fid_max, views_per_object,
                       rng: np.random.RandomState):
    n = len(split.images)
    if n > n_images_fid_max:
        idx = np.sort(rng.permutation(n)[:n_images_fid_max])
    else:
        idx = np.arange(n)
    split.eval_indices = idx
    split.eval_indices_perm = compute_view_perm(idx, views_per_object, rng)


def select_inversion_targets(dataset_name, dataset_config, use_testset,
                             export_demo, train_split, train_eval_split,
                             split, sel, sel_perm):
    """Per-batch target selection (run.py:1874-1958). Two protocols:

    - testset: optimize AND evaluate on cropped test images (eval
      center/bbox None: the pose regressor is always in use,
      run.py:1746, 1906-1910); novel-view cameras come from the test
      split (p3d: train_eval, whose pose distribution stands in for the
      unavailable test poses, run.py:1895-1905).
    - train split: optimize on UNCROPPED train_split images (demo mode:
      cropped train_eval, run.py:1921-1926); evaluate the render with
      train_eval's bbox/center against the cropped train_eval image
      (ortho/CUB: uncropped train image, run.py:1928-1934); novel-view
      cameras and random-view targets come from train_eval.
    """
    vpo = dataset_config['views_per_object']
    if use_testset:
        target_img = split.images[sel]
        target_img_fid = target_img
        gt_cam2world = split.tform_cam2world[sel]
        target_center_fid = target_bbox_fid = None
        perm_split = (train_eval_split if 'p3d' in dataset_name else split)
        vpo_eff = dataset_config['views_per_object_test']
        target_img_random = (split.images[sel_perm] if vpo_eff > 1
                             else None)
    else:
        opt_split = train_eval_split if export_demo else train_split
        target_img = opt_split.images[sel]
        if dataset_config['camera_projection_model'] == 'ortho':
            target_img_fid = train_split.images[sel]  # uncropped
        else:
            target_img_fid = train_eval_split.images[sel]  # cropped
        gt_cam2world = train_split.tform_cam2world[sel]
        if export_demo:
            target_center_fid = target_bbox_fid = None
        else:
            target_center_fid = (None if train_eval_split.center is None
                                 else train_eval_split.center[sel])
            target_bbox_fid = (None if train_eval_split.bbox is None
                               else train_eval_split.bbox[sel])
        perm_split = train_eval_split
        vpo_eff = vpo
        target_img_random = (train_eval_split.images[sel_perm]
                             if vpo_eff > 1 else None)
    perm_cam = perm_split.tform_cam2world[sel_perm]
    perm_focal = (None if perm_split.focal_length is None
                  else perm_split.focal_length[sel_perm])
    perm_center = (None if perm_split.center is None
                   else perm_split.center[sel_perm])
    perm_bbox = (None if perm_split.bbox is None
                 else perm_split.bbox[sel_perm])
    return {
        'target_img': target_img,
        'target_img_fid': target_img_fid,
        'gt_cam2world': gt_cam2world,
        'target_center_fid': target_center_fid,
        'target_bbox_fid': target_bbox_fid,
        'target_img_random': target_img_random,
        'perm_cameras': (perm_cam, perm_focal, perm_center, perm_bbox),
    }


def run_name(args, experiment_name: str) -> str:
    """The run's directory name under reports/ and coords_checkpoints/:
    --resume_from, or the experiment name. A literal .pth path gives its
    file name (the JAX CLI joins the path itself, which fails for an
    absolute one)."""
    if not args.resume_from:
        return experiment_name
    if args.resume_from.endswith('.pth'):
        return os.path.basename(args.resume_from)
    return args.resume_from


def config_string(args) -> str:
    """The inversion's configuration string (run.py:1760-1777)."""
    if args.dataset == 'p3d_car' and args.inv_use_testset:
        split_str = ('imagenettest' if args.inv_use_imagenet_testset
                     else 'test')
    else:
        split_str = 'test' if args.inv_use_testset else 'train'
    mode_str = '_separate' if args.inv_use_separate else '_joint'
    mode_str += '_nooptpose' if args.inv_no_optimize_pose else '_optpose'
    w_split_str = 'nosplit' if args.inv_no_split else 'split'
    cfg_xid = f'_{args.xid}' if args.xid else ''
    return (f'i{cfg_xid}_{split_str}{mode_str}_{args.inv_loss}'
            f'_gain{args.inv_gain_z}_{w_split_str}')


def load_encoder(args, coords_dir: str, device: torch.device
                 ) -> Optional[BootstrapEncoder]:
    """The bootstrap encoder from --coord_resume_from: a literal .pth (the
    reference's encoder file) or a label of `coords_dir`'s encoder
    checkpoints (enc_latest, enc_<i>). None when neither is given or the
    label has no checkpoint (then the encoder is distilled)."""
    label = args.coord_resume_from
    if not label:
        return None
    if label.endswith('.npz'):
        raise ValueError(f'--coord_resume_from {label}: the port reads the '
                         'reference encoder .pth itself, not the JAX '
                         "package's converted .npz")
    if label.endswith('.pth'):
        ckpt = ckpt_lib.load(label)
    else:
        manager = ckpt_lib.CheckpointManager(coords_dir)
        if not manager.exists(label):
            return None
        ckpt = manager.load(label)
    encoder = BootstrapEncoder(args.latent_dim,
                               separate_backbones=args.inv_use_separate,
                               device=device)
    encoder.load_state_dict(ckpt_lib.encoder_state_dict(ckpt))
    return encoder


class _Timer:
    """Elapsed ms of a span of queued work: CUDA events on the card (read
    once the work is done), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == 'cuda'
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        if self.cuda:
            self._start.record()
        else:
            self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self._end.record()
        else:
            self._ms = (time.perf_counter() - self._t) * 1e3

    def ms(self) -> float:
        if self.cuda:
            self._end.synchronize()
            return self._start.elapsed_time(self._end)
        return self._ms


def _timed_pnp(host, focal_guesses):
    """`pipe.bootstrap_pnp` on `bootstrap_to_host`'s copies, with the
    seconds its thread waited for the copies and the seconds it solved."""
    t = time.perf_counter()
    if host[2] is not None:
        host[2].synchronize()
    t_copy = time.perf_counter()
    out = pipe.bootstrap_pnp(host, focal_guesses)
    return out, t_copy - t, time.perf_counter() - t_copy


def run_inversion_cli(args, gan_cfg, dataset_config, gen, train_split,
                      train_eval_split, test_split, report_dir: str,
                      experiment_name: str, device: torch.device
                      ) -> Optional[Dict[str, object]]:
    """Inverts the evaluation images and writes the report.

    `gen` is the generator with the EMA weights, on `device`. Returns
    {'report_dir', 'report', 'report_text', 'batches' (each batch's
    times, see the module's docstring), 'real_stats_s', 'consolidate_s'},
    for the demo {'report_dir', 'batches', 'demo_path', 'demo_s'}, or
    None after --inv_train_coord_only.
    """
    use_testset = args.inv_use_testset
    lr_gain_z = args.inv_gain_z
    demo = bool(args.inv_export_demo_sample)
    if args.inv_manual_input_path:
        batch_size = 1
    else:
        # The reference's batch_size // 4 per GPU (run.py:1757), on one
        # card.
        batch_size = max(args.batch_size // 4, 1)

    cfg_string = config_string(args)
    print('Config string:', cfg_string)
    name = run_name(args, experiment_name)
    report_dir_eff = os.path.join(report_dir, name, cfg_string)
    writer = SummaryWriter(report_dir_eff)

    # Encoder: load or train (run.py:1785-1808).
    coords_dir = os.path.join(args.root_path, 'coords_checkpoints', name)
    encoder = load_encoder(args, coords_dir, device)
    if encoder is None:
        from nerf_from_image_tpu_torch.cli.train_encoder import \
            train_coord_regressor
        encoder = train_coord_regressor(
            args, gan_cfg, gen, train_split,
            ckpt_lib.CheckpointManager(coords_dir), writer, device)
        if args.inv_train_coord_only:
            print('Exit after encoder training.')
            writer.close()
            return None
    encoder.eval()

    pnp.load_library()
    focal_guesses = pnp.get_focal_guesses(train_split.focal_length)

    # Eval indices (run.py:413-499).
    rng = np.random.RandomState(1234)
    build_eval_indices(train_eval_split, N_IMAGES_FID_MAX,
                       dataset_config['views_per_object'], rng)
    if use_testset and test_split is not None:
        build_eval_indices(test_split, N_IMAGES_FID_MAX,
                           dataset_config['views_per_object_test'], rng)
    split = test_split if use_testset else train_eval_split
    image_indices = split.eval_indices
    image_indices_perm = split.eval_indices_perm
    if demo and not args.inv_manual_input_path:
        shuffle = np.random.RandomState(1).permutation(len(image_indices))
        image_indices = image_indices[shuffle]
        image_indices_perm = image_indices_perm[shuffle]
    n_images = len(image_indices)

    if args.inv_encoder_only:
        checkpoint_steps = [0]
    elif args.inv_steps:
        checkpoint_steps = [0, args.inv_steps]
    elif lr_gain_z >= 10:
        checkpoint_steps = [0, 10]
    else:
        checkpoint_steps = [0, 30]
    niter = max(checkpoint_steps)

    inv_cfg = inv_opt.InversionConfig(
        resolution=args.resolution,
        depth_samples_per_ray=config_lib.depth_samples(args),
        fine_sampling=args.fine_sampling,
        scene_range=dataset_config['scene_range'],
        white_background=dataset_config['white_background'],
        camera_flipped=dataset_config['camera_flipped'],
        lr_gain_z=float(lr_gain_z), loss_type=args.inv_loss,
        optimize_pose=not args.inv_no_optimize_pose)

    lpips = weights_lib.load_lpips(args.root_path, device)
    inception = weights_lib.load_inception(args.root_path, device)

    with torch.no_grad():
        z_avg = gen.average_w(
            torch.Generator(device=device).manual_seed(1234), 10000)

    ctx = pipe.EvalContext(gen=gen, lpips=lpips,
                           has_mask=dataset_config['has_mask'],
                           inception=inception)

    # Real-data Inception stats for fid_front/fid_random (run.py:385-413).
    t0 = time.perf_counter()
    cache_dir = os.path.join(args.root_path, 'fid_stats')
    if not demo:
        train_eval_split.fid_stats = pipe.compute_real_fid_stats(
            train_eval_split.images, inception, batch_size,
            os.path.join(cache_dir, f'fid_stats_{args.dataset}_train.npz'))
    if use_testset and test_split is not None and not demo:
        test_split.fid_stats = pipe.compute_real_fid_stats(
            test_split.images, inception, batch_size,
            os.path.join(cache_dir, f'fid_stats_{args.dataset}_test.npz'))
    real_stats_s = time.perf_counter() - t0

    report = pipe.make_report(checkpoint_steps)
    # The crops' draws; its state is the report checkpoint's key.
    crops_rng = torch.Generator(device=device).manual_seed(4321)
    report_ckpt_path = os.path.join(report_dir_eff, 'report_checkpoint.npz')
    idx, saved_key = 0, None
    if not demo:
        idx, saved_key = pipe.load_report_checkpoint(report_ckpt_path,
                                                     report)
    if saved_key is not None:
        crops_rng.set_state(torch.from_numpy(np.asarray(saved_key)))
    if idx:
        print(f'Resumed inversion report at image {idx}')

    def tensor(a):
        return (None if a is None else torch.as_tensor(
            np.ascontiguousarray(a), dtype=torch.float32, device=device))

    def targets_at(at):
        sel = image_indices[at:at + batch_size]
        sel_perm = image_indices_perm[at:at + batch_size]
        valid = len(sel)
        if valid < batch_size:
            # Straggler: pad to the batch, keep the first `valid` rows.
            pad = batch_size - valid
            sel = np.concatenate([sel, sel[-1:].repeat(pad)])
            sel_perm = np.concatenate([sel_perm, sel_perm[-1:].repeat(pad)])
        tsel = select_inversion_targets(
            args.dataset, dataset_config, use_testset, demo, train_split,
            train_eval_split, split, sel, sel_perm)
        out = {k: tensor(v) for k, v in tsel.items() if k != 'perm_cameras'}
        out['perm_cameras'] = tuple(tensor(a) for a in tsel['perm_cameras'])
        return out, valid

    compute_rot_error = not (args.dataset == 'p3d_car' and use_testset)
    batches: List[Dict[str, object]] = []
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    pending = None  # the next batch's (encoder output, PnP future, timer)
    try:
        while idx < n_images:
            t1 = time.perf_counter()
            tsel, valid = targets_at(idx)
            target_img = tsel['target_img']
            timers = {}

            if pending is None:
                with _Timer(device) as timers['encoder']:
                    enc_out = pipe.bootstrap_dispatch(encoder, target_img)
                pnp_out, copy_s, pnp_s = _timed_pnp(
                    pipe.bootstrap_to_host(enc_out), focal_guesses)
                wait_s, serial = None, True
            else:
                (enc_out, future, timers['encoder']), pending = pending, None
                tw = time.perf_counter()
                pnp_out, copy_s, pnp_s = future.result()
                wait_s, serial = time.perf_counter() - tw, False
            coords_np, mask_np, cam2world, focal, errors = pnp_out
            params = pipe.init_inversion_params(
                pipe.initial_latent(enc_out, z_avg, float(lr_gain_z)),
                cam2world, focal, dataset_config['camera_flipped'])

            # The next batch's encoder forward and host copies go on the
            # stream before this batch's work; its PnP starts on the
            # worker as soon as they are done.
            if idx + valid < n_images and not demo:
                ntsel, _ = targets_at(idx + valid)
                with _Timer(device) as timer:
                    next_out = pipe.bootstrap_dispatch(encoder,
                                                       ntsel['target_img'])
                host = pipe.bootstrap_to_host(next_out)
                pending = (next_out, pool.submit(_timed_pnp, host,
                                                 focal_guesses), timer)

            def evaluate(step, p):
                with _Timer(device) as timers[f'evaluation {step}']:
                    pipe.evaluate_checkpoint(
                        ctx, inv_cfg, p, report[step], tsel['target_img_fid'],
                        tsel['target_center_fid'], tsel['target_bbox_fid'],
                        tsel['gt_cam2world'],
                        perm_cameras=tsel['perm_cameras'],
                        target_img_random=tsel['target_img_random'],
                        compute_rot_error=compute_rot_error, valid=valid)

            if 0 in report:
                evaluate(0, params)
            if niter > 0:
                with _Timer(device) as timers['steps']:
                    params, step_metrics = inv_opt.run_inversion(
                        gen, lpips, params, target_img[..., :3], inv_cfg,
                        niter, generator=crops_rng,
                        gt_cam2world=tsel['gt_cam2world'])
                if idx == 0:
                    # First-batch per-step telemetry, the reference's tags
                    # (run.py:2288-2306) and per-parameter grad norms.
                    _log_first_batch(writer, step_metrics, niter)
                evaluate(niter, params)

            idx += valid
            stats = {'images': valid, 'serial': serial,
                     'pnp_copy_wait_s': copy_s, 'pnp_s': pnp_s,
                     'pnp_wait_s': wait_s,
                     'pnp_fallbacks': int(np.sum(errors == pnp.DUMMY_ERROR)),
                     **{f'{k}_ms': t.ms() for k, t in timers.items()}}
            stats['wall_s'] = time.perf_counter() - t1
            batches.append(stats)
            wait = ('serial' if serial else
                    f'waited {stats["pnp_wait_s"]:.3f} s')
            print(f'[{idx}/{n_images}] batch in {stats["wall_s"]:.2f} s '
                  f'({stats["wall_s"] / valid:.2f} s/img; PnP '
                  f'{pnp_s:.2f} s, {wait})', flush=True)

            if demo:
                t0 = time.perf_counter()
                demo_path = export_demo(
                    args, gen, inv_cfg, params, target_img, coords_np,
                    mask_np, dataset_config, niter)
                writer.close()
                return {'report_dir': report_dir_eff, 'batches': batches,
                        'demo_path': demo_path,
                        'demo_s': time.perf_counter() - t0}

            if idx % REPORT_CHECKPOINT_EVERY == 0:
                pipe.save_report_checkpoint(report_ckpt_path, report, idx,
                                            crops_rng.get_state())
    finally:
        pool.shutdown(wait=True)

    t0 = time.perf_counter()
    report, report_str = pipe.consolidate_report(
        report, train_eval_split.fid_stats,
        test_split.fid_stats if use_testset and test_split is not None
        else None, writer=writer)
    consolidate_s = time.perf_counter() - t0
    print(report_str)
    pipe.save_report(report, report_str, report_dir_eff,
                     header=f'{args.resume_from}\n{cfg_string}')
    writer.close()
    return {'report_dir': report_dir_eff, 'report': report,
            'report_text': report_str, 'batches': batches,
            'real_stats_s': real_stats_s, 'consolidate_s': consolidate_s}


def _log_first_batch(writer: SummaryWriter,
                     metrics: Dict[str, torch.Tensor], niter: int) -> None:
    sm = {k: v.float().cpu().numpy() for k, v in metrics.items()}
    for it in range(niter):
        for key in ('psnr', 'lpips', 'rot_error'):
            if key in sm:
                writer.add_scalar(f'monitor_b0/{key}', sm[key][it], it)
        for pname in ('z', 'f', 'R', 's', 't'):
            gkey = f'grad_norm_{pname}'
            if gkey in sm:
                writer.add_scalar(f'monitor_b0/{gkey}', sm[gkey][it], it)


NOVEL_VIEW_DEGREES = 50.0


@torch.no_grad()
def export_demo(args, gen, inv_cfg, params, target_img: torch.Tensor,
                coords: np.ndarray, mask: np.ndarray, dataset_config: dict,
                it: int) -> str:
    """Writes the demo strip [input | coords | recon | normals | novel
    view] (reference run.py:2058-2159), one row of panels an image, to
    `outputs/{demo_manual|sample}_<dataset>_<it>it.png` under the working
    directory, and returns its path. The renders take the generator's
    'const' noise; the normals come with the reconstruction's render
    (B1 and B2 on the card), the novel view is the recovered camera
    turned 50 degrees about the world's y axis (B1)."""
    out, cam, _ = inv_opt.render_from_params(
        gen, params, inv_cfg, compute_normals=args.use_sdf)
    strips = [target_img[..., :3].float().cpu().numpy()]
    if coords is not None:
        m = mask[..., None]
        coords_img = np.clip(coords * m / dataset_config['scene_range'],
                             -1, 1)
        if dataset_config['white_background']:
            coords_img = coords_img + (1 - m)
        strips.append(coords_img)
    strips.append(out.rgb.clamp(-1, 1).float().cpu().numpy())
    if out.normals is not None:
        strips.append(out.normals.clamp(-1, 1).float().cpu().numpy())

    angle = np.deg2rad(NOVEL_VIEW_DEGREES)
    rot = torch.tensor([[np.cos(angle), 0, np.sin(angle), 0],
                        [0, 1, 0, 0],
                        [-np.sin(angle), 0, np.cos(angle), 0],
                        [0, 0, 0, 1]], dtype=torch.float32,
                       device=cam.device)
    out_novel, _, _ = inv_opt.render_from_params(
        gen, params, inv_cfg, override_cam=rot[None] @ cam)
    strips.append(out_novel.rgb.clamp(-1, 1).float().cpu().numpy())
    strip = np.concatenate(strips, axis=2) / 2 + 0.5

    os.makedirs('outputs', exist_ok=True)
    name = 'demo_manual' if args.inv_manual_input_path else 'sample'
    out_path = os.path.join('outputs', f'{name}_{args.dataset}_{it}it.png')
    img8 = (np.clip(strip.reshape(-1, strip.shape[2], 3), 0, 1) *
            255).astype(np.uint8)
    image_io.write_png(out_path, img8)
    print('Saved demo output to', out_path)
    return out_path
