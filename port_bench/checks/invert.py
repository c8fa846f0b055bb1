"""Whether an inverted batch is right: the program's results against the
plain reference (`port_bench/reference/`), at the timed sizes.

The reference takes the run's inputs (the seeded weights, the batch's
targets and PnP's input, the state of the crops' generator before the
batch) and works out again what the program derived from them. PnP's
pose is the one stage it cannot redo (a host solver), so from the
refinement's start on it follows the program's own state; the stages
before are checked by themselves. The numbers, each a relative gap (0:
the same):

- bootstrap_gap: the encoder's coordinates, mask and latent on the
  batch's targets, and the refinement's start (the latent over the gain,
  the pose from PnP's camera): the largest |program - reference| over the
  largest |reference| of each.
- loss0_gap: the first step's loss (render, crops, LPIPS) at that start,
  over max(|reference|, 1e-3).
- grad0_gap: the first step's gradient norm of each parameter (the
  latent, the rotation, the scale, the offset, the focal), the largest
  |program - reference| over the reference's or the median parameter's,
  whichever is larger (a parameter whose gradient is all but nought
  reads its round-off alone).
- eval_gap: the checkpoint metrics (psnr, ssim, lpips, IoU, rotation
  error) of the program's parameters at both checkpoints, against the
  reference's of the same parameters: |program - reference| /
  max(|reference|, 0.05), the largest.
- final_gap: the last checkpoint's image metrics (psnr, ssim, lpips,
  IoU) against the reference's after its own steps from the same start
  with the same draws: each image's worst gap as in eval_gap, the median
  image's. The steps' parameters part by round-off grown over 30 steps
  (Adam's first steps move each element by the sign of its gradient),
  so the parameters themselves are not compared, nor the rotation error,
  which follows the pose they reach. Most images' metrics do not part,
  but about one image in forty reaches another minimum: the same seed's
  batch read a worst image of 0.017 and of 1.13 in two runs of one code,
  the reference's own IoU for that image 0.054 and 0.001 from the same
  start and draws. The worst image therefore swings with the
  reference's round-off, and the median image is held. A fault in one
  slot's inputs to the steps (its target, crops or start) shows at the
  first step, in loss0_gap and bootstrap_gap; one confined to a slot's
  later steps or final parameters is not seen here.

The reference runs once the window has closed, in blocks of rows. The
same comparison holds the control (`port_bench/control.py`): the
reference in bf16 in the program's place.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from port_bench import weights as weights_lib
from port_bench.checks import REFERENCE_ROWS
from port_bench.common import reference_generator
from port_bench.reference import encoder as ref_encoder
from port_bench.reference import inversion as ref_inv
from port_bench.reference import lpips as ref_lpips
from port_bench.reference import triplane as ref_triplane

# The parameters' names, the latent compared as w = z * gain.
PARAMS = ('ws', 'R', 's', 't2', 'z0')
METRICS = ('psnr', 'ssim', 'lpips', 'iou', 'rot_error')
EVAL_FLOOR = 0.05
LOSS_FLOOR = 1e-3
# The refinement's metric of each parameter's gradient norm.
GRAD_METRICS = {'z': 'z', 'R': 'R', 's': 's', 't2': 't', 'z0': 'f'}


class Reference:
    """The plain models with the run's weights, and the configuration."""

    def __init__(self, s, spec: dict, device, dtype=None):
        self.gen = reference_generator(s.cfg, device)
        if device.type == 'cpu':
            self.gen.plane_sampler = ref_triplane.plain_sampler
        self.encoder = ref_encoder.BootstrapEncoder(
            s.args.latent_dim, separate_backbones=s.args.inv_use_separate,
            device=device, **spec['config'].get('encoder', {}))
        self.lpips = ref_lpips.LPIPS(device)
        for module, name in ((self.gen, 'generator'),
                             (self.encoder, 'encoder'),
                             (self.lpips, 'lpips')):
            weights_lib.load(module, s.state_dict(name, device))
        self.encoder.eval()
        c = s.inv_cfg
        self.cfg = ref_inv.Config(
            resolution=c.resolution,
            depth_samples_per_ray=c.depth_samples_per_ray * c.ray_multiplier,
            scene_range=c.scene_range, white_background=c.white_background,
            camera_flipped=c.camera_flipped, lr_gain_z=c.lr_gain_z,
            num_augmentations=c.num_augmentations,
            optimize_pose=c.optimize_pose, lr=c.lr)
        self.has_mask = s.dataset_config['has_mask']
        self.device = device
        # The control's precision: None (float32), or an autocast type.
        self.dtype = dtype

    def precision(self):
        if self.dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.dtype)


def rel_max(a: torch.Tensor, ref: torch.Tensor) -> float:
    a, ref = a.double(), ref.double()
    return float((a - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def draws_for(ref: Reference, crops_state: torch.Tensor, batch: int,
              niter: int):
    """The batch's draws, from the crops' generator restored to the state
    it had before the batch."""
    g = torch.Generator(device=ref.device)
    g.set_state(crops_state)
    return ref_inv.draws(ref.gen, g, batch, niter, ref.cfg)


def as_params(named: Dict[str, torch.Tensor], gain: float) -> Dict:
    """A parameter dict with the latent as w (z * gain)."""
    out = {k: v for k, v in named.items() if k != 'z' and v is not None}
    out['ws'] = named['z'] * gain
    return out


def report_params(report_entry: Dict[str, list], device) -> Dict:
    """The parameters a checkpoint recorded (one batch's report)."""
    return {k: torch.as_tensor(report_entry[k][0], device=device)
            for k in PARAMS if report_entry.get(k)}


def report_metrics(report_entry: Dict[str, list]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(report_entry[k][0], dtype=np.float64)
            for k in METRICS if report_entry.get(k)}


def to_reference_params(p: Dict[str, torch.Tensor], gain: float) -> Dict:
    """{ws, R, s, t2, z0} -> the reference's {z, R, s, t2, z0}."""
    out = {k: v.float() for k, v in p.items() if k != 'ws'}
    out['z'] = p['ws'].float() / gain
    return out


def image_gaps(cand: Dict[str, np.ndarray], ref: Dict[str, torch.Tensor]
               ) -> np.ndarray:
    """Each image's worst |candidate - reference| / max(|reference|,
    0.05) over the metrics."""
    gaps = [np.abs(v - ref[k].double().cpu().numpy()) /
            np.maximum(np.abs(ref[k].double().cpu().numpy()), EVAL_FLOOR)
            for k, v in cand.items()]
    return np.max(np.stack(gaps), axis=0)


@torch.no_grad()
def evaluate_rows(ref: Reference, params: Dict, targets: Dict,
                  rot_error: bool, block: int) -> Dict[str, torch.Tensor]:
    """The reference's checkpoint metrics of `params` ({ws, ...}) in
    blocks of rows."""
    b = targets['target_img'].shape[0]
    parts = []
    for start in range(0, b, block):
        rows = slice(start, min(start + block, b))
        p = to_reference_params({k: v[rows] for k, v in params.items()},
                                ref.cfg.lr_gain_z)
        with ref.precision():
            parts.append(ref_inv.evaluate(
                ref.gen, ref.lpips, p, ref.cfg,
                targets['target_img'][rows], ref.has_mask,
                targets['gt_cam2world'][rows] if rot_error else None,
                None, None))
    return {k: torch.cat([m[k] for m in parts]).float() for k in parts[0]}


def reference_results(ref: Reference, targets: Dict, enc_out, pnp_out
                      ) -> Dict:
    """What the reference derives before the steps: the encoder's outputs
    on the targets, and the start from the candidate's w and PnP's
    camera."""
    img = targets['target_img'][..., :3].permute(0, 3, 1, 2).contiguous()
    with torch.no_grad(), ref.precision():
        enc = ref.encoder(img)
    cam2world, focal = pnp_out[2], pnp_out[3]
    dev = ref.device
    start = ref_inv.initial_params(
        enc_out[2], ref.gen.num_ws,
        torch.as_tensor(cam2world, dtype=torch.float32, device=dev),
        None if focal is None else torch.as_tensor(
            focal, dtype=torch.float32, device=dev), ref.cfg)
    return {'encoder': enc, 'start': start}


def compare(ref: Reference, cand: Dict, targets: Dict, crops_state,
            niter: int, rot_error: bool, block: int) -> Dict[str, float]:
    """The numbers for a candidate's results `cand` = {'encoder': (coords,
    mask, w), 'pnp': PnP's output, 'start': {z, R, s, t2, z0}, 'losses':
    (niter,), 'grad_norms': {name: (niter,)}, 'final': {ws, ...},
    'metrics': {step: {name: array}}}."""
    derived = reference_results(ref, targets, cand['encoder'], cand['pnp'])
    gaps = [rel_max(a.float(), r.float())
            for a, r in zip(cand['encoder'], derived['encoder'])]
    gaps += [rel_max(cand['start'][k].float(), derived['start'][k].float())
             for k in derived['start']]
    numbers = {'bootstrap_gap': max(gaps)}

    start = {k: v.float() for k, v in cand['start'].items()}
    b = targets['target_img'].shape[0]
    with ref.precision():
        ref_final, ref_losses, ref_grad_sq = ref_inv.refine_rows(
            ref.gen, ref.lpips, start, targets['target_img'], ref.cfg,
            draws_for(ref, crops_state, b, niter), block)
    loss0 = float(ref_losses[0])
    numbers['loss0_gap'] = abs(float(cand['losses'][0]) - loss0) / max(
        abs(loss0), LOSS_FLOOR)
    ref_norms = {k: float(sq[0].sqrt()) for k, sq in ref_grad_sq.items()}
    median = float(np.median(list(ref_norms.values())))
    numbers['grad0_gap'] = max(
        abs(float(cand['grad_norms'][k][0]) - r) / max(r, median, 1e-30)
        for k, r in ref_norms.items())
    gain = ref.cfg.lr_gain_z
    worst = 0.0
    for step, params in ((0, as_params(start, gain)),
                         (niter, {k: v.float()
                                  for k, v in cand['final'].items()})):
        ref_metrics = evaluate_rows(ref, params, targets, rot_error, block)
        worst = max(worst, float(image_gaps(cand['metrics'][step],
                                            ref_metrics).max()))
    numbers['eval_gap'] = worst
    final = {k: v for k, v in cand['metrics'][niter].items()
             if k != 'rot_error'}
    ref_metrics = evaluate_rows(ref, as_params(ref_final, gain), targets,
                                False, block)
    gaps = image_gaps(final, ref_metrics)
    numbers['final_gap'] = float(np.median(gaps))
    i = int(gaps.argmax())
    print('invert check: final gaps by image '
          f'{[round(float(g), 4) for g in gaps]}; image {i}: ' + ', '.join(
              f'{k} {float(v[i]):.5g} against '
              f'{float(ref_metrics[k][i]):.5g}' for k, v in final.items()),
          file=sys.stderr, flush=True)
    return numbers


def program_results(record, niter: int, device) -> Dict:
    """A window batch's results in `compare`'s form."""
    start = {k: v for k, v in record.init.named()}
    norms = {k: record.step_metrics[f'grad_norm_{n}']
             for k, n in GRAD_METRICS.items() if k in start}
    return {'encoder': record.enc_out, 'pnp': record.pnp_out,
            'start': start, 'losses': record.step_metrics['loss'].float(),
            'grad_norms': norms,
            'final': report_params(record.report[niter], device),
            'metrics': {step: report_metrics(record.report[step])
                        for step in (0, niter)}}


def check(s, record, spec: dict, device) -> Tuple[Dict, bool]:
    """Frees the program's models, builds the reference and compares one
    window batch. Returns ({name: {'value', 'limit'}}, correct)."""
    limits = spec['limits']
    s.free_program()
    ref = Reference(s, spec, device)
    rot_error = not (s.args.dataset == 'p3d_car' and s.args.inv_use_testset)
    numbers = compare(ref, program_results(record, s.niter, device),
                      record.targets, record.crops_state, s.niter,
                      rot_error, REFERENCE_ROWS)
    checks = {k: {'value': v, 'limit': limits[k]} for k, v in numbers.items()}
    correct = all(np.isfinite(c['value']) and c['value'] <= c['limit']
                  for c in checks.values())
    return checks, correct
