"""Replay of the real reference's hybrid-inversion tapes through the
port, with no JAX.

`tests/golden/trajectory_inversion_{l1,vgg}.npz` each hold a 5-step
hybrid inversion of two 16x16 images by the reference on the CPU:
bootstrap encoder -> cv2 PnP -> Adam (lr 2e-3, betas 0.9/0.95) over
[z, z0, R, s, t2] with per-step projections, every random draw replaced
by a numpy-seeded value, and the encoder's and PnP's outputs tapped.
This file replays them through the port's refinement (`run_inversion`
on the CPU: the plain versions of kernels B1, B2 and B3) as
`tests/test_inversion_trajectory.py` replays them through the JAX
package: the converted generator weights, the reference's recorded PnP
pose as the start (through the port's `invert_space` and
`matrix_to_pose`), the reference LPIPS stub's seeded weights, and the
injected render draws and crop transforms of each step
(`render_noise`, `tforms`). It asserts, at that file's tolerances, the
step-0 latent, the per-step monitors, the final report's pose
parameters and latent, and the front-view psnr/ssim/lpips/rot_error at
the checkpoint steps 0 and 5.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from nerf_from_image_tpu_torch.core import augment
from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.invert import optimizer as inv
from nerf_from_image_tpu_torch.metrics import image as image_metrics
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.utils import convert

GOLDEN_DIR = pathlib.Path(__file__).parent / 'golden'
REPO = pathlib.Path(__file__).parent.parent
KEEP_SITES = {
    'nerf_utils.py:compute_query_points_from_rays',
    'nerf_utils.py:sample_pdf',
    'run.py:augment_impl',
    'tap:coord_regressor',
    'tap:pnp',
}


def _regen(entry):
    r = np.random.RandomState(entry['seed'])
    shape = tuple(entry['shape'])
    vals = (r.random_sample(shape) if entry['kind'] == 'rand'
            else r.standard_normal(shape))
    return torch.tensor(vals.astype(np.float32))


def _arr(entry, key):
    a = entry['arrays'][key]
    return np.asarray(a['values'], np.float64).reshape(a['shape'])


class _TapeReader:
    def __init__(self, tape):
        self.entries = [e for e in tape if e['site'] in KEEP_SITES]
        self.pos = 0

    def take(self, site, kind):
        e = self.entries[self.pos]
        assert e['site'] == site and e['kind'] == kind, \
            f'tape mismatch at {self.pos}: got {e["site"]}/{e["kind"]}, ' \
            f'wanted {site}/{kind}'
        self.pos += 1
        return e

    def render_noise(self):
        """One render's draws: stratified depths, then the fine PDF."""
        depth = _regen(self.take(
            'nerf_utils.py:compute_query_points_from_rays', 'rand'))
        pdf_u = _regen(self.take('nerf_utils.py:sample_pdf', 'rand'))
        return {'depth': depth, 'pdf_u': pdf_u}

    def augment_tform(self):
        """One 15-crop augment's draws (rotation, scale, translation,
        each followed by its gate, which p = 1 always passes)."""
        rot = (_regen(self.take('run.py:augment_impl', 'rand')) - 0.5) \
            * 2.0 * np.pi
        self.take('run.py:augment_impl', 'rand')
        scale = torch.exp2(
            _regen(self.take('run.py:augment_impl', 'randn')) * 0.2)
        self.take('run.py:augment_impl', 'rand')
        translation = _regen(self.take('run.py:augment_impl', 'randn')) * 0.1
        self.take('run.py:augment_impl', 'rand')
        return augment.AffineTransform(rot, scale, translation)


def _stub_lpips():
    """The reference LPIPS stub's seeded weights (scripts/ref_stubs/lpips,
    torch only), loaded into the port's LPIPS."""
    spec = importlib.util.spec_from_file_location(
        'ref_lpips_stub', REPO / 'scripts' / 'ref_stubs' / 'lpips' /
        '__init__.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sd = {k: v.numpy() for k, v in mod.LPIPS(net='vgg').state_dict().items()}
    vgg_sd = {k[len('net.'):]: v for k, v in sd.items()
              if k.startswith('net.features')}
    lin_sd = {f'lin{i}.model.1.weight': sd[f'lins.{i}.weight'].reshape(
        1, -1, 1, 1) for i in range(5)}
    lpips = LPIPS(device='cpu').eval()
    convert.load_lpips_state_dicts(lpips, vgg_sd, lin_sd)
    return lpips


@pytest.fixture(scope='module', params=['l1', 'vgg'])
def trajectory(request):
    d = np.load(GOLDEN_DIR / f'trajectory_inversion_{request.param}.npz')
    cfg_ref = json.loads(str(d['config_json']))
    tape = json.loads(str(d['tape_json']))
    scalars = json.loads(str(d['scalars_json']))
    report = {k[len('report/'):]: d[k] for k in d.files
              if k.startswith('report/')}
    g_sd = {k[len('init_g/'):]: d[k] for k in d.files
            if k.startswith('init_g/')}

    gen = Generator(latent_dim=cfg_ref['latent_dim'],
                    scene_range=cfg_ref['scene_range'], attention_values=10,
                    img_resolution=256, channel_base=cfg_ref['channel_base'],
                    channel_max=cfg_ref['channel_max'], device='cpu')
    convert.load_reference_state_dict(gen, g_sd)
    lpips = _stub_lpips()
    cfg = inv.InversionConfig(
        resolution=cfg_ref['resolution'], depth_samples_per_ray=64,
        scene_range=cfg_ref['scene_range'],
        white_background=cfg_ref['white_background'], camera_flipped=False,
        lr_gain_z=float(cfg_ref['inv_gain_z']), loss_type=cfg_ref['loss'],
        optimize_pose=True, lr=2e-3)
    images = torch.tensor(d['images'])
    poses = torch.tensor(d['poses'])
    n_steps = cfg_ref['inv_steps']

    @torch.no_grad()
    def eval_front(params, noise, target, gt_cam):
        out, cam, _ = inv.render_from_params(gen, params, cfg,
                                             render_rng=noise)
        rgb = out.rgb.clamp(-1.0, 1.0)
        p01 = rgb / 2.0 + 0.5
        t01 = target[..., :3] / 2.0 + 0.5
        return {
            'psnr': image_metrics.psnr(p01, t01, reduction='none'),
            'ssim': image_metrics.ssim(p01.permute(0, 3, 1, 2),
                                       t01.permute(0, 3, 1, 2),
                                       reduction='none'),
            'lpips': lpips(rgb.permute(0, 3, 1, 2),
                           target[..., :3].permute(0, 3, 1, 2)).reshape(-1),
            'rot_error': pose_lib.rotation_matrix_distance(cam, gt_cam),
            'ws': params.z * cfg.lr_gain_z,
            **{k: getattr(params, k) for k in ('z0', 'R', 's', 't2')}}

    reader = _TapeReader(tape)
    results = []
    for b in range(cfg_ref['n_images']):
        enc = reader.take('tap:coord_regressor', 'tensors')
        pnp_entry = reader.take('tap:pnp', 'tensors')
        w2c = torch.tensor(_arr(pnp_entry, 'world2cam').astype(np.float32))
        focal = torch.tensor(_arr(pnp_entry, 'focal').astype(np.float32))
        target_w = torch.tensor(_arr(enc, 'w').astype(np.float32))

        # The start (run.py:1960-2010): the encoder's w over every slot,
        # divided by the gain; the pose from the recorded PnP estimate.
        z0, t2, s, quat = pose_lib.matrix_to_pose(
            pose_lib.invert_space(w2c), focal, cfg.camera_flipped)
        num_ws = report['0/ws'].shape[1]
        z = target_w.expand(1, num_ws, target_w.shape[-1])
        params = inv.InversionParams(z=z / cfg.lr_gain_z, R=quat, s=s,
                                     t2=t2, z0=z0)
        target = images[b:b + 1]
        gt_cam = poses[b:b + 1]

        eval0 = eval_front(params, reader.render_noise(), target, gt_cam)
        reader.render_noise()  # the novel-view render's draws

        # Each step's draws, in the reference's order: the render's, then
        # (vgg only) the crops'.
        noise, tforms = [], []
        for _ in range(n_steps):
            noise.append(reader.render_noise())
            if cfg_ref['loss'] in ('vgg', 'mixed'):
                tforms.append(reader.augment_tform())
        final, metrics = inv.run_inversion(
            gen, lpips, params, target[..., :3], cfg, n_steps,
            gt_cam2world=gt_cam, tforms=tforms or None, render_noise=noise)
        eval5 = eval_front(final, reader.render_noise(), target, gt_cam)
        reader.render_noise()  # the novel-view render's draws
        results.append({
            'init': params,
            'steps': {k: v.numpy() for k, v in metrics.items()},
            'eval0': {k: v.detach().numpy() for k, v in eval0.items()},
            'eval5': {k: v.detach().numpy() for k, v in eval5.items()}})
    assert reader.pos == len(reader.entries), 'unconsumed tape entries'
    return results, scalars, report, cfg_ref


def test_initial_ws_matches_reference(trajectory):
    """The start's latent as the step-0 report records it (the pose
    entries of the step-0 report alias the final pose in the reference's
    CPU run, `tests/test_inversion_trajectory.py`; the step-0 pose is
    held through the step-0 monitors and metrics below)."""
    results, _, report, _ = trajectory
    for b, res in enumerate(results):
        np.testing.assert_allclose(res['init'].z.numpy() * 5.0,
                                   report['0/ws'][b:b + 1], rtol=1e-5,
                                   atol=1e-7, err_msg=f'ws[{b}]')


@pytest.mark.parametrize('key,tag', [
    ('psnr', 'monitor_b0/psnr'),
    ('lpips', 'monitor_b0/lpips'),
    ('rot_error', 'monitor_b0/rot_error'),
])
def test_per_step_monitors_match_reference(trajectory, key, tag):
    """The five per-step monitors of image 0: steps 0-1 at 2e-4, later
    steps at 2e-3 under the vgg loss (Adam's sign-like first steps
    amplify rounding), 2e-4 under l1."""
    results, scalars, _, cfg_ref = trajectory
    got = results[0]['steps'][key]
    ref = dict(scalars[tag])
    late_rtol = 2e-3 if cfg_ref['loss'] == 'vgg' else 2e-4
    for t in range(cfg_ref['inv_steps']):
        rtol = 2e-4 if t <= 1 else late_rtol
        np.testing.assert_allclose(got[t], ref[t], rtol=rtol, atol=2e-6,
                                   err_msg=f'{tag} @ step {t}')


@pytest.mark.parametrize('step', [0, 5])
@pytest.mark.parametrize('key', ['psnr', 'ssim', 'lpips', 'rot_error'])
def test_report_metrics_match_reference(trajectory, step, key):
    """Front-view metrics at the checkpoint steps, at
    `tests/test_inversion_trajectory.py`'s tolerances."""
    results, _, report, cfg_ref = trajectory
    ref = report[f'{step}/{key}']
    got = np.concatenate([np.asarray(r[f'eval{step}'][key]).reshape(-1)
                          for r in results])
    vgg5 = cfg_ref['loss'] == 'vgg' and step == 5
    atol = ((1.2e-3 if vgg5 else 2e-5) if key == 'ssim' else 2e-6)
    rtol = 8e-3 if vgg5 else (1e-3 if (key == 'lpips' and step == 5)
                              else 2e-4)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                               err_msg=f'report {key} @ {step}')


@pytest.mark.parametrize('key', ['z0', 'R', 's', 't2'])
def test_final_pose_params_match_reference(trajectory, key):
    """The pose after five Adam steps and projections: 7e-3 under the
    vgg loss, 2e-4 under l1."""
    results, _, report, cfg_ref = trajectory
    got = np.concatenate([r['eval5'][key] for r in results])
    rtol = 7e-3 if cfg_ref['loss'] == 'vgg' else 2e-4
    np.testing.assert_allclose(got, report[f'5/{key}'], rtol=rtol,
                               atol=2e-6, err_msg=f'final {key}')


def test_final_ws_matches_reference(trajectory):
    """The final latents: the update's direction (cosine > 0.999), every
    entry within the five-step Adam envelope, the bulk within 5e-4."""
    results, _, report, cfg_ref = trajectory
    envelope = cfg_ref['inv_steps'] * 2e-3 * cfg_ref['inv_gain_z']
    for b, res in enumerate(results):
        got = res['eval5']['ws'][0]
        ref = report['5/ws'][b]
        init = report['0/ws'][b]
        du_got = (got - init).ravel()
        du_ref = (ref - init).ravel()
        cos = du_got @ du_ref / (np.linalg.norm(du_got) *
                                 np.linalg.norm(du_ref))
        assert cos > 0.999, f'update direction diverged: cos={cos} [{b}]'
        diff = np.abs(got - ref)
        assert diff.max() <= envelope, f'outside the envelope [{b}]'
        assert diff.mean() < 5e-4, f'bulk ws mismatch: {diff.mean()} [{b}]'
