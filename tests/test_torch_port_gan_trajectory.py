"""Replay of the real reference's GAN training tape through the port.

`tests/golden/trajectory_gan.npz` holds three iterations of the reference
trainer on the CPU (G step, D step with R1, G step) from a known init
checkpoint, with every random draw replaced by a numpy-seeded value and
the per-iteration scalars recorded. This file replays the same trajectory
through the port's `g_step` and `d_step` on the CPU (the plain versions
of kernels B1 and B4): the init state dicts load with
`load_state_dict`, the batches are the recorded indices into the same
fixture data, and each draw is regenerated from its recorded seed and
injected through `batch['noise']`, as `tests/test_reference_trajectory.py`
does for the JAX package. It imports nothing of JAX. The tolerances are
that file's: rtol 1e-4 and atol 2e-6 on the 14 scalars, rtol 1e-4 on the
SDF parameters after step 0 and their EMA, 1e-6 at step 0.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import convert

GOLDEN = pathlib.Path(__file__).parent / 'golden' / 'trajectory_gan.npz'
KEEP_SITES = {
    'run.py:sample_batch',
    'nerf_utils.py:compute_query_points_from_rays',
    'nerf_utils.py:sample_pdf',
    'ops.py:sample_volume_stratified',
    'generator.py:forward',
    'utils.py:_yield_batch',
}


def _regen(entry):
    """A substituted draw, regenerated from its recorded seed."""
    r = np.random.RandomState(entry['seed'])
    shape = tuple(entry['shape'])
    vals = (r.random_sample(shape) if entry['kind'] == 'rand'
            else r.standard_normal(shape))
    return torch.tensor(vals.astype(np.float32))


class _TapeReader:
    """The tape's draws in order, less the model-construction draws (the
    checkpoint overwrites them) and the eval-latent presample."""

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


@pytest.fixture(scope='module')
def trajectory():
    d = np.load(GOLDEN)
    cfg_ref = json.loads(str(d['config_json']))
    tape = json.loads(str(d['tape_json']))
    scalars = json.loads(str(d['scalars_json']))
    g_sd = {k[len('init_g/'):]: d[k] for k in d.files
            if k.startswith('init_g/')}
    d_sd = {k[len('init_d/'):]: d[k] for k in d.files
            if k.startswith('init_d/')}

    cfg = gan.GANConfig(
        resolution=cfg_ref['resolution'], latent_dim=cfg_ref['latent_dim'],
        depth_samples_per_ray=64, scene_range=cfg_ref['scene_range'],
        white_background=cfg_ref['white_background'], camera_flipped=False,
        supervise_alpha=False, attention_values=10,
        tv=cfg_ref['tv'], entropy=cfg_ref['entropy'],
        eikonal=cfg_ref['eikonal'], r1=cfg_ref['r1'], augment_p_max=0.0,
        clip_gradient_norm=100.0, lr_g=cfg_ref['lr_g'],
        lr_d=cfg_ref['lr_d'],
        batch_size=cfg_ref['batch_size'], plane_resolution=256,
        channel_base=cfg_ref['channel_base'],
        channel_max=cfg_ref['channel_max'])
    state = gan.init_train_state(cfg, device='cpu')
    for opt in (state.opt_g, state.opt_d):
        # A resumed reference run starts at the full lr: past the warmup.
        opt.param_groups[0]['count'] = gan.LR_WARMUP_ITERS // 2
    convert.load_reference_state_dict(state.gen, g_sd)
    state.gen_ema.load_state_dict(state.gen.state_dict())
    state.disc.load_state_dict({k: torch.tensor(v) for k, v in d_sd.items()},
                               strict=True)

    images = torch.tensor(d['images'])  # (N, H, W, 3) in [-1, 1]
    poses = torch.tensor(d['poses'])
    focal = torch.full((cfg_ref['batch_size'],), float(d['focal']))
    reader = _TapeReader(tape)

    def g_batch():
        idx = np.asarray(reader.take('run.py:sample_batch',
                                     'randint')['values'])
        z = _regen(reader.take('run.py:sample_batch', 'randn'))
        noise = {
            'depth': _regen(reader.take(
                'nerf_utils.py:compute_query_points_from_rays', 'rand')),
            'strata': _regen(reader.take(
                'ops.py:sample_volume_stratified', 'rand')),
            'perturb': _regen(reader.take('generator.py:forward', 'randn')),
            'pdf_u': _regen(reader.take('nerf_utils.py:sample_pdf', 'rand')),
        }
        return {'pose': poses[idx], 'focal': focal, 'z': z, 'noise': noise}

    def sdf_params(gen):
        return float(gen.beta.detach()[0]), float(gen.alpha.detach()[0])

    results = {0: dict(zip(('beta', 'alpha'), sdf_params(state.gen)))}
    results[0].update({k: float(v) for k, v in
                       gan.g_step(state, g_batch(), cfg).items()})

    # i = 1: the D step (R1 and the warmup blur on).
    perm = np.asarray(reader.take('utils.py:_yield_batch',
                                  'permutation')['values'])
    real_idx = perm[:cfg_ref['batch_size']]
    reader.take('run.py:sample_batch', 'randn')  # unused real-phase z
    real = {'pose': poses[real_idx], 'focal': focal,
            'image': images[real_idx]}
    fake_idx = np.asarray(reader.take('run.py:sample_batch',
                                      'randint')['values'])
    fake = {'pose': poses[fake_idx], 'focal': focal,
            'z': _regen(reader.take('run.py:sample_batch', 'randn')),
            'noise': {
                'depth': _regen(reader.take(
                    'nerf_utils.py:compute_query_points_from_rays',
                    'rand')),
                'pdf_u': _regen(reader.take('nerf_utils.py:sample_pdf',
                                            'rand'))}}
    results[1] = {k: float(v) for k, v in
                  gan.d_step(state, real, fake, cfg).items()}

    # i = 2: the G step, after the first update of G.
    results[2] = dict(zip(('beta', 'alpha'), sdf_params(state.gen)))
    results[2].update(zip(('beta_ema', 'alpha_ema'),
                          sdf_params(state.gen_ema)))
    results[2].update({k: float(v) for k, v in
                       gan.g_step(state, g_batch(), cfg).items()})
    assert reader.pos == len(reader.entries), 'unconsumed tape entries'
    return results, scalars


def _ref(scalars, tag, step):
    for s, v in scalars[tag]:
        if s == step:
            return v
    raise KeyError(f'{tag} @ {step}')


@pytest.mark.parametrize('step,key,tag', [
    (0, 'loss_g', 'loss/g'),
    (0, 'loss_eikonal', 'loss/eikonal'),
    (0, 'loss_tv', 'loss/tv'),
    (0, 'loss_entropy', 'loss/entropy'),
    (0, 'grad_norm_g', 'grad_norm/g'),
    (1, 'loss_d_real', 'loss/d_real'),
    (1, 'loss_d_fake', 'loss/d_fake'),
    (1, 'loss_r1', 'loss/r1'),
    (1, 'grad_norm_d', 'grad_norm/d'),
    (2, 'loss_g', 'loss/g'),
    (2, 'loss_eikonal', 'loss/eikonal'),
    (2, 'loss_tv', 'loss/tv'),
    (2, 'loss_entropy', 'loss/entropy'),
    (2, 'grad_norm_g', 'grad_norm/g'),
])
def test_scalar_matches_reference(trajectory, step, key, tag):
    results, scalars = trajectory
    np.testing.assert_allclose(results[step][key], _ref(scalars, tag, step),
                               rtol=1e-4, atol=2e-6,
                               err_msg=f'{tag} @ step {step}')


def test_sdf_params_match_reference(trajectory):
    """beta/alpha (and their EMA) logged at step 2 are the values after
    step 0's Adam update, clamp and EMA mix."""
    results, scalars = trajectory
    for key, tag in [('beta', 'sdf/beta'), ('alpha', 'sdf/alpha'),
                     ('beta_ema', 'sdf/beta_ema'),
                     ('alpha_ema', 'sdf/alpha_ema')]:
        np.testing.assert_allclose(results[2][key], _ref(scalars, tag, 2),
                                   rtol=1e-4, err_msg=f'{tag} @ 2')
    for key, tag in [('beta', 'sdf/beta'), ('alpha', 'sdf/alpha')]:
        np.testing.assert_allclose(results[0][key], _ref(scalars, tag, 0),
                                   rtol=1e-6, err_msg=f'{tag} @ 0')
