"""Replay of the reference's stateful GAN tape through the port.

`tests/golden/trajectory_gan_stateful.npz` holds 8 iterations (4 G + 4 D,
resumed at iteration 12,504) of the reference trainer on the CPU, carla
at latent 64 and 16^2 renders with path-length regularization at full
weight, ADA at p = 0.5 (real Bernoulli gates, the controller's update at
i % 8 == 7) and per-layer StyleGAN noise, every random draw substituted
by a numpy-seeded value. This file replays it through the port's
`g_step` and `d_step` on the CPU (the plain versions of kernels B1 and
B4) with each draw regenerated and injected, as
`tests/test_reference_trajectory_stateful.py` does for the JAX package,
and holds all 17 scalar tags at that file's tolerances (its tolerance
model is quoted at `_g_tol`). It imports nothing of JAX.

The whole replay is `slow` and `parity`, as the JAX one is; the gate
keeps its first G step (`test_first_g_step_matches_reference`: the seven
G tags and the SDF parameters at the first step's 2e-4).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from nerf_from_image_tpu_torch.core import augment
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import convert

GOLDEN = (pathlib.Path(__file__).parent / 'golden' /
          'trajectory_gan_stateful.npz')
START = 12504
N_ITERS = 8
KEEP_SITES = {
    'run.py:sample_batch', 'run.py:augment_impl',
    'nerf_utils.py:compute_query_points_from_rays',
    'nerf_utils.py:sample_pdf', 'ops.py:sample_volume_stratified',
    'generator.py:forward', 'stylegan.py:forward', 'utils.py:_yield_batch',
    'tap:train_split',
}
G_TAGS = [('loss_g', 'loss/g'), ('loss_eikonal', 'loss/eikonal'),
          ('loss_tv', 'loss/tv'), ('loss_entropy', 'loss/entropy'),
          ('loss_ppl', 'ppl/loss'), ('ppl_running_avg', 'ppl/running_avg'),
          ('grad_norm_g', 'grad_norm/g')]
D_TAGS = [('loss_d_real', 'loss/d_real'), ('loss_d_fake', 'loss/d_fake'),
          ('loss_r1', 'loss/r1'), ('grad_norm_d', 'grad_norm/d'),
          ('augment_p', 'augment/p')]
SDF_TAGS = [('beta', 'sdf/beta'), ('alpha', 'sdf/alpha'),
            ('beta_ema', 'sdf/beta_ema'), ('alpha_ema', 'sdf/alpha_ema')]
G_STEPS = [START + k for k in (0, 2, 4, 6)]
D_STEPS = [START + k for k in (1, 3, 5, 7)]


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _regen(entry):
    r = np.random.RandomState(entry['seed'])
    shape = tuple(entry['shape'])
    vals = (r.random_sample(shape) if entry['kind'] == 'rand'
            else r.standard_normal(shape))
    return vals.astype(np.float32)


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

    def draw(self, site, kind):
        return torch.from_numpy(_regen(self.take(site, kind)))

    def tform(self, p):
        """One augment call with the reference's Bernoulli gates."""
        site = 'run.py:augment_impl'
        rot = (_regen(self.take(site, 'rand')) - 0.5) * 2.0 * np.pi
        rot = rot * (_regen(self.take(site, 'rand')) < p)
        scale = np.exp2(_regen(self.take(site, 'randn')) * 0.2)
        scale = 1.0 + (scale - 1.0) * (_regen(self.take(site, 'rand')) < p)
        trans = _regen(self.take(site, 'randn')) * 0.1
        trans = trans * (_regen(self.take(site, 'rand')) < p)
        return augment.AffineTransform(
            rot=torch.tensor(rot.astype(np.float32)),
            scale=torch.tensor(scale.astype(np.float32)),
            translation=torch.tensor(trans.astype(np.float32)))

    def sg_noise(self):
        """The per-layer synthesis noise draws, outermost first."""
        out = []
        while (self.pos < len(self.entries) and
               self.entries[self.pos]['site'] == 'stylegan.py:forward'):
            out.append(self.draw('stylegan.py:forward', 'randn'))
        return out


class _SamplerMirror:
    """The reference's EndlessSampler, from the recorded permutations."""

    def __init__(self, reader, n_images):
        self.reader, self.n = reader, n_images
        self.perm, self.pos = None, 0

    def __call__(self, bs):
        if self.perm is None or self.pos + bs > self.n:
            self.perm = np.asarray(self.reader.take(
                'utils.py:_yield_batch', 'permutation')['values'])
            self.pos = 0
        out = self.perm[self.pos:self.pos + bs]
        self.pos += bs
        return out


def _replay(n_iters):
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
        supervise_alpha=False, attention_values=10, tv=cfg_ref['tv'],
        entropy=cfg_ref['entropy'], eikonal=cfg_ref['eikonal'],
        r1=cfg_ref['r1'], path_length_regularization=True,
        augment_ada=True, augment_p_max=cfg_ref['augment_p'],
        ada_target=0.6, is_highres=True, use_stylegan_noise=True,
        clip_gradient_norm=100.0, lr_g=cfg_ref['lr_g'],
        lr_d=cfg_ref['lr_d'], batch_size=cfg_ref['batch_size'],
        plane_resolution=256, channel_base=cfg_ref['channel_base'],
        channel_max=cfg_ref['channel_max'])
    state = gan.init_train_state(cfg, device='cpu')
    for opt in (state.opt_g, state.opt_d):
        # A resumed reference run starts at the full lr: past the warmup.
        opt.param_groups[0]['count'] = gan.LR_WARMUP_ITERS // 2
    convert.load_reference_state_dict(state.gen, g_sd)
    state.gen_ema.load_state_dict(state.gen.state_dict())
    state.disc.load_state_dict({k: torch.tensor(v) for k, v in d_sd.items()},
                               strict=True)
    state.iteration = START
    # The checkpoint's augment_p (no ppl_running_avg in it).
    state.augment_p = float(cfg_ref['augment_p_init'])

    poses = torch.tensor(d['poses'])
    bs = cfg_ref['batch_size']
    focal = torch.full((bs,), float(d['focal']))
    reader = _TapeReader(tape)
    split = reader.take('tap:train_split', 'tensors')

    def arr(key):
        a = split['arrays'][key]
        return torch.tensor(np.asarray(a['values'], np.float32).reshape(
            a['shape']))

    images, images_highres = arr('images'), arr('images_highres')
    sampler = _SamplerMirror(reader, cfg_ref['n_images'])

    def g_batch(p):
        idx = np.asarray(reader.take('run.py:sample_batch',
                                     'randint')['values'])
        z = reader.draw('run.py:sample_batch', 'randn')
        tform = reader.tform(p)
        noise = {'depth': reader.draw(
            'nerf_utils.py:compute_query_points_from_rays', 'rand')}
        noise['sg_noise'] = reader.sg_noise()
        noise['ppl_planes'] = reader.draw('generator.py:forward', 'randn')
        noise['ppl_attn'] = reader.draw('generator.py:forward', 'randn')
        noise['strata'] = reader.draw('ops.py:sample_volume_stratified',
                                      'rand')
        noise['perturb'] = reader.draw('generator.py:forward', 'randn')
        noise['pdf_u'] = reader.draw('nerf_utils.py:sample_pdf', 'rand')
        return {'pose': poses[idx], 'focal': focal, 'z': z,
                'aug_tform': tform, 'noise': noise}

    def d_batches(p):
        real_idx = sampler(bs)
        reader.take('run.py:sample_batch', 'randn')  # unused real z
        real = {'pose': poses[real_idx], 'focal': focal,
                'image': images[real_idx],
                'image_highres': images_highres[real_idx],
                'aug_tform': reader.tform(p)}
        fake_idx = np.asarray(reader.take('run.py:sample_batch',
                                          'randint')['values'])
        fake_z = reader.draw('run.py:sample_batch', 'randn')
        tform_f = reader.tform(p)
        noise = {'depth': reader.draw(
            'nerf_utils.py:compute_query_points_from_rays', 'rand')}
        noise['sg_noise'] = reader.sg_noise()
        noise['pdf_u'] = reader.draw('nerf_utils.py:sample_pdf', 'rand')
        return real, {'pose': poses[fake_idx], 'focal': focal, 'z': fake_z,
                      'aug_tform': tform_f, 'noise': noise}

    def sdf(gen):
        return float(gen.beta.detach()[0]), float(gen.alpha.detach()[0])

    results = {}
    for i in range(START, START + n_iters):
        p = state.augment_p
        if i % 2 == 0:
            res = dict(zip(('beta', 'alpha'), sdf(state.gen)))
            res.update(zip(('beta_ema', 'alpha_ema'), sdf(state.gen_ema)))
            res.update({k: float(v) for k, v in
                        gan.g_step(state, g_batch(p), cfg).items()})
            res['ppl_running_avg'] = state.ppl_running_avg
        else:
            real, fake = d_batches(p)
            res = {k: float(v) for k, v in
                   gan.d_step(state, real, fake, cfg).items()}
            res['augment_p'] = state.augment_p
        results[i] = res
    if n_iters == N_ITERS:
        assert reader.pos == len(reader.entries), 'unconsumed tape entries'
    return results, scalars


def _ref(scalars, tag, step):
    for s, v in scalars[tag]:
        if s == step:
            return v
    raise KeyError(f'{tag} @ {step}')


# The JAX replay's tolerance model: the steps before any G update pin the
# forward, loss and gradient math at 2e-4. The PPL gradient is a
# near-cancelling sum over 6.3M zero-mean-weighted plane elements, so its
# float32 noise floor is about 100x a normal backward's; Adam normalizes
# per parameter, so noise-dominated parameters step a full lr apart and
# the gradient-norm tags drift about 1e-2 by step 12510, value tags about
# 6e-4, and ppl/loss (the variance of ppl over batch 4) amplifies it.
def _g_tol(step, tag):
    first = step == START
    if tag == 'ppl/loss':
        return 2e-3 if first else 1.5e-1
    if tag == 'grad_norm/g':
        return 2e-4 if first else 4e-2
    return 2e-4 if first else 2e-3


def _d_tol(step, tag):
    first = step == START + 1
    if tag in ('grad_norm/d', 'loss/r1'):
        return 2e-4 if first else 2e-2
    return 2e-4 if first else 2e-3


@pytest.fixture(scope='module')
def first_g_step():
    return _replay(1)


def test_first_g_step_matches_reference(first_g_step):
    """The gate's form: the first G step's seven tags and the SDF
    parameters logged before it."""
    results, scalars = first_g_step
    for key, tag in G_TAGS:
        np.testing.assert_allclose(
            results[START][key], _ref(scalars, tag, START),
            rtol=_g_tol(START, tag), atol=2e-6, err_msg=tag)
    for key, tag in SDF_TAGS:
        np.testing.assert_allclose(results[START][key],
                                   _ref(scalars, tag, START), rtol=1e-4,
                                   err_msg=tag)


@pytest.fixture(scope='module')
def trajectory():
    return _replay(N_ITERS)


@pytest.mark.slow
@pytest.mark.parity
@pytest.mark.parametrize('step', G_STEPS)
@pytest.mark.parametrize('key,tag', G_TAGS)
def test_g_scalars_match_reference(trajectory, step, key, tag):
    results, scalars = trajectory
    np.testing.assert_allclose(results[step][key], _ref(scalars, tag, step),
                               rtol=_g_tol(step, tag), atol=2e-6,
                               err_msg=f'{tag} @ {step}')


@pytest.mark.slow
@pytest.mark.parity
@pytest.mark.parametrize('step', D_STEPS)
@pytest.mark.parametrize('key,tag', D_TAGS)
def test_d_scalars_match_reference(trajectory, step, key, tag):
    results, scalars = trajectory
    np.testing.assert_allclose(results[step][key], _ref(scalars, tag, step),
                               rtol=_d_tol(step, tag), atol=2e-6,
                               err_msg=f'{tag} @ {step}')


@pytest.mark.slow
@pytest.mark.parity
def test_ada_sign_real_matches_reference(trajectory):
    results, scalars = trajectory
    np.testing.assert_allclose(results[START + 7]['sign_real'],
                               _ref(scalars, 'augment/sign_real',
                                    START + 7), rtol=1e-6)


@pytest.mark.slow
@pytest.mark.parity
@pytest.mark.parametrize('key,tag', SDF_TAGS)
@pytest.mark.parametrize('step', G_STEPS)
def test_sdf_params_match_reference(trajectory, step, key, tag):
    results, scalars = trajectory
    np.testing.assert_allclose(results[step][key], _ref(scalars, tag, step),
                               rtol=1e-4, err_msg=f'{tag} @ {step}')


@pytest.mark.slow
@pytest.mark.parity
def test_late_step_residuals_are_noise_not_drift(trajectory):
    """The JAX replay's drift detector: the signed relative residuals of
    the loose steps, each tag at unit rms, pooled; a one-sided drift
    pushes the mean's magnitude to 1."""
    results, scalars = trajectory
    tags = [(k, t, G_STEPS[1:]) for k, t in G_TAGS
            if k != 'ppl_running_avg'] + [
        (k, t, D_STEPS[1:]) for k, t in D_TAGS if k != 'augment_p']
    pooled = []
    for key, tag, steps in tags:
        r = np.array([(results[s][key] - _ref(scalars, tag, s)) /
                      max(abs(_ref(scalars, tag, s)), 1e-12) for s in steps])
        rms = float(np.sqrt(np.mean(np.square(r))))
        if rms >= 1e-12:
            pooled.extend((r / rms).tolist())
    assert pooled
    assert abs(float(np.mean(pooled))) < 0.8, pooled
