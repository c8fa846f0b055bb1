"""Replay of the reference's encoder-mode evaluation tape through the port.

`tests/golden/trajectory_gan_eval.npz` holds a 4-iteration encoder-mode
run of the reference trainer on the CPU (carla at latent 64 and 16^2
renders: G, D with R1, G, D with R1) and its iteration-3 evaluation: the
front and random views' reconstruction metrics over the seeded
evaluation indices and view permutation, the frozen latents, the FIDs
against the frozen real statistics (a seeded stub Inception) and LPIPS
(seeded stub weights), every random draw substituted by a numpy-seeded
value. This file replays it through the port's `g_step`, `d_step` and
`GANEvaluator` on the CPU (the plain versions of kernels B1 and B4), each
draw regenerated and injected (the evaluation's renders through
`render_noise_provider`), with the stub modules themselves, as
`tests/test_eval_trajectory.py` does for the JAX package, at that file's
tolerances. It imports nothing of JAX.

The whole replay is `slow` and `parity`, as the JAX one is; the gate
keeps the first G step (`test_first_g_step_matches_reference`).
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from nerf_from_image_tpu_torch.data.loaders import DatasetSplit
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.train import eval as eval_lib
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import convert

REPO = pathlib.Path(__file__).parent.parent
GOLDEN = pathlib.Path(__file__).parent / 'golden' / 'trajectory_gan_eval.npz'
CARLA_DATASET_CONFIG = {
    'scene_range': 3.0, 'white_background': True, 'has_mask': False,
    'has_bbox': False, 'is_highres': True, 'views_per_object': 1,
    'views_per_object_test': None,
    'camera_projection_model': 'perspective', 'camera_flipped': False,
}
KEEP_SITES = {
    'run.py:compute_view_perm', 'run.py:<module>', 'run.py:sample_batch',
    'nerf_utils.py:compute_query_points_from_rays',
    'nerf_utils.py:sample_pdf', 'ops.py:sample_volume_stratified',
    'generator.py:forward', 'utils.py:_yield_batch',
}
TRAIN_TAGS = [
    (0, 'loss_g', 'loss/g'), (0, 'loss_eikonal', 'loss/eikonal'),
    (0, 'grad_norm_g', 'grad_norm/g'),
    (1, 'loss_d_real', 'loss/d_real'), (1, 'loss_d_fake', 'loss/d_fake'),
    (1, 'loss_r1', 'loss/r1'), (1, 'grad_norm_d', 'grad_norm/d'),
    (2, 'loss_g', 'loss/g'), (2, 'loss_eikonal', 'loss/eikonal'),
    (2, 'grad_norm_g', 'grad_norm/g'),
    (3, 'loss_d_real', 'loss/d_real'), (3, 'loss_d_fake', 'loss/d_fake'),
    (3, 'loss_r1', 'loss/r1'), (3, 'grad_norm_d', 'grad_norm/d'),
]


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
    return torch.tensor(vals.astype(np.float32))


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
        return {'depth': _regen(self.take(
            'nerf_utils.py:compute_query_points_from_rays', 'rand')),
            'pdf_u': _regen(self.take('nerf_utils.py:sample_pdf', 'rand'))}


def _stub(path, name):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stub_inception():
    """The reference run's seeded stub feature extractor, itself."""
    stub = _stub('scripts/ref_stubs/pytorch_fid/inception.py',
                 'ref_fid_stub').InceptionV3().eval()
    return lambda im: stub(im.float())[0][:, :, 0, 0]


def _stub_lpips() -> LPIPS:
    """The reference run's seeded stub LPIPS weights in the port's LPIPS
    (images in [-1, 1], as the reference calls it)."""
    stub = _stub('scripts/ref_stubs/lpips/__init__.py',
                 'ref_lpips_stub').LPIPS(net='vgg')
    sd = {k: v.numpy() for k, v in stub.state_dict().items()}
    vgg_sd = {k[len('net.'):]: v for k, v in sd.items()
              if k.startswith('net.features')}
    lin_sd = {f'lin{i}.model.1.weight': sd[f'lins.{i}.weight']
              for i in range(5)}
    lpips = LPIPS(device='cpu')
    convert.load_lpips_state_dicts(lpips, vgg_sd, lin_sd)
    return lpips


def _tap_images(tape, site):
    arr = next(e for e in tape if e['site'] == site)['arrays']['images']
    return np.asarray(arr['values'], np.float32).reshape(arr['shape'])


class _RecordingWriter:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars[(tag, step)] = float(value)

    def add_images(self, *a, **kw):
        pass


def _replay(full: bool):
    d = np.load(GOLDEN)
    cfg_ref = json.loads(str(d['config_json']))
    tape = json.loads(str(d['tape_json']))
    scalars = json.loads(str(d['scalars_json']))
    train_images = _tap_images(tape, 'tap:train_split')
    eval_images = _tap_images(tape, 'tap:train_eval_split')
    g_sd = {k[len('init_g/'):]: d[k] for k in d.files
            if k.startswith('init_g/')}
    d_sd = {k[len('init_d/'):]: d[k] for k in d.files
            if k.startswith('init_d/')}
    cfg = gan.GANConfig(
        resolution=cfg_ref['resolution'], latent_dim=cfg_ref['latent_dim'],
        depth_samples_per_ray=64, scene_range=cfg_ref['scene_range'],
        white_background=cfg_ref['white_background'], camera_flipped=False,
        supervise_alpha=False, use_encoder=True, attention_values=10,
        tv=cfg_ref['tv'], entropy=cfg_ref['entropy'],
        eikonal=cfg_ref['eikonal'], r1=cfg_ref['r1'], augment_p_max=0.0,
        clip_gradient_norm=100.0, lr_g=cfg_ref['lr_g'],
        lr_d=cfg_ref['lr_d'], batch_size=cfg_ref['batch_size'],
        plane_resolution=256, channel_base=cfg_ref['channel_base'],
        channel_max=cfg_ref['channel_max'])
    state = gan.init_train_state(cfg, device='cpu')
    for opt in (state.opt_g, state.opt_d):
        # The JAX replay's lr_warmup=False: the full lr from the start.
        opt.param_groups[0]['count'] = gan.LR_WARMUP_ITERS // 2
    convert.load_reference_state_dict(state.gen, g_sd)
    state.gen_ema.load_state_dict(state.gen.state_dict())
    convert.load_reference_state_dict(state.disc, d_sd)

    bs = cfg_ref['batch_size']
    images = torch.tensor(train_images)
    poses = torch.tensor(d['poses'])
    focal = torch.full((bs,), float(d['focal']))
    reader = _TapeReader(tape)
    view_perm = np.asarray(
        reader.take('run.py:compute_view_perm', 'permutation')['values'])
    z_fid = _regen(reader.take('run.py:<module>', 'randn')).numpy()

    def g_batch():
        idx = np.asarray(reader.take('run.py:sample_batch',
                                     'randint')['values'])
        z = _regen(reader.take('run.py:sample_batch', 'randn'))
        noise = {'depth': _regen(reader.take(
            'nerf_utils.py:compute_query_points_from_rays', 'rand')),
            'strata': _regen(reader.take(
                'ops.py:sample_volume_stratified', 'rand')),
            'perturb': _regen(reader.take('generator.py:forward',
                                          'randn')),
            'pdf_u': _regen(reader.take('nerf_utils.py:sample_pdf',
                                        'rand'))}
        return {'pose': poses[idx], 'focal': focal, 'z': z,
                'image': images[idx], 'noise': noise}

    def d_batches(real_idx):
        reader.take('run.py:sample_batch', 'randn')  # unused real-phase z
        real = {'pose': poses[real_idx], 'focal': focal,
                'image': images[real_idx]}
        fake_idx = np.asarray(reader.take('run.py:sample_batch',
                                          'randint')['values'])
        fake_z = _regen(reader.take('run.py:sample_batch', 'randn'))
        return real, {'pose': poses[fake_idx], 'focal': focal, 'z': fake_z,
                      'image': images[fake_idx],
                      'noise': reader.render_noise()}

    results = {0: {k: float(v) for k, v in
                   gan.g_step(state, g_batch(), cfg).items()}}
    if not full:
        return results, None, scalars
    perm = np.asarray(reader.take('utils.py:_yield_batch',
                                  'permutation')['values'])
    results[1] = {k: float(v) for k, v in gan.d_step(
        state, *d_batches(perm[:bs]), cfg).items()}
    results[2] = {k: float(v) for k, v in
                  gan.g_step(state, g_batch(), cfg).items()}
    results[3] = {k: float(v) for k, v in gan.d_step(
        state, *d_batches(perm[bs:2 * bs]), cfg).items()}

    focal_all = np.full((len(train_images),), float(d['focal']), np.float32)
    train_split = DatasetSplit(images=train_images,
                               tform_cam2world=np.asarray(d['poses']),
                               focal_length=focal_all)
    train_eval_split = DatasetSplit(
        images=eval_images, tform_cam2world=np.asarray(d['poses']),
        focal_length=np.full((len(eval_images),), float(d['focal']),
                             np.float32))
    evaluator = eval_lib.GANEvaluator(
        cfg, CARLA_DATASET_CONFIG, 'carla', train_split, train_eval_split,
        inception=_stub_inception(), lpips=_stub_lpips(), use_encoder=True,
        eval_batch_size=bs, seed=1234, device='cpu')
    # The reference's torch-seeded protocol draws, verbatim.
    assert np.array_equal(train_eval_split.eval_indices,
                          np.arange(len(eval_images)))
    train_eval_split.eval_indices_perm = \
        train_eval_split.eval_indices[view_perm]
    evaluator.z_fid = z_fid.astype(np.float32)
    noise_iter = iter([reader.render_noise() for _ in range(4)])
    evaluator.render_noise_provider = lambda: next(noise_iter)
    writer = _RecordingWriter()
    current_fid, is_best = evaluator.evaluate(state, 3, writer)
    eval_out = dict(writer.scalars)
    eval_out[('reconstruction/fid_randomview_return', 3)] = current_fid
    eval_out[('is_best', 3)] = is_best
    eval_out[('best_fid', 3)] = evaluator.best_fid
    # The img/* logging block's draws, which no asserted scalar reads.
    reader.take('run.py:<module>', 'randn')
    reader.render_noise()
    assert reader.pos == len(reader.entries), 'unconsumed tape entries'
    assert next(noise_iter, None) is None, 'unconsumed eval render noise'
    return results, eval_out, scalars


def _ref(scalars, tag, step):
    for s, v in scalars[tag]:
        if s == step:
            return v
    raise KeyError(f'{tag} @ {step}')


def _train_rtol(step, key):
    # grad_norm includes the encoder's instance-norm chains, whose tiny
    # gradients lose relative precision fastest (the JAX replay's band).
    return 2e-3 if (step >= 2 and key.startswith('grad_norm')) else 1e-4


@pytest.fixture(scope='module')
def first_g_step():
    return _replay(False)


def test_first_g_step_matches_reference(first_g_step):
    """The gate's form: the encoder-mode G step's three tags."""
    results, _, scalars = first_g_step
    for step, key, tag in TRAIN_TAGS[:3]:
        np.testing.assert_allclose(results[step][key],
                                   _ref(scalars, tag, step), rtol=1e-4,
                                   atol=2e-6, err_msg=tag)


@pytest.fixture(scope='module')
def eval_trajectory():
    return _replay(True)


@pytest.mark.slow
@pytest.mark.parity
@pytest.mark.parametrize('step,key,tag', TRAIN_TAGS)
def test_train_scalar_matches_reference(eval_trajectory, step, key, tag):
    results, _, scalars = eval_trajectory
    np.testing.assert_allclose(results[step][key], _ref(scalars, tag, step),
                               rtol=_train_rtol(step, key), atol=2e-6,
                               err_msg=f'{tag} @ step {step}')


@pytest.mark.slow
@pytest.mark.parity
@pytest.mark.parametrize('tag', ['reconstruction/psnr_front',
                                 'reconstruction/ssim_front',
                                 'reconstruction/lpips_front'])
def test_recon_metric_matches_reference(eval_trajectory, tag):
    _, eval_out, scalars = eval_trajectory
    np.testing.assert_allclose(eval_out[(tag, 3)], _ref(scalars, tag, 3),
                               rtol=1e-4, atol=2e-6, err_msg=tag)


@pytest.mark.slow
@pytest.mark.parity
@pytest.mark.parametrize('tag', ['reconstruction/fid_frontview',
                                 'reconstruction/fid_randomview'])
def test_fid_matches_reference(eval_trajectory, tag):
    """The 2048-D covariance of 8 samples is rank-deficient, so the
    Frechet distance amplifies float differences (the JAX replay's
    2e-3)."""
    _, eval_out, scalars = eval_trajectory
    np.testing.assert_allclose(eval_out[(tag, 3)], _ref(scalars, tag, 3),
                               rtol=2e-3, err_msg=tag)


@pytest.mark.slow
@pytest.mark.parity
def test_best_fid_gating(eval_trajectory):
    _, eval_out, scalars = eval_trajectory
    ref_random = _ref(scalars, 'reconstruction/fid_randomview', 3)
    np.testing.assert_allclose(
        eval_out[('reconstruction/fid_randomview_return', 3)], ref_random,
        rtol=2e-3)
    assert eval_out[('is_best', 3)] is True
    np.testing.assert_allclose(eval_out[('best_fid', 3)], ref_random,
                               rtol=2e-3)
