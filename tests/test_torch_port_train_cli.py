"""The slice as a whole: GAN training through the port's entry points
against the JAX package's.

- `GANEvaluator`, unconditional, in p3d_car's geometry (box 1.4, black
  background, flipped camera) on a small generator (latent 32, 64^2
  planes, narrow channels, 16^2 renders of 8 + 8 samples, evaluation
  batches of 4 over 10 images, so the last batch is padded): the same
  reference-format generator weights and the same random Inception state
  dict (`random_inception_state_dict`) on both sides. The evaluation
  indices, the view permutation and `z_fid` exactly; the logged tags the
  same; the first batch's images (rgb, normals, semantics) and the
  training images within 1e-3; `generation/fid_untrunc` within 1e-3
  relative. With all 2048 activations each side's FID takes a 2048^2
  matrix square root (about a minute each on a CPU), so that case is
  `slow`; the quick case takes the first 64 activations of the same
  network on both sides. In p3d_car the field's box is the render's, so
  the first coarse point of each hitting ray lies on the field's box
  face, where the normals (and, rounded one way or the other by XLA,
  the features) are not reproducible (ROADMAP C: a gap of the
  reference, not of the port); both generators here take a field box of
  1.6, so those points lie inside it.
- The training CLI: a fresh run pretrains, trains 4 iterations with the
  iteration-3 evaluation and writes `latest` and `best`; a resume does
  not pretrain; the logged tags are JAX's; auto-resume only from 12,500.
  The quick cases narrow the generator and discriminator (channel_base
  1024, channel_max 64) through a test-side wrapper of
  `make_gan_config`; the whole CLI against JAX's CLI (full width on both
  sides) is `slow`.
- The repairs: the inversion CLI's generator is float32 at the default
  flags, and float32 is no longer refused on the card. The loop, its
  resume and --ada_target are in `test_torch_port_train_loop.py`.
Everything runs in float32 on the CPU unless stated, on one torch
thread (`one_torch_thread`).
"""

import dataclasses
import functools
import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.data import loaders as jax_loaders
from nerf_from_image_tpu.models.inception import \
    InceptionV3FID as JaxInceptionV3FID
from nerf_from_image_tpu.train import eval as jax_eval
from nerf_from_image_tpu.train import gan as jax_gan
from nerf_from_image_tpu.train import loop as jax_loop
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.data import loaders
from nerf_from_image_tpu_torch.models.inception import InceptionV3FID
from nerf_from_image_tpu_torch.train import eval as port_eval
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import checkpoint
from nerf_from_image_tpu_torch.utils import convert

SCALAR_RTOL, SCALAR_ATOL = 1e-4, 2e-6
IMAGE_TOL = 1e-3
FID_RTOL = 1e-3
QUICK_WIDTH = 64  # activations of the quick FID case


def _rel(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30)


def _cameras(rng, b):
    """p3d_car-style cameras: a flipped camera at distance 2 looking at
    the origin from a random rotation near the front."""
    q = rng.standard_normal((b, 4)) * 0.2 + [1.0, 0.0, 0.0, 0.0]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cam, focal = pose_lib.pose_to_matrix(
        torch.full((b,), float(np.log(2.0))),
        torch.tensor(rng.uniform(-0.05, 0.05, (b, 2)), dtype=torch.float32),
        torch.ones(b), torch.tensor(q, dtype=torch.float32), True)
    return cam.numpy(), focal.numpy()


def _split_arrays(seed, n, res, highres=False, bbox=False):
    rng = np.random.default_rng(seed)
    size = 2 * res if highres else res
    images = rng.uniform(-1, 1, (n, size, size, 4)).astype(np.float32)
    cam, focal = _cameras(rng, n)
    out = dict(tform_cam2world=cam, focal_length=focal)
    if highres:
        out['images_highres'] = images
        out['images'] = images.reshape(n, res, 2, res, 2, 4).mean(
            axis=(2, 4))
    else:
        out['images'] = images
    if bbox:
        x0 = rng.uniform(0.0, 0.1, (n, 2))
        out['bbox'] = np.stack([x0, 1.0 - x0 - rng.uniform(0, 0.1, (n, 2))],
                               axis=1).astype(np.float32)
    return out


class Writer:
    """Records what a `SummaryWriter` is given."""

    def __init__(self):
        self.scalars = {}
        self.images = {}

    def add_scalar(self, tag, value, step):
        self.scalars[tag, int(step)] = float(value)

    def add_images(self, tag, images, step):
        self.images[tag, int(step)] = np.asarray(images, np.float32)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Beside other test processes, torch's default of one thread a core
    spins on shared cores; these small tensors run as fast on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- The evaluator ----------------------------------------------------

EVAL_CFG = dict(resolution=16, latent_dim=32, depth_samples_per_ray=8,
                scene_range=1.4, white_background=False,
                camera_flipped=True, attention_values=4,
                plane_resolution=64, channel_base=1024, channel_max=64)
EVAL_N, EVAL_BS, ITER = 10, 4, 3
FIELD_RANGE = 1.6  # the generators' box; the render's is 1.4
DATASET_CONFIG = dict(scene_range=1.4, white_background=False,
                      has_mask=True, has_bbox=True, is_highres=True,
                      views_per_object=1, views_per_object_test=1,
                      camera_projection_model='perspective',
                      camera_flipped=True)


@pytest.fixture(scope='module')
def eval_setup():
    cfg = gan.GANConfig(**EVAL_CFG)
    state = gan.init_train_state(cfg, device='cpu', seed=2)
    with torch.no_grad():
        # A fresh decoder's SDF is far from 0 in the box; put a surface in.
        for g in (state.gen, state.gen_ema):
            g.decoder.net[2].bias[0] -= 1.0
        state.gen_ema.decoder.net[2].bias[0] -= 0.2  # EMA != G
    state.gen.scene_range = state.gen_ema.scene_range = FIELD_RANGE
    train = _split_arrays(0, 6, 16)
    train_eval = _split_arrays(1, EVAL_N, 16, bbox=True)
    inc_sd = convert.random_inception_state_dict(0)
    port_inc = InceptionV3FID(device='cpu')
    convert.load_inception_state_dict(port_inc, inc_sd)
    jnet = JaxInceptionV3FID()
    jvars = jax.tree_util.tree_map(jnp.asarray,
                                   torch_convert.convert_inception(inc_sd))
    jax_inc = jax.jit(functools.partial(jnet.apply, jvars))
    jcfg = jax_gan.GANConfig(use_pallas=False, fine_sampling=True,
                             **EVAL_CFG)
    jgen = jax_gan.make_models(jcfg)[0].clone(scene_range=FIELD_RANGE)
    conv = functools.partial(torch_convert.convert_generator,
                             attention_values=EVAL_CFG['attention_values'],
                             plane_resolution=EVAL_CFG['plane_resolution'])
    jstate = types.SimpleNamespace(
        params_g=jax.tree_util.tree_map(jnp.asarray, conv(
            {k: v.numpy() for k, v in state.gen.state_dict().items()})),
        ema_params_g=jax.tree_util.tree_map(jnp.asarray, conv(
            {k: v.numpy() for k, v in state.gen_ema.state_dict().items()})))
    return dict(cfg=cfg, jcfg=jcfg, state=state, jstate=jstate, jgen=jgen,
                train=train, train_eval=train_eval, port_inc=port_inc,
                jax_inc=jax_inc)


def _run_evaluators(s, width):
    """Both evaluators' evaluate and log_training_images, with the first
    `width` activations of the same Inception."""
    port_inc = (s['port_inc'] if width is None else
                lambda im: s['port_inc'](im)[:, :width])
    jax_inc = (s['jax_inc'] if width is None else
               lambda im: s['jax_inc'](im)[:, :width])
    port = port_eval.GANEvaluator(
        s['cfg'], DATASET_CONFIG, 'p3d_car',
        loaders.DatasetSplit(**s['train']),
        loaders.DatasetSplit(**s['train_eval']), inception=port_inc,
        eval_batch_size=EVAL_BS, device='cpu')
    ref = jax_eval.GANEvaluator(
        s['jcfg'], DATASET_CONFIG, 'p3d_car',
        jax_loaders.DatasetSplit(**s['train']),
        jax_loaders.DatasetSplit(**s['train_eval']),
        inception_apply=jax_inc, eval_batch_size=EVAL_BS)
    writers = Writer(), Writer()
    fids = (port.evaluate(s['state'], ITER, writers[0]),
            ref.evaluate(s['jstate'], ITER, s['jgen'], writers[1]))
    port.log_training_images(s['state'], ITER, writers[0],
                             np.random.RandomState(4321))
    ref.log_training_images(s['jstate'], ITER, s['jgen'], writers[1],
                            np.random.RandomState(4321))
    return port, ref, fids, writers


@pytest.fixture(scope='module')
def quick_eval(eval_setup):
    return _run_evaluators(eval_setup, QUICK_WIDTH)


def test_eval_indices_permutation_and_latents(quick_eval):
    port, ref, _, _ = quick_eval
    for name in ('eval_indices', 'eval_indices_perm'):
        np.testing.assert_array_equal(getattr(port.train_eval_split, name),
                                      getattr(ref.train_eval_split, name))
    np.testing.assert_array_equal(port.z_fid, ref.z_fid)
    assert len(port.z_fid) == EVAL_N


def test_eval_tags_and_images(quick_eval):
    _, _, _, (pw, jw) = quick_eval
    assert set(pw.scalars) == set(jw.scalars) == {
        ('generation/fid_untrunc', ITER)}
    assert set(pw.images) == set(jw.images)
    for tag in ('img_eval_gen/static_untrunc',
                'img_eval_gen/static_normals_untrunc',
                'img_eval_gen/static_semantics_untrunc', 'img/ref',
                'img/rgb', 'img/depth', 'img/mask', 'img/normals',
                'img/inference', 'img/inference_normals',
                'img/inference_semantics'):
        assert (tag, ITER) in pw.images, tag
    assert pw.images['img_eval_gen/static_untrunc', ITER].shape == (
        EVAL_BS, 3, 16, 16)
    for key, ref in jw.images.items():
        got = pw.images[key]
        assert got.shape == ref.shape, key
        np.testing.assert_allclose(got, ref, rtol=IMAGE_TOL, atol=IMAGE_TOL,
                                   err_msg=str(key))


def test_eval_fid_quick(quick_eval):
    port, ref, ((fid, is_best), (jfid, jbest)), _ = quick_eval
    assert np.isfinite(fid) and is_best and jbest
    assert _rel(fid, jfid) < FID_RTOL, (fid, jfid)
    assert port.best_fid == fid


@pytest.mark.slow
@pytest.mark.parametrize('parity', [pytest.param(0, marks=pytest.mark.parity)])
def test_eval_fid_full_inception(eval_setup, parity):
    _, _, ((fid, _), (jfid, _)), _ = _run_evaluators(eval_setup, None)
    assert _rel(fid, jfid) < FID_RTOL, (fid, jfid)


def test_evaluator_refuses_encoder_and_class_modes(eval_setup):
    """The encoder and class modes are ported: the evaluator builds in
    both (their evaluations: test_torch_port_flag_eval.py), with the test
    split's latents only when it has a test split."""
    s = eval_setup
    for flag in ('use_encoder', 'use_class'):
        evaluator = port_eval.GANEvaluator(
            s['cfg'], DATASET_CONFIG, 'p3d_car',
            loaders.DatasetSplit(**s['train']),
            loaders.DatasetSplit(**s['train_eval']), device='cpu',
            **{flag: True})
        assert getattr(evaluator, flag) and evaluator.z_fid_test is None


# ---- The training CLI -----------------------------------------------------

CLI_KNOBS = ['--dataset', 'p3d_car', '--resolution', '16', '--latent_dim',
             '512', '--attention_values', '4', '--plane_resolution', '32',
             '--depth_samples_per_ray', '4', '--batch_size', '4',
             '--compute_dtype', 'float32', '--mesh_shape', 'data:1']
IMAGE_TAGS = {'img_eval_gen/static_untrunc',
              'img_eval_gen/static_normals_untrunc',
              'img_eval_gen/static_semantics_untrunc', 'img/ref', 'img/rgb',
              'img/depth', 'img/mask', 'img/normals', 'img/inference',
              'img/inference_normals', 'img/inference_semantics'}


def _pooled_features(im):
    """A narrow stand-in for Inception on both sides: 4 x 4 mean pools of
    the three channels, 48 activations (scipy's square root of 2048^2
    covariances takes a minute on a CPU)."""
    b, c, h, w = im.shape
    return im.reshape(b, c, 4, h // 4, 4, w // 4).mean(axis=(3, 5)).reshape(
        b, c * 16)


@pytest.fixture(scope='module')
def cli_data(tmp_path_factory):
    from nerf_from_image_tpu_torch.data import fixtures
    root = tmp_path_factory.mktemp('train_cli')
    fixtures.write_p3d_car(str(root / 'data'), n_train=6, n_test=2,
                           size=(48, 40), seed=0)
    yield root
    # The module's runs write checkpoints of hundreds of MB here.
    shutil.rmtree(root, ignore_errors=True)


class Calls:
    """What a test-side wrapper saw: pretraining calls and image tags."""

    def __init__(self):
        self.pretrain = []
        self.images = set()


def _patch_port(monkeypatch, calls, narrow=True):
    from nerf_from_image_tpu_torch.cli import run as cli_run
    from nerf_from_image_tpu_torch.train import pretrain
    from nerf_from_image_tpu_torch.utils.logging import SummaryWriter
    original = pretrain.pretrain_sdf
    if narrow:
        make_cfg = cli_run.make_gan_config
        monkeypatch.setattr(cli_run, 'make_gan_config', lambda *args: (
            dataclasses.replace(make_cfg(*args), channel_base=1024,
                                channel_max=64)))

    def short_pretrain(state, *args, **kwargs):
        calls.pretrain.append(state.iteration)
        return original(state, *args, n_steps=2, **kwargs)

    add_images = SummaryWriter.add_images

    def record(self, tag, images, step):
        calls.images.add((tag, int(step)))
        return add_images(self, tag, images, step)

    monkeypatch.setattr(pretrain, 'pretrain_sdf', short_pretrain)
    monkeypatch.setattr(SummaryWriter, 'add_images', record)
    monkeypatch.setattr(
        cli_run.weights_lib, 'load_inception',
        lambda *args, **kwargs: lambda im: _pooled_features(im))


def _scalars(log_dir):
    with open(os.path.join(log_dir, 'scalars.jsonl')) as f:
        return {(s['tag'], s['step']) for s in map(json.loads, f)}


def _run_port_cli(root, data, extra):
    from nerf_from_image_tpu_torch.cli import run as cli_run
    return cli_run.main(CLI_KNOBS + ['--root_path', str(root), '--data_path',
                                     str(data)] + extra, device='cpu')


def _port_runs(cli_data, monkeypatch, root, narrow=True):
    """A fresh run of 4 iterations, then a resume to 8."""
    calls = Calls()
    _patch_port(monkeypatch, calls, narrow)
    fresh = _run_port_cli(root, cli_data / 'data', ['--iterations', '4'])
    name = os.path.basename(fresh['checkpoint_dir'])
    after_fresh = (sorted(os.listdir(fresh['checkpoint_dir'])),
                   _scalars(fresh['log_dir']), set(calls.images),
                   list(calls.pretrain))
    resumed = _run_port_cli(root, cli_data / 'data',
                            ['--iterations', '8', '--resume_from', name])
    return dict(fresh=fresh, resumed=resumed, name=name,
                after_fresh=after_fresh, calls=calls)


def _expected_train_scalars():
    """The tags JAX's loop logs for p3d_car's configuration at a G step
    and at a D step: its `metric_tag` of the step metrics the JAX steps
    return, and its state scalars."""
    g = ['loss_g', 'loss_eikonal', 'loss_tv', 'loss_entropy', 'grad_norm_g']
    d = ['loss_d_real', 'loss_d_fake', 'loss_r1', 'sign_real', 'grad_norm_d']
    state = ['img_per_sec', 'augment/p', 'sdf/beta', 'sdf/alpha',
             'sdf/beta_ema', 'sdf/alpha_ema']
    return ({jax_loop.metric_tag(k, False) for k in g} | set(state),
            {jax_loop.metric_tag(k, False) for k in d} | set(state))


def test_cli_trains_pretrains_and_resumes(cli_data, monkeypatch):
    """The port's whole training CLI: a fresh run pretrains, trains 4
    iterations with the iteration-3 evaluation and writes `latest` and
    `best` at iteration 4; a resume by name does not pretrain and reaches
    8. The logged tags are those JAX's loop and evaluator log (its
    `metric_tag`; the evaluator's image families)."""
    runs = _port_runs(cli_data, monkeypatch, cli_data / 'port')
    labels, scalars, images, pretrained = runs['after_fresh']
    assert runs['fresh']['pretrained'] and pretrained == [0]
    assert labels == ['checkpoint_best.pth', 'checkpoint_latest.pth']
    g_tags, _ = _expected_train_scalars()
    assert scalars == ({(t, 0) for t in g_tags} |
                       {('generation/fid_untrunc', 3)})
    assert images == {(t, 3) for t in IMAGE_TAGS}
    ckpt_dir = runs['fresh']['checkpoint_dir']
    best = checkpoint.load(os.path.join(ckpt_dir, 'checkpoint_best.pth'))
    assert best['iteration'] == 4 and np.isfinite(best['best_fid'])

    assert not runs['resumed']['pretrained']
    assert runs['calls'].pretrain == [0]
    assert runs['resumed']['state'].iteration == 8
    latest = checkpoint.load(os.path.join(ckpt_dir, 'checkpoint_latest.pth'))
    assert latest['iteration'] == 8
    # iterations 4-7 log nothing (every 100) and hold no evaluation
    assert _scalars(runs['resumed']['log_dir']) == scalars


def test_cli_auto_resume_only_from_12500(cli_data, monkeypatch, capsys):
    """A run's own latest below iteration 12,500 is not resumed: the run
    trains from scratch, pretraining first."""
    from nerf_from_image_tpu_torch.cli import run as cli_run
    calls = Calls()
    _patch_port(monkeypatch, calls)
    monkeypatch.setattr(cli_run.loop_lib, 'train_gan',
                        lambda state, *args, **kwargs: state)
    root = cli_data / 'auto'
    first = _run_port_cli(root, cli_data / 'data', ['--iterations', '0'])
    assert first['state'].iteration == 0
    capsys.readouterr()
    _run_port_cli(root, cli_data / 'data', ['--iterations', '0'])
    assert 'Aborting resume (training from scratch)' in \
        capsys.readouterr().out
    assert calls.pretrain == [0, 0]


@pytest.mark.slow
@pytest.mark.parametrize('parity', [pytest.param(0, marks=pytest.mark.parity)])
def test_cli_matches_jax(cli_data, monkeypatch, parity):
    """The port's CLI against JAX's on the same fixture and flags (JAX
    also --use_pallas 0): the logged scalar and image tags with their
    steps, the checkpoint labels and their iterations, and pretraining
    in the fresh run only (both shortened to 2 steps, JAX's with its
    result's leaves copied; both evaluators on the same 48-wide stand-in
    for Inception)."""
    import orbax.checkpoint as ocp
    from nerf_from_image_tpu.cli import run as jax_cli
    from nerf_from_image_tpu.train import pretrain as jax_pretrain
    from nerf_from_image_tpu.utils.logging import \
        SummaryWriter as JaxSummaryWriter

    runs = _port_runs(cli_data, monkeypatch, cli_data / 'vs_port',
                      narrow=False)
    jcalls = Calls()
    original = jax_pretrain.pretrain_sdf

    def short_pretrain(state, *args, **kwargs):
        jcalls.pretrain.append(int(state.iteration))
        # JAX's pretraining returns EMA leaves that are G's own buffers,
        # which its loop's donating G step refuses on this backend
        # ("Attempt to donate the same buffer twice"; ROADMAP C): copies.
        return jax.tree_util.tree_map(
            jnp.copy, original(state, *args, n_steps=2, **kwargs))

    add_images = JaxSummaryWriter.add_images

    def record(self, tag, images, step):
        jcalls.images.add((tag, int(step)))
        return add_images(self, tag, images, step)

    monkeypatch.setattr(jax_pretrain, 'pretrain_sdf', short_pretrain)
    monkeypatch.setattr(JaxSummaryWriter, 'add_images', record)
    monkeypatch.setattr(jax_cli, 'make_inception_apply', lambda args: (
        lambda im: _pooled_features(jnp.asarray(im))))
    root = cli_data / 'vs_jax'
    argv = CLI_KNOBS + ['--use_pallas', '0', '--root_path', str(root),
                        '--data_path', str(cli_data / 'data')]
    jax_cli.main(argv + ['--iterations', '4'])
    name = runs['name']
    ckpt_dir = root / 'gan_checkpoints' / name
    log_dir = root / 'gan_logs' / name
    after_fresh = (sorted(os.listdir(ckpt_dir)), _scalars(log_dir),
                   set(jcalls.images), list(jcalls.pretrain))
    jax_cli.main(argv + ['--iterations', '8', '--resume_from', name])

    labels, scalars, images, pretrained = runs['after_fresh']
    assert [f'{l}.pth' for l in after_fresh[0]] == labels
    assert after_fresh[1:] == (scalars, images, pretrained)
    assert jcalls.pretrain == runs['calls'].pretrain == [0]
    assert _scalars(log_dir) == _scalars(runs['resumed']['log_dir'])
    assert jcalls.images == runs['calls'].images
    for label, iteration in (('latest', 8), ('best', 4)):
        tree = ocp.StandardCheckpointer().restore(
            str(ckpt_dir / f'checkpoint_{label}'))
        port = checkpoint.load(os.path.join(
            runs['fresh']['checkpoint_dir'], f'checkpoint_{label}.pth'))
        assert int(tree['iteration']) == port['iteration'] == iteration


# ---- The inversion CLI's precision ------------------------------------------

def test_inversion_generator_is_float32_at_the_default_flags(
        cli_data, monkeypatch):
    """--compute_dtype stays at its default, bfloat16: the inversion's
    generator is float32 all the same, as the JAX CLI builds it."""
    from nerf_from_image_tpu_torch.cli import inversion as cli_inv
    from nerf_from_image_tpu_torch.cli import run as cli_run
    seen = {}

    def capture(args, cfg, dataset_config, gen, *rest):
        seen['dtype'] = gen.dtype
        seen['param'] = next(gen.parameters()).dtype
        seen['compute_dtype'] = args.compute_dtype

    monkeypatch.setattr(cli_inv, 'run_inversion_cli', capture)
    argv = [a for a in CLI_KNOBS if a not in ('--compute_dtype', 'float32')]
    cli_run.main(argv + ['--run_inversion', '--root_path',
                         str(cli_data / 'inv'), '--data_path',
                         str(cli_data / 'data')], device='cpu')
    assert seen == {'dtype': torch.float32, 'param': torch.float32,
                    'compute_dtype': 'bfloat16'}


def test_float32_on_the_card_is_not_refused(monkeypatch):
    """On the card the CLI goes on to its work at --compute_dtype float32
    (here it stops at the dataset, which the test replaces)."""
    from nerf_from_image_tpu_torch.cli import run as cli_run

    class Reached(Exception):
        pass

    def stop(*args, **kwargs):
        raise Reached

    monkeypatch.setattr(cli_run, 'resolve_device',
                        lambda device: torch.device('cuda'))
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda device: 'card')
    monkeypatch.setattr(cli_run.loaders, 'load_dataset', stop)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        for extra in (['--run_inversion'], []):
            with pytest.raises(Reached):
                cli_run.main(['--dataset', 'p3d_car', '--compute_dtype',
                              'float32'] + extra)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


@pytest.mark.parametrize('extra,match', [
    # --profile_trace_at is ported: the CLI goes on to load the dataset.
    (['--profile_trace_at', '5'], None),
    # GAN training's flag-only modes are ported: only several cards are
    # refused.
    (['--dual_discriminator', '--mesh_shape', 'data:2'], 'several cards'),
    (['--path_length_regularization', '--multihost'], 'several cards'),
    (['--use_class', '--profile_trace_at', '1'], None),
])
def test_unported_training_branches_raise(extra, match, monkeypatch):
    from nerf_from_image_tpu_torch.cli import run as cli_run

    class Reached(Exception):
        pass

    def stop(*args, **kwargs):
        raise Reached

    monkeypatch.setattr(cli_run.loaders, 'load_dataset', stop)
    # Several cards in one process: the layout check refuses them before
    # any work (`test_torch_port_config.layout_error`).
    from test_torch_port_config import layout_error
    with pytest.raises(Reached if match is None else layout_error(extra),
                       match=match):
        cli_run.main(['--dataset', 'p3d_car'] + extra, device='cpu')


def test_summary_writer_flush_matches_jax(tmp_path):
    """`flush` writes the buffered TensorBoard events out before `close`,
    as the JAX package's does: both events files grow, and both JSONL
    logs hold the same rows; a `NullWriter` flushes nothing."""
    import glob
    from nerf_from_image_tpu.utils.logging import \
        SummaryWriter as JaxSummaryWriter
    from nerf_from_image_tpu_torch.utils.logging import NullWriter
    from nerf_from_image_tpu_torch.utils.logging import SummaryWriter
    rows, grew = {}, {}
    for side, cls in (('port', SummaryWriter), ('jax', JaxSummaryWriter)):
        writer = cls(str(tmp_path / side))
        events, = glob.glob(str(tmp_path / side / 'events.out.tfevents.*'))
        before = os.path.getsize(events)
        writer.add_scalar('Loss/G', 0.25, 3)
        writer.flush()
        grew[side] = os.path.getsize(events) > before
        with open(tmp_path / side / 'scalars.jsonl') as f:
            rows[side] = [(r['tag'], r['value'], r['step'])
                          for r in map(json.loads, f)]
        writer.close()
    assert grew == {'port': True, 'jax': True}
    assert rows['port'] == rows['jax'] == [('Loss/G', 0.25, 3)]
    NullWriter().flush()
