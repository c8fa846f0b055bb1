"""SRN ShapeNet (shapenet_cars, shapenet_chairs) through the port against
the JAX package.

- `load_dataset` on `fixtures.write_shapenet` files (the chairs' train
  stage under `chairs_2.0_train/`), with and without --run_inversion and
  --use_encoder: every array of every split within SPLIT_ATOL.
- The evaluation indices and view permutation (`build_eval_indices`) and
  the inversion targets (`select_inversion_targets`, the test-set
  protocol) for a test split of 2 objects x 251 views, ShapeNet's real
  grouping: exactly JAX's. The CLI fixtures below hold fewer views than
  251, so all their test images fall into one "object" and the novel
  views (`*_random`) are permutations within it.
- The inversion CLI on a shapenet_cars fixture (1 train object of 4
  views, 1 test object of 6, 64^2 files, 32^2 renders): the port's
  report rows (two l1 steps) finite, with the novel views and no `iou`;
  encoder only against JAX's CLI (`slow` and `parity`: about two minutes
  beside other test processes), the parameters within PARAM_ATOL, each
  image metric and its `_random` form within
  `test_torch_port_cli_inversion.py`'s limits.
  The checkpoint's SDF is raised by 0.5 (a thin field inside the box):
  with a surface on the faces of ShapeNet's box (0.55, the field's own),
  JAX's jitted evaluation render parts from its eager one by up to 0.1
  in rgb (ROADMAP C, `probes/cli_render_witness.py --dataset
  shapenet_cars`), as far as the port parts from either.
- Two l1 refinement steps through the CLI with the pose frozen
  (ShapeNet's --inv_no_optimize_pose): s, t2 and z0 after the steps
  equal the bootstrap's bit for bit and R within two float32 places
  (each step renormalizes the quaternion, in JAX as in the port). The
  same through JAX's CLI, with the latent held against JAX's as the
  demo's steps hold it (`test_torch_port_demo.py`), is `slow` and
  `parity` (JAX compiles its steps for over a minute).
- One G step and one D step with R1 against JAX's in ShapeNet's training
  configuration (the principal point in every batch; no ADA; an RGB-only
  D), at `tests/torch_port_flag_steps.py`'s limits.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import test_torch_port_cli_inversion as cli_base
import torch_port_flag_steps as harness
from nerf_from_image_tpu import config as jax_config
from nerf_from_image_tpu.cli import inversion as jax_cli_inv
from nerf_from_image_tpu.cli import run as jax_cli
from nerf_from_image_tpu.data import loaders as jax_loaders
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu.utils.weights import save_npz_variables
from nerf_from_image_tpu_torch import config
from nerf_from_image_tpu_torch.cli import inversion as cli_inv
from nerf_from_image_tpu_torch.cli import run as cli_run
from nerf_from_image_tpu_torch.data import fixtures
from nerf_from_image_tpu_torch.data import loaders
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import checkpoint
from nerf_from_image_tpu_torch.utils import convert

SPLIT_ATOL = 1e-6
PARAM_ATOL = cli_base.PARAM_ATOL
METRIC_RTOL = {k: v for k, v in cli_base.METRIC_RTOL.items() if k != 'iou'}
# The demo's limits on the latent after two steps (`test_torch_port_demo`):
# Adam moves an entry whose gradient sits at float32 noise by up to its
# rate a step either way (ROADMAP C). The report stores ws = LR_GAIN_Z z.
STEPS, LR, LR_GAIN_Z = 2, 2e-3, 5.0
Z_STEP_ATOL = 2 * STEPS * LR
Z_SHARE = 0.9
R_PROJECT_ATOL = 2.4e-7  # two float32 places at 1
KNOBS = ['--dataset', 'shapenet_cars', '--run_inversion', '--resolution',
         '32', '--latent_dim', '512', '--attention_values', '4',
         '--plane_resolution', '32', '--depth_samples_per_ray', '4',
         '--compute_dtype', 'float32', '--mesh_shape', 'data:1',
         '--batch_size', '16']
TEST_VIEWS = 6


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_splits_equal(got, ref):
    assert (got is None) == (ref is None)
    if got is None:
        return
    for field in ('images', 'images_highres', 'tform_cam2world',
                  'focal_length', 'bbox', 'center', 'classes',
                  'num_classes'):
        a, b = getattr(got, field), getattr(ref, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert np.shape(a) == np.shape(b), field
            np.testing.assert_allclose(a, b, rtol=0, atol=SPLIT_ATOL,
                                       err_msg=field)


@pytest.mark.parametrize('extra', [[], ['--run_inversion'],
                                   ['--use_encoder']],
                         ids=['train', 'inversion', 'encoder'])
@pytest.mark.parametrize('dataset', ['shapenet_cars', 'shapenet_chairs'])
def test_load_dataset_matches_jax(tmp_path, dataset, extra):
    fixtures.write_shapenet(str(tmp_path), dataset.split('_')[1], 2, 1, 3,
                            4, size=48, seed=len(dataset))
    argv = ['--dataset', dataset, '--data_path', str(tmp_path),
            '--resolution', '32'] + extra
    got = loaders.load_dataset(config.parse_args(argv))
    ref = jax_loaders.load_dataset(jax_config.parse_args(argv))
    assert got[0] == ref[0]
    for g, r in zip(got[1:], ref[1:]):
        _assert_splits_equal(g, r)
    train, _, test = got[1:]
    assert train.images.shape == (6, 32, 32, 3)
    np.testing.assert_allclose(train.center, 0.5)
    assert (test is None) == (not extra)


def test_view_grouping_at_its_real_size():
    """2 objects x 251 test views: ShapeNet's evaluation grouping."""
    dataset_config = config.get_dataset_config('shapenet_cars')
    vpo = dataset_config['views_per_object_test']
    n = 2 * vpo
    rng = np.random.default_rng(0)
    split = loaders.DatasetSplit(
        images=rng.uniform(-1, 1, (n, 2, 2, 3)).astype(np.float32),
        tform_cam2world=rng.standard_normal((n, 4, 4)).astype(np.float32),
        focal_length=np.full(n, 2.05, np.float32),
        center=np.full((n, 2), 0.5, np.float32))
    a, b = (loaders.DatasetSplit(images=split.images) for _ in range(2))
    cli_inv.build_eval_indices(a, 8000, vpo, np.random.RandomState(1234))
    jax_cli_inv.build_eval_indices(b, 8000, vpo, np.random.RandomState(1234))
    np.testing.assert_array_equal(a.eval_indices, b.eval_indices)
    np.testing.assert_array_equal(a.eval_indices_perm, b.eval_indices_perm)
    # Each view's novel view is another view of its own object.
    assert np.all(a.eval_indices_perm // vpo == a.eval_indices // vpo)
    assert np.any(a.eval_indices_perm != a.eval_indices)
    sel = a.eval_indices[[0, 3, 250, 251, 501]]
    sel_perm = a.eval_indices_perm[[0, 3, 250, 251, 501]]
    got = cli_inv.select_inversion_targets(
        'shapenet_cars', dataset_config, True, False, split, split, split,
        sel, sel_perm)
    ref = jax_cli_inv.select_inversion_targets(
        'shapenet_cars', dataset_config, True, False, split, split, split,
        sel, sel_perm)
    assert got.keys() == ref.keys()
    np.testing.assert_array_equal(got['target_img_random'],
                                  split.images[sel_perm])
    for key in got:
        for x, y in zip(np.atleast_1d(np.asarray(got[key], object)),
                        np.atleast_1d(np.asarray(ref[key], object))):
            assert (x is None) == (y is None), key
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=key)


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp('shapenet')
    fixtures.write_shapenet(str(root / 'data'), 'cars', 1, 1, 4, TEST_VIEWS,
                            size=64, seed=1)
    cfg = gan.GANConfig(resolution=32, latent_dim=512, attention_values=4,
                        plane_resolution=32, scene_range=0.55,
                        white_background=True, camera_flipped=False)
    state = gan.init_train_state(cfg, device='cpu', seed=3)
    with torch.no_grad():
        # A thin field inside the box: see the module's docstring.
        state.gen.decoder.net[2].bias[0] += 0.5
        state.gen_ema.load_state_dict(state.gen.state_dict())
    checkpoint.save(checkpoint.gan_checkpoint(state), str(root / 'gan.pth'))
    enc_sd = convert.random_encoder_state_dict(2)
    enc_sd['post.4.bias'][3] += 8.0  # masks past PnP's 0.9 cut
    torch.save({k: torch.from_numpy(v) for k, v in enc_sd.items()},
               str(root / 'enc.pth'))
    save_npz_variables(torch_convert.convert_bootstrap_encoder(enc_sd),
                       str(root / 'enc.npz'))
    vgg, lin = convert.random_lpips_state_dicts(1)
    (root / 'weights_port').mkdir()
    for name, sd in (('vgg16.pth', vgg), ('lpips_lins.pth', lin)):
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   str(root / 'weights_port' / name))
    save_npz_variables(torch_convert.convert_lpips(vgg, lin),
                       str(root / 'weights_jax' / 'lpips.npz'))
    yield root
    shutil.rmtree(root, ignore_errors=True)


def _run(assets, monkeypatch, tag, extra, side):
    """The inversion CLI of `side` ('port' or 'jax') on the fixture;
    returns (the port CLI's output or None, the report)."""
    monkeypatch.chdir(assets)
    root = f'{side}_{tag}'
    cli_base._weights_into(assets, root, side, False)
    argv = KNOBS + ['--resume_from', 'gan.pth', '--data_path', 'data',
                    '--root_path', root] + extra
    if side == 'port':
        out = cli_run.main(argv + ['--coord_resume_from', 'enc.pth'],
                           device='cpu')
    else:
        out = None
        jax_cli.main(argv + ['--coord_resume_from', 'enc.npz',
                             '--use_pallas', '0'])
    cfg_string = 'i_test_joint_nooptpose_{}_gain5_split'.format(
        'l1' if '--inv_loss' in extra else 'vgg')
    return out, dict(np.load(os.path.join(root, 'reports', 'gan.pth',
                                          cfg_string, 'report.npz')))


def _compare_params(port, ref, step):
    for key in ('ws', 'R', 's', 't2', 'z0'):
        assert port[f'{step}/{key}'].shape[0] == TEST_VIEWS, key
        np.testing.assert_allclose(port[f'{step}/{key}'],
                                   ref[f'{step}/{key}'], rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)


STEPS_FLAGS = ['--inv_steps', '2', '--inv_loss', 'l1']


@pytest.fixture(scope='module')
def two_steps(assets):
    with pytest.MonkeyPatch.context() as mp:
        return _run(assets, mp, 'steps', STEPS_FLAGS, 'port')


@pytest.fixture(scope='module')
def encoder_only(assets):
    with pytest.MonkeyPatch.context() as mp:
        return _run(assets, mp, 'enc', ['--inv_encoder_only'], 'port')


def test_inversion_cli_runs(two_steps):
    """The port's CLI alone (two l1 steps): the test-set protocol's report
    rows at steps 0 and 2, with the novel views and without IoU,
    finite."""
    out, port = two_steps
    assert os.path.basename(out['report_dir']) == (
        'i_test_joint_nooptpose_l1_gain5_split')
    assert sum(b['images'] for b in out['batches']) == TEST_VIEWS
    assert not any('iou' in key for key in port)
    for step in (0, 2):
        for key in ('ws', 'R', 's', 't2', 'z0', 'psnr', 'ssim', 'lpips',
                    'psnr_random', 'ssim_random', 'lpips_random'):
            assert port[f'{step}/{key}'].shape[0] == TEST_VIEWS, key
            assert np.all(np.isfinite(port[f'{step}/{key}'])), key


@pytest.mark.slow
@pytest.mark.parity
def test_inversion_cli_matches_jax_encoder_only(assets, monkeypatch,
                                                encoder_only):
    """JAX's CLI takes 45 s alone, about two minutes beside other test
    processes."""
    port = encoder_only[1]
    ref = _run(assets, monkeypatch, 'enc', ['--inv_encoder_only'], 'jax')[1]
    assert sorted(port) == sorted(ref)
    _compare_params(port, ref, 0)
    gaps = {name: cli_base._rel(port[f'0/{name}'], ref[f'0/{name}'])
            for key in METRIC_RTOL
            for name in (key, f'{key}_avg', f'{key}_random',
                         f'{key}_random_avg')}
    over = {name: gap for name, gap in gaps.items()
            if gap > METRIC_RTOL[name.split('_')[0]]}
    assert not over, gaps


def _assert_pose_frozen(report):
    for key in ('s', 't2', 'z0'):
        np.testing.assert_array_equal(report[f'2/{key}'], report[f'0/{key}'],
                                      err_msg=key)
    # Each step projects R onto the unit quaternions, as JAX's does: the
    # renormalization moves an entry by up to a float32 place.
    np.testing.assert_allclose(report['2/R'], report['0/R'], rtol=0,
                               atol=R_PROJECT_ATOL)
    assert np.abs(report['2/ws'] - report['0/ws']).max() > 0


def test_pose_frozen_through_two_steps(two_steps):
    _assert_pose_frozen(two_steps[1])


@pytest.mark.slow
@pytest.mark.parity
def test_two_steps_match_jax(assets, monkeypatch, two_steps):
    """JAX compiles its CLI's l1 steps: about 70 s beside the port's."""
    port = two_steps[1]
    ref = _run(assets, monkeypatch, 'steps', STEPS_FLAGS, 'jax')[1]
    _assert_pose_frozen(ref)
    _compare_params(port, ref, 0)
    gap = np.abs(port['2/ws'] - ref['2/ws']) / LR_GAIN_Z
    assert gap.max() <= Z_STEP_ATOL, gap.max()
    assert (gap <= PARAM_ATOL).mean() >= Z_SHARE, (gap <= PARAM_ATOL).mean()


@pytest.fixture(scope='module')
def steps():
    return harness.run_mode('shapenet_cars')


def test_g_and_d_steps_match_jax(steps):
    checked = harness.check_metrics(steps)
    assert {(0, 'loss_g'), (1, 'loss_d_fake'), (1, 'loss_r1')} <= set(
        checked)
    assert not steps['cfg'].supervise_alpha
    assert steps['cfg'].augment_p_max == 0.0


def test_parameters_after_steps_match_jax(steps):
    harness.check_params(steps)
