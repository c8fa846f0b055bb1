"""The ImageNet datasets (imagenet_car, _airplane, _motorcycle, _zebra,
_elephant) through the port against the JAX package, and FID's resize of
images above 299^2.

- `load_dataset` on `fixtures.write_imagenet` files (JPEG images, which
  the port reads through PIL and JAX through cv2; the detections and the
  multi-template poses), with and without --run_inversion and
  --use_encoder: every array of every split within SPLIT_ATOL. ImageNet
  has no test split; under ADA the train split carries the 2x images.
- The inversion CLI, encoder only, on imagenet_car and imagenet_elephant
  fixtures (8 images of 48 x 40): ImageNet's train-split protocol
  (optimized on the uncropped image, evaluated against the train-eval
  split's bbox crop). The parameters within PARAM_ATOL; the image
  metrics within `test_torch_port_cli_inversion.py`'s limits. The
  checkpoint's SDF is raised by 0.5, a thin field inside the box whose
  masks stay below the IoU's cut (the IoU compares empty masks): with a
  surface on the faces of the field's box (1.4, the render's) one
  image's iou parts by 2.1e-2 and its psnr by 1.4e-3, where JAX's jitted
  and eager renders part as far (ROADMAP C,
  `probes/cli_render_witness.py`). Elephant's checkpoint has StyleGAN
  noise: its renders take the 'const' noise on both sides, as cub's do.
  Beside other test processes each JAX CLI takes about two minutes, so
  the comparisons are `slow` and `parity`; the gate keeps both
  datasets' CLIs in the port alone, their report rows finite.
- One G step and one D step with R1 of imagenet_car's training
  configuration (ADA on the 2x real images, the mask as D's fourth
  channel) against JAX's, at `tests/torch_port_flag_steps.py`'s limits.
- `resize_bilinear` against `jax.image.resize` from 300^2, 384^2 and
  512^2 down to 299^2 (antialiased) within RESIZE_ATOL, and the
  InceptionV3 on a 512^2 image against JAX's within 1e-4 of its largest
  activation (`test_torch_port_fid.py`'s limit).
"""

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_cli_datasets as datasets_base
import test_torch_port_cli_inversion as cli_base
import torch_port_flag_steps as harness
from nerf_from_image_tpu import config as jax_config
from nerf_from_image_tpu.cli import run as jax_cli
from nerf_from_image_tpu.data import loaders as jax_loaders
from nerf_from_image_tpu.models.inception import \
    InceptionV3FID as JaxInceptionV3FID
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu.utils.weights import save_npz_variables
from nerf_from_image_tpu_torch import config
from nerf_from_image_tpu_torch.cli import run as cli_run
from nerf_from_image_tpu_torch.data import fixtures
from nerf_from_image_tpu_torch.data import loaders
from nerf_from_image_tpu_torch.models.inception import InceptionV3FID
from nerf_from_image_tpu_torch.models.inception import resize_bilinear
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import checkpoint
from nerf_from_image_tpu_torch.utils import convert

DATASETS = ('imagenet_car', 'imagenet_airplane', 'imagenet_motorcycle',
            'imagenet_zebra', 'imagenet_elephant')
SPLIT_ATOL = 1e-6
PARAM_ATOL = cli_base.PARAM_ATOL
METRIC_RTOL = cli_base.METRIC_RTOL
RESIZE_ATOL = 1e-5
INCEPTION_RTOL = 1e-4
IMAGES = 8
KNOBS = ['--run_inversion', '--resolution', '32', '--latent_dim', '512',
         '--attention_values', '4', '--plane_resolution', '32',
         '--depth_samples_per_ray', '4', '--compute_dtype', 'float32',
         '--mesh_shape', 'data:1', '--batch_size', '16',
         '--inv_encoder_only']


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('extra', [[], ['--run_inversion'],
                                   ['--use_encoder']],
                         ids=['train', 'inversion', 'encoder'])
@pytest.mark.parametrize('dataset', DATASETS)
def test_load_dataset_matches_jax(tmp_path, dataset, extra):
    fixtures.write_imagenet(str(tmp_path), dataset, 3, (48, 40),
                            seed=len(dataset))
    argv = ['--dataset', dataset, '--data_path', str(tmp_path),
            '--resolution', '32'] + extra
    got = loaders.load_dataset(config.parse_args(argv))
    ref = jax_loaders.load_dataset(jax_config.parse_args(argv))
    assert got[0] == ref[0]
    for g, r in zip(got[1:], ref[1:]):
        _assert_splits_equal(g, r)
    train, train_eval, test = got[1:]
    assert test is None
    # Mirrored train views at 2x under ADA; the bbox-cropped train-eval.
    assert train.images_highres.shape == (6, 64, 64, 4)
    assert train.images.shape == (6, 32, 32, 4)
    assert train.bbox is None and train_eval.bbox.shape == (3, 2, 2)


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


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp('imagenet')
    for seed, dataset in enumerate(('imagenet_car', 'imagenet_elephant')):
        fixtures.write_imagenet(str(root / 'data'), dataset, IMAGES,
                                (48, 40), seed=seed)
        cfg = gan.GANConfig(resolution=32, latent_dim=512,
                            attention_values=4, plane_resolution=32,
                            use_stylegan_noise=dataset == 'imagenet_elephant')
        state = gan.init_train_state(cfg, device='cpu', seed=3)
        rng = np.random.default_rng(4)
        with torch.no_grad():
            # A thin field inside the box: see the module's docstring.
            state.gen.decoder.net[2].bias[0] += 0.5
            for name, p in state.gen.named_parameters():
                if name.endswith('noise_strength'):
                    p.fill_(float(rng.standard_normal() * 0.1))
            state.gen_ema.load_state_dict(state.gen.state_dict())
        checkpoint.save(checkpoint.gan_checkpoint(state),
                        str(root / f'gan_{dataset}.pth'))
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


CFG_STRING = 'i_train_joint_optpose_vgg_gain5_split'


def _run_port(assets, monkeypatch, dataset, tag):
    """The port's inversion CLI on `dataset`'s fixture: checks its batches
    and report rows and returns the report."""
    monkeypatch.chdir(assets)
    root = f'port_{dataset}_{tag}'
    cli_base._weights_into(assets, root, 'port', False)
    out = cli_run.main(['--dataset', dataset] + KNOBS + [
        '--resume_from', f'gan_{dataset}.pth', '--data_path', 'data',
        '--root_path', root, '--coord_resume_from', 'enc.pth'],
        device='cpu')
    assert out['report_dir'].endswith(CFG_STRING)
    # The train-eval split (unmirrored) is the evaluation set.
    assert sum(b['images'] for b in out['batches']) == IMAGES
    report = datasets_base._report(root, f'gan_{dataset}.pth', CFG_STRING)
    assert '0/iou' in report and '0/psnr_random' not in report
    for key in ('ws', 'R', 's', 't2', 'z0', 'psnr', 'ssim', 'lpips', 'iou'):
        assert report[f'0/{key}'].shape[0] == IMAGES, key
        assert np.all(np.isfinite(report[f'0/{key}'])), key
    return report


@pytest.fixture(scope='module')
def port_reports(assets):
    """Each dataset's report of the port's CLI, run once."""
    reports = {}

    def get(dataset):
        if dataset not in reports:
            with pytest.MonkeyPatch.context() as mp:
                reports[dataset] = _run_port(assets, mp, dataset, 'port')
        return reports[dataset]

    return get


@pytest.mark.parametrize('dataset', ['imagenet_car', 'imagenet_elephant'])
def test_inversion_cli_runs(port_reports, dataset):
    """The port's CLI alone: the train-split protocol's report rows with
    IoU and without novel views, finite."""
    port_reports(dataset)


@pytest.mark.slow
@pytest.mark.parity
@pytest.mark.parametrize('dataset', ['imagenet_car', 'imagenet_elephant'])
def test_inversion_cli_matches_jax_encoder_only(assets, monkeypatch,
                                                port_reports, dataset):
    port = port_reports(dataset)
    monkeypatch.chdir(assets)
    jax_root = f'jax_{dataset}'
    cli_base._weights_into(assets, jax_root, 'jax', False)
    jax_cli.main(['--dataset', dataset] + KNOBS + [
        '--resume_from', f'gan_{dataset}.pth', '--data_path', 'data',
        '--root_path', jax_root, '--coord_resume_from', 'enc.npz',
        '--use_pallas', '0'])
    ref = datasets_base._report(jax_root, f'gan_{dataset}.pth', CFG_STRING)
    assert sorted(port) == sorted(ref)
    for key in ('ws', 'R', 's', 't2', 'z0'):
        np.testing.assert_allclose(port[f'0/{key}'], ref[f'0/{key}'],
                                   rtol=0, atol=PARAM_ATOL, err_msg=key)
    gaps = {name: cli_base._rel(port[f'0/{name}'], ref[f'0/{name}'])
            for key in METRIC_RTOL for name in (key, f'{key}_avg')}
    over = {name: gap for name, gap in gaps.items()
            if gap > METRIC_RTOL[name.replace('_avg', '')]}
    assert not over, gaps


@pytest.fixture(scope='module')
def steps():
    return harness.run_mode('imagenet_car')


def test_g_and_d_steps_match_jax(steps):
    checked = harness.check_metrics(steps)
    assert {(0, 'loss_g'), (1, 'loss_d_real'), (1, 'loss_r1')} <= set(
        checked)
    assert steps['cfg'].is_highres and steps['cfg'].supervise_alpha


def test_parameters_after_steps_match_jax(steps):
    harness.check_params(steps)


@pytest.mark.parametrize('size', [300, 384, 512])
def test_resize_down_matches_jax_image_resize(size):
    x = np.random.default_rng(size).random((2, 3, size, size)).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(x).transpose(0, 2, 3, 1),
                           (2, 299, 299, 3), method='bilinear')
    got = resize_bilinear(torch.tensor(x), 299).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=RESIZE_ATOL)


def test_inception_above_299_matches_jax():
    sd = convert.random_inception_state_dict(0)
    port = InceptionV3FID(device='cpu')
    convert.load_inception_state_dict(port, sd)
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       torch_convert.convert_inception(sd))
    apply = jax.jit(functools.partial(JaxInceptionV3FID().apply, variables))
    x = np.random.default_rng(5).random((1, 3, 512, 512)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.tensor(x)).numpy()
    ref = np.asarray(apply(jnp.asarray(x)))
    assert got.shape == ref.shape == (1, 2048)
    assert np.abs(ref).max() > 1.0
    assert cli_base._rel(got, ref) < INCEPTION_RTOL
