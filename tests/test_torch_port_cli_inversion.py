"""The slice as a whole: the port's inversion CLI (`cli.run.main`) against
the JAX package's, on p3d_car fixtures on disk, and the port's batch loop.

Both CLIs read the same files: the fixture's train split and car_val.mat
test split (`data/fixtures.py`), one reference-format GAN checkpoint
(`--resume_from gan.pth`: the full-width generator at tiny resolution,
latent 512, 32^2 planes, four attention values, EMA = G), one random
MiT-B5 encoder file (the port reads the `.pth`, JAX its own converter's
`.npz`) and random LPIPS (and, for FID, Inception) weights (the port
reads the published file names under `weights/`, JAX its converters'
`.npz`). Flags: --resolution 32 --depth_samples_per_ray 4
--compute_dtype float32 --mesh_shape data:1 (JAX also --use_pallas 0),
--inv_encoder_only, 10 test images (a batch of 8 and a straggler of 2).
--inv_encoder_only draws no crops, so the reports compare entry by entry:
ws, R, s, t2 and z0 within 1e-4; each image metric within its own
relative limit, about three to four times its measured gap (ROADMAP C:
psnr 3.2e-4, lpips 1.2e-3, ssim 2.4e-3), and iou within 2e-2 (gap
1.6e-2), the evaluation renders' tolerance of
`test_torch_port_pipeline.py`; fid_front and fid_random (and their _test
forms) within 1e-3 relative. The render in p3d_car's geometry (the
field's box is the render's) is not reproducible below that even in
JAX: its jitted evaluation render and the same render run eagerly part
by up to 0.067 on the mask (ROADMAP C, `probes/cli_render_witness.py`),
and the IoU counts pixels past 0.5. With FID the four 2048^2 `sqrtm`s of
each side take minutes on the CPU, so that case is `slow`; the quick case
runs without the Inception file (FID off on both sides, as both CLIs do
without it).

The port's own batch loop (the overlap of PnP with the steps, the
resume from a report checkpoint, the logs) is held in
`test_torch_port_cli_overlap.py`, which takes this file's fixture. The
encoder's load-or-train branch runs with small step counts. Unported
branches raise; the other datasets' generator features reach the run.
"""

import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

from nerf_from_image_tpu.cli import inversion as jax_cli_inv
from nerf_from_image_tpu.cli import run as jax_cli
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu.utils.weights import save_npz_variables
from nerf_from_image_tpu_torch import config
from nerf_from_image_tpu_torch.cli import inversion as cli_inv
from nerf_from_image_tpu_torch.cli import run as cli_run
from nerf_from_image_tpu_torch.cli import train_encoder as cli_train_encoder
from nerf_from_image_tpu_torch.data import fixtures
from nerf_from_image_tpu_torch.data import loaders
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import checkpoint
from nerf_from_image_tpu_torch.utils import convert

KNOBS = ['--dataset', 'p3d_car', '--run_inversion', '--resolution', '32',
         '--latent_dim', '512', '--attention_values', '4',
         '--plane_resolution', '32', '--depth_samples_per_ray', '4',
         '--compute_dtype', 'float32', '--mesh_shape', 'data:1']
TINY = dict(depths=(1, 1, 1, 1), embed_dims=(8, 8, 16, 16),
            num_heads=(1, 1, 2, 2), sr_ratios=(2, 1, 1, 1), head_width=16)
PARAM_ATOL = 1e-4
METRIC_RTOL = {'psnr': 1e-3, 'lpips': 5e-3, 'ssim': 1e-2, 'iou': 2e-2}
FID_RTOL = 1e-3
CFG_STRING = 'i_test_joint_optpose_vgg_gain5_split'


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp('cli')
    for name, n_test in (('data10', 10), ('data16', 16)):
        fixtures.write_p3d_car(str(root / name), n_train=16, n_test=n_test,
                               size=(48, 40), seed=n_test)
    cfg = gan.GANConfig(resolution=32, latent_dim=512, attention_values=4,
                        plane_resolution=32)
    state = gan.init_train_state(cfg, device='cpu', seed=3)
    with torch.no_grad():
        # A fresh decoder's SDF is above 0 everywhere; put a surface in.
        state.gen.decoder.net[2].bias[0] -= 1.5
        state.gen_ema.load_state_dict(state.gen.state_dict())
    checkpoint.save(checkpoint.gan_checkpoint(state), str(root / 'gan.pth'))

    enc_sd = convert.random_encoder_state_dict(2)
    enc_sd['post.4.bias'][3] += 8.0  # masks past PnP's 0.9 cut
    torch.save({k: torch.from_numpy(v) for k, v in enc_sd.items()},
               str(root / 'enc.pth'))
    save_npz_variables(torch_convert.convert_bootstrap_encoder(enc_sd),
                       str(root / 'enc.npz'))
    vgg, lin = convert.random_lpips_state_dicts(1)
    inc = convert.random_inception_state_dict(0)
    weights_files = {'vgg16.pth': vgg, 'lpips_lins.pth': lin,
                     'pt_inception.pth': inc}
    for name, sd in weights_files.items():
        path = root / 'weights_port' / name
        path.parent.mkdir(exist_ok=True)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    save_npz_variables(torch_convert.convert_lpips(vgg, lin),
                       str(root / 'weights_jax' / 'lpips.npz'))
    save_npz_variables(torch_convert.convert_inception(inc),
                       str(root / 'weights_jax' / 'inception.npz'))
    yield root
    # The module's runs write checkpoints of hundreds of MB here.
    shutil.rmtree(root, ignore_errors=True)


def _weights_into(assets, root, kind, with_fid):
    """Copies the LPIPS (and with FID the Inception) files of one side
    into `root`/weights."""
    names = {'port': ['vgg16.pth', 'lpips_lins.pth', 'pt_inception.pth'],
             'jax': ['lpips.npz', 'inception.npz']}[kind]
    os.makedirs(os.path.join(root, 'weights'))
    for name in names[:None if with_fid else -1]:
        shutil.copy(os.path.join(assets, f'weights_{kind}', name),
                    os.path.join(root, 'weights', name))


def _report(root):
    path = os.path.join(root, 'reports', 'gan.pth', CFG_STRING,
                        'report.npz')
    return dict(np.load(path))


def _run_both(assets, monkeypatch, with_fid):
    monkeypatch.chdir(assets)
    common = KNOBS + ['--resume_from', 'gan.pth', '--data_path',
                      str(assets / 'data10'), '--inv_encoder_only']
    port_root = str(assets / f'port_fid{with_fid}')
    jax_root = str(assets / f'jax_fid{with_fid}')
    _weights_into(assets, port_root, 'port', with_fid)
    _weights_into(assets, jax_root, 'jax', with_fid)
    out = cli_run.main(common + ['--root_path', port_root,
                                 '--coord_resume_from',
                                 str(assets / 'enc.pth')], device='cpu')
    jax_cli.main(common + ['--root_path', jax_root, '--coord_resume_from',
                           str(assets / 'enc.npz'), '--use_pallas', '0'])
    return out, _report(port_root), _report(jax_root)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30)


def _compare_reports(port, ref):
    for key in ('ws', 'R', 's', 't2', 'z0'):
        assert port[f'0/{key}'].shape[0] == 10, key
        np.testing.assert_allclose(port[f'0/{key}'], ref[f'0/{key}'],
                                   rtol=0, atol=PARAM_ATOL, err_msg=key)
    for key in ('psnr', 'ssim', 'lpips', 'iou'):
        assert port[f'0/{key}'].shape == (10,), key
        for name in (key, f'{key}_avg'):
            gap = _rel(port[f'0/{name}'], ref[f'0/{name}'])
            assert gap <= METRIC_RTOL[key], (name, gap)
    assert '0/rot_error' not in port and '0/rot_error' not in ref


def test_cli_matches_jax_encoder_only(assets, monkeypatch):
    out, port, ref = _run_both(assets, monkeypatch, with_fid=False)
    assert sorted(port) == sorted(ref)
    _compare_reports(port, ref)
    assert [b['images'] for b in out['batches']] == [8, 2]
    assert [b['serial'] for b in out['batches']] == [True, False]
    assert 'fid_front' not in out['report'][0]


@pytest.mark.slow
@pytest.mark.parity
def test_cli_matches_jax_with_fid(assets, monkeypatch):
    _, port, ref = _run_both(assets, monkeypatch, with_fid=True)
    assert sorted(port) == sorted(ref)
    _compare_reports(port, ref)
    for key in ('fid_front', 'fid_random', 'fid_front_test',
                'fid_random_test'):
        assert np.isfinite(port[f'0/{key}'])
        assert _rel(port[f'0/{key}'], ref[f'0/{key}']) <= FID_RTOL, key


def _splits(data):
    args = config.parse_args(KNOBS + ['--data_path', data])
    return loaders.load_dataset(args)


def test_eval_indices_and_targets_match_jax(assets):
    dataset_config, train, train_eval, test = _splits(str(assets / 'data16'))
    for vpo in (1, 3):
        for n_max in (100, 5):
            a = loaders.DatasetSplit(images=np.zeros((12, 1)))
            b = loaders.DatasetSplit(images=np.zeros((12, 1)))
            cli_inv.build_eval_indices(a, n_max, vpo,
                                       np.random.RandomState(7))
            jax_cli_inv.build_eval_indices(b, n_max, vpo,
                                           np.random.RandomState(7))
            np.testing.assert_array_equal(a.eval_indices, b.eval_indices)
            np.testing.assert_array_equal(a.eval_indices_perm,
                                          b.eval_indices_perm)
    sel, sel_perm = np.array([3, 1, 4, 1]), np.array([5, 9, 2, 6])
    for use_testset in (True, False):
        got = cli_inv.select_inversion_targets(
            'p3d_car', dataset_config, use_testset, False, train,
            train_eval, test, sel, sel_perm)
        ref = jax_cli_inv.select_inversion_targets(
            'p3d_car', dataset_config, use_testset, False, train,
            train_eval, test, sel, sel_perm)
        assert got.keys() == ref.keys()
        for key in got:
            for a, b in zip(np.atleast_1d(np.asarray(got[key], object)),
                            np.atleast_1d(np.asarray(ref[key], object))):
                assert (a is None) == (b is None), key
                if a is not None:
                    np.testing.assert_array_equal(a, b, err_msg=key)


def _scalars(report_dir):
    with open(os.path.join(report_dir, 'scalars.jsonl')) as f:
        return [json.loads(line) for line in f]


def test_encoder_load_or_train(assets, monkeypatch, capsys):
    """No encoder file: the CLI distills one (here a tiny SegFormer for 3
    steps, a log every step, enc_latest every 2 and enc_<i> every 2) and
    stops under --inv_train_coord_only; a second run resumes from
    enc_latest with its host state and draws the steps an uninterrupted
    run draws; the label form of --coord_resume_from then loads it."""
    monkeypatch.chdir(assets)
    argv = KNOBS + ['--resume_from', 'gan.pth', '--data_path',
                    str(assets / 'data10'), '--batch_size', '4',
                    '--inv_train_coord_only']
    # A tiny SegFormer: MiT-B5's checkpoints with Adam's moments are 1.1 GB.
    tiny = functools.partial(BootstrapEncoder, **TINY)
    monkeypatch.setattr(cli_train_encoder, 'BootstrapEncoder', tiny)
    monkeypatch.setattr(cli_inv, 'BootstrapEncoder', tiny)
    for name, value in (('LOG_EVERY', 1), ('SAVE_EVERY', 2),
                        ('KEEP_EVERY', 2)):
        monkeypatch.setattr(cli_train_encoder, name, value)

    def run(root, max_iters):
        monkeypatch.setattr(cli_train_encoder, 'MAX_ITERS', max_iters)
        assert cli_run.main(argv + ['--root_path', root],
                            device='cpu') is None
        return {s['step']: s['value'] for s in _scalars(os.path.join(
            root, 'reports', 'gan.pth', CFG_STRING))
            if s['tag'] == 'coord_regressor/loss_coords'}

    straight = run(str(assets / 'enc_a'), 3)
    assert sorted(straight) == [1, 2, 3]
    coords_dir = assets / 'enc_a' / 'coords_checkpoints' / 'gan.pth'
    assert sorted(os.listdir(coords_dir)) == [
        'checkpoint_enc_2.pth', 'checkpoint_enc_latest.pth']
    assert checkpoint.load(str(coords_dir / 'checkpoint_enc_latest.pth'))[
        'iteration'] == 3

    run(str(assets / 'enc_b'), 2)
    resumed = run(str(assets / 'enc_b'), 3)
    assert 'Resumed encoder from iteration 2' in capsys.readouterr().out
    assert resumed[3] == straight[3]

    encoder = cli_inv.load_encoder(
        config.parse_args(['--coord_resume_from', 'enc_latest']),
        str(coords_dir), torch.device('cpu'))
    saved = checkpoint.load(str(coords_dir / 'checkpoint_enc_latest.pth'))
    for key, value in encoder.state_dict().items():
        assert torch.equal(value, saved['state_dict'][key]), key
    with pytest.raises(ValueError, match='npz'):
        cli_inv.load_encoder(config.parse_args(
            ['--coord_resume_from', 'enc.npz']), str(coords_dir),
            torch.device('cpu'))


@pytest.mark.parametrize('extra,match', [
    (['--run_inversion', '--mesh_shape', 'data:2'], 'several cards'),
    (['--run_inversion', '--multihost'], 'several cards'),
    # GAN training's flag-only modes are ported: only several cards are
    # refused.
    (['--run_inversion', '--mesh_shape', 'data:4'], 'several cards'),
    (['--run_inversion', '--mesh_shape', 'data:1,rays:2'], 'several cards'),
    (['--run_inversion', '--multihost', '--use_encoder'], 'several cards'),
])
def test_unported_branches_raise(extra, match):
    with pytest.raises(NotImplementedError, match=match):
        cli_run.main(['--dataset', 'p3d_car'] + extra, device='cpu')


@pytest.mark.parametrize('dataset,extra', [
    ('cub', ['--run_inversion']),  # StyleGAN noise, orthographic cameras
    ('imagenet_elephant', ['--run_inversion']),  # StyleGAN noise
    ('carla', ['--run_inversion']),  # view directions
    ('cub', []),
    ('imagenet_elephant', []),
    ('carla', []),
], ids=['cub', 'imagenet_elephant', 'carla', 'cub-training',
        'imagenet_elephant-training', 'carla-training'])
def test_dataset_features_reach_the_run(dataset, extra, monkeypatch):
    """The other datasets' generator features pass the CLI's checks: the CLI
    goes on to load the dataset (which the test replaces), for the
    inversion and for training."""
    class Reached(Exception):
        pass

    def stop(args, manual_image=None):
        assert args.dataset == dataset
        raise Reached

    monkeypatch.setattr(cli_run.loaders, 'load_dataset', stop)
    with pytest.raises(Reached):
        cli_run.main(['--dataset', dataset] + extra, device='cpu')
