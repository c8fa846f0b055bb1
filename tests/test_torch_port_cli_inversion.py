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

The port's own loop, at --inv_steps 2 over 16 images: the second batch,
whose PnP ran on the worker thread while the first batch's steps were
queued, equals a serial `bootstrap_batch` + `evaluate_checkpoint` of the
same images exactly; a run resumed from a report checkpoint at image 8
ends with the uninterrupted run's report exactly; the `monitor_b0/*` and
`report/*` scalars land in scalars.jsonl. The encoder's load-or-train
branch runs with small step counts. Unported branches raise.
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
from nerf_from_image_tpu_torch.invert import optimizer as inv_opt
from nerf_from_image_tpu_torch.invert import pipeline as pipe
from nerf_from_image_tpu_torch.invert import pnp
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import checkpoint
from nerf_from_image_tpu_torch.utils import convert
from nerf_from_image_tpu_torch.utils import weights

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
    return root


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


def test_loop_overlap_resume_and_logs(assets, monkeypatch):
    monkeypatch.chdir(assets)
    argv = KNOBS + ['--resume_from', 'gan.pth', '--data_path',
                    str(assets / 'data16'), '--coord_resume_from',
                    str(assets / 'enc.pth'), '--inv_steps', '2']
    kept = {}
    save = pipe.save_report_checkpoint

    def keep_at_8(path, report, idx, key):
        save(path, report, idx, key)
        if idx == 8:
            kept['path'] = path + '.at8'
            shutil.copy(path, kept['path'])

    monkeypatch.setattr(pipe, 'save_report_checkpoint', keep_at_8)
    monkeypatch.setattr(cli_inv, 'REPORT_CHECKPOINT_EVERY', 8)
    first_root = str(assets / 'loop_a')
    out = cli_run.main(argv + ['--root_path', first_root], device='cpu')
    assert [b['images'] for b in out['batches']] == [8, 8]
    assert [b['serial'] for b in out['batches']] == [True, False]
    assert out['batches'][1]['pnp_wait_s'] >= 0
    for key in ('encoder_ms', 'evaluation 0_ms', 'steps_ms',
                'evaluation 2_ms'):
        assert all(b[key] > 0 for b in out['batches']), key

    tags = {s['tag'] for s in _scalars(out['report_dir'])}
    for pname in ('psnr', 'lpips', 'rot_error', 'grad_norm_z',
                  'grad_norm_R', 'grad_norm_s', 'grad_norm_t',
                  'grad_norm_f'):
        assert f'monitor_b0/{pname}' in tags, pname
    for name in ('psnr', 'ssim', 'lpips', 'iou'):
        assert f'report/{name}' in tags, name
    monitor = [s for s in _scalars(out['report_dir'])
               if s['tag'] == 'monitor_b0/psnr']
    assert [s['step'] for s in monitor] == [0, 1]

    # The second batch's step-0 entries against the serial path.
    dataset_config, train, train_eval, test = _splits(str(assets / 'data16'))
    rng = np.random.RandomState(1234)
    cli_inv.build_eval_indices(train_eval, 8000, 1, rng)
    cli_inv.build_eval_indices(test, 8000, 1, rng)
    tsel = cli_inv.select_inversion_targets(
        'p3d_car', dataset_config, True, False, train, train_eval, test,
        test.eval_indices[8:16], test.eval_indices_perm[8:16])
    t = {k: None if v is None else torch.as_tensor(
        np.ascontiguousarray(v), dtype=torch.float32)
        for k, v in tsel.items() if k != 'perm_cameras'}
    perm = tuple(None if v is None else torch.as_tensor(v)
                 for v in tsel['perm_cameras'])
    cfg = gan.GANConfig(resolution=32, latent_dim=512, attention_values=4,
                        plane_resolution=32, scene_range=1.4)
    gen, _ = gan.make_models(cfg, device='cpu')
    convert.load_reference_state_dict(
        gen, checkpoint.load(str(assets / 'gan.pth'))['model_ema'])
    encoder = BootstrapEncoder(512, device='cpu').eval()
    encoder.load_state_dict(checkpoint.encoder_state_dict(
        checkpoint.load(str(assets / 'enc.pth'))))
    with torch.no_grad():
        z_avg = gen.average_w(torch.Generator().manual_seed(1234), 10000)
    _, _, z_init, cam2world, focal, _ = pipe.bootstrap_batch(
        encoder, t['target_img'], pnp.get_focal_guesses(train.focal_length),
        z_avg, 5.0)
    params = pipe.init_inversion_params(z_init, cam2world, focal, True)
    inv_cfg = inv_opt.InversionConfig(
        resolution=32, depth_samples_per_ray=4, scene_range=1.4,
        white_background=False, camera_flipped=True)
    entry = pipe.make_report([0])[0]
    pipe.evaluate_checkpoint(
        pipe.EvalContext(gen=gen, lpips=weights.load_lpips(first_root,
                                                            'cpu'),
                         has_mask=True), inv_cfg, params, entry,
        t['target_img_fid'], None, None, t['gt_cam2world'],
        perm_cameras=perm, compute_rot_error=False)
    for key, values in entry.items():
        if values:
            np.testing.assert_array_equal(out['report'][0][key][8:],
                                          values[0], err_msg=key)

    # Resumed at image 8 from the report checkpoint: the same report.
    second_root = str(assets / 'loop_b')
    report_dir = os.path.join(second_root, 'reports', 'gan.pth', CFG_STRING)
    os.makedirs(report_dir)
    shutil.copy(kept['path'],
                os.path.join(report_dir, 'report_checkpoint.npz'))
    resumed = cli_run.main(argv + ['--root_path', second_root],
                           device='cpu')
    assert [b['images'] for b in resumed['batches']] == [8]
    assert resumed['report'].keys() == out['report'].keys()
    for step, entry in out['report'].items():
        assert resumed['report'][step].keys() == entry.keys()
        for key, value in entry.items():
            np.testing.assert_array_equal(resumed['report'][step][key],
                                          value, err_msg=f'{step}/{key}')
    assert not any(s['tag'].startswith('monitor_b0')
                   for s in _scalars(resumed['report_dir']))


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
    ([], 'GAN-training CLI'),
    (['--run_inversion', '--inv_export_demo_sample'], 'the demo'),
    (['--inv_manual_input_path', 'x.png'], 'the demo'),
    (['--run_inversion', '--mesh_shape', 'data:2'], 'several cards'),
    (['--run_inversion', '--multihost'], 'several cards'),
    (['--run_inversion', '--perturb_poses', '0.1'], 'flag-only modes'),
    (['--run_inversion', '--use_encoder'], 'flag-only modes'),
    (['--run_inversion', '--attention_values', '0'], 'flag-only modes'),
])
def test_unported_branches_raise(extra, match):
    with pytest.raises(NotImplementedError, match=match):
        cli_run.main(['--dataset', 'p3d_car'] + extra, device='cpu')


@pytest.mark.parametrize('dataset,match', [
    ('cub', 'generator features'),  # StyleGAN noise, then orthographic cameras
    ('imagenet_elephant', 'generator features'),  # StyleGAN noise
    ('carla', 'generator features'),  # view directions
])
def test_unported_dataset_features_raise(dataset, match):
    with pytest.raises(NotImplementedError, match=match):
        cli_run.main(['--dataset', dataset, '--run_inversion'],
                     device='cpu')


def test_float32_on_the_card_is_refused(monkeypatch):
    """The kernels take bfloat16 planes, so the card's CLI refuses
    --compute_dtype float32 before any work (ROADMAP C)."""
    monkeypatch.setattr(cli_run, 'resolve_device',
                        lambda device: torch.device('cuda'))
    with pytest.raises(NotImplementedError, match='float32 on the card'):
        cli_run.main(['--dataset', 'p3d_car', '--run_inversion',
                      '--compute_dtype', 'float32'])
