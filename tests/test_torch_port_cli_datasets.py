"""The other datasets' generator features through the CLIs: cub (StyleGAN
noise, orthographic cameras) and carla (the view-direction mapper).

- cub's inversion CLI against JAX's on the same files (a `write_cub`
  fixture of 6 train and 4 test images, a reference-format GAN checkpoint
  of the full-width generator with noise at 32^2 planes, the encoder and
  LPIPS files of `test_torch_port_cli_inversion.py`), encoder only (its
  checkpoint renders take the 'const' noise on both sides): ws, R, s, t2
  within 1e-4 (no z0: the camera is orthographic), each image metric and
  the rotation error within that file's limits (psnr within 1e-2, see
  METRIC_RTOL). With FID (the eight 2048^2 `sqrtm`s take minutes on
  the CPU) the same comparison is `slow` and `parity`, the FIDs within
  5e-3 (FID_RTOL). The refinement
  steps of a noise model are not compared through the CLIs: each draws
  fresh noise every step, JAX from its keys and the port from a
  `torch.Generator` (`test_torch_port_noise.py` holds the noise against
  JAX's with injected draws).
- carla's inversion CLI (one refinement step, the rays' directions
  through the mapper): the report's rows finite. JAX's CLI stops at its
  first render of a view-direction generator (ROADMAP C), so the port's
  carla is held against JAX unit by unit (`test_torch_port_viewdir.py`).
- The training CLI on both fixtures (narrowed models, two pretraining
  steps, the narrow Inception stand-in of `test_torch_port_train_cli.py`)
  to iteration 4 with the iteration-3 evaluation: finite scalars, the
  noise model's noise parameters trained, carla's mapper present.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import test_torch_port_cli_inversion as cli_base
from nerf_from_image_tpu.cli import run as jax_cli
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu.utils.weights import save_npz_variables
from nerf_from_image_tpu_torch.cli import run as cli_run
from nerf_from_image_tpu_torch.data import fixtures
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.train import pretrain
from nerf_from_image_tpu_torch.utils import checkpoint
from nerf_from_image_tpu_torch.utils import convert

KNOBS = ['--run_inversion', '--resolution', '32', '--latent_dim', '512',
         '--attention_values', '4', '--plane_resolution', '32',
         '--depth_samples_per_ray', '4', '--compute_dtype', 'float32',
         '--mesh_shape', 'data:1', '--batch_size', '16']
TRAIN_KNOBS = ['--resolution', '16', '--latent_dim', '512',
               '--attention_values', '4', '--plane_resolution', '32',
               '--depth_samples_per_ray', '4', '--batch_size', '4',
               '--compute_dtype', 'float32']
PARAM_ATOL = 1e-4
# The p3d_car CLI test's limits, and psnr at 1e-2: cub's render box is
# its field's (2.0) and every orthographic ray enters through a face of
# it, where the render is not reproducible (ROADMAP C; one image's psnr
# parts by 3.1e-3, the average by 2e-4).
METRIC_RTOL = dict(cli_base.METRIC_RTOL, psnr=1e-2, rot_error=1e-3)
# The FIDs of those renders: fid_front parts by 1.75e-3 (ROADMAP C).
FID_RTOL = 5e-3
CFG_STRING = 'i_test_joint_optpose_vgg_gain5_split'


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Beside other test processes, torch's default of one thread a core
    spins on shared cores; these small tensors run as fast on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp('datasets')
    fixtures.write_cub(str(root / 'data'), n_train=6, n_test=4,
                       size=(48, 40), seed=1)
    fixtures.write_carla(str(root / 'data'), 6, 40, seed=2)
    for name, kw in (('cub', dict(scene_range=2.0,
                                  use_stylegan_noise=True)),
                     ('carla', dict(scene_range=3.0, use_viewdir=True))):
        cfg = gan.GANConfig(resolution=32, latent_dim=512,
                            attention_values=4, plane_resolution=32, **kw)
        state = gan.init_train_state(cfg, device='cpu', seed=3)
        rng = np.random.default_rng(4)
        with torch.no_grad():
            state.gen.decoder.net[2].bias[0] -= 1.5
            for pname, p in state.gen.named_parameters():
                if pname.endswith('noise_strength'):
                    p.fill_(float(rng.standard_normal() * 0.1))
            if cfg.use_viewdir:
                state.gen.viewdir_mapper.output.weight.normal_(
                    generator=torch.Generator().manual_seed(5))
            state.gen_ema.load_state_dict(state.gen.state_dict())
        checkpoint.save(checkpoint.gan_checkpoint(state),
                        str(root / f'gan_{name}.pth'))
    enc_sd = convert.random_encoder_state_dict(2)
    enc_sd['post.4.bias'][3] += 8.0  # masks past PnP's 0.9 cut
    torch.save({k: torch.from_numpy(v) for k, v in enc_sd.items()},
               str(root / 'enc.pth'))
    save_npz_variables(torch_convert.convert_bootstrap_encoder(enc_sd),
                       str(root / 'enc.npz'))
    vgg, lin = convert.random_lpips_state_dicts(1)
    inc = convert.random_inception_state_dict(0)
    for name, sd in (('vgg16.pth', vgg), ('lpips_lins.pth', lin),
                     ('pt_inception.pth', inc)):
        path = root / 'weights_port' / name
        path.parent.mkdir(exist_ok=True)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   str(path))
    save_npz_variables(torch_convert.convert_lpips(vgg, lin),
                       str(root / 'weights_jax' / 'lpips.npz'))
    save_npz_variables(torch_convert.convert_inception(inc),
                       str(root / 'weights_jax' / 'inception.npz'))
    yield root
    # The module's runs write checkpoints of hundreds of MB here.
    shutil.rmtree(root, ignore_errors=True)


def _report(root, name, cfg_string):
    return dict(np.load(os.path.join(root, 'reports', name, cfg_string,
                                     'report.npz')))


def _run_cub(assets, monkeypatch, tag, extra, with_fid):
    monkeypatch.chdir(assets)
    common = ['--dataset', 'cub'] + KNOBS + [
        '--resume_from', 'gan_cub.pth', '--data_path', 'data'] + extra
    port_root, jax_root = f'port_{tag}', f'jax_{tag}'
    cli_base._weights_into(assets, port_root, 'port', with_fid)
    cli_base._weights_into(assets, jax_root, 'jax', with_fid)
    out = cli_run.main(common + ['--root_path', port_root,
                                 '--coord_resume_from', 'enc.pth'],
                       device='cpu')
    jax_cli.main(common + ['--root_path', jax_root, '--coord_resume_from',
                           'enc.npz', '--use_pallas', '0'])
    cfg_string = os.path.basename(out['report_dir'])
    return (out, _report(port_root, 'gan_cub.pth', cfg_string),
            _report(jax_root, 'gan_cub.pth', cfg_string))


def _compare(port, ref, steps):
    assert sorted(port) == sorted(ref)
    for step in steps:
        for key in ('ws', 'R', 's', 't2'):
            assert port[f'{step}/{key}'].shape[0] == 4, key
            np.testing.assert_allclose(port[f'{step}/{key}'],
                                       ref[f'{step}/{key}'], rtol=0,
                                       atol=PARAM_ATOL, err_msg=key)
        assert f'{step}/z0' not in port
        gaps = {name: cli_base._rel(port[f'{step}/{name}'],
                                    ref[f'{step}/{name}'])
                for key in METRIC_RTOL
                for name in (key, f'{key}_avg')}
        over = {name: gap for name, gap in gaps.items()
                if gap > METRIC_RTOL[name.replace('_avg', '')]}
        assert not over, (step, gaps)


def test_cub_inversion_cli_matches_jax(assets, monkeypatch):
    out, port, ref = _run_cub(assets, monkeypatch, 'enc',
                              ['--inv_encoder_only'], with_fid=False)
    assert [b['images'] for b in out['batches']] == [4]
    _compare(port, ref, (0,))


@pytest.mark.slow
@pytest.mark.parity
def test_cub_inversion_cli_with_fid_matches_jax(assets, monkeypatch):
    _, port, ref = _run_cub(assets, monkeypatch, 'fid',
                            ['--inv_encoder_only'], with_fid=True)
    _compare(port, ref, (0,))
    for key in ('fid_front', 'fid_random', 'fid_front_test',
                'fid_random_test'):
        assert np.isfinite(port[f'0/{key}'])
        assert cli_base._rel(port[f'0/{key}'], ref[f'0/{key}']) <= FID_RTOL, (
            key, cli_base._rel(port[f'0/{key}'], ref[f'0/{key}']))


def test_carla_inversion_cli_runs(assets, monkeypatch):
    monkeypatch.chdir(assets)
    cli_base._weights_into(assets, 'port_carla', 'port', False)
    out = cli_run.main(['--dataset', 'carla'] + KNOBS + [
        '--resume_from', 'gan_carla.pth', '--data_path', 'data',
        '--root_path', 'port_carla', '--coord_resume_from', 'enc.pth',
        '--inv_steps', '1'], device='cpu')
    assert [b['images'] for b in out['batches']] == [4, 2]
    report = _report('port_carla', 'gan_carla.pth',
                     'i_train_joint_optpose_vgg_gain5_split')
    for step in (0, 1):
        for key in ('ws', 'R', 's', 't2', 'z0', 'psnr', 'ssim', 'lpips',
                    'rot_error'):
            arr = report[f'{step}/{key}']
            assert arr.shape[0] == 6 and np.all(np.isfinite(arr)), key


@pytest.mark.parametrize('dataset', ['cub', 'carla'])
def test_training_cli_runs(assets, monkeypatch, dataset):
    calls = []
    make_cfg = cli_run.make_gan_config
    monkeypatch.setattr(cli_run, 'make_gan_config', lambda *args: (
        dataclasses.replace(make_cfg(*args), channel_base=1024,
                            channel_max=64)))
    original = pretrain.pretrain_sdf

    def short_pretrain(state, *args, **kwargs):
        calls.append(state.iteration)
        return original(state, *args, n_steps=2, **kwargs)

    monkeypatch.setattr(pretrain, 'pretrain_sdf', short_pretrain)
    # cub's overrides set --iterations to 200,000, as JAX's do: the loop
    # stops at 4 here.
    train_gan = cli_run.loop_lib.train_gan
    monkeypatch.setattr(cli_run.loop_lib, 'train_gan',
                        lambda state, cfg, split, num_iters, **kwargs:
                        train_gan(state, cfg, split, 4, **kwargs))
    monkeypatch.setattr(
        cli_run.weights_lib, 'load_inception', lambda *args, **kwargs:
        lambda im: im.reshape(im.shape[0], 3, 4, im.shape[2] // 4, 4,
                              im.shape[3] // 4).mean(dim=(3, 5)).reshape(
                                  im.shape[0], 48))
    out = cli_run.main(['--dataset', dataset, '--data_path',
                        str(assets / 'data'), '--root_path',
                        str(assets / f'train_{dataset}')] + TRAIN_KNOBS,
                       device='cpu')
    assert calls == [0]
    state = out['state']
    assert state.iteration == 4
    assert state.gen.use_stylegan_noise == (dataset == 'cub')
    assert state.gen.use_viewdir == (dataset == 'carla')
    with open(os.path.join(out['log_dir'], 'scalars.jsonl')) as f:
        scalars = [json.loads(line) for line in f]
    assert ('generation/fid_untrunc', 3) in {(s['tag'], s['step'])
                                              for s in scalars}
    assert all(np.isfinite(s['value']) for s in scalars)
    strengths = [float(p) for n, p in state.gen.named_parameters()
                 if n.endswith('noise_strength')]
    # Trained from zero where the noise is on, untouched where it is off.
    assert any(s != 0.0 for s in strengths) == (dataset == 'cub')
