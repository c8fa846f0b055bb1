"""GAN training's flag-only modes through the port's training CLI.

Each mode runs `cli.run.main` on a fixture (p3d_car: 6 train and 2 test
images; cub: 4 and 2; carla: 6 views) at tiny knobs (16^2 renders, 32^2 planes, 4 + 4
samples, batch 4, float32, the models narrowed to channel_base 1024),
resumed from a reference-format checkpoint of its own configuration at
iteration 2: one G step, one D step and the iteration-3 evaluation, every
step's scalars logged (the loop's `log_every` set to 1). The flags are no
longer refused, and what each mode logs and saves is its own:

- --use_encoder --dual_discriminator --path_length_regularization: the
  dual tags (`loss/g_cond` and `loss/g`, D1's `_cond`, `grad_norm/d2`),
  `ppl/loss` and `ppl/running_avg`, the reconstruction metrics of the
  front and random views and of the test split, and `discriminator2` in
  the checkpoint;
- --use_class on cub: the classes counted in the train split, the class
  tables in G and D;
- --use_encoder --dual_discriminator_mse --attention_values 0
  --perturb_poses 30 on carla (the recon modes cannot take p3d_car's and
  cub's alpha, in JAX as in the port; the fixture's views lie 27-174
  degrees apart, so 5 would move none): no D1 (the recon loss under `loss/g_cond`), no
  palette and no semantics images, the training poses moved at load.

The modes' numbers are held against JAX unit by unit
(`test_torch_port_flag_steps_*.py`, `test_torch_port_flag_eval.py`).
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from nerf_from_image_tpu_torch import config
from nerf_from_image_tpu_torch.cli import run as cli_run
from nerf_from_image_tpu_torch.data import fixtures
from nerf_from_image_tpu_torch.data import loaders
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import checkpoint

KNOBS = ['--resolution', '16', '--latent_dim', '512', '--plane_resolution',
         '32', '--depth_samples_per_ray', '4', '--batch_size', '4',
         '--compute_dtype', 'float32', '--iterations', '4']
START = 2
MODES = {
    'encoder_dual_ppl': ('p3d_car', ['--use_encoder', '--dual_discriminator',
                                     '--path_length_regularization',
                                     '--attention_values', '4']),
    'class': ('cub', ['--use_class', '--attention_values', '4']),
    'encoder_mse_nopalette': ('carla', [
        '--use_encoder', '--dual_discriminator_mse', '--attention_values',
        '0', '--perturb_poses', '30']),
}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp('flag_cli')
    fixtures.write_p3d_car(str(root / 'p3d_car'), n_train=6, n_test=2,
                           size=(48, 40), seed=0)
    fixtures.write_cub(str(root / 'cub'), 4, 2, (48, 40), seed=1)
    fixtures.write_carla(str(root / 'carla'), 6, 40, seed=2)
    yield root
    # The module's runs write checkpoints of hundreds of MB here.
    shutil.rmtree(root, ignore_errors=True)


def _narrow(cfg):
    return dataclasses.replace(cfg, channel_base=1024, channel_max=64)


def _pooled_features(im):
    b, c, h, w = im.shape
    return im.reshape(b, c, 4, h // 4, 4, w // 4).mean(axis=(3, 5)).reshape(
        b, c * 16)


def _run(data, mode, monkeypatch):
    dataset, flags = MODES[mode]
    root = data / mode
    argv = (['--dataset', dataset] + KNOBS + flags +
            ['--root_path', str(root), '--data_path', str(data / dataset)])
    args = config.parse_args(argv)
    config.override_default_args(args)
    dataset_config, train_split, _, _ = loaders.load_dataset(args)
    original_poses = train_split.tform_cam2world.copy()
    cfg = _narrow(cli_run.make_gan_config(args, dataset_config,
                                          train_split.num_classes))
    state = gan.init_train_state(cfg, device='cpu', seed=4)
    with torch.no_grad():
        for g in (state.gen, state.gen_ema):
            g.decoder.net[2].bias[0] -= 1.0  # a surface in the box
    state.iteration = START
    path = str(root / 'resume.pth')
    checkpoint.save(checkpoint.gan_checkpoint(state), path)

    make_cfg = cli_run.make_gan_config
    monkeypatch.setattr(cli_run, 'make_gan_config',
                        lambda *a: _narrow(make_cfg(*a)))
    monkeypatch.setattr(
        cli_run.weights_lib, 'load_inception',
        lambda *a, **k: lambda im: _pooled_features(im))
    seen = {}
    train_gan = cli_run.loop_lib.train_gan

    def logged_train_gan(state, cfg, split, num_iters, **kwargs):
        seen['poses'] = split.tform_cam2world.copy()
        seen['cfg'] = cfg
        # cub's overrides set 200,000 iterations: stop at 4.
        return train_gan(state, cfg, split, START + 2, log_every=1,
                         **kwargs)

    monkeypatch.setattr(cli_run.loop_lib, 'train_gan', logged_train_gan)
    out = cli_run.main(argv + ['--resume_from', path], device='cpu')
    with open(os.path.join(out['log_dir'], 'scalars.jsonl')) as f:
        tags = {(s['tag'], s['step']) for s in map(json.loads, f)}
    latest = checkpoint.load(os.path.join(out['checkpoint_dir'],
                                          'checkpoint_latest.pth'))
    return dict(out=out, tags=tags, latest=latest, original=original_poses,
                **seen)


def test_encoder_dual_ppl(data, monkeypatch):
    r = _run(data, 'encoder_dual_ppl', monkeypatch)
    assert r['cfg'].path_length_regularization and r['cfg'].use_encoder
    assert r['out']['state'].iteration == START + 2
    assert not r['out']['pretrained']
    g = {t for t, s in r['tags'] if s == START}
    d = {t for t, s in r['tags'] if s == START + 1}
    assert {'loss/g_cond', 'loss/g', 'ppl/loss', 'ppl/running_avg'} <= g
    assert {'loss/d_real_cond', 'loss/d_fake_cond', 'loss/r1_cond',
            'loss/d_real', 'loss/d_fake', 'loss/r1', 'grad_norm/d',
            'grad_norm/d2'} <= d
    evals = {t for t, s in r['tags'] if s == 3 and
             t.startswith('reconstruction/')}
    for name in ('psnr', 'ssim', 'lpips', 'iou'):
        assert {f'reconstruction/{name}_front',
                f'reconstruction/{name}_test_front'} <= evals, name
    assert {'reconstruction/fid_frontview',
            'reconstruction/fid_randomview'} <= evals
    assert r['latest']['discriminator2'] is not None
    assert r['out']['state'].ppl_running_avg > 0
    np.testing.assert_array_equal(r['poses'], r['original'])


def test_class(data, monkeypatch):
    r = _run(data, 'class', monkeypatch)
    cfg = r['cfg']
    assert cfg.use_class and cfg.num_classes >= 1
    state = r['out']['state']
    assert state.gen.class_embedding.weight.shape[0] == cfg.num_classes
    assert state.disc.label_embedding.weight.shape[0] == cfg.num_classes
    assert {('loss/g', START), ('loss/d_real', START + 1),
            ('generation/fid_untrunc', 3)} <= r['tags']
    assert 'class_embedding.weight' in r['latest']['model']


def test_encoder_mse_nopalette_perturbed(data, monkeypatch):
    r = _run(data, 'encoder_mse_nopalette', monkeypatch)
    state = r['out']['state']
    assert state.disc is None and state.disc2 is not None
    assert state.gen.num_ws == 14 and not hasattr(state.gen,
                                                   'texture_mapper')
    g = {t for t, s in r['tags'] if s == START}
    d = {t for t, s in r['tags'] if s == START + 1}
    assert {'loss/g_cond', 'loss/g'} <= g
    assert 'grad_norm/d2' in d and 'grad_norm/d' not in d
    assert r['latest']['discriminator'] is None
    # --perturb_poses: each pose replaced by a neighbour's.
    assert not np.array_equal(r['poses'], r['original'])
    rows = {tuple(p.ravel()) for p in r['original']}
    assert all(tuple(p.ravel()) in rows for p in r['poses'])
