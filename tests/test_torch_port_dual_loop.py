"""The dual-discriminator mode through GAN training's loop and CLI.

- `train.loop.train_gan` against JAX's `train_gan` for two iterations (a
  G step with its second poses, then a D step over both discriminators
  with R1) in `tests/torch_port_flag_steps.py`'s dual configuration (D2
  is D1, no encoder), from one state at iteration 1000. Both loops draw
  their batch indices from the same seeded RandomState and sampler; the
  latents and every step's draws are made with numpy and put into both
  loops' batches by a test-side wrapper of each package's `sample_batch`
  (calls: G, G's second poses, D real, D fake, second real, second
  fake), as `test_torch_port_train_loop.py` injects them. Held: the
  batch indices exactly; every logged loss and gradient norm within the
  harness's RTOL; every parameter after the loop, G's last synthesis
  layer among them, within its PARAM_RTOL rule.
- The training CLI with --dual_discriminator --dual_discriminator_l1
  --use_encoder on carla (the reconstruction modes cannot take p3d_car's
  alpha, in JAX as in the port), resumed at iteration 2 to iteration 4
  with the iteration-3 evaluation (`test_torch_port_flag_cli.py`'s
  runner): finite scalars, the reconstruction loss in D1's place and D2
  built, as JAX's `init_train_state` builds them for that
  configuration.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_flag_steps as harness
from nerf_from_image_tpu.data import loaders as jax_loaders
from nerf_from_image_tpu.parallel import mesh as jax_mesh
from nerf_from_image_tpu.train import gan as jax_gan
from nerf_from_image_tpu.train import loop as jax_loop
from nerf_from_image_tpu_torch import config
from nerf_from_image_tpu_torch.cli import run as cli_run
from nerf_from_image_tpu_torch.data import loaders
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.train import loop
from nerf_from_image_tpu_torch.utils import checkpoint
from test_torch_port_flag_cli import _narrow, _pooled_features
from test_torch_port_flag_cli import data  # noqa: F401
from test_torch_port_flag_cli import one_torch_thread  # noqa: F401
from test_torch_port_train_cli import Writer

MODE = 'dual_shared'
SPLIT_N = 6


class Injector:
    """Wraps a package's `sample_batch`: records each call's indices and
    puts the k-th call's numpy draws into its batch (per iteration pair:
    G, G's second poses, D real, D fake, second real, second fake)."""

    def __init__(self, original, convert_batch):
        self.original = original
        self.convert_batch = convert_batch
        self.indices = []

    def extras(self, k):
        rng = np.random.default_rng([11, k])
        out = {'aug_tform': harness._tform(rng)}
        if k % 6 not in (2, 4):  # not a real batch
            out['z'] = rng.standard_normal((harness.BATCH, harness.LATENT))
            out['noise'] = harness._render_noise(rng)
        if k % 6 == 0:
            n = harness.NSTRATA - 1
            out['noise'].update(
                strata=rng.random((harness.BATCH, n, n, n, 3)),
                perturb=rng.standard_normal((harness.BATCH, n ** 3, 3)))
        return out

    def __call__(self, *args, **kwargs):
        idx, batch = self.original(*args, **kwargs)
        self.indices.append(np.asarray(idx).copy())
        batch.update(self.convert_batch(self.extras(len(self.indices) - 1)))
        return idx, batch


def _split(package_loaders):
    rng = np.random.default_rng(3)
    cam, focal = harness._cameras(rng, SPLIT_N)
    return package_loaders.DatasetSplit(
        images=rng.uniform(-1, 1, (SPLIT_N, harness.RES, harness.RES,
                                   3)).astype(np.float32),
        tform_cam2world=cam, focal_length=focal)


@pytest.fixture(scope='module')
def loops():
    init = harness.init_states(MODE)
    cfg, state, jcfg = init['cfg'], init['state'], init['jcfg']
    # The loop donates the state: every leaf its own buffer.
    jstate = jax.tree_util.tree_map(jnp.copy, init['jstate'])
    mesh = jax_mesh.create_mesh('data:1')
    port_inj = Injector(loop.sample_batch, harness.to_port)
    jax_inj = Injector(jax_loop.sample_batch, harness.to_jax)
    writers = Writer(), Writer()
    end = harness.START + 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, 'sample_batch', port_inj)
        mp.setattr(jax_loop, 'sample_batch', jax_inj)
        loop.train_gan(state, cfg, _split(loaders), end, writer=writers[0],
                       log_every=1)
        jstate = jax_loop.train_gan(
            jax_mesh.replicate(jstate, mesh), jcfg, _split(jax_loaders),
            mesh, end, writer=writers[1], log_every=1)
    return dict(cfg=cfg, state=state, jstate=jax.device_get(jstate),
                writers=writers, indices=(port_inj.indices, jax_inj.indices))


def test_dual_loop_batches_and_scalars_match_jax(loops):
    port, ref = loops['indices']
    assert len(port) == len(ref) == 6
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    assert loops['state'].iteration == int(loops['jstate'].iteration) == (
        harness.START + 2)
    pw, jw = loops['writers']
    assert set(pw.scalars) == set(jw.scalars)
    assert {('loss/g_cond', harness.START), ('loss/g', harness.START),
            ('loss/d_real_cond', harness.START + 1),
            ('loss/r1', harness.START + 1)} <= set(pw.scalars)
    for (tag, step), value in jw.scalars.items():
        if tag == 'img_per_sec':
            continue
        got = pw.scalars[tag, step]
        assert np.isfinite(got), tag
        if value == 0.0:
            assert got == 0.0, tag
        else:
            assert harness.rel(got, value) < harness.RTOL, (tag, got, value)


def test_dual_loop_parameters_match_jax(loops):
    harness.check_params(loops)
    last = f'synthesis_network.b{harness.PLANES}.torgb.weight'
    assert last in loops['state'].gen.state_dict()


def test_dual_l1_cli_runs(data, monkeypatch):  # noqa: F811
    flags = ['--use_encoder', '--dual_discriminator',
             '--dual_discriminator_l1', '--attention_values', '4']
    root = data / 'dual_l1'
    argv = (['--dataset', 'carla', '--resolution', '16', '--latent_dim',
             '512', '--plane_resolution', '32', '--depth_samples_per_ray',
             '4', '--batch_size', '4', '--compute_dtype', 'float32',
             '--iterations', '4'] + flags +
            ['--root_path', str(root), '--data_path', str(data / 'carla')])
    args = config.parse_args(argv)
    config.override_default_args(args)
    dataset_config, train_split, _, _ = loaders.load_dataset(args)
    cfg = _narrow(cli_run.make_gan_config(args, dataset_config,
                                          train_split.num_classes))
    state = gan.init_train_state(cfg, device='cpu', seed=4)
    with torch.no_grad():
        for g in (state.gen, state.gen_ema):
            g.decoder.net[2].bias[0] -= 1.0  # a surface in the box
    state.iteration = 2
    path = str(root / 'resume.pth')
    checkpoint.save(checkpoint.gan_checkpoint(state), path)

    make_cfg = cli_run.make_gan_config
    monkeypatch.setattr(cli_run, 'make_gan_config',
                        lambda *a: _narrow(make_cfg(*a)))
    monkeypatch.setattr(cli_run.weights_lib, 'load_inception',
                        lambda *a, **k: lambda im: _pooled_features(im))
    train_gan = cli_run.loop_lib.train_gan
    monkeypatch.setattr(
        cli_run.loop_lib, 'train_gan',
        lambda state, cfg, split, num_iters, **kw: train_gan(
            state, cfg, split, num_iters, log_every=1, **kw))
    out = cli_run.main(argv + ['--resume_from', path], device='cpu')
    state = out['state']
    assert state.iteration == 4 and not out['pretrained']
    with open(os.path.join(out['log_dir'], 'scalars.jsonl')) as f:
        scalars = [json.loads(line) for line in f]
    assert all(np.isfinite(s['value']) for s in scalars)
    tags = {(s['tag'], s['step']) for s in scalars}
    assert {('loss/g_cond', 2), ('loss/g', 2), ('grad_norm/d2', 3)} <= tags
    assert ('grad_norm/d', 3) not in tags

    # Which discriminators JAX builds depends on the mode's flags alone.
    jcfg = jax_gan.GANConfig(use_pallas=False, **harness.CFG,
                             dual_discriminator=True,
                             dual_discriminator_l1=True, use_encoder=True)
    jstate = jax.eval_shape(lambda k: jax_gan.init_train_state(k, jcfg),
                            jax.random.PRNGKey(0))
    assert (state.disc is None) == (jstate.params_d is None)
    assert (state.disc2 is None) == (jstate.params_d2 is None)
    assert state.disc is None and state.disc2 is not None
