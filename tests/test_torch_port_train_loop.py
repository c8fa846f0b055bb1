"""GAN training's loop against the JAX package's (the slice's training
loop; the evaluator and the CLI are in `test_torch_port_train_cli.py`).

- `train.loop.train_gan` for 4 iterations against JAX's `train_gan` (G,
  D with R1 and the warmup blur, G, D with R1, then the iteration-3
  evaluation hook), in `test_torch_port_gan_step.py`'s configuration:
  both loops draw their batch indices from the same seeded RandomState
  and sampler; the latents and each step's random draws (depths, PDF
  draws, strata, perturbations, ADA transforms) are made with numpy and
  put into both loops' batches by a test-side wrapper of each package's
  `sample_batch`, as the trajectory tests inject them. Held: the batch
  indices exactly; every logged scalar (but images per second) and the
  SDF parameters and their EMA at `test_torch_port_gan_trajectory.py`'s
  tolerances (rtol 1e-4, atol 2e-6).
- Resume: 8 iterations straight against 4 (the iteration-3 checkpoint)
  plus a resume of 4, with equal parameters and batch indices (the
  counterpart of `tests/test_train_loop.py`'s bit-exact resume).
- --ada_target reaches the ADA controller, held against JAX's at 0.7.
Everything runs in float32 on the CPU, on one torch thread (see
`test_torch_port_train_cli.one_torch_thread`).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.data import loaders as jax_loaders
from nerf_from_image_tpu.parallel import mesh as jax_mesh
from nerf_from_image_tpu.train import gan as jax_gan
from nerf_from_image_tpu.train import loop as jax_loop
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu_torch.data import loaders
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.train import loop
from nerf_from_image_tpu_torch.utils import checkpoint

from test_torch_port_gan_step import CFG as STEP_CFG
from test_torch_port_gan_step import _noise, _tform, _to_jax, _to_port
from test_torch_port_train_cli import (SCALAR_ATOL, SCALAR_RTOL, Writer,
                                       _cameras, _split_arrays,
                                       one_torch_thread)  # noqa: F401


# ---- The loop -----------------------------------------------------------

LOOP_N = 6


class Injector:
    """Wraps a package's `sample_batch`: records each call's indices and
    puts the k-th call's numpy latents and draws into its batch (calls
    alternate G, D real, D fake)."""

    def __init__(self, original, convert_batch, seed):
        self.original = original
        self.convert_batch = convert_batch
        self.rng = np.random.default_rng(seed)
        self.indices = []

    def extras(self, k):
        rng = np.random.default_rng([7, k])
        b, latent = STEP_CFG['batch_size'], STEP_CFG['latent_dim']
        kind = k % 3  # 0: G, 1: D real, 2: D fake
        out = {'aug_tform': _tform(rng, b)}
        if kind != 1:
            out['z'] = rng.standard_normal((b, latent)).astype(np.float32)
            out['noise'] = _noise(rng, kind == 0)
        return out

    def __call__(self, *args, **kwargs):
        idx, batch = self.original(*args, **kwargs)
        k = len(self.indices)
        self.indices.append(np.asarray(idx).copy())
        batch.update(self.convert_batch(self.extras(k)))
        return idx, batch


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's directory, removed after it: its checkpoints are large."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _loop_split(package_loaders):
    return package_loaders.DatasetSplit(**_split_arrays(3, LOOP_N, 16,
                                                        highres=True))


def _fresh_loop_state():
    cfg = gan.GANConfig(**STEP_CFG)
    state = gan.init_train_state(cfg, device='cpu', seed=0)
    with torch.no_grad():
        state.gen.decoder.net[2].bias[0] += 1.0  # the surface in the box
    state.gen_ema.load_state_dict(state.gen.state_dict())
    return cfg, state


@pytest.fixture(scope='module')
def loops():
    cfg, state = _fresh_loop_state()
    g_sd = {k: v.numpy().copy() for k, v in state.gen.state_dict().items()}
    d_sd = {k: v.numpy().copy() for k, v in state.disc.state_dict().items()}
    jcfg = jax_gan.GANConfig(use_pallas=False, fine_sampling=True,
                             **STEP_CFG)
    opt_g, opt_d = jax_gan.make_optimizers(jcfg)
    params_g = jax.tree_util.tree_map(
        jnp.asarray, torch_convert.convert_generator(
            g_sd, attention_values=STEP_CFG['attention_values'],
            plane_resolution=STEP_CFG['plane_resolution']))
    params_d = jax.tree_util.tree_map(
        jnp.asarray, torch_convert.convert_discriminator(d_sd))
    jstate = jax_gan.GANTrainState(
        params_g=params_g, params_d=params_d,
        ema_params_g=jax.tree_util.tree_map(jnp.copy, params_g),
        opt_g=opt_g.init(params_g), opt_d=opt_d.init(params_d),
        iteration=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
        augment_p=jnp.asarray(0.0), ppl_running_avg=jnp.asarray(-1.0))
    # The loop donates the state: every leaf its own buffer.
    jstate = jax.tree_util.tree_map(jnp.copy, jstate)
    mesh = jax_mesh.create_mesh('data:1')

    port_inj = Injector(loop.sample_batch, _to_port, 0)
    jax_inj = Injector(jax_loop.sample_batch, _to_jax, 0)
    evals = {'port': [], 'jax': []}
    writers = Writer(), Writer()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, 'sample_batch', port_inj)
        mp.setattr(jax_loop, 'sample_batch', jax_inj)
        loop.train_gan(state, cfg, _loop_split(loaders), 4,
                       writer=writers[0], log_every=1,
                       eval_fn=lambda s, i: evals['port'].append(
                           (i, s.iteration)) or (None, False))
        jstate = jax_loop.train_gan(
            jax_mesh.replicate(jstate, mesh), jcfg, _loop_split(jax_loaders),
            mesh, 4, writer=writers[1], log_every=1,
            eval_fn=lambda s, i: evals['jax'].append(
                (i, int(s.iteration))) or (None, False))
    return dict(state=state, jstate=jax.device_get(jstate), evals=evals,
                writers=writers, indices=(port_inj.indices,
                                          jax_inj.indices))


def test_loop_batches_and_eval_hook(loops):
    port, ref = loops['indices']
    assert len(port) == len(ref) == 6  # G, real, fake, G, real, fake
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    assert loops['evals']['port'] == loops['evals']['jax'] == [(3, 4)]
    assert loops['state'].iteration == int(loops['jstate'].iteration) == 4


def test_loop_scalars_match_jax(loops):
    pw, jw = loops['writers']
    assert set(pw.scalars) == set(jw.scalars)
    steps = sorted({s for _, s in pw.scalars})
    assert steps == [0, 1, 2, 3]
    for (tag, step), ref in jw.scalars.items():
        if tag == 'img_per_sec':
            continue
        got = pw.scalars[tag, step]
        np.testing.assert_allclose(got, ref, rtol=SCALAR_RTOL,
                                   atol=SCALAR_ATOL, err_msg=f'{tag}@{step}')
    for tag in ('loss/g', 'loss/eikonal', 'loss/tv', 'loss/entropy',
                'grad_norm/g', 'loss/d_real', 'loss/d_fake', 'loss/r1',
                'grad_norm/d', 'augment/sign_real', 'augment/p', 'sdf/beta',
                'sdf/alpha_ema', 'img_per_sec'):
        assert any(t == tag for t, _ in pw.scalars), tag


def test_loop_sdf_parameters_match_jax(loops):
    state, jstate = loops['state'], loops['jstate']
    for module, params in ((state.gen, jstate.params_g),
                           (state.gen_ema, jstate.ema_params_g)):
        for name in ('beta', 'alpha'):
            np.testing.assert_allclose(
                getattr(module, name).detach().numpy(),
                np.asarray(params['params'][name]), rtol=SCALAR_RTOL,
                atol=SCALAR_ATOL, err_msg=name)


def test_loop_resume_matches_straight_run(tmp_path, monkeypatch):
    """No injection: every draw comes from the loop's and the state's
    generators, which the iteration-3 checkpoint carries."""
    runs = []

    def run(state, num_iters, ckpt=None, host_state=None):
        inj = Injector(loop.sample_batch, lambda extras: {}, 0)
        monkeypatch.setattr(loop, 'sample_batch', inj)
        loop.train_gan(state, state_cfg, _loop_split(loaders), num_iters,
                       ckpt_manager=ckpt, host_state=host_state,
                       eval_fn=lambda s, i: (1.0, True),
                       host_state_extra=lambda: {'best_fid': 7.25})
        runs.append(inj.indices)
        return state

    state_cfg, straight = _fresh_loop_state()
    ckpt = checkpoint.CheckpointManager(str(tmp_path))
    run(straight, 8, ckpt)
    assert sorted(os.listdir(tmp_path)) == ['checkpoint_best.pth',
                                            'checkpoint_latest.pth']
    saved = ckpt.load('latest')
    assert saved['iteration'] == 4 and saved['best_fid'] == 7.25
    _, resumed = _fresh_loop_state()
    assert checkpoint.restore_gan_checkpoint(saved, resumed) == {
        'best_fid': 7.25}
    run(resumed, 8, host_state=saved['random_state'])
    assert resumed.iteration == 8
    for a, b in zip(runs[0][6:], runs[1]):
        np.testing.assert_array_equal(a, b)
    for module in ('gen', 'gen_ema', 'disc'):
        a = getattr(straight, module).state_dict()
        b = getattr(resumed, module).state_dict()
        for key in a:
            assert torch.equal(a[key], b[key]), f'{module}.{key}'


# ---- --ada_target ---------------------------------------------------------

ADA_BATCH = 12  # 10 positive logits in 12: a sign mean of 2/3


def test_ada_target_reaches_the_controller_as_in_jax():
    """A D step at iteration 12,503 (an ADA update, past the blur warmup)
    whose real logits have a sign mean of 2/3: at --ada_target 0.6 p
    would rise; at 0.7 both packages lower it by one step."""
    step_cfg = dict(STEP_CFG, batch_size=ADA_BATCH, ada_target=0.7)
    cfg = gan.GANConfig(**step_cfg)
    state = gan.init_train_state(cfg, device='cpu', seed=0)
    state.iteration, state.augment_p = 12503, 0.4
    rng = np.random.default_rng(11)
    cam, focal = _cameras(rng, ADA_BATCH)
    res = STEP_CFG['resolution']
    tform = _tform(rng, ADA_BATCH)
    # Real images whose logits give the wanted sign mean: a seed search,
    # on the port's own D, over images drawn from numpy.
    for seed in range(200):
        hi = np.random.default_rng(seed).uniform(
            -1, 1, (ADA_BATCH, 2 * res, 2 * res, 4)).astype(np.float32)
        real = dict(image=hi.reshape(ADA_BATCH, res, 2, res, 2, 4).mean(
            axis=(2, 4)), image_highres=hi, pose=cam, focal=focal,
            aug_tform=tform)
        img, pose, foc = gan._prepare_d_real(state, _to_port(real), cfg,
                                             False)
        with torch.no_grad():
            logits = state.disc(img, pose, None, foc)
        if int((logits > 0).sum()) == 10:
            break
    else:
        pytest.fail('no real batch with a sign mean of 2/3')
    cam_f, focal_f = _cameras(rng, ADA_BATCH)
    fake = dict(z=rng.standard_normal((ADA_BATCH, STEP_CFG['latent_dim']))
                .astype(np.float32), pose=cam_f, focal=focal_f,
                noise=dict(depth=rng.random((ADA_BATCH, res, res, 16)),
                           pdf_u=rng.random((ADA_BATCH * res * res, 16))),
                aug_tform=_tform(rng, ADA_BATCH))
    fake['noise'] = {k: v.astype(np.float32) for k, v in
                     fake['noise'].items()}

    g_sd = {k: v.numpy().copy() for k, v in state.gen.state_dict().items()}
    d_sd = {k: v.numpy().copy() for k, v in state.disc.state_dict().items()}
    jcfg = jax_gan.GANConfig(use_pallas=False, fine_sampling=True,
                             **step_cfg)
    jgen, jdisc = jax_gan.make_models(jcfg)
    _, opt_d = jax_gan.make_optimizers(jcfg)
    params_g = jax.tree_util.tree_map(
        jnp.asarray, torch_convert.convert_generator(
            g_sd, attention_values=STEP_CFG['attention_values'],
            plane_resolution=STEP_CFG['plane_resolution']))
    params_d = jax.tree_util.tree_map(
        jnp.asarray, torch_convert.convert_discriminator(d_sd))
    jstate = jax_gan.GANTrainState(
        params_g=params_g, params_d=params_d, ema_params_g=params_g,
        opt_g=None, opt_d=opt_d.init(params_d),
        iteration=jnp.asarray(12503, jnp.int32),
        rng=jax.random.PRNGKey(0), augment_p=jnp.asarray(0.4),
        ppl_running_avg=jnp.asarray(-1.0))
    jstate, jmetrics = jax.jit(lambda s, b, f: jax_gan.d_step(
        s, b, f, jgen, jdisc, opt_d, jcfg, use_r1_now=True,
        blur_active=False))(jstate, _to_jax(real), _to_jax(fake))
    metrics = gan.d_step(state, _to_port(real), _to_port(fake), cfg)

    assert float(metrics['sign_real']) == pytest.approx(2 / 3)
    assert float(jmetrics['sign_real']) == pytest.approx(2 / 3)
    lowered = 0.4 - ADA_BATCH * 4 / 500000.0
    assert state.augment_p == pytest.approx(lowered, abs=1e-7)
    assert float(jstate.augment_p) == pytest.approx(lowered, abs=1e-7)


def test_cli_passes_ada_target():
    from nerf_from_image_tpu_torch import config as config_lib
    from nerf_from_image_tpu_torch.cli import run as cli_run
    args = config_lib.parse_args(['--dataset', 'p3d_car', '--ada_target',
                                  '0.7'])
    config_lib.override_default_args(args)
    cfg = cli_run.make_gan_config(
        args, config_lib.get_dataset_config('p3d_car'))
    assert cfg.ada_target == 0.7 and cfg.augment_ada
