"""Checkpoints of the flag-only modes in the reference's layout.

A dual-discriminator state with the image encoder (G's and D1's `emb`, a
separate D2) and one in the MSE reconstruction mode (no D1, D2 alone),
their optimizers holding moments from two steps on random gradients:

- the port's `.pth` holds `discriminator2` and one `optimizer_d` over D1's
  parameters and then D2's, as the reference writes it; restored into a
  fresh state, every weight, moment and step count comes back exactly;
- the JAX package's `cli/run.convert_reference_checkpoint` reads the same
  file: its D1, D2 and EMA weights equal the port's (through
  `from_jax_discriminator` and `from_jax_params`), and its D1 and D2 Adam
  moments equal the port's `exp_avg` and `exp_avg_sq`, exactly. JAX is
  handed the file without `optimizer_g`: its G-moment conversion fails on
  a generator state dict with the noise buffers (ROADMAP C) and
  then restarts every moment, D's included.
"""

import shutil

import jax
import numpy as np
import optax
import pytest
import torch

from nerf_from_image_tpu.cli import run as jax_run
from nerf_from_image_tpu.train import gan as jax_gan
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import checkpoint
from nerf_from_image_tpu_torch.utils import convert

BASE = dict(resolution=16, latent_dim=16, depth_samples_per_ray=4,
            attention_values=4, plane_resolution=32, channel_base=512,
            channel_max=64, dual_discriminator=True, use_encoder=True)
MODES = {'dual_encoder': {}, 'dual_mse': {'dual_discriminator_mse': True}}


class _Args:
    attention_values = BASE['attention_values']
    use_viewdir = False
    use_sdf = True


def _trained_state(cfg, seed=0):
    state = gan.init_train_state(cfg, device='cpu', seed=seed)
    rng = torch.Generator().manual_seed(seed + 7)
    for module, opt in ((state.gen, state.opt_g), (state.disc, state.opt_d),
                        (state.disc2, state.opt_d2)):
        if module is None:
            continue
        for _ in range(2):
            for p in module.parameters():
                p.grad = torch.randn(p.shape, generator=rng)
            opt.step()
            opt.param_groups[0]['count'] += 1
    state.iteration = 12
    return state


def _adam(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


@pytest.fixture(scope='module', params=list(MODES))
def saved(request, tmp_path_factory):
    cfg = gan.GANConfig(**BASE, **MODES[request.param])
    state = _trained_state(cfg)
    root = tmp_path_factory.mktemp('ckpt')
    checkpoint.save(checkpoint.gan_checkpoint(state), str(root / 'gan.pth'))
    loaded = checkpoint.load(str(root / 'gan.pth'))
    shutil.rmtree(root, ignore_errors=True)
    return request.param, cfg, state, loaded


def test_layout_and_port_round_trip(saved):
    mode, cfg, state, ckpt = saved
    assert ckpt['discriminator2'] is not None
    assert (ckpt['discriminator'] is None) == (mode == 'dual_mse')
    n_d = 0 if state.disc is None else len(list(state.disc.parameters()))
    n_d2 = len(list(state.disc2.parameters()))
    group = ckpt['optimizer_d']['param_groups'][0]
    assert group['params'] == list(range(n_d + n_d2))
    fresh = gan.init_train_state(cfg, device='cpu', seed=3)
    checkpoint.restore_gan_checkpoint(ckpt, fresh)
    assert fresh.iteration == 12
    for a, b in ((state.disc, fresh.disc), (state.disc2, fresh.disc2),
                 (state.gen, fresh.gen)):
        if a is None:
            assert b is None
            continue
        for (k, x), y in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(x, y), k
    for a, b in ((state.opt_d, fresh.opt_d), (state.opt_d2, fresh.opt_d2)):
        if a is None:
            assert b is None
            continue
        assert b.param_groups[0]['count'] == a.param_groups[0]['count'] == 2
        for pa, pb in zip(a.param_groups[0]['params'],
                          b.param_groups[0]['params']):
            for key in ('exp_avg', 'exp_avg_sq', 'step'):
                assert torch.equal(a.state[pa][key], b.state[pb][key]), key


def test_jax_reads_the_checkpoint(saved, capsys):
    mode, cfg, state, ckpt = saved
    jcfg = jax_gan.GANConfig(use_pallas=False, batch_size=4, **BASE,
                             **MODES[mode])
    jstate = jax.jit(lambda k: jax_gan.init_train_state(k, jcfg))(
        jax.random.PRNGKey(0))
    jstate, _ = jax_run.convert_reference_checkpoint(
        dict(ckpt, optimizer_g=None), _Args, jstate)
    assert 'WARNING' not in capsys.readouterr().out
    assert int(jstate.iteration) == 12
    ema = convert.from_jax_params(jax.device_get(jstate.ema_params_g))
    for key, value in state.gen_ema.state_dict().items():
        if key in ema:
            np.testing.assert_array_equal(ema[key], value.numpy(), key)
    assert any(k.startswith('emb.norm3') for k in ema)
    pairs = [(state.disc2, state.opt_d2, jstate.params_d2, jstate.opt_d2)]
    if state.disc is not None:
        pairs.append((state.disc, state.opt_d, jstate.params_d,
                      jstate.opt_d))
    else:
        assert jstate.params_d is None
    for module, opt, params, opt_state in pairs:
        sd = convert.from_jax_discriminator(jax.device_get(params))
        adam = _adam(jax.device_get(opt_state))
        assert int(adam.count) == 2
        mu = convert.from_jax_discriminator(adam.mu)
        nu = convert.from_jax_discriminator(adam.nu)
        for name, p in module.named_parameters():
            np.testing.assert_array_equal(sd[name], p.detach().numpy(), name)
            np.testing.assert_array_equal(
                mu[name], opt.state[p]['exp_avg'].numpy(), name)
            np.testing.assert_array_equal(
                nu[name], opt.state[p]['exp_avg_sq'].numpy(), name)
