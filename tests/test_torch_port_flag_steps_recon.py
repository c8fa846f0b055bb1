"""The reconstruction modes of dual discriminators: one G step and one D
step of each in both packages (the harness and its tolerances:
`tests/torch_port_flag_steps.py`). With an encoder, 10 x the L1 or MSE of
the render against the blurred conditioning image takes D1's place (the
G batch not augmented) and D2 alone is trained. Without an encoder no
discriminator is left: JAX's G step fails calling the missing second D,
and its D step only counts; the port does the same."""

import jax
import numpy as np
import pytest
import torch

import torch_port_flag_steps as harness
from nerf_from_image_tpu.train import gan as jax_gan
from nerf_from_image_tpu_torch.train import gan

MODES = ('dual_l1', 'dual_mse')


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def results():
    return {mode: harness.run_mode(mode) for mode in MODES}


@pytest.mark.parametrize('mode', MODES)
def test_step_metrics_match_jax(results, mode):
    checked = harness.check_metrics(results[mode])
    assert (1, 'grad_norm_d2') in checked
    assert (1, 'grad_norm_d') not in checked


@pytest.mark.parametrize('mode', MODES)
def test_parameters_after_steps_match_jax(results, mode):
    harness.check_params(results[mode])


@pytest.mark.parametrize('mse', [False, True], ids=['l1', 'mse'])
def test_without_encoder_no_discriminator_is_left_in_both(mse):
    flags = dict(dual_discriminator=True, dual_discriminator_mse=mse,
                 dual_discriminator_l1=not mse)
    jcfg = jax_gan.GANConfig(use_pallas=False, **harness.CFG, **flags)
    assert jax_gan.make_second_discriminator(jcfg) is None
    jgen, jdisc = jax_gan.make_models(jcfg)
    opt_g, opt_d = jax_gan.make_optimizers(jcfg)
    jstate = jax.jit(lambda k: jax_gan.init_train_state(k, jcfg))(
        jax.random.PRNGKey(0))
    assert jstate.params_d is None and jstate.params_d2 is None
    g, g2, real, fake, real2, fake2 = harness.batches(3)
    with pytest.raises(AttributeError, match="'NoneType'"):
        jax.eval_shape(lambda s, b, b2: jax_gan.g_step(
            s, b, jgen, jdisc, opt_g, jcfg, batch2=b2, disc2=None),
            jstate, harness.to_jax(g), harness.to_jax(g2))
    jnext, jm = jax.jit(lambda s, r, f, r2, f2: jax_gan.d_step(
        s, r, f, jgen, jdisc, opt_d, jcfg, use_r1_now=True,
        blur_active=True, batch2=r2, fake_batch2=f2, disc2=None))(
        jstate, harness.to_jax(real), harness.to_jax(fake),
        harness.to_jax(real2), harness.to_jax(fake2))
    assert {k: float(v) for k, v in jm.items()} == {'sign_real': 0.0}
    assert int(jnext.iteration) == 1

    cfg = gan.GANConfig(**harness.CFG, **flags)
    state = gan.init_train_state(cfg, device='cpu')
    assert state.disc is None and state.disc2 is None
    with pytest.raises(ValueError, match='no discriminator'):
        gan.g_step(state, harness.to_port(g), cfg,
                   batch2=harness.to_port(g2))
    m = gan.d_step(state, harness.to_port(real), harness.to_port(fake), cfg,
                   batch2=harness.to_port(real2),
                   fake_batch2=harness.to_port(fake2))
    assert {k: float(v) for k, v in m.items()} == {'sign_real': 0.0}
    assert state.iteration == 1
    np.testing.assert_array_equal(np.asarray(jnext.augment_p), 0.0)


def test_recon_with_the_mask_where_jax_fails():
    """p3d_car's --supervise_alpha renders the mask as a fourth channel.
    JAX's recon loss subtracts the conditioning image's three channels
    from the render's four and fails; so does the port's (ROADMAP C)."""
    flags = dict(dual_discriminator=True, dual_discriminator_mse=True,
                 use_encoder=True, supervise_alpha=True)
    g, g2 = harness.batches(5)[:2]
    rng = np.random.default_rng(6)
    for b in (g, g2):
        b['image'] = rng.uniform(-1, 1, (harness.BATCH, harness.RES,
                                         harness.RES, 4))
    jcfg = jax_gan.GANConfig(use_pallas=False, **harness.CFG, **flags)
    jgen, jdisc = jax_gan.make_models(jcfg)
    opt_g, _ = jax_gan.make_optimizers(jcfg)
    jstate = jax.jit(lambda k: jax_gan.init_train_state(k, jcfg))(
        jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match='incompatible shapes'):
        jax.eval_shape(lambda s, b, b2: jax_gan.g_step(
            s, b, jgen, jdisc, opt_g, jcfg, batch2=b2,
            disc2=jax_gan.make_second_discriminator(jcfg)),
            jstate, harness.to_jax(g), harness.to_jax(g2))

    cfg = gan.GANConfig(**harness.CFG, **flags)
    state = gan.init_train_state(cfg, device='cpu')
    with pytest.raises(ValueError, match='supervise_alpha'):
        gan.generator_loss(state, harness.to_port(g), cfg,
                           batch2=harness.to_port(g2))
