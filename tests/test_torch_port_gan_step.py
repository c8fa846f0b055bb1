"""The slice as a whole: the port's GAN steps against the JAX ones.

A small generator and discriminator (latent 32, 64^2 planes, narrow
channels, 16^2 renders of 16 + 16 samples, batch 4) in p3d_car's setting
(box 1.4, black background, flipped camera, `supervise_alpha` with a
4-channel D, ADA at p = 0.5 with injected transforms, `is_highres` real
images) take a G step, a D step with R1 and the warmup blur, and a G step
in both packages, from one fresh state: the port's seeded weights reach
JAX through its `convert_generator` and `convert_discriminator`. Every
random draw (depths, PDF draws, strata, perturbations, transforms) is
made with numpy and injected into both. JAX runs its jitted `g_step` and
`d_step` on its XLA sampler (`use_pallas=False`), the port its CPU path
(the plain versions of kernels B1 and B4), all in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.core import augment as jax_augment
from nerf_from_image_tpu.train import gan as jax_gan
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu_torch.core import augment
from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import convert

BATCH, RES, SAMPLES, LATENT = 4, 16, 16, 32
CFG = dict(resolution=RES, latent_dim=LATENT, depth_samples_per_ray=SAMPLES,
           scene_range=1.4, white_background=False, camera_flipped=True,
           supervise_alpha=True, is_highres=True, augment_ada=True,
           augment_p_max=0.8, batch_size=BATCH, plane_resolution=64,
           channel_base=1024, channel_max=64, attention_values=10)
NSTRATA = 32
# Every metric and every parameter against JAX: both sides compute in
# float32, in another order and with other library kernels (the sort and
# searchsorted of the PDF draw, the convolutions). A fresh state runs at
# the warmup's lr / 10, so Adam's first, sign-like updates move an entry
# whose gradient sits at float32 noise by about 2.5e-4 per step.
RTOL = 1e-3
G_METRICS = ('loss_g', 'loss_eikonal', 'loss_tv', 'loss_entropy',
             'grad_norm_g')
D_METRICS = ('loss_d_real', 'loss_d_fake', 'loss_r1', 'grad_norm_d')


def _cameras(rng, b):
    q = rng.standard_normal((b, 4)) * 0.2 + [1.0, 0.0, 0.0, 0.0]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cam, focal = pose_lib.pose_to_matrix(
        torch.full((b,), float(np.log(2.0))),
        torch.tensor(rng.uniform(-0.05, 0.05, (b, 2)), dtype=torch.float32),
        torch.ones(b), torch.tensor(q, dtype=torch.float32), True)
    return cam.numpy(), focal.numpy()


def _tform(rng, b):
    return dict(rot=rng.uniform(-np.pi, np.pi, b).astype(np.float32),
                scale=np.exp2(rng.standard_normal(b) * 0.2).astype(
                    np.float32),
                translation=(rng.standard_normal((b, 2)) * 0.1).astype(
                    np.float32))


def _noise(rng, with_regularizers):
    noise = {'depth': rng.random((BATCH, RES, RES, SAMPLES)),
             'pdf_u': rng.random((BATCH * RES * RES, SAMPLES))}
    if with_regularizers:
        n = NSTRATA - 1
        noise['strata'] = rng.random((BATCH, n, n, n, 3))
        noise['perturb'] = rng.standard_normal((BATCH, n ** 3, 3))
    return {k: v.astype(np.float32) for k, v in noise.items()}


def _batches(seed):
    """Numpy batches: G step, D step (real, fake), G step."""
    rng = np.random.default_rng(seed)

    def g_batch():
        cam, focal = _cameras(rng, BATCH)
        return dict(z=rng.standard_normal((BATCH, LATENT)).astype(
            np.float32), pose=cam, focal=focal, noise=_noise(rng, True),
            aug_tform=_tform(rng, BATCH))

    g0 = g_batch()
    cam, focal = _cameras(rng, BATCH)
    hi = rng.uniform(-1, 1, (BATCH, 2 * RES, 2 * RES, 4)).astype(np.float32)
    real = dict(image=hi.reshape(BATCH, RES, 2, RES, 2, 4).mean(axis=(2, 4)),
                image_highres=hi, pose=cam, focal=focal,
                aug_tform=_tform(rng, BATCH))
    cam, focal = _cameras(rng, BATCH)
    fake = dict(z=rng.standard_normal((BATCH, LATENT)).astype(np.float32),
                pose=cam, focal=focal, noise=_noise(rng, False),
                aug_tform=_tform(rng, BATCH))
    return g0, real, fake, g_batch()


def _to_port(batch):
    out = {}
    for k, v in batch.items():
        if k == 'noise':
            out[k] = {n: torch.tensor(a) for n, a in v.items()}
        elif k == 'aug_tform':
            out[k] = augment.AffineTransform(
                **{n: torch.tensor(a) for n, a in v.items()})
        else:
            out[k] = torch.tensor(v)
    return out


def _to_jax(batch):
    out = {}
    for k, v in batch.items():
        if k == 'noise':
            out[k] = {n: jnp.asarray(a) for n, a in v.items()}
        elif k == 'aug_tform':
            out[k] = jax_augment.AffineTransform(
                **{n: jnp.asarray(a) for n, a in v.items()})
        else:
            out[k] = jnp.asarray(v)
    return out


@pytest.fixture(scope='module')
def trajectories():
    cfg = gan.GANConfig(**CFG)
    state = gan.init_train_state(cfg, device='cpu', seed=0)
    with torch.no_grad():
        # Shift the decoder's distance output so that the surface crosses
        # the box (this fresh decoder puts the SDF at -1.3 +- 0.5, inside
        # the surface nearly everywhere, where the tv and entropy terms
        # vanish in float32).
        state.gen.decoder.net[2].bias[0] += 1.0
    state.gen_ema.load_state_dict(state.gen.state_dict())
    state.augment_p = 0.5
    g_sd = {k: v.numpy().copy() for k, v in state.gen.state_dict().items()}
    d_sd = {k: v.numpy().copy() for k, v in state.disc.state_dict().items()}

    jcfg = jax_gan.GANConfig(use_pallas=False, fine_sampling=True,
                             **CFG)
    jgen, jdisc = jax_gan.make_models(jcfg)
    opt_g, opt_d = jax_gan.make_optimizers(jcfg)
    params_g = jax.tree_util.tree_map(
        jnp.asarray, torch_convert.convert_generator(
            g_sd, attention_values=CFG['attention_values'],
            plane_resolution=CFG['plane_resolution']))
    params_d = jax.tree_util.tree_map(
        jnp.asarray, torch_convert.convert_discriminator(d_sd))
    jstate = jax_gan.GANTrainState(
        params_g=params_g, params_d=params_d,
        ema_params_g=jax.tree_util.tree_map(lambda x: x, params_g),
        opt_g=opt_g.init(params_g), opt_d=opt_d.init(params_d),
        iteration=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
        augment_p=jnp.asarray(0.5), ppl_running_avg=jnp.asarray(-1.0))
    g_jit = jax.jit(lambda s, b: jax_gan.g_step(s, b, jgen, jdisc, opt_g,
                                                jcfg))
    d_jit = jax.jit(lambda s, b, f: jax_gan.d_step(
        s, b, f, jgen, jdisc, opt_d, jcfg, use_r1_now=True,
        blur_active=True))

    g0, real, fake, g2 = _batches(7)
    port, ref = [], []
    port.append(gan.g_step(state, _to_port(g0), cfg))
    jstate, m = g_jit(jstate, _to_jax(g0))
    ref.append(m)
    port.append(gan.d_step(state, _to_port(real), _to_port(fake), cfg))
    jstate, m = d_jit(jstate, _to_jax(real), _to_jax(fake))
    ref.append(m)
    port.append(gan.g_step(state, _to_port(g2), cfg))
    jstate, m = g_jit(jstate, _to_jax(g2))
    ref.append(m)
    assert state.iteration == int(jstate.iteration) == 3
    return dict(state=state, jstate=jax.device_get(jstate),
                port=[{k: float(v) for k, v in m.items()} for m in port],
                ref=[{k: float(v) for k, v in m.items()} for m in ref])


def _rel(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize('step,key', [(0, k) for k in G_METRICS] +
                         [(1, k) for k in D_METRICS] +
                         [(2, k) for k in G_METRICS])
def test_metric_matches_jax(trajectories, step, key):
    got = trajectories['port'][step][key]
    ref = trajectories['ref'][step][key]
    assert np.isfinite(got) and ref != 0.0
    assert _rel(got, ref) < RTOL, (got, ref)


def _check_state_dict(port_sd, ref_sd):
    missing = set(ref_sd) - set(port_sd)
    assert not missing, missing
    for key, ref in ref_sd.items():
        got = port_sd[key].detach().numpy()
        assert _rel(got, ref) < RTOL, (key, _rel(got, ref))


@pytest.mark.parametrize('which', ['params_g', 'ema_params_g'])
def test_generator_after_three_steps_matches_jax(trajectories, which):
    """Every G (or EMA) parameter after G, D, G, relative to the largest
    entry of its tensor (RTOL)."""
    state = trajectories['state']
    module = state.gen if which == 'params_g' else state.gen_ema
    ref = convert.from_jax_params(getattr(trajectories['jstate'], which))
    _check_state_dict(module.state_dict(), ref)


def test_discriminator_after_three_steps_matches_jax(trajectories):
    ref = convert.from_jax_discriminator(trajectories['jstate'].params_d)
    _check_state_dict(trajectories['state'].disc.state_dict(), ref)


def test_steps_reject_unported_modes():
    """Every mode is ported; the G step refuses only the recon modes
    without an encoder, which leave no discriminator for its second pass,
    or under supervise_alpha (JAX's G step fails in both:
    test_torch_port_flag_steps_recon.py), while the D step, with no
    discriminator to train, only counts."""
    cfg = gan.GANConfig(**dict(CFG, dual_discriminator=True,
                               dual_discriminator_l1=True))
    state = gan.init_train_state(cfg, device='cpu')
    assert state.disc is None and state.disc2 is None
    with pytest.raises(ValueError, match='no discriminator'):
        gan.g_step(state, {}, cfg)
    assert gan.d_step(state, {}, {}, cfg) == {'sign_real': 0.0}
    assert state.iteration == 1


def test_init_train_state_needs_cuda_unless_asked_for_cpu():
    cfg = gan.GANConfig(**CFG)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            gan.init_train_state(cfg)
    state = gan.init_train_state(cfg, device='cpu')
    assert state.iteration == 0 and state.augment_p == 0.0
    assert state.disc.backbone.b16.fromrgb.weight.shape[1] == 4
    assert not any(p.requires_grad for p in state.gen_ema.parameters())
    assert state.opt_g.param_groups[0]['lr'] == pytest.approx(
        cfg.lr_g / 10.0)
