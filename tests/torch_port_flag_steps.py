"""Shared harness of the flag-mode GAN step tests
(`test_torch_port_flag_steps_*.py`): one G step and one D step of a mode
in both packages, from one state.

A small generator and discriminator (latent 32, 32^2 planes, narrow
channels, 16^2 renders of 16 + 16 samples, batch 4) at iteration 1000
(the path-length weight 1.0, the warmup blur on in the D step, R1 on),
ADA at p = 0.5 with injected transforms, black background. The port's
seeded weights reach JAX through `convert_generator` and
`convert_discriminator`, the class tables (which JAX's converters leave
out) by hand. Every random draw (depths, PDF draws, strata,
perturbations, path-length noise, transforms) is made with numpy and
injected into both. JAX runs its jitted `g_step` and `d_step` on its XLA
sampler, the port its CPU path (the plain versions of kernels B1 and
B4), all in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerf_from_image_tpu.core import augment as jax_augment
from nerf_from_image_tpu.train import gan as jax_gan
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu_torch.core import augment
from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import convert

BATCH, RES, SAMPLES, LATENT, PLANES = 4, 16, 16, 32, 32
CLASSES = 3
START = 1000
NSTRATA = 32
CFG = dict(resolution=RES, latent_dim=LATENT, depth_samples_per_ray=SAMPLES,
           scene_range=1.4, white_background=False, camera_flipped=True,
           augment_p_max=0.8, batch_size=BATCH, plane_resolution=PLANES,
           channel_base=512, channel_max=64, attention_values=4)
# Both sides compute one step in float32 from the same state, in another
# order and with other library kernels: the losses and gradient norms of
# that step agree within RTOL; every parameter after it within PARAM_RTOL
# of its tensor's largest entry, plus twice the step's lr (lr / 10 at the
# warmup's start): Adam's first update is sign-like, so an entry whose
# gradient sits at float32 noise moves by up to the lr either way.
RTOL = 1e-4
PARAM_RTOL = 1e-3
MODES = {
    'ppl': dict(path_length_regularization=True),
    'class': dict(use_class=True, num_classes=CLASSES),
    'dual_shared': dict(dual_discriminator=True),
    'dual_encoder': dict(dual_discriminator=True, use_encoder=True),
    'dual_l1': dict(dual_discriminator=True, dual_discriminator_l1=True,
                    use_encoder=True),
    'dual_mse': dict(dual_discriminator=True, dual_discriminator_mse=True,
                     use_encoder=True),
    # The datasets' training configurations (config.override_default_args):
    # ShapeNet's white background in a box of 0.55, an unflipped camera,
    # no ADA and an RGB-only D, with the principal point in every batch;
    # ImageNet's ADA on the 2x real images and the mask as D's fourth
    # channel.
    'shapenet_cars': dict(scene_range=0.55, white_background=True,
                          camera_flipped=False, augment_p_max=0.0),
    'imagenet_car': dict(supervise_alpha=True, is_highres=True),
}
# What each dataset's batches carry beyond the images and cameras.
VIEWS = {'shapenet_cars': dict(center=True),
         'imagenet_car': dict(channels=4, highres=True)}


def _cameras(rng, b):
    q = rng.standard_normal((b, 4)) * 0.2 + [1.0, 0.0, 0.0, 0.0]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cam, focal = pose_lib.pose_to_matrix(
        torch.full((b,), float(np.log(2.0))),
        torch.tensor(rng.uniform(-0.05, 0.05, (b, 2)), dtype=torch.float32),
        torch.ones(b), torch.tensor(q, dtype=torch.float32), True)
    return cam.numpy(), focal.numpy()


def _tform(rng):
    return dict(rot=rng.uniform(-np.pi, np.pi, BATCH).astype(np.float32),
                scale=np.exp2(rng.standard_normal(BATCH) * 0.2).astype(
                    np.float32),
                translation=(rng.standard_normal((BATCH, 2)) * 0.1).astype(
                    np.float32))


def _render_noise(rng):
    return {'depth': rng.random((BATCH, RES, RES, SAMPLES)),
            'pdf_u': rng.random((BATCH * RES * RES, SAMPLES))}


def _views(rng, with_latent, channels=3, highres=False, center=False):
    """One sampled batch: images (`channels` of them, with `highres` their
    2x copy too), cameras, classes, a transform, with `center` a
    principal point near the image's centre, and with a latent the latent
    and its render's draws."""
    cam, focal = _cameras(rng, BATCH)
    out = dict(pose=cam, focal=focal,
               image=rng.uniform(-1, 1, (BATCH, RES, RES, channels)),
               aug_tform=_tform(rng),
               **{'class': rng.integers(0, CLASSES, BATCH)})
    if with_latent:
        out['z'] = rng.standard_normal((BATCH, LATENT))
        out['noise'] = _render_noise(rng)
    if highres:
        out['image_highres'] = rng.uniform(-1, 1, (BATCH, 2 * RES, 2 * RES,
                                                   channels))
    if center:
        out['center'] = 0.5 + rng.uniform(-0.05, 0.05, (BATCH, 2))
    return out


def batches(seed, **views):
    """Numpy batches: the G step's (with every regularizer's and the path
    length's draws) and its second poses; the D step's real, fake, second
    real and second fake batches; `views` as `_views` takes them."""
    rng = np.random.default_rng(seed)
    g = _views(rng, True, **views)
    n = NSTRATA - 1
    g['noise'].update(
        strata=rng.random((BATCH, n, n, n, 3)),
        perturb=rng.standard_normal((BATCH, n ** 3, 3)),
        ppl_planes=rng.standard_normal((BATCH, 96, PLANES, PLANES)),
        ppl_attn=rng.standard_normal((BATCH, CFG['attention_values'], 3)))
    g2 = _views(rng, True, **views)
    return (g, g2, _views(rng, False, **views), _views(rng, True, **views),
            _views(rng, False, **views), _views(rng, True, **views))


def _convert(batch, to_tensor, tform_cls):
    out = {}
    for k, v in batch.items():
        if k == 'noise':
            out[k] = {n: to_tensor(np.asarray(a, np.float32))
                      for n, a in v.items()}
        elif k == 'aug_tform':
            out[k] = tform_cls(**{n: to_tensor(a) for n, a in v.items()})
        elif k == 'class':
            out[k] = to_tensor(np.asarray(v, np.int32))
        else:
            out[k] = to_tensor(np.asarray(v, np.float32))
    return out


def to_port(batch):
    out = _convert(batch, torch.tensor, augment.AffineTransform)
    if 'class' in out:
        out['class'] = out['class'].long()
    return out


def to_jax(batch):
    return _convert(batch, jnp.asarray, jax_augment.AffineTransform)


def _class_table(variables, sd, key):
    if f'{key}.weight' in sd:
        variables['params'][key] = {'embedding': sd[f'{key}.weight']}
    return variables


def _jax_disc(module):
    if module is None:
        return None
    sd = {k: v.numpy().copy() for k, v in module.state_dict().items()}
    return jax.tree_util.tree_map(jnp.asarray, _class_table(
        torch_convert.convert_discriminator(sd), sd, 'label_embedding'))


def init_states(mode):
    """The port's train state of `mode` at iteration START and JAX's from
    the same weights, with JAX's models and optimizers."""
    flags = {**CFG, **MODES[mode]}
    cfg = gan.GANConfig(**flags)
    state = gan.init_train_state(cfg, device='cpu', seed=0)
    with torch.no_grad():
        # Move the surface into the box (a fresh decoder is inside the
        # surface nearly everywhere).
        state.gen.decoder.net[2].bias[0] += 1.0
    state.gen_ema.load_state_dict(state.gen.state_dict())
    state.iteration = START
    state.augment_p = 0.5
    g_sd = {k: v.numpy().copy() for k, v in state.gen.state_dict().items()}

    jcfg = jax_gan.GANConfig(use_pallas=False, fine_sampling=True,
                             **flags)
    jgen, jdisc = jax_gan.make_models(jcfg)
    disc2 = jax_gan.make_second_discriminator(jcfg)
    opt_g, opt_d = jax_gan.make_optimizers(jcfg)
    params_g = jax.tree_util.tree_map(jnp.asarray, _class_table(
        torch_convert.convert_generator(
            g_sd, attention_values=CFG['attention_values'],
            plane_resolution=PLANES), g_sd, 'class_embedding'))
    params_d = _jax_disc(state.disc)
    params_d2 = _jax_disc(state.disc2)
    jstate = jax_gan.GANTrainState(
        params_g=params_g, params_d=params_d,
        ema_params_g=jax.tree_util.tree_map(lambda x: x, params_g),
        opt_g=opt_g.init(params_g),
        opt_d=None if params_d is None else opt_d.init(params_d),
        iteration=jnp.asarray(START, jnp.int32), rng=jax.random.PRNGKey(0),
        augment_p=jnp.asarray(0.5), ppl_running_avg=jnp.asarray(-1.0),
        params_d2=params_d2,
        opt_d2=None if params_d2 is None else opt_d.init(params_d2))
    return dict(cfg=cfg, state=state, jcfg=jcfg, jgen=jgen, jdisc=jdisc,
                disc2=disc2, opt_g=opt_g, opt_d=opt_d, jstate=jstate)


def run_mode(mode, seed=7):
    """Both packages' G step then D step of `mode`. Returns the port's and
    JAX's metrics per step and the states after them."""
    init = init_states(mode)
    cfg, state, jcfg, jstate = (init[k] for k in ('cfg', 'state', 'jcfg',
                                                  'jstate'))
    jgen, jdisc, disc2, opt_g, opt_d = (init[k] for k in (
        'jgen', 'jdisc', 'disc2', 'opt_g', 'opt_d'))
    g_jit = jax.jit(lambda s, b, b2: jax_gan.g_step(
        s, b, jgen, jdisc, opt_g, jcfg, batch2=b2, disc2=disc2))
    d_jit = jax.jit(lambda s, r, f, r2, f2: jax_gan.d_step(
        s, r, f, jgen, jdisc, opt_d, jcfg, use_r1_now=True,
        blur_active=True, batch2=r2, fake_batch2=f2, disc2=disc2))

    g, g2, real, fake, real2, fake2 = batches(seed, **VIEWS.get(mode, {}))
    dual = cfg.dual_discriminator
    port = [gan.g_step(state, to_port(g), cfg,
                       batch2=to_port(g2) if dual else None)]
    jstate, m = g_jit(jstate, to_jax(g), to_jax(g2) if dual else None)
    ref = [m]
    port.append(gan.d_step(
        state, to_port(real), to_port(fake), cfg,
        batch2=to_port(real2) if dual else None,
        fake_batch2=to_port(fake2) if dual else None))
    jstate, m = d_jit(jstate, to_jax(real), to_jax(fake),
                      to_jax(real2) if dual else None,
                      to_jax(fake2) if dual else None)
    ref.append(m)
    assert state.iteration == int(jstate.iteration) == START + 2
    return dict(cfg=cfg, state=state, jstate=jax.device_get(jstate),
                port=[{k: float(v) for k, v in m.items()} for m in port],
                ref=[{k: float(v) for k, v in m.items()} for m in ref])


def rel(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30)


def check_metrics(result):
    """Every metric of both steps (the same keys in both packages) within
    RTOL; returns the keys checked."""
    checked = []
    for step in (0, 1):
        port, ref = result['port'][step], result['ref'][step]
        ref = {k: v for k, v in ref.items() if k != 'overflow_resid'}
        assert set(port) == set(ref), (step, sorted(port), sorted(ref))
        for key, value in ref.items():
            assert np.isfinite(port[key]), key
            if value == 0.0:
                assert port[key] == 0.0, key
            else:
                assert rel(port[key], value) < RTOL, (
                    step, key, port[key], value)
            checked.append((step, key))
    return checked


def check_params(result):
    """Every parameter of G, its EMA, D and D2 after the two steps against
    JAX's (see PARAM_RTOL)."""
    state, jstate, cfg = result['state'], result['jstate'], result['cfg']
    lr_g, lr_d = cfg.lr_g / 10, cfg.lr_d / 10
    pairs = [(state.gen, convert.from_jax_params(jstate.params_g), lr_g),
             (state.gen_ema, convert.from_jax_params(jstate.ema_params_g),
              lr_g)]
    for module, tree in ((state.disc, jstate.params_d),
                         (state.disc2, jstate.params_d2)):
        assert (module is None) == (tree is None)
        if module is not None:
            pairs.append((module, convert.from_jax_discriminator(tree),
                          lr_d))
    for module, ref_sd, lr in pairs:
        port_sd = module.state_dict()
        missing = set(ref_sd) - set(port_sd)
        assert not missing, missing
        for key, ref in ref_sd.items():
            got = port_sd[key].detach().numpy().astype(np.float64)
            ref = np.asarray(ref, np.float64)
            err = np.abs(got - ref).max()
            assert err <= PARAM_RTOL * np.abs(ref).max() + 2 * lr, (
                key, err, np.abs(ref).max())
