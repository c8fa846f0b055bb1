"""StyleGAN noise injection (cub, imagenet_elephant) against the JAX
package.

A small generator with noise (latent 32, 32^2 planes of narrow channels)
whose per-layer `noise_strength` is drawn away from its zero start feeds
both packages through JAX's `convert_generator`, which carries each
layer's `noise_strength` and `noise_const` across. The synthesis is held
against JAX's in the 'random' mode with the same injected per-layer
values (numpy draws, outermost layer first) and in the 'const' mode, at
2e-4, the tolerance of the synthesis golden (`tests/test_weight_parity.py`);
the 'none' mode equals a model built without noise; the gradient of the
planes to every `noise_strength` is held against JAX's. One G step and
one D step, each from the same fresh state and with every draw injected
(the StyleGAN noise as `sg_noise`), are held against JAX's `g_step` and
`d_step` at rtol 1e-4 (`test_torch_port_gan_step.py`'s setting, with
noise; `slow` and `parity`: JAX compiles both steps for minutes), and
in the gate the G step's forward (its render and regularizers) against
JAX's `generator_forward`. The distillation's target render with
injected noise is held against JAX's `render_distillation_targets`. A
reference-format checkpoint carries the noise across.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_distill as ds
import test_torch_port_gan_step as gs
from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.train import encoder as jax_enc
from nerf_from_image_tpu.train import gan as jax_gan
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.train import encoder as enc
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import checkpoint

CONFIG = dict(latent_dim=32, scene_range=2.0, attention_values=4,
              img_resolution=32, channel_base=1024, channel_max=64)
SYNTH_TOL = 2e-4
STEP_RTOL = 1e-4
RESOLUTIONS = (4, 8, 16, 32)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Beside other test processes, torch's default of one thread a core
    spins on shared cores; these small tensors run as fast on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _with_strengths(gen, seed):
    """Draws every layer's noise_strength from N(0, 0.3^2), in place."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name.endswith('noise_strength'):
                p.fill_(float(rng.standard_normal() * 0.3))
    return gen


def _layer_values(rng, batch, resolutions):
    return [rng.standard_normal((batch, 1, r, r)).astype(np.float32)
            for r in resolutions for _ in range(1 if r == 4 else 2)]


@pytest.fixture(scope='module')
def models():
    port = _with_strengths(Generator(device='cpu', use_stylegan_noise=True,
                                     **CONFIG), 1)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       torch_convert.convert_generator(
                                           sd, attention_values=4,
                                           plane_resolution=32))
    jgen = JaxGenerator(use_stylegan_noise=True, **CONFIG)
    rng = np.random.default_rng(2)
    ws = rng.standard_normal((2, 14, 512)).astype(np.float32)
    values = _layer_values(rng, 2, RESOLUTIONS)
    return dict(port=port, jgen=jgen, variables=variables, ws=ws,
                values=values)


def _jax_planes(m, noise_mode=None, noise_rng=None, params=None):
    variables = dict(m['variables'])
    if params is not None:
        variables['params'] = params
    return m['jgen'].apply(variables, jnp.asarray(m['ws']),
                           noise_mode=noise_mode, noise_rng=noise_rng,
                           method=JaxGenerator.synthesize_planes)


def _close(a, b, tol=SYNTH_TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol,
                               atol=tol)


def test_policy_matches_jax(models):
    """The three modes: 'random' with a source, 'const' without, 'none'
    for a model built without noise (whatever the source)."""
    port, jgen = models['port'], models['jgen']
    plain = Generator(device='cpu', **CONFIG)
    jplain = JaxGenerator(**CONFIG)
    source = torch.Generator().manual_seed(0)
    assert port.noise_mode(source) == 'random' == jgen.resolve_noise_mode(
        None, jax.random.PRNGKey(0))
    assert port.noise_mode(None) == 'const' == jgen.resolve_noise_mode(
        None, None)
    for src in (source, None):
        assert plain.noise_mode(src) == 'none'
        assert jplain.resolve_noise_mode(
            None, None if src is None else jax.random.PRNGKey(0)) == 'none'


@pytest.mark.parametrize('mode', ['random', 'const'])
def test_synthesis_matches_jax(models, mode):
    values = models['values'] if mode == 'random' else None
    with torch.no_grad():
        got = models['port'].synthesize_planes(
            torch.tensor(models['ws']),
            None if values is None else [torch.tensor(v) for v in values])
    ref = _jax_planes(models, None, None if values is None else
                      tuple(jnp.asarray(v) for v in values))
    assert np.abs(np.asarray(ref)).max() > 0.1
    _close(got.numpy(), ref)


def test_random_draws_from_a_generator(models):
    """A generator as the source draws (B, 1, res, res) float32 normals,
    layer by layer from the outermost, as injected values of the same
    draws give."""
    port, ws = models['port'], torch.tensor(models['ws'])
    draws = torch.Generator().manual_seed(5)
    values = [torch.randn((2, 1, r, r), generator=draws)
              for r in RESOLUTIONS for _ in range(1 if r == 4 else 2)]
    with torch.no_grad():
        got = port.synthesize_planes(ws, torch.Generator().manual_seed(5))
        ref = port.synthesize_planes(ws, values)
    assert torch.equal(got, ref)


def test_none_equals_the_model_without_noise(models):
    """'none' adds nothing: the noise model's planes in that mode equal a
    model built without noise on the same weights, and JAX's."""
    port = models['port']
    plain = Generator(device='cpu', **CONFIG)
    plain.load_state_dict(port.state_dict())
    ws = torch.tensor(models['ws'])
    with torch.no_grad():
        got = port.synthesis_network(ws, 'none')
        ref = plain.synthesize_planes(ws, torch.Generator().manual_seed(0))
    assert torch.equal(got.reshape(ref.shape), ref)
    _close(ref.numpy(), _jax_planes(models, 'none'))


def test_noise_strength_gradients_match_jax(models):
    """d(sum(planes * r)) / d(noise_strength) of every layer, 'random'
    mode, relative to the largest."""
    rng = np.random.default_rng(3)
    r = rng.standard_normal((2, 3, 32, 32, 32)).astype(np.float32)
    port = models['port']
    values = models['values']
    names = [n for n, _ in port.named_parameters()
             if n.endswith('noise_strength')]
    params = dict(port.named_parameters())
    planes = port.synthesize_planes(torch.tensor(models['ws']),
                                    [torch.tensor(v) for v in values])
    grads = torch.autograd.grad((planes * torch.tensor(r)).sum(),
                                [params[n] for n in names])

    def loss(p):
        return jnp.sum(_jax_planes(models, None, tuple(
            jnp.asarray(v) for v in values), params=p) * r)

    ref = jax.grad(loss)(models['variables']['params'])
    got, want = [], []
    for name, g in zip(names, grads):
        _, block, conv, _ = name.split('.')
        got.append(float(g))
        want.append(float(ref['synthesis_network'][block][conv][
            'noise_strength']))
    got, want = np.array(got), np.array(want)
    assert len(got) == 7 and np.abs(want).min() > 0
    assert np.abs(got - want).max() / np.abs(want).max() < SYNTH_TOL


def test_distillation_targets_with_noise_match_jax(models):
    """The distillation's target render of the noise model, its SDF's
    zero level moved into the box, with every draw injected (depths, PDF
    draws, per-layer noise): image, mask, coordinates and ws against
    JAX's `render_distillation_targets` within 1e-5 of each one's largest
    value, as without noise (`test_torch_port_distill.py`); other noise
    gives another image."""
    port = copy.deepcopy(models['port'])
    with torch.no_grad():
        port.decoder.net[2].bias[0] = -1.5
    variables = jax.tree_util.tree_map(
        jnp.asarray, torch_convert.convert_generator(
            {k: v.numpy() for k, v in port.state_dict().items()},
            attention_values=4, plane_resolution=32))
    enc_cfg = dict(ds.ENC_CFG, scene_range=CONFIG['scene_range'])
    batch = ds._batch(np.random.default_rng(7))
    values = models['values']

    def port_targets(layer_values):
        with torch.no_grad():
            return enc.render_distillation_targets(
                port, torch.tensor(batch['z']), torch.tensor(batch['pose']),
                torch.tensor(batch['focal']), None, None,
                enc.EncoderConfig(**enc_cfg),
                {k: torch.tensor(a) for k, a in batch['noise'].items()},
                noise=[torch.tensor(v) for v in layer_values])

    got = port_targets(values)
    jnoise = {k: jnp.asarray(a) for k, a in batch['noise'].items()}
    jnoise['sg_noise'] = tuple(jnp.asarray(v) for v in values)
    ref = jax.jit(lambda b, n: jax_enc.render_distillation_targets(
        models['jgen'], variables, b['z'], b['pose'], b['focal'], None,
        None, jax_enc.EncoderConfig(**enc_cfg), jax.random.PRNGKey(1),
        noise=n))({k: jnp.asarray(batch[k]) for k in ('z', 'pose', 'focal')},
                  jnoise)
    for a, b, name in zip(got, ref, ('image', 'mask', 'coords', 'ws')):
        assert tuple(a.shape) == np.asarray(b).shape, name
        assert ds._rel(a.numpy(), b) < 1e-5, name
    assert float(got[1].max()) > 0.3
    other = port_targets(_layer_values(np.random.default_rng(8), 2,
                                       RESOLUTIONS))
    assert not torch.equal(other[0], got[0])


# ---- One G step and one D step, with noise -----------------------------

NOISE_CFG = dict(gs.CFG, use_stylegan_noise=True)
STEP_RESOLUTIONS = (4, 8, 16, 32, 64)


def _with_sg_noise(batch, rng):
    batch = dict(batch)
    batch['noise'] = dict(batch['noise'], sg_noise=_layer_values(
        rng, gs.BATCH, STEP_RESOLUTIONS))
    return batch


def _port_batch(batch):
    sg = batch['noise']['sg_noise']
    out = gs._to_port(dict(batch, noise={k: v for k, v in
                                         batch['noise'].items()
                                         if k != 'sg_noise'}))
    out['noise']['sg_noise'] = [torch.tensor(v) for v in sg]
    return out


def _jax_batch(batch):
    sg = batch['noise']['sg_noise']
    out = gs._to_jax(dict(batch, noise={k: v for k, v in
                                        batch['noise'].items()
                                        if k != 'sg_noise'}))
    out['noise']['sg_noise'] = tuple(jnp.asarray(v) for v in sg)
    return out


def _fresh_states():
    cfg = gan.GANConfig(**NOISE_CFG)
    state = gan.init_train_state(cfg, device='cpu', seed=0)
    _with_strengths(state.gen, 4)
    with torch.no_grad():
        state.gen.decoder.net[2].bias[0] += 1.0  # as the G/D step test
    state.gen_ema.load_state_dict(state.gen.state_dict())
    state.augment_p = 0.5
    g_sd = {k: v.numpy().copy() for k, v in state.gen.state_dict().items()}
    d_sd = {k: v.numpy().copy() for k, v in state.disc.state_dict().items()}
    jcfg = jax_gan.GANConfig(use_pallas=False, fine_sampling=True,
                             **NOISE_CFG)
    jgen, jdisc = jax_gan.make_models(jcfg)
    opt_g, opt_d = jax_gan.make_optimizers(jcfg)
    params_g = jax.tree_util.tree_map(
        jnp.asarray, torch_convert.convert_generator(
            g_sd, attention_values=NOISE_CFG['attention_values'],
            plane_resolution=NOISE_CFG['plane_resolution']))
    params_d = jax.tree_util.tree_map(
        jnp.asarray, torch_convert.convert_discriminator(d_sd))
    jstate = jax_gan.GANTrainState(
        params_g=params_g, params_d=params_d,
        ema_params_g=jax.tree_util.tree_map(lambda x: x, params_g),
        opt_g=opt_g.init(params_g), opt_d=opt_d.init(params_d),
        iteration=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
        augment_p=jnp.asarray(0.5), ppl_running_avg=jnp.asarray(-1.0))
    return cfg, state, jcfg, jgen, jdisc, opt_g, opt_d, jstate


@pytest.fixture(scope='module')
def steps():
    rng = np.random.default_rng(11)
    g0, real, fake, _ = gs._batches(7)
    g0, fake = _with_sg_noise(g0, rng), _with_sg_noise(fake, rng)

    cfg, state, jcfg, jgen, jdisc, opt_g, _, jstate = _fresh_states()
    port_g = gan.g_step(state, _port_batch(g0), cfg)
    _, ref_g = jax.jit(lambda s, b: jax_gan.g_step(
        s, b, jgen, jdisc, opt_g, jcfg))(jstate, _jax_batch(g0))

    cfg, state, jcfg, jgen, jdisc, _, opt_d, jstate = _fresh_states()
    state.iteration = 1
    jstate = jstate.replace(iteration=jnp.ones((), jnp.int32))
    port_d = gan.d_step(state, gs._to_port(real), _port_batch(fake), cfg)
    _, ref_d = jax.jit(lambda s, b, f: jax_gan.d_step(
        s, b, f, jgen, jdisc, opt_d, jcfg, use_r1_now=True,
        blur_active=True))(jstate, gs._to_jax(real), _jax_batch(fake))
    return {'g': ({k: float(v) for k, v in port_g.items()},
                  {k: float(v) for k, v in ref_g.items()}),
            'd': ({k: float(v) for k, v in port_d.items()},
                  {k: float(v) for k, v in ref_d.items()})}


@pytest.mark.slow
@pytest.mark.parity
@pytest.mark.parametrize('step,key', [('g', k) for k in gs.G_METRICS] +
                         [('d', k) for k in gs.D_METRICS])
def test_step_with_noise_matches_jax(steps, step, key):
    got, ref = steps[step][0][key], steps[step][1][key]
    assert np.isfinite(got) and ref != 0.0
    assert abs(got - ref) / abs(ref) < STEP_RTOL, (got, ref)


def test_g_forward_with_noise_matches_jax():
    """The G step's forward with injected noise (the quick form of the
    step comparison above): the render and the three regularizers of
    `generator_forward` against JAX's, at STEP_RTOL of each mean."""
    g0 = _with_sg_noise(gs._batches(7)[0], np.random.default_rng(11))
    cfg, state, jcfg, jgen, _, _, _, jstate = _fresh_states()
    requests = ('sdf_eikonal_loss', 'total_variation_loss', 'entropy_loss')
    pb, jb = _port_batch(g0), _jax_batch(g0)
    out, extra = gan.generator_forward(state.gen, pb['z'], pb['pose'],
                                       pb['focal'], cfg, state.rng, requests,
                                       pb['noise'])
    ref, ref_extra = jax.jit(lambda p, b: jax_gan.generator_forward(
        jgen, p, b['z'], b['pose'], b['focal'], None, None, jcfg,
        jax.random.PRNGKey(0), requests, noise=b['noise']))(
            jstate.params_g, jb)
    pairs = [('rgb', out.rgb, ref.rgb), ('mask', out.mask, ref.mask)] + [
        (k, extra[k], ref_extra[k]) for k in requests]
    for name, got, want in pairs:
        got = float(got.detach().double().mean())
        want = float(np.asarray(want, np.float64).mean())
        assert want != 0.0 and abs(got - want) / abs(want) < STEP_RTOL, (
            name, got, want)


def test_noise_changes_the_step():
    """The injected noise reaches the render: other draws give another
    G loss."""
    g0 = gs._batches(7)[0]
    losses = []
    for seed in (11, 12):
        cfg, state = _fresh_states()[:2]
        batch = _with_sg_noise(g0, np.random.default_rng(seed))
        losses.append(float(gan.g_step(state, _port_batch(batch),
                                       cfg)['loss_g']))
    assert losses[0] != losses[1]


def test_checkpoint_carries_the_noise(tmp_path):
    """A reference-format GAN checkpoint of a noise model restores every
    noise_strength and noise_const into a fresh state, and JAX's
    converter reads them from it."""
    cfg = gan.GANConfig(resolution=16, latent_dim=32, attention_values=4,
                        plane_resolution=32, channel_base=1024,
                        channel_max=64, use_stylegan_noise=True)
    state = gan.init_train_state(cfg, device='cpu', seed=0)
    _with_strengths(state.gen_ema, 5)
    path = str(tmp_path / 'gan.pth')
    checkpoint.save(checkpoint.gan_checkpoint(state), path)
    saved = checkpoint.load(path)
    fresh = gan.init_train_state(cfg, device='cpu', seed=1)
    checkpoint.restore_gan_checkpoint(saved, fresh)
    want = state.gen_ema.state_dict()
    keys = [k for k in want if 'noise' in k]
    assert len(keys) == 14
    got = fresh.gen_ema.state_dict()
    for k in keys:
        assert torch.equal(got[k], want[k]), k
    variables = torch_convert.convert_generator(
        {k: v.numpy() for k, v in saved['model_ema'].items()},
        attention_values=4, plane_resolution=32)
    b8 = variables['params']['synthesis_network']['b8']['conv0']
    assert float(b8['noise_strength']) == float(
        want['synthesis_network.b8.conv0.noise_strength'])
    np.testing.assert_array_equal(
        variables['buffers']['synthesis_network']['b8']['conv0'][
            'noise_const'],
        want['synthesis_network.b8.conv0.noise_const'].numpy())
