"""Encoder distillation in the port against the JAX package and the
reference tape: the coordinate render, stochastic depth, the learning
rate schedule, the distillation targets and the train step.

A small generator (latent 32, 64^2 planes, four attention values) from a
seeded JAX init and a tiny SegFormer encoder from one reference-format
state dict feed both packages; renders are 16^2 with 8 + 8 samples in
p3d_car's box (1.4, black background, flipped cameras), every draw made
with numpy and injected into both. JAX runs its XLA decode
(`use_pallas=False`), the port its CPU path (the plain version of kernel
B1), in float32. Stochastic depth cannot draw JAX's masks, so the steps
run with a drop-path rate of 0 and the masks are tested on their own.
`tests/golden/trajectory_encoder.npz` is replayed through the port with
no JAX call (slow, parity). Tolerances are stated per check.
"""

import functools
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.models.encoder import \
    BootstrapEncoder as JaxBootstrapEncoder
from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.render import render as jax_render
from nerf_from_image_tpu.train import encoder as jax_enc
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.models import segformer
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.render.renderer import render
from nerf_from_image_tpu_torch.train import encoder as enc
from nerf_from_image_tpu_torch.utils import convert

CONFIG = dict(latent_dim=32, scene_range=1.4, attention_values=4,
              img_resolution=64, channel_base=1024, channel_max=64)
TINY = dict(depths=(1, 1, 1, 1), embed_dims=(8, 8, 16, 16),
            num_heads=(1, 1, 2, 2), sr_ratios=(2, 1, 1, 1), head_width=16)
BATCH, RES, SAMPLES, STEPS = 2, 16, 8, 3
ENC_CFG = dict(resolution=RES, latent_dim=32, depth_samples_per_ray=SAMPLES,
               scene_range=1.4, white_background=False)
GOLDEN = pathlib.Path(__file__).parent / 'golden' / 'trajectory_encoder.npz'


def _rel(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30)


def _cameras(rng, b):
    """Flipped perspective cameras of the p3d_car form at random
    azimuths, as numpy (cam2world, focal)."""
    theta = rng.uniform(-np.pi, np.pi, b)
    quat = np.stack((np.cos(theta / 2), np.zeros(b), np.sin(theta / 2),
                     np.zeros(b)), axis=-1)
    quat = quat + rng.standard_normal((b, 4)) * 0.05
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))

    cam, focal = pose_lib.pose_to_matrix(
        t(np.full(b, np.log(2.0))), t(rng.uniform(-0.05, 0.05, (b, 2))),
        t(np.ones(b)), t(quat), True)
    return cam.numpy(), focal.numpy()


def _batch(rng):
    cam, focal = _cameras(rng, BATCH)
    return {'pose': cam, 'focal': focal,
            'z': rng.standard_normal((BATCH, 32)).astype(np.float32),
            'noise': {'depth': rng.random((BATCH, RES, RES, SAMPLES)).astype(
                np.float32), 'pdf_u': rng.random(
                    (BATCH * RES * RES, SAMPLES)).astype(np.float32)}}


def _to(batch, fn):
    return {k: ({n: fn(a) for n, a in v.items()} if k == 'noise' else fn(v))
            for k, v in batch.items()}


@pytest.fixture(scope='module')
def pair():
    """A seeded JAX generator (its SDF's zero level moved into the box)
    and the port's frozen copy of it."""
    jgen = JaxGenerator(**CONFIG)
    variables = jax.jit(jgen.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((BATCH, CONFIG['latent_dim'])))
    variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    variables['params']['decoder']['fc1']['bias'][0] = -1.5
    port = Generator(device='cpu', **CONFIG)
    convert.load_reference_state_dict(port,
                                      convert.from_jax_params(variables))
    port.requires_grad_(False)
    return jgen, variables, port


def test_coordinate_render_matches_jax(pair):
    """`render(compute_coords=True)`: rgb, mask, depth and the composited
    points against JAX's within 1e-5 of each one's largest value; the
    same render without coordinates gives rgb, mask and depth bit for
    bit; and the gradient of the coordinate map to the decoder's weights
    (through the weights, which the composite does not detach) within
    1e-4 relative."""
    jgen, variables, port = pair
    rng = np.random.default_rng(1)
    batch = _batch(rng)
    draws = batch['noise']

    @functools.partial(jax.jit, static_argnums=3)
    def field(v, state, pts, reqs):
        return jgen.apply(v, state, pts, reqs, method=JaxGenerator.sample)

    def jax_coords(v):
        state = jgen.apply(v, jgen.apply(v, jnp.asarray(batch['z']),
                                         method=JaxGenerator.map),
                           method=JaxGenerator.synthesize)
        return jax_render(lambda pts, reqs: field(v, state, pts, reqs), RES,
                          RES, jnp.asarray(batch['pose']),
                          jnp.asarray(batch['focal']), None, None, 1.4,
                          False, SAMPLES,
                          rng={k: jnp.asarray(a) for k, a in draws.items()},
                          fine_sampling=True, compute_coords=True)

    ref = jax_coords(variables)

    def port_render(compute_coords):
        state = port.synthesize(port.map(torch.tensor(batch['z'])))
        return render(port.field(state), RES,
                      RES, torch.tensor(batch['pose']),
                      torch.tensor(batch['focal']), 1.4, False, SAMPLES,
                      rng={k: torch.tensor(a) for k, a in draws.items()},
                      compute_coords=compute_coords)

    out = port_render(True)
    assert out.semantics.shape == (BATCH, RES, RES, 3)
    assert float(out.mask.max()) > 0.3
    for name in ('rgb', 'mask', 'depth', 'semantics'):
        got = getattr(out, name).detach().numpy()
        assert _rel(got, getattr(ref, name)) < 1e-5, name
    with torch.no_grad():
        plain = port_render(False)
    assert plain.semantics is None
    for name in ('rgb', 'mask', 'depth'):
        assert torch.equal(getattr(plain, name), getattr(out, name)), name

    weight = port.decoder.net[2].weight
    weight.requires_grad_(True)
    try:
        got, = torch.autograd.grad(port_render(True).semantics.sum(),
                                   weight)
    finally:
        weight.requires_grad_(False)
    ref_grad = jax.grad(lambda w: jnp.sum(jax_coords(dict(
        variables, params=dict(variables['params'], decoder=dict(
            variables['params']['decoder'], fc1=dict(
                variables['params']['decoder']['fc1'], weight=w))))
    ).semantics))(jnp.asarray(variables['params']['decoder']['fc1'][
        'weight']))
    assert np.abs(np.asarray(ref_grad)).max() > 0
    assert _rel(got.numpy(), ref_grad) < 1e-4


def test_fused_view_refuses_coordinates(pair):
    """The fused view decodes sigma and rgb only; it refuses 'coords'
    rather than dropping it, so a coordinate render never takes B5a."""
    _, _, port = pair
    fused = port.fused_view()
    with torch.no_grad():
        state = fused.synthesize(fused.map(torch.zeros((BATCH, 32))))
        with pytest.raises(ValueError, match='sigma and rgb'):
            fused.sample(state, torch.zeros((BATCH, 10, 3)),
                         ('sigma', 'rgb', 'coords'))
    out = port.sample(port.synthesize(port.map(torch.zeros((BATCH, 32)))),
                      torch.ones((BATCH, 4, 5, 3)), ('coords',))
    assert torch.equal(out['coords'], torch.ones((BATCH, 20, 3)))


def test_drop_path_masks_come_from_the_generator():
    """Each sample's residual is kept with probability 1 - rate and
    rescaled, its mask the generator's uniform draw below 1 - rate on the
    activations' device; a seeded generator repeats, another seed
    differs."""
    x = torch.ones((256, 3, 5))
    out = segformer.drop_path(x, 0.25, True, torch.Generator().manual_seed(3))
    keep = torch.rand((256, 1, 1), generator=torch.Generator().manual_seed(
        3)) < 0.75
    assert torch.equal(out, x * keep / 0.75)
    again = segformer.drop_path(x, 0.25, True,
                                torch.Generator().manual_seed(3))
    other = segformer.drop_path(x, 0.25, True,
                                torch.Generator().manual_seed(4))
    assert torch.equal(out, again) and not torch.equal(out, other)
    assert 0.6 < float(keep.float().mean()) < 0.9


def test_encoder_train_mode_is_repeatable_and_eval_is_the_identity():
    """Train mode with drop path 0.1 draws from the generator it is given:
    the same seed gives the same outputs, another seed others, and no
    generator raises. Eval mode ignores stochastic depth (with or without
    a generator, equal to a rate-0 encoder in train mode)."""
    sd = {k: torch.tensor(v) for k, v in
          convert.random_encoder_state_dict(5, **TINY).items()}
    encoder = BootstrapEncoder(512, device='cpu', drop_path_rate=0.5, **TINY)
    encoder.load_state_dict(sd)
    x = torch.rand((4, 3, RES, RES)) * 2 - 1

    def run(seed):
        return encoder(x, torch.Generator().manual_seed(seed))

    encoder.train()
    a, b, c = run(0), run(0), run(1)
    for u, v, w in zip(a, b, c):
        assert torch.equal(u, v)
    assert not all(torch.equal(u, w) for u, w in zip(a, c))
    with pytest.raises(ValueError, match='explicit generator'):
        encoder(x)
    encoder.eval()
    e1, e2 = encoder(x), run(0)
    zero = BootstrapEncoder(512, device='cpu', drop_path_rate=0.0, **TINY)
    zero.load_state_dict(sd)
    zero.train()
    e3 = zero(x)
    for u, v, w in zip(e1, e2, e3):
        assert torch.equal(u, v)
        torch.testing.assert_close(u, w, rtol=0, atol=0)


@pytest.mark.parametrize('count', [0, 59999, 60000, 119999])
def test_lr_schedule_matches_jax(count):
    """LR below 60,000 optimizer steps, LR / 10 from 60,000 on."""
    assert enc.lr_schedule(count) == pytest.approx(
        float(jax_enc.lr_schedule(jnp.asarray(count))), rel=1e-7)
    assert enc.lr_schedule(count) == (enc.LR if count < 60000
                                      else enc.LR / 10.0)


@pytest.fixture(scope='module')
def distilled(pair):
    """Three train steps in each package from one encoder state dict
    (drop path 0) and the same injected draws."""
    jgen, variables, port = pair
    enc_sd = convert.random_encoder_state_dict(6, **TINY)
    cfg = enc.EncoderConfig(**ENC_CFG)
    encoder = BootstrapEncoder(512, device='cpu', drop_path_rate=0.0, **TINY)
    encoder.load_state_dict({k: torch.tensor(v) for k, v in enc_sd.items()})
    state = enc.init_train_state(encoder, seed=0)

    jcfg = jax_enc.EncoderConfig(**ENC_CFG)
    jenc = JaxBootstrapEncoder(latent_dim=512, drop_path_rate=0.0, **TINY)
    params = jax.tree_util.tree_map(
        jnp.asarray, torch_convert.convert_bootstrap_encoder(enc_sd))
    opt = jax_enc.make_optimizer()
    jstate = jax_enc.EncoderTrainState(
        params=params, opt_state=opt.init(params),
        iteration=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    step_jit = jax.jit(lambda s, b: jax_enc.train_step(
        s, b, jenc, jgen, variables, opt, jcfg))
    targets_jit = jax.jit(lambda b: jax_enc.render_distillation_targets(
        jgen, variables, b['z'], b['pose'], b['focal'], None, None, jcfg,
        jax.random.PRNGKey(1), noise=b['noise']))

    rng = np.random.default_rng(7)
    batches = [_batch(rng) for _ in range(STEPS)]
    b0 = batches[0]
    targets = enc.render_distillation_targets(
        port, torch.tensor(b0['z']), torch.tensor(b0['pose']),
        torch.tensor(b0['focal']), None, None, cfg,
        {k: torch.tensor(a) for k, a in b0['noise'].items()})
    jtargets = targets_jit(_to(b0, jnp.asarray))
    port_m, ref_m = [], []
    for b in batches:
        port_m.append(enc.train_step(state, _to(b, torch.tensor), port, cfg))
        jstate, m = step_jit(jstate, _to(b, jnp.asarray))
        ref_m.append(m)
    assert state.iteration == int(jstate.iteration) == STEPS
    return dict(targets=targets, jtargets=jax.device_get(jtargets),
                port=[{k: float(v) for k, v in m.items()} for m in port_m],
                ref=[{k: float(v) for k, v in m.items()} for m in ref_m],
                state=state, jparams=jax.device_get(jstate.params))


def test_distillation_targets_match_jax(distilled):
    """Image (clipped), mask, coordinates and ws within 1e-5 of each
    one's largest value; the mask sees the surface."""
    for got, ref, name in zip(distilled['targets'], distilled['jtargets'],
                              ('image', 'mask', 'coords', 'ws')):
        assert tuple(got.shape) == np.asarray(ref).shape, name
        assert _rel(got.numpy(), ref) < 1e-5, name
    assert float(distilled['targets'][1].max()) > 0.3
    assert float(distilled['targets'][0].abs().max()) <= 1.0


@pytest.mark.parametrize('step,key', [
    (s, k) for s in range(STEPS)
    for k in ('loss_coords', 'loss_mask', 'loss_latent')])
def test_train_step_metrics_match_jax(distilled, step, key):
    """The three losses of each step within 1e-4 relative."""
    got = distilled['port'][step][key]
    ref = distilled['ref'][step][key]
    assert np.isfinite(got) and ref != 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_encoder_after_three_steps_matches_jax(distilled):
    """Every encoder parameter after three Adam steps, brought to JAX's
    tree by `convert_bootstrap_encoder`, within 1e-3 of each tensor's
    largest entry (float32 sums in another order). One exception: the
    key half of each attention's `kv` bias shifts every logit of a query
    alike, so the softmax leaves its gradient at 0 in exact arithmetic
    and at float32 noise here; Adam moves such an entry by up to lr a
    step either way, so that half is held to 2 x 3 steps x lr."""
    sd = {k: v.detach().numpy() for k, v in
          distilled['state'].encoder.state_dict().items()}
    got = jax.tree_util.tree_flatten_with_path(
        torch_convert.convert_bootstrap_encoder(sd))[0]
    ref = dict(jax.tree_util.tree_flatten_with_path(distilled['jparams'])[0])
    assert len(got) == len(ref) > 50
    for path, value in got:
        name = jax.tree_util.keystr(path)
        want = np.asarray(ref[path])
        if name.endswith("['attn']['kv']['bias']"):
            half = value.shape[0] // 2
            assert np.abs(value[:half] - want[:half]).max() <= (
                2 * STEPS * enc.LR), name
            value, want = value[half:], want[half:]
        assert _rel(value, want) < 1e-3, name


# --- the reference tape, replayed with no JAX -------------------------------

def _regen(entry):
    r = np.random.RandomState(entry['seed'])
    shape = tuple(entry['shape'])
    vals = (r.random_sample(shape) if entry['kind'] == 'rand'
            else r.standard_normal(shape))
    return torch.tensor(vals.astype(np.float32))


class _Tape:
    KEEP = {'run.py:train_coord_regressor',
            'nerf_utils.py:compute_query_points_from_rays',
            'nerf_utils.py:sample_pdf', 'utils.py:_yield_batch',
            'tap:add_scalar'}

    def __init__(self, tape):
        self.entries = [e for e in tape if e['site'] in self.KEEP]
        self.pos = 0

    def take(self, site, kind):
        e = self.entries[self.pos]
        assert e['site'] == site and e['kind'] == kind, (self.pos, e)
        self.pos += 1
        return e


class _SamplerReplay:
    """The reference's endless sampler, its permutations from the tape."""

    def __init__(self, tape, dataset_size):
        self.tape, self.n, self.ptr, self.perm = tape, dataset_size, 0, None

    def __call__(self, batch_size):
        out = []
        for _ in range(batch_size):
            if self.perm is None:
                self.perm = self.tape.take('utils.py:_yield_batch',
                                           'permutation')['values']
            out.append(self.perm[self.ptr])
            self.ptr += 1
            if self.ptr == self.n:
                self.ptr, self.perm = 0, None
        return np.asarray(out)


@pytest.fixture(scope='module')
def tape_replay():
    d = np.load(GOLDEN)
    cfg_ref = json.loads(str(d['config_json']))
    tape = json.loads(str(d['tape_json']))

    def prefixed(prefix):
        return {k[len(prefix):]: d[k] for k in d.files
                if k.startswith(prefix)}

    g_sd, enc_sd, final_sd = (prefixed(p) for p in
                              ('init_g/', 'init_enc/', 'final/'))
    gen = Generator(latent_dim=cfg_ref['latent_dim'],
                    scene_range=cfg_ref['scene_range'], attention_values=10,
                    img_resolution=256, channel_base=cfg_ref['channel_base'],
                    channel_max=cfg_ref['channel_max'], device='cpu')
    convert.load_reference_state_dict(gen, g_sd)
    gen.requires_grad_(False)
    cfg = enc.EncoderConfig(resolution=cfg_ref['resolution'],
                            latent_dim=cfg_ref['latent_dim'],
                            scene_range=cfg_ref['scene_range'],
                            white_background=cfg_ref['white_background'])
    encoder = BootstrapEncoder(
        cfg_ref['latent_dim'], depths=tuple(cfg_ref['seg_depths']),
        embed_dims=tuple(cfg_ref['seg_embed_dims']),
        num_heads=tuple(cfg_ref['seg_num_heads']),
        sr_ratios=tuple(cfg_ref['seg_sr_ratios']), drop_path_rate=0.0,
        head_width=enc_sd['post.4.weight'].shape[1], device='cpu')
    encoder.load_state_dict({k: torch.tensor(v) for k, v in enc_sd.items()})
    state = enc.init_train_state(encoder)
    poses = torch.tensor(d['poses'])
    focal = torch.full((cfg_ref['batch_size'],), float(d['focal']))
    reader = _Tape(tape)
    sampler = _SamplerReplay(reader, cfg_ref['n_images'])
    results = []
    for it in range(cfg_ref['iterations']):
        idx = sampler(cfg_ref['batch_size'])
        z = _regen(reader.take('run.py:train_coord_regressor', 'randn'))
        noise = {'depth': _regen(reader.take(
            'nerf_utils.py:compute_query_points_from_rays', 'rand')),
            'pdf_u': _regen(reader.take('nerf_utils.py:sample_pdf', 'rand'))}
        got = enc.train_step(state, {'pose': poses[idx], 'focal': focal,
                                     'z': z, 'noise': noise}, gen, cfg)
        ref = {}
        for key in ('loss_coords', 'loss_mask', 'loss_latent'):
            e = reader.take('tap:add_scalar', 'scalar')
            assert e['tag'] == f'coord_regressor/{key}'
            ref[key] = e['value']
        results.append(({k: float(v) for k, v in got.items()}, ref))
    assert reader.pos == len(reader.entries)
    return results, state.encoder.state_dict(), final_sd


@pytest.mark.slow
@pytest.mark.parity
@pytest.mark.skipif(not GOLDEN.exists(), reason='encoder tape missing')
@pytest.mark.parametrize('step', [0, 1, 2])
@pytest.mark.parametrize('key', ['loss_coords', 'loss_mask', 'loss_latent'])
def test_tape_scalar_matches_reference(tape_replay, step, key):
    """Each step's three losses at the JAX replay's tolerances (rtol 1e-4,
    atol 2e-6, `tests/test_encoder_trajectory.py`)."""
    results, _, _ = tape_replay
    got, ref = results[step]
    np.testing.assert_allclose(
        got[key], ref[key],
        rtol=float(os.environ.get('NFI_TRAJ_RTOL', 1e-4)),
        atol=float(os.environ.get('NFI_TRAJ_ATOL', 2e-6)))


@pytest.mark.slow
@pytest.mark.parity
@pytest.mark.skipif(not GOLDEN.exists(), reason='encoder tape missing')
def test_tape_final_weights_match_reference(tape_replay):
    """The encoder after three steps against the reference's, at the JAX
    replay's tolerances (rtol 5e-3, atol 4e-4 per entry; mean |diff|
    below 2e-6 per tensor)."""
    _, got, ref = tape_replay
    assert set(got) == set(ref)
    for key, want in ref.items():
        g = got[key].numpy()
        np.testing.assert_allclose(g, want, rtol=5e-3, atol=4e-4,
                                   err_msg=key)
        assert float(np.mean(np.abs(g - want))) < 2e-6, key
