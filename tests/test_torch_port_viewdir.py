"""The view-direction mapper (carla) against the JAX package and the
weight golden.

- `ViewDirectionMapper` on `weight_golden.npz`'s reference weights and
  inputs against `viewdir_mapper.out0` (the reference module's output)
  and against JAX's module: 1e-5.
- A small view-direction generator (latent 32, 32^2 planes, narrow
  channels, four attention values, the mapper's zero-initialized output
  layer drawn away from zero) feeds JAX through `convert_generator`:
  the port's field given directions against JAX's `synthesize(ws,
  viewdirs)` then `sample` at 1e-5, and a render, whose rays' directions
  reach the mapper, against JAX's render of a state synthesized with the
  same directions, rgb and mask within 1e-4. JAX's own callers never pass
  directions, and its render of a view-direction generator without them
  fails (the decoder's 32 features meet a palette of 4); the port refuses
  a sample without them by name.
- The fused view declines for a view-direction generator, as JAX's gate
  does: its checkpoint renders decode unfused.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.core import rays as jax_rays
from nerf_from_image_tpu.models import generator as jax_gen_lib
from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.render import render as jax_render
from nerf_from_image_tpu.render.renderer import normalize as jax_normalize
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu_torch.models.generator import (Generator,
                                                        ViewDirectionMapper)
from nerf_from_image_tpu_torch.render.renderer import render

TOL = 1e-5
RENDER_TOL = 1e-4
CONFIG = dict(latent_dim=32, scene_range=1.5, attention_values=4,
              img_resolution=32, channel_base=1024, channel_max=64)
BATCH, RES, SAMPLES = 2, 8, 4


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Beside other test processes, torch's default of one thread a core
    spins on shared cores; these small tensors run as fast on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol,
                               atol=tol)


def test_mapper_matches_golden_and_jax():
    wg = np.load(pathlib.Path(__file__).parent / 'golden' /
                 'weight_golden.npz')
    pre = 'viewdir_mapper.sd.'
    sd = {k[len(pre):]: wg[k] for k in wg.files if k.startswith(pre)}
    mapper = ViewDirectionMapper(6, num_features=16)
    mapper.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    assert list(mapper.state_dict()) == list(sd)  # the reference's order
    vd, feats = wg['viewdir_mapper.in0'], wg['viewdir_mapper.in1']
    with torch.no_grad():
        got = mapper(torch.tensor(vd), torch.tensor(feats)).numpy()
    ref = jax_gen_lib.ViewDirectionMapper(6, num_features=16).apply(
        {'params': torch_convert.convert_viewdir_mapper(sd)},
        jnp.asarray(vd), jnp.asarray(feats))
    _close(got, wg['viewdir_mapper.out0'], TOL)
    _close(got, ref, TOL)


def test_output_layer_starts_at_zero():
    mapper = ViewDirectionMapper(4, 32, generator=torch.Generator()
                                 .manual_seed(0))
    assert not mapper.output.weight.any()
    assert not mapper.output.bias.any()


@pytest.fixture(scope='module')
def pair():
    port = Generator(device='cpu', use_viewdir=True, **CONFIG)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        port.decoder.net[2].bias[0] -= 1.5
        port.viewdir_mapper.output.weight.copy_(torch.tensor(
            rng.standard_normal((4, 32)).astype(np.float32)))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    assert any(k.startswith('viewdir_mapper.norm1.') for k in sd)
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       torch_convert.convert_generator(
                                           sd, attention_values=4,
                                           use_viewdir=True,
                                           plane_resolution=32))
    jgen = JaxGenerator(use_viewdir=True, **CONFIG)
    ws = rng.standard_normal((BATCH, 15, 512)).astype(np.float32)
    return dict(port=port, jgen=jgen, variables=variables, ws=ws, rng=rng)


def test_synthesize_with_viewdirs_then_sample_matches_jax(pair):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.4, 1.4, (BATCH, 6, 5, 3)).astype(np.float32)
    vd = rng.standard_normal((BATCH, 6, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    reqs = ('sigma', 'rgb', 'semantics')
    port = pair['port']
    with torch.no_grad():
        state = port.synthesize(torch.tensor(pair['ws']))
        got = port.field(state)(torch.tensor(pts), reqs, torch.tensor(vd))

    def run(ws, vd, pts):
        st = pair['jgen'].apply(pair['variables'], ws, viewdirs=vd,
                                method=JaxGenerator.synthesize)
        return pair['jgen'].apply(pair['variables'], st, pts, reqs,
                                  method=JaxGenerator.sample)

    ref = jax.jit(run)(jnp.asarray(pair['ws']), jnp.asarray(vd),
                       jnp.asarray(pts))
    for key in reqs:
        assert got[key].shape == ref[key].shape, key
        _close(got[key].numpy(), ref[key], TOL)
    assert float(ref['semantics'].std()) > 1e-3


def _camera():
    cam = np.tile(np.eye(4, dtype=np.float32), (BATCH, 1, 1))
    cam[:, 2, 3] = 4.0
    cam[1, 0, 3] = 0.3
    return cam, np.full((BATCH,), 1.2, np.float32)


def test_render_with_ray_directions_matches_jax(pair):
    cam, focal = _camera()
    port = pair['port']
    with torch.no_grad():
        state = port.synthesize(torch.tensor(pair['ws']))
        out = render(port.field(state), RES, RES, torch.tensor(cam),
                     torch.tensor(focal), 1.4, True, SAMPLES)

    _, dirs = jax_rays.get_ray_bundle(RES, RES, jnp.asarray(focal),
                                      jnp.asarray(cam))
    dirs = jax_normalize(dirs)
    variables, jgen = pair['variables'], pair['jgen']

    @jax.jit
    def jax_stage(ws, dirs, cam, focal):
        st = jgen.apply(variables, ws, viewdirs=dirs,
                        method=JaxGenerator.synthesize)

        def sample_fn(pts, reqs):
            return jgen.apply(variables, st, pts, reqs,
                              method=JaxGenerator.sample)
        return jax_render(sample_fn, RES, RES, cam, focal, None, None, 1.4,
                          True, SAMPLES, rng=None, fine_sampling=True)

    ref = jax_stage(jnp.asarray(pair['ws']), dirs, jnp.asarray(cam),
                    jnp.asarray(focal))
    assert float(ref.mask.max()) > 0.3
    _close(out.rgb.numpy(), ref.rgb, RENDER_TOL)
    _close(out.mask.numpy(), ref.mask, RENDER_TOL)


def test_render_without_directions_fails_in_both(pair):
    """JAX's render of a view-direction generator without directions (as
    every JAX caller renders) fails at the palette product; the port's
    sample without them is refused by name."""
    cam, focal = _camera()
    variables, jgen = pair['variables'], pair['jgen']

    def jax_render_without(ws):
        st = jgen.apply(variables, ws, method=JaxGenerator.synthesize)

        def sample_fn(pts, reqs):
            return jgen.apply(variables, st, pts, reqs,
                              method=JaxGenerator.sample)
        return jax_render(sample_fn, RES, RES, jnp.asarray(cam),
                          jnp.asarray(focal), None, None, 1.4, True,
                          SAMPLES, rng=None, fine_sampling=True)

    with pytest.raises(TypeError, match='dot_general'):
        jax.eval_shape(jax_render_without, jnp.asarray(pair['ws']))
    port = pair['port']
    with torch.no_grad(), pytest.raises(ValueError, match='directions'):
        state = port.synthesize(torch.tensor(pair['ws']))
        port.sample(state, torch.zeros((BATCH, 4, 5, 3)), ('sigma', 'rgb'))


def test_fused_view_declines_for_viewdirs(pair):
    port = pair['port']
    fused = port.fused_view()
    assert fused.fuse_decode and not fused.fuses
    assert Generator(device='cpu', **CONFIG).fused_view().fuses
    cam, focal = _camera()
    with torch.no_grad():
        outs = []
        for gen in (port, fused):
            state = gen.synthesize(torch.tensor(pair['ws']))
            assert state.fused_tail is None
            outs.append(render(gen.field(state), RES, RES,
                               torch.tensor(cam), torch.tensor(focal), 1.4,
                               True, SAMPLES))
    assert torch.equal(outs[0].rgb, outs[1].rgb)
