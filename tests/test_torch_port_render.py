"""The slice as a whole: the port's render forward against the JAX one.

A small JAX `Generator` (latent 32, 64^2 planes, narrow channels, four
attention values) is initialised from a seed; its parameters reach the
port through `from_jax_params`. Both then map the same latents,
synthesize, decode and render 16x16 rays with 4 coarse + 4 fine samples,
in float32 on the CPU, the JAX side on its XLA sampler
(`use_pallas=False`). Tolerances are stated per check.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.render import render as jax_render
from nerf_from_image_tpu_torch.models.generator import (Generator,
                                                        GeneratorState)
from nerf_from_image_tpu_torch.ops import triplane
from nerf_from_image_tpu_torch.render.renderer import render
from nerf_from_image_tpu_torch.utils import convert

CONFIG = dict(latent_dim=32, scene_range=0.55, attention_values=4,
              img_resolution=64, channel_base=1024, channel_max=64)
BATCH, RES, SAMPLES = 2, 16, 4


def _camera():
    cam = np.tile(np.eye(4, dtype=np.float32), (BATCH, 1, 1))
    cam[:, 2, 3] = 2.0
    cam[1, 0, 3] = 0.15  # second view off-centre
    focal = np.full((BATCH,), 1.2, np.float32)
    return cam, focal


@pytest.fixture(scope='module')
def pair():
    jgen = JaxGenerator(**CONFIG)
    variables = jax.jit(jgen.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((BATCH, CONFIG['latent_dim'])))
    variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    # A freshly initialised decoder puts the SDF well above 0 everywhere
    # (empty views); shift its distance output so the surface crosses the
    # box and the render has something to composite.
    variables['params']['decoder']['fc1']['bias'][0] = -1.5
    port = Generator(device='cpu', **CONFIG)
    convert.load_reference_state_dict(
        port, convert.from_jax_params(variables))
    z = np.random.default_rng(0).standard_normal(
        (BATCH, CONFIG['latent_dim'])).astype(np.float32)
    cam, focal = _camera()

    # JAX runs stage by stage, each stage jitted on its own, as the port
    # runs. One jit around the whole render lets XLA fuse o + d * t with
    # the / scene_range of the decode and round the points differently;
    # each hitting ray's first coarse sample lies exactly on a box face
    # (near = the box entry), so that flips its out-of-box test and moves
    # its sigma by up to 1 (measured 0.15 on rgb). Both stagings are the
    # JAX function; this one is reproducible across fusion decisions.
    @jax.jit
    def jax_map_synthesize(z):
        ws = jgen.apply(variables, z, method=JaxGenerator.map)
        state = jgen.apply(variables, ws, method=JaxGenerator.synthesize)
        return ws, state

    @functools.partial(jax.jit, static_argnums=2)
    def jax_field(state, pts, reqs):
        return jgen.apply(variables, state, pts, reqs,
                          method=JaxGenerator.sample)

    ws, state = jax_map_synthesize(jnp.asarray(z))
    out = jax_render(lambda pts, reqs: jax_field(state, pts, reqs), RES,
                     RES, jnp.asarray(cam), jnp.asarray(focal), None, None,
                     scene_range=CONFIG['scene_range'],
                     white_background=True, depth_samples_per_ray=SAMPLES,
                     rng=None, fine_sampling=True)
    ref = jax.device_get((ws, state.planes, state.attention_values, out))

    @jax.jit
    def jax_sample(planes, att, pts):
        state = jgen.apply(variables, jnp.zeros((BATCH, 15, 512)),
                           method=JaxGenerator.synthesize)
        state = state.replace(planes=planes, attention_values=att,
                              packed_planes=None)
        return jgen.apply(variables, state, pts, ('sigma', 'rgb'),
                          method=JaxGenerator.sample)

    return port, z, ref, jax_sample


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port.detach(), np.float32),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def test_map_and_synthesize(pair):
    """1e-4 for ws and the palette; 2e-4 for the planes (the synthesis
    stack's float32 sum-order drift)."""
    port, z, (ws, planes, att, _), _ = pair
    with torch.no_grad():
        pws = port.map(torch.tensor(z))
        state = port.synthesize(pws)
    _close(pws, ws, 1e-4)
    _close(state.planes, planes, 2e-4)
    _close(state.attention_values, att, 1e-4)
    assert torch.equal(state.planes_cl,
                       state.planes.permute(0, 1, 3, 4, 2))


def test_decode(pair):
    """Generator.sample on the JAX planes and palette, at points inside
    and outside the box: 1e-4 (float32 on both sides)."""
    port, _, (_, planes, att, _), jax_sample = pair
    pts = np.random.default_rng(1).uniform(
        -0.7, 0.7, (BATCH, 5, 6, 3)).astype(np.float32)
    state = GeneratorState(
        planes=torch.tensor(planes),
        planes_cl=triplane.planes_channel_last(torch.tensor(planes)),
        attention_values=torch.tensor(att))
    with torch.no_grad():
        out = port.sample(state, torch.tensor(pts), ('sigma', 'rgb'))
    ref = jax.device_get(jax_sample(jnp.asarray(planes), jnp.asarray(att),
                                    jnp.asarray(pts)))
    assert (out['sigma'][np.abs(pts.reshape(BATCH, -1, 3)).max(-1) > 0.55]
            == 0).all()
    for key in ('sigma', 'rgb'):
        _close(out[key], ref[key], 1e-4)
    assert int(out['overflow_resid']) == 0


def test_render(pair):
    """The whole render, map to composite, against the JAX render: 1e-3,
    a margin left for `sample_pdf`, whose fine depths move by a whole bin
    where a float32 CDF value ties with a linspace quantile."""
    port, z, (_, _, _, ref), _ = pair
    cam, focal = _camera()
    with torch.no_grad():
        state = port.synthesize(port.map(torch.tensor(z)))
        out = render(port.field(state), RES,
                     RES, torch.tensor(cam), torch.tensor(focal),
                     CONFIG['scene_range'], True, SAMPLES)
    assert out.rgb.shape == (BATCH, RES, RES, 3)
    assert float(out.mask.max()) > 0.3  # the views see the surface
    _close(out.rgb, ref.rgb, 1e-3)
    _close(out.mask, ref.mask, 1e-3)
    _close(out.depth, ref.depth, 1e-3)
    assert int(out.overflow_resid) == 0
