"""Normals and semantics through the port's field, render and composite,
and the card's float32-plane sampler, against the JAX package.

- The composite's normal map (detached weights, white-background fill)
  and semantic map (live weights): against `tests/golden/core_golden.npz`
  at 1e-4, the bound of `tests/test_core_rays.py`, and against JAX's
  composite at 1e-6.
- A small render (latent 32, 64^2 planes, narrow channels, 16^2 rays of
  4 + 4 samples) with normals and semantics, the port's generator loaded
  from a JAX generator's seeded parameters, JAX on its XLA sampler
  (`use_pallas=False`) run stage by stage as in
  `test_torch_port_render.py`: the field's per-point normals within 1e-3
  at the points inside the box (outside it they are undefined in the
  JAX package too), the palette probabilities within 1e-4, and the
  composited rgb, mask, normal and semantic maps.
- The card's sampler on float32 planes (`triplane_cuda.sample_bf16_planes`,
  the CUDA branch of B1, B2 and B4) with the plain versions standing in
  for the kernels: its features are those of the plain sampler on the
  bf16-rounded planes, in bf16; its plane gradient is the kernel's,
  rounded to bf16 and returned in float32. Against JAX's Pallas sampler
  (interpret mode) on the same float32 planes, which rounds them to bf16
  itself (`plane_layout_for_dma`): forward 1e-2 of the largest value, as
  B1's other cases, and both backwards 5e-2, the bound of the B2 and B4
  tests against the Pallas kernels' bf16 tap weights.
Inputs come from numpy seeds; torch runs on one thread
(`test_torch_port_train_cli.one_torch_thread`).
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.core import compositing as jax_comp
from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.ops.pallas import triplane_window
from nerf_from_image_tpu.render import render as jax_render
from nerf_from_image_tpu_torch.core import compositing
from nerf_from_image_tpu_torch.models.generator import (Generator,
                                                        GeneratorState)
from nerf_from_image_tpu_torch.ops import triplane
from nerf_from_image_tpu_torch.ops import triplane_cuda
from nerf_from_image_tpu_torch.render.renderer import render
from nerf_from_image_tpu_torch.utils import convert

from test_torch_port_train_cli import one_torch_thread  # noqa: F401

GOLDEN = pathlib.Path(__file__).parent / 'golden' / 'core_golden.npz'
CONFIG = dict(latent_dim=32, scene_range=0.55, attention_values=4,
              img_resolution=64, channel_base=1024, channel_max=64)
BATCH, RES, SAMPLES = 2, 16, 4
REQUESTS = ('sigma', 'rgb', 'normals', 'semantics')


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port.detach(), np.float32),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def test_composite_maps_match_golden():
    g = np.load(GOLDEN)
    _, _, _, normal_map, sem_map = compositing.composite(
        _t(g['comp_sigma']), _t(g['comp_rgb']), _t(g['nf_d']),
        _t(g['qp_depths']), normals=_t(g['comp_normals']),
        semantics=_t(g['comp_sem']), white_background=True)
    _close(normal_map, g['comp_normal_map'], 1e-4)
    _close(sem_map, g['comp_sem_map'], 1e-4)


@pytest.mark.parametrize('white_background', [True, False])
def test_composite_maps_match_jax(white_background):
    """Random samples in ascending depth, as one pass composites them."""
    rng = np.random.default_rng(3)
    r, s, k = 41, 12, 5
    z = np.sort(rng.uniform(1.0, 3.0, (r, s)), axis=-1).astype(np.float32)
    sigma = rng.uniform(0.0, 5.0, (r, s)).astype(np.float32)
    rgb = rng.uniform(-1.0, 1.0, (r, s, 3)).astype(np.float32)
    rd = rng.standard_normal((r, 3)).astype(np.float32)
    normals = rng.standard_normal((r, s, 3)).astype(np.float32)
    sem = rng.uniform(0.0, 1.0, (r, s, k)).astype(np.float32)
    port = compositing.composite(_t(sigma), _t(rgb), _t(rd), _t(z),
                                 normals=_t(normals), semantics=_t(sem),
                                 white_background=white_background)
    ref = jax_comp.render_volume_density(
        *map(jnp.asarray, (sigma, rgb, rd, z, normals, sem)),
        white_background=white_background)
    for p, j in zip(port, ref):
        _close(p, j, 1e-6)


def test_composite_normal_map_takes_detached_weights():
    rng = np.random.default_rng(4)
    z = np.sort(rng.uniform(1.0, 3.0, (6, 8)), axis=-1).astype(np.float32)
    sigma = _t(rng.uniform(0.0, 5.0, (6, 8)).astype(np.float32))
    sigma.requires_grad_()
    normals = _t(rng.standard_normal((6, 8, 3)).astype(np.float32))
    sem = _t(rng.uniform(0.0, 1.0, (6, 8, 4)).astype(np.float32))
    _, _, _, normal_map, sem_map = compositing.composite(
        sigma, torch.zeros(6, 8, 3), torch.ones(6, 3), _t(z),
        normals=normals, semantics=sem, white_background=False)
    assert not normal_map.requires_grad
    assert sem_map.requires_grad


@pytest.fixture(scope='module')
def pair():
    jgen = JaxGenerator(**CONFIG)
    variables = jax.jit(jgen.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((BATCH, CONFIG['latent_dim'])))
    variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    # Put the surface inside the box (a fresh decoder's SDF is above 0).
    variables['params']['decoder']['fc1']['bias'][0] = -1.5
    port = Generator(device='cpu', **CONFIG)
    convert.load_reference_state_dict(
        port, convert.from_jax_params(variables))
    z = np.random.default_rng(0).standard_normal(
        (BATCH, CONFIG['latent_dim'])).astype(np.float32)
    cam = np.tile(np.eye(4, dtype=np.float32), (BATCH, 1, 1))
    cam[:, 2, 3] = 2.0
    cam[1, 0, 3] = 0.15
    focal = np.full((BATCH,), 1.2, np.float32)

    # Stage by stage, each stage jitted on its own (see
    # `test_torch_port_render.py`).
    @jax.jit
    def jax_map_synthesize(z):
        ws = jgen.apply(variables, z, method=JaxGenerator.map)
        return jgen.apply(variables, ws, method=JaxGenerator.synthesize)

    @functools.partial(jax.jit, static_argnums=2)
    def jax_field(state, pts, reqs):
        return jgen.apply(variables, state, pts, reqs,
                          method=JaxGenerator.sample)

    state = jax_map_synthesize(jnp.asarray(z))
    out = jax_render(lambda pts, reqs: jax_field(state, pts, reqs), RES,
                     RES, jnp.asarray(cam), jnp.asarray(focal), None, None,
                     scene_range=CONFIG['scene_range'],
                     white_background=True, depth_samples_per_ray=SAMPLES,
                     rng=None, fine_sampling=True, compute_normals=True,
                     compute_semantics=True)
    pts = np.random.default_rng(1).uniform(
        -0.7, 0.7, (BATCH, 6, 5, 3)).astype(np.float32)
    field = jax_field(state, jnp.asarray(pts), REQUESTS)
    ref = jax.device_get((state.planes, state.attention_values, out, field))
    return port, z, cam, focal, pts, ref


def test_field_normals_and_semantics(pair):
    port, _, _, _, pts, (planes, att, _, field) = pair
    state = GeneratorState(
        planes=_t(planes), planes_cl=triplane.planes_channel_last(
            _t(planes)), attention_values=_t(att))
    with torch.no_grad():
        out = port.sample(state, _t(pts), REQUESTS)
    inside = np.abs(pts.reshape(BATCH, -1, 3)).max(-1) <= CONFIG[
        'scene_range']
    assert inside.sum() > 10 and (~inside).sum() > 10
    _close(out['normals'][torch.tensor(inside)], field['normals'][inside],
           1e-3)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(out['normals'], dim=-1).numpy(), 1.0,
        atol=1e-5)
    _close(out['semantics'], field['semantics'], 1e-4)
    _close(out['rgb'], field['rgb'], 1e-4)


def test_render_with_normals_and_semantics(pair):
    """The render under `torch.no_grad()`, as the GAN evaluation runs it
    (the normals take their point gradient inside): rgb and mask within
    1e-4, the normal map within 1e-3, the semantic map within 1e-4."""
    port, z, cam, focal, _, (_, _, ref, _) = pair
    with torch.no_grad():
        state = port.synthesize(port.map(_t(z)))
        out = render(port.field(state), RES,
                     RES, _t(cam), _t(focal), CONFIG['scene_range'], True,
                     SAMPLES, compute_normals=True, compute_semantics=True)
    assert float(out.mask.max()) > 0.3  # the views see the surface
    assert out.normals.shape == (BATCH, RES, RES, 3)
    assert out.semantics.shape == (BATCH, RES, RES, CONFIG[
        'attention_values'])
    _close(out.rgb, ref.rgb, 1e-4)
    _close(out.mask, ref.mask, 1e-4)
    _close(out.normals, ref.normals, 1e-3)
    _close(out.semantics, ref.semantics, 1e-4)


def test_fused_decode_refuses_normals_and_semantics(pair):
    port = pair[0].fused_view()
    with torch.no_grad():
        state = port.synthesize(port.map(torch.zeros(1, 32)))
        for req in ('normals', 'semantics'):
            with pytest.raises(ValueError, match='sigma and rgb only'):
                port.sample(state, torch.zeros(1, 8, 3), ('sigma', req))


def _plain_kernel_sampler(planes_cl, coords):
    """The card's sampler with the plain versions for the kernels."""
    return triplane_cuda.sample_bf16_planes(
        planes_cl, coords, triplane.sample_triplane_plain,
        triplane.sample_triplane_grad_plain,
        triplane.sample_triplane_grad_planes_plain)


def _structured(seed, b=1, r=64):
    """float32 planes (b, 3, 32, r, r) and a structured 8 x 8 x 4 point
    grid (b, 8, 8, 4, 3), as the Pallas sampler takes them."""
    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((b, 3, 32, r, r)).astype(np.float32)
    base = rng.uniform(-0.5, 0.5, (b, 1, 1, 1, 1, 1, 1, 3))
    jitter = rng.uniform(-0.04, 0.04, (b, 1, 8, 1, 8, 1, 4, 3))
    coords = np.clip(base + jitter, -1, 1).reshape(b, 8, 8, 4, 3).astype(
        np.float32)
    grad_out = rng.standard_normal((b, 256, 32)).astype(np.float32)
    return planes, coords, grad_out


def _rel(a, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(a, np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('coord_grads', [True, False])
def test_float32_planes_on_the_card_match_pallas(coord_grads):
    planes, coords, grad_out = _structured(5)
    b = planes.shape[0]

    def loss(p, c):
        pdma = triplane_window.plane_layout_for_dma(p)
        feats, _ = triplane_window.sample_triplane_windowed(
            p, pdma, None, c, coord_grads=coord_grads)
        return jnp.sum(feats.astype(jnp.float32) * grad_out), feats

    argnums = (0, 1) if coord_grads else 0
    grads, feats_ref = jax.grad(loss, argnums=argnums, has_aux=True)(
        jnp.asarray(planes), jnp.asarray(coords))
    ref_planes = grads[0] if coord_grads else grads

    planes_cl = triplane.planes_channel_last(_t(planes)).requires_grad_()
    coords_t = _t(coords.reshape(b, -1, 3)).requires_grad_(coord_grads)
    feats = _plain_kernel_sampler(planes_cl, coords_t)
    assert feats.dtype == torch.bfloat16
    assert _rel(feats.float().detach(), np.asarray(
        feats_ref, np.float32).reshape(b, -1, 32)) < 1e-2
    wanted = (planes_cl, coords_t) if coord_grads else (planes_cl,)
    got = torch.autograd.grad(feats, wanted,
                              _t(grad_out).to(torch.bfloat16))
    assert got[0].dtype == torch.float32
    assert _rel(got[0].permute(0, 1, 4, 2, 3), ref_planes) < 5e-2
    if coord_grads:
        assert _rel(got[1], np.asarray(grads[1]).reshape(b, -1, 3)) < 5e-2


@pytest.mark.parametrize('coord_grads', [True, False])
def test_float32_planes_on_the_card_round_at_the_boundary(coord_grads):
    """Exactly the plain sampler on the bf16-rounded planes, forward and
    backward (B2's or B4's plain version), with the planes' gradient
    rounded to bf16 and returned as float32."""
    planes, coords, grad_out = _structured(6)
    planes_cl = triplane.planes_channel_last(_t(planes)).requires_grad_()
    coords_t = _t(coords.reshape(1, -1, 3)).requires_grad_(coord_grads)
    cot = _t(grad_out).to(torch.bfloat16)
    feats = _plain_kernel_sampler(planes_cl, coords_t)
    dplanes = torch.autograd.grad(feats, planes_cl, cot)[0]

    rounded = planes_cl.detach().to(torch.bfloat16)
    assert torch.equal(feats, triplane.sample_triplane_plain(
        rounded, coords_t.detach()))
    if coord_grads:
        ref, _ = triplane.sample_triplane_grad_plain(
            rounded, coords_t.detach(), cot)
    else:
        ref = triplane.sample_triplane_grad_planes_plain(
            tuple(rounded.shape), coords_t.detach(), cot)
    assert torch.equal(dplanes, ref.to(torch.bfloat16).float())
