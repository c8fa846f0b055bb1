"""The parts of GAN training in the port, one by one, against the JAX
package: stratified volume samples, the progressive blur, the render with
injected random draws, the pose half of the augment, and the SDF
regularizers with their second-order gradients.

Inputs come from a numpy seed, weights from a seeded JAX `Generator`
brought over by `from_jax_params`; everything runs in float32 on the CPU,
the JAX side on its XLA sampler (`use_pallas=False`). Tolerances are
stated per check.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.core import augment as jax_augment
from nerf_from_image_tpu.core import grids as jax_grids
from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.render import render as jax_render
from nerf_from_image_tpu.train import gan as jax_gan
from nerf_from_image_tpu_torch.core import augment
from nerf_from_image_tpu_torch.core import grids
from nerf_from_image_tpu_torch.models import generator as generator_lib
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.render.renderer import render
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import convert

# p3d_car's box: the field's and the render's are both 1.4.
CONFIG = dict(latent_dim=32, scene_range=1.4, attention_values=4,
              img_resolution=64, channel_base=1024, channel_max=64)
BATCH, RES, SAMPLES, NSTRATA = 2, 16, 8, 12


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port.detach(), np.float32),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope='module')
def pair():
    """A seeded JAX generator, the port's copy of it, and one synthesis."""
    jgen = JaxGenerator(**CONFIG)
    variables = jax.jit(jgen.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((BATCH, CONFIG['latent_dim'])))
    variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    # Move the SDF's zero level into the box so that the views see a
    # surface and the regularizers are not flat.
    variables['params']['decoder']['fc1']['bias'][0] = -1.5
    port = Generator(device='cpu', **CONFIG)
    convert.load_reference_state_dict(port,
                                      convert.from_jax_params(variables))
    z = np.random.default_rng(0).standard_normal(
        (BATCH, CONFIG['latent_dim'])).astype(np.float32)
    state = jax.jit(lambda z: jgen.apply(
        variables, jgen.apply(variables, z, method=JaxGenerator.map),
        method=JaxGenerator.synthesize))(jnp.asarray(z))
    return jgen, variables, port, z, jax.device_get(state.planes)


def test_sample_volume_stratified_matches_jax():
    """Injected jitter: 1e-6 (the same float32 arithmetic)."""
    jitter = np.random.default_rng(1).random(
        (BATCH, NSTRATA - 1, NSTRATA - 1, NSTRATA - 1, 3)).astype(np.float32)
    ref = jax_grids.sample_volume_stratified(jnp.asarray(jitter), BATCH,
                                             NSTRATA, 1.4)
    out = grids.sample_volume_stratified(torch.tensor(jitter), BATCH,
                                         NSTRATA, 1.4)
    assert out.shape == (BATCH, (NSTRATA - 1) ** 3, 3)
    _close(out, ref, 1e-6)
    drawn = grids.sample_volume_stratified(torch.Generator().manual_seed(0),
                                           BATCH, NSTRATA, 1.4)
    assert drawn.shape == out.shape and float(drawn.abs().max()) <= 1.4


@pytest.mark.parametrize('iteration', [0, 1, 6000, 12499, 12500, 20000])
def test_blur_kernels_match_jax(iteration):
    """`blur_kernel_1d` against JAX's and, zero-padded to its 61 taps (a
    delta once the blur is over), against JAX's fixed-width
    `blur_kernel_dynamic`: 1e-6; `blur` and `blur_image` on a
    white-background batch: 1e-5."""
    ref = jax_grids.blur_kernel_1d(iteration, gan.BLUR_WARMUP_ITERS)
    out = grids.blur_kernel_1d(iteration, gan.BLUR_WARMUP_ITERS)
    assert (out is None) == (ref is None)
    if out is not None:
        _close(out, ref, 1e-6)
    fixed = jax_gan.blur_kernel_dynamic(jnp.asarray(iteration))
    padded = torch.zeros(fixed.shape[0])
    if out is None:
        padded[fixed.shape[0] // 2] = 1.0
    else:
        half = (fixed.shape[0] - out.shape[0]) // 2
        padded[half:half + out.shape[0]] = out
    _close(padded, fixed, 1e-6)
    img = np.random.default_rng(iteration).uniform(
        -1, 1, (2, 4, 16, 16)).astype(np.float32)
    _close(grids.blur(torch.tensor(img), out, True),
           jax_grids.blur(jnp.asarray(img), ref, True), 1e-5)
    _close(gan.blur_image(torch.tensor(img), iteration, True),
           jax_gan.blur_image(jnp.asarray(img), jnp.asarray(iteration),
                              True), 1e-5)


def test_render_with_injected_draws_matches_jax(pair):
    """The render with injected jittered depths and PDF draws, flipped
    cameras in the p3d_car box: 1e-3 on rgb, mask and depth (as the
    deterministic render test), the JAX render run around its jitted
    field."""
    jgen, variables, port, z, planes = pair
    rng = np.random.default_rng(2)
    cam = np.tile(np.eye(4, dtype=np.float32), (BATCH, 1, 1))
    cam[:, 2, 3] = 3.0
    cam[1, 0, 3] = 0.2
    cam[:, :3, 1:] *= -1.0  # the flipped camera of p3d_car
    focal = np.full((BATCH,), 1.5, np.float32)
    draws = {'depth': rng.random((BATCH, RES, RES, SAMPLES)),
             'pdf_u': rng.random((BATCH * RES * RES, SAMPLES))}
    draws = {k: v.astype(np.float32) for k, v in draws.items()}

    @functools.partial(jax.jit, static_argnums=2)
    def field(state, pts, reqs):
        return jgen.apply(variables, state, pts, reqs,
                          method=JaxGenerator.sample)

    state = jax.jit(lambda z: jgen.apply(
        variables, jgen.apply(variables, z, method=JaxGenerator.map),
        method=JaxGenerator.synthesize))(jnp.asarray(z))
    ref = jax_render(lambda pts, reqs: field(state, pts, reqs), RES, RES,
                     jnp.asarray(cam), jnp.asarray(focal), None, None,
                     CONFIG['scene_range'], False, SAMPLES,
                     rng={k: jnp.asarray(v) for k, v in draws.items()},
                     fine_sampling=True)
    with torch.no_grad():
        pstate = port.synthesize(port.map(torch.tensor(z)))
        out = render(port.field(pstate), RES,
                     RES, torch.tensor(cam), torch.tensor(focal),
                     CONFIG['scene_range'], False, SAMPLES,
                     rng={k: torch.tensor(v) for k, v in draws.items()})
    assert 0.3 < float(out.mask.max())
    for name in ('rgb', 'mask', 'depth'):
        _close(getattr(out, name), getattr(ref, name), 1e-3)
    # With draws from a generator, the render is finite and differs from
    # the one with the injected draws.
    with torch.no_grad():
        drawn = render(port.field(pstate), RES,
                       RES, torch.tensor(cam), torch.tensor(focal),
                       CONFIG['scene_range'], False, SAMPLES,
                       rng=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn.rgb).all()
    assert not torch.equal(drawn.rgb, out.rgb)


@pytest.mark.parametrize('with_focal', [True, False])
def test_augment_pose_matches_jax(with_focal):
    """The pose and focal half of the augment, and the image half with it,
    under one fixed transform: 1e-5 (the same float32 arithmetic)."""
    rng = np.random.default_rng(3)
    b = 6
    pose = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose[:, :3, 3] = rng.uniform(-0.3, 0.3, (b, 3)) + [0.0, 0.0, 2.5]
    if not with_focal:
        pose[:, 3, 3] = rng.uniform(0.8, 1.2, b)
    focal = rng.uniform(1.0, 2.0, b).astype(np.float32) if with_focal \
        else None
    img = rng.uniform(-1, 1, (b, 4, 16, 16)).astype(np.float32)
    t = dict(rot=rng.uniform(-np.pi, np.pi, b).astype(np.float32),
             scale=np.exp2(rng.standard_normal(b) * 0.2).astype(np.float32),
             translation=(rng.standard_normal((b, 2)) * 0.1).astype(
                 np.float32))
    ref_img, ref_pose, ref_focal = jax_augment.augment_impl(
        jnp.asarray(img), jnp.asarray(pose),
        None if focal is None else jnp.asarray(focal),
        jax_augment.AffineTransform(**{k: jnp.asarray(v)
                                       for k, v in t.items()}), False)
    tform = augment.AffineTransform(**{k: torch.tensor(v)
                                       for k, v in t.items()})
    out_img, out_pose, out_focal, same = augment.augment(
        None, torch.tensor(img), torch.tensor(pose),
        None if focal is None else torch.tensor(focal), 0.5, False,
        cached_tform=tform)
    assert same is tform
    _close(out_pose, ref_pose, 1e-5)
    _close(out_img, ref_img, 1e-5)
    if with_focal:
        _close(out_focal, ref_focal, 1e-5)
    else:
        assert out_focal is None and ref_focal is None
    alone, alone_focal = augment.augment_pose(
        torch.tensor(pose), None if focal is None else torch.tensor(focal),
        tform)
    assert torch.equal(alone, out_pose)


def _jax_sdf_losses(jgen, variables, planes, noise, requests):
    def losses(planes, decoder):
        v = dict(variables, params=dict(variables['params'],
                                        decoder=decoder))
        return jgen.apply(v, planes, noise, requests, nstrata=NSTRATA,
                          method=JaxGenerator.sdf_losses)

    def eikonal(planes, decoder):
        return jnp.sum(losses(planes, decoder)['sdf_eikonal_loss'])

    dec = variables['params']['decoder']
    values = jax.jit(losses)(planes, dec)
    grads = jax.jit(jax.grad(eikonal, argnums=(0, 1)))(planes, dec)
    return jax.device_get(values), jax.device_get(grads)


def test_sdf_losses_and_eikonal_gradients_match_jax(pair):
    """`Generator.sdf_losses` with injected strata and perturbations:
    the three losses within 1e-5; the gradient of the eikonal loss (a
    gradient of a gradient, through the gather sampler) to the planes and
    to the decoder's weights within 1e-4 of each one's largest entry."""
    jgen, variables, port, _, planes = pair
    rng = np.random.default_rng(4)
    n = NSTRATA - 1
    noise = {'strata': rng.random((BATCH, n, n, n, 3)).astype(np.float32),
             'perturb': rng.standard_normal((BATCH, n ** 3, 3)).astype(
                 np.float32)}
    requests = ('sdf_eikonal_loss', 'total_variation_loss', 'entropy_loss')
    ref, (ref_dplanes, ref_ddec) = _jax_sdf_losses(
        jgen, variables, jnp.asarray(planes),
        {k: jnp.asarray(v) for k, v in noise.items()}, requests)

    planes_cl = torch.tensor(planes).permute(0, 1, 3, 4, 2).contiguous()
    planes_cl.requires_grad_()
    out = port.sdf_losses(planes_cl, {k: torch.tensor(v)
                                      for k, v in noise.items()},
                          requests, nstrata=NSTRATA)
    for key in requests:
        assert out[key].shape == (BATCH,)
        assert float(out[key].detach().abs().min()) > 0, key
        _close(out[key], ref[key], 1e-5)
    dec = port.decoder.net
    # The output layer's bias shifts the SDF and leaves its gradient to the
    # points, and so the eikonal loss, as it is.
    weights = [dec[0].weight, dec[0].bias, dec[2].weight]
    grads = torch.autograd.grad(out['sdf_eikonal_loss'].sum(),
                                [planes_cl] + weights)
    assert float(np.abs(ref_ddec['fc1']['bias']).max()) == 0.0
    pairs = [(grads[0].permute(0, 1, 4, 2, 3), ref_dplanes)]
    pairs += [(g, ref_ddec[f'fc{i}'][name]) for g, (i, name) in zip(
        grads[1:], [(0, 'weight'), (0, 'bias'), (1, 'weight')])]
    for got, want in pairs:
        want = np.asarray(want, np.float64)
        assert np.abs(want).max() > 0
        err = np.abs(got.detach().double().numpy() - want).max()
        assert err / np.abs(want).max() < 1e-4


def test_sdf_losses_draw_from_a_generator(pair):
    _, _, port, _, planes = pair
    planes_cl = torch.tensor(planes).permute(0, 1, 3, 4, 2).contiguous()
    draw = lambda: port.sdf_losses(  # noqa: E731
        planes_cl, torch.Generator().manual_seed(5),
        ('sdf_eikonal_loss', 'sdf_distance_loss', 'total_variation_loss'),
        nstrata=NSTRATA)
    a, b = draw(), draw()
    assert len(a) == 3
    for key in a:
        assert torch.isfinite(a[key]).all() and torch.equal(a[key], b[key])
    with pytest.raises(NotImplementedError):
        port.sdf_losses(planes_cl, torch.Generator(), ('semantics',))


@pytest.mark.parametrize('n', [3 * 4096, 16 * 8, 2 * 4096 + 512])
def test_palette_product_is_one_product_per_image(n):
    """The chunked palette product against one `bmm` per image: the
    colours within 1e-6, and both gradients within 1e-6 of their largest
    entry (float32, the same products summed in another order; the
    palette's gradient sums N of them)."""
    rng = np.random.default_rng(n)
    probs = torch.tensor(rng.random((2, n, 10)).astype(np.float32),
                         requires_grad=True)
    palette = torch.tensor(rng.standard_normal((2, 10, 3)).astype(
        np.float32), requires_grad=True)
    cot = torch.tensor(rng.standard_normal((2, n, 3)).astype(np.float32))
    out = generator_lib.palette_rgb(probs, palette)
    ref = torch.bmm(probs, palette)
    _close(out, ref.detach().numpy(), 1e-6)
    got = torch.autograd.grad(out, (probs, palette), cot)
    want = torch.autograd.grad(ref, (probs, palette), cot)
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) < 1e-6
