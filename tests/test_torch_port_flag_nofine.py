"""The non-fine render's inversion step against the JAX package's.

`InversionConfig(fine_sampling=False)` renders one stratified pass of
depth_samples_per_ray x 4 samples a ray (the reference's rule when fine
sampling is off; JAX's config takes `ray_multiplier=4` for it), composited in depth order
without a sort. On `test_torch_port_inversion.py`'s case (a small
generator in the p3d_car geometry, a random-weight VGG LPIPS, 32^2
renders, 4 x 4 samples), `inversion_loss` and its gradient to every
parameter against JAX's with the same injected crops, at that file's
relative tolerance (1e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_inversion as base
from nerf_from_image_tpu.invert import optimizer as jax_inv
from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.render import render as jax_render
from nerf_from_image_tpu_torch.invert import optimizer as inv

NOFINE = dict(base.CFG, fine_sampling=False)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _staged_render_from_params(jgen, variables):
    """JAX's `render_from_params` with synthesize and the render jitted on
    their own, the render's samples and fine pass as its config says."""
    synthesize = jax.jit(lambda ws: jgen.apply(
        variables, ws, method=JaxGenerator.synthesize))

    @functools.partial(jax.jit, static_argnums=3)
    def render_stage(state, cam, focal, cfg):
        def sample_fn(pts, reqs):
            return jgen.apply(variables, state, pts, reqs,
                              method=JaxGenerator.sample)
        return jax_render(sample_fn, cfg.resolution, cfg.resolution, cam,
                          focal, None, None, cfg.scene_range,
                          cfg.white_background,
                          cfg.depth_samples_per_ray * cfg.ray_multiplier,
                          rng=None, fine_sampling=cfg.fine_sampling)

    def render_from_params(gen, gen_vars, params, cfg, **unused):
        cam, focal = jax_inv.make_camera(params, cfg.camera_flipped)
        ws = params.z * cfg.lr_gain_z
        if ws.shape[1] == 1:
            ws = jnp.broadcast_to(ws, (ws.shape[0], 15, ws.shape[-1]))
        return render_stage(synthesize(ws), cam, focal, cfg), cam, focal

    return render_from_params


@pytest.fixture(scope='module')
def setup():
    case = base.make_case(base.CONFIG)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_inv, 'render_from_params',
                      _staged_render_from_params(case['jgen'],
                                                 case['variables']))
        yield case


def test_render_takes_one_pass_of_four_times_the_samples(setup):
    calls = []
    port = setup['port']
    field = port.field

    def counting_field(state, *args):
        fn = field(state, *args)

        def sample_fn(pts, reqs, viewdirs):
            calls.append(tuple(pts.shape))
            return fn(pts, reqs, viewdirs)
        return sample_fn

    port.field = counting_field
    try:
        with torch.no_grad():
            inv.render_from_params(port, setup['init'],
                                   inv.InversionConfig(**NOFINE))
    finally:
        del port.field
    assert calls == [(base.BATCH, base.RES, base.RES, 4 * base.SAMPLES, 3)]


@pytest.mark.parametrize('loss_type', ['vgg', 'l1'])
def test_loss_and_gradients_match_jax(setup, loss_type):
    cfg = inv.InversionConfig(loss_type=loss_type, **NOFINE)
    jcfg = jax_inv.InversionConfig(loss_type=loss_type, ray_multiplier=4,
                                   **NOFINE)
    params = setup['init'].copy(requires_grad=True)
    port_tform, jax_tform = base._tforms(10, 1)[0]
    target = setup['target']
    loss, monitor = inv.inversion_loss(setup['port'], setup['lpips'], params,
                                       target, cfg, tform=port_tform)
    named = params.named()
    grads = torch.autograd.grad(loss, [t for _, t in named])

    def loss_fn(p):
        return jax_inv.inversion_loss(
            setup['jgen'], setup['variables'], setup['jax_lpips'],
            setup['lpips_vars'], p, jnp.asarray(target.numpy()), jcfg,
            jax.random.PRNGKey(0), injected={'tform': jax_tform})

    (ref_loss, ref_monitor), ref_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(base._to_jax_params(params))
    assert base._rel(float(loss.detach()), float(ref_loss)) < base.RTOL
    assert base._rel(monitor['psnr'].numpy(),
                     ref_monitor['psnr']) < base.RTOL
    for (name, _), g in zip(named, grads):
        ref = getattr(ref_grads, name)
        assert np.abs(ref).max() > 0, name
        assert base._rel(g.numpy(), ref) < base.RTOL, (
            name, base._rel(g.numpy(), ref))
