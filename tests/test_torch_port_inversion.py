"""The slice as a whole: the port's inversion step against the JAX one.

A small generator (latent 32, 64^2 planes, narrow channels, four
attention values) in the p3d_car geometry (render box 1.4, black
background, flipped perspective camera) and a random-weight VGG LPIPS
feed both packages: the port's seeded weights reach JAX through its
`convert_generator`, the LPIPS state dicts through `convert_lpips`.
Both invert the same target (a 32x32 render of another latent) from the
same start, with the same injected crop transforms, in float32 on the
CPU: the JAX side runs its own `inversion_loss` and `make_inversion_step`
on its XLA sampler and warp, the port its CPU path (the plain versions of
kernels B1, B2 and B3).

JAX runs `inversion_loss` and `make_inversion_step` eagerly around
compiled stages, as `test_torch_port_render.py` runs its render: its
`render_from_params` (camera, synthesize, render) is swapped for the same
calls with synthesize and the render each jitted on their own, and LPIPS
is jitted. Tolerances are stated per check.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_from_image_tpu.core import augment as jax_augment
from nerf_from_image_tpu.invert import optimizer as jax_inv
from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.models.lpips import LPIPS as JaxLPIPS
from nerf_from_image_tpu.render import render as jax_render
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu_torch.core import augment
from nerf_from_image_tpu_torch.invert import optimizer as inv
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.utils import convert

# The generator's box (1.5) is a little larger than the render's (1.4).
# The first coarse sample of every ray lies on a face of the render box.
# With equal boxes that face is the field's own: the field zeroes sigma
# outside it (|x| > 1 after normalising) and the sampler's border clamp
# has a kink there. The two packages' points, equal to a few ulps, then
# fall on different sides, and with the dense random field those samples
# carry much of each ray's weight. A larger field box keeps every sample
# off the face, so the gradients compare a well-defined derivative.
# `test_torch_port_inversion_box.py` compares the equal boxes of p3d_car.
CONFIG = dict(latent_dim=32, scene_range=1.5, attention_values=4,
              img_resolution=64, channel_base=1024, channel_max=64)
BATCH, RES, SAMPLES, N_AUG = 2, 32, 4, 3
CFG = dict(resolution=RES, depth_samples_per_ray=SAMPLES, scene_range=1.4,
           white_background=False, camera_flipped=True,
           num_augmentations=N_AUG)
PARAM_NAMES = ('z', 'R', 's', 't2', 'z0')
# Relative tolerance of every comparison with JAX: both sides compute in
# float32, in another order and with other library kernels (the sort and
# the PDF draw of the fine depths, the VGG convolutions).
RTOL = 1e-3


class _JittedLPIPS:
    """The JAX LPIPS module with its `apply` jitted."""

    def __init__(self, module):
        self._apply = jax.jit(module.apply)

    def apply(self, variables, *args):
        return self._apply(variables, *args)


def _staged_render_from_params(jgen, variables):
    """JAX's `render_from_params` as three stages: the camera and ws
    eagerly, synthesize jitted, the render (with the field) jitted."""
    synthesize = jax.jit(lambda ws: jgen.apply(
        variables, ws, method=JaxGenerator.synthesize))

    @functools.partial(jax.jit, static_argnums=3)
    def render_stage(state, cam, focal, cfg):
        def sample_fn(pts, reqs):
            return jgen.apply(variables, state, pts, reqs,
                              method=JaxGenerator.sample)
        return jax_render(sample_fn, cfg.resolution, cfg.resolution, cam,
                          focal, None, None, cfg.scene_range,
                          cfg.white_background, cfg.depth_samples_per_ray,
                          rng=None, fine_sampling=True)

    def render_from_params(gen, gen_vars, params, cfg, **unused):
        cam, focal = jax_inv.make_camera(params, cfg.camera_flipped)
        ws = params.z * cfg.lr_gain_z
        if ws.shape[1] == 1:
            ws = jnp.broadcast_to(ws, (ws.shape[0], 15, ws.shape[-1]))
        return render_stage(synthesize(ws), cam, focal, cfg), cam, focal

    return render_from_params


def _to_jax_params(params):
    return jax_inv.InversionParams(**{
        n: jnp.asarray(t.detach().numpy()) for n, t in params.named()})


def _tforms(seed, steps):
    rng = np.random.default_rng(seed)
    n = BATCH * N_AUG
    out = []
    for _ in range(steps):
        rot = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
        scale = np.exp2(rng.standard_normal(n) * 0.2).astype(np.float32)
        trans = (rng.standard_normal((n, 2)) * 0.1).astype(np.float32)
        out.append((augment.AffineTransform(
            torch.tensor(rot), torch.tensor(scale), torch.tensor(trans)),
            jax_augment.AffineTransform(
                rot=jnp.asarray(rot), scale=jnp.asarray(scale),
                translation=jnp.asarray(trans))))
    return out


def make_case(config):
    """Both packages' generator (of `config`) and LPIPS, the target and
    the start of the inversion."""
    # One reference-format state dict feeds both packages: the port's
    # seeded weights, converted for JAX by its own `convert_generator`.
    port = Generator(device='cpu', **config)
    with torch.no_grad():
        # Shift the decoder's distance output so the surface crosses the
        # box and the views see it (a fresh decoder puts the SDF above 0).
        port.decoder.net[2].bias[0] -= 1.5
    variables = torch_convert.convert_generator(
        {k: v.numpy() for k, v in port.state_dict().items()},
        attention_values=config['attention_values'],
        plane_resolution=config['img_resolution'])
    jgen = JaxGenerator(**config)
    vgg_sd, lin_sd = convert.random_lpips_state_dicts(1)
    lpips = LPIPS(device='cpu')
    convert.load_lpips_state_dicts(lpips, vgg_sd, lin_sd)
    jax_lpips = JaxLPIPS()
    lpips_vars = torch_convert.convert_lpips(vgg_sd, lin_sd)

    rng = np.random.default_rng(0)
    gain = 5.0
    with torch.no_grad():
        ws_target, ws_init = (port.map(torch.tensor(rng.standard_normal(
            (BATCH, config['latent_dim'])).astype(np.float32)))
            for _ in range(2))
    quat = np.array([[1.0, 0.1, 0.3, 0.0], [0.9, -0.2, 0.5, 0.1]],
                    np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    target_params = inv.InversionParams(
        z=ws_target / gain, R=torch.tensor(quat),
        s=torch.tensor([1.0, 1.1]), t2=torch.tensor([[0.02, -0.03],
                                                     [0.0, 0.05]]),
        z0=torch.tensor([np.log(2.0), np.log(1.8)], dtype=torch.float32))
    cfg = inv.InversionConfig(**CFG)
    with torch.no_grad():
        out, cam, _ = inv.render_from_params(port, target_params, cfg)
    assert float(out.mask.max()) > 0.3  # the target sees the surface
    noise = rng.standard_normal((BATCH, 4)).astype(np.float32) * 0.05
    init = inv.InversionParams(
        z=ws_init / gain, R=torch.tensor(quat + noise),
        s=target_params.s * 1.05, t2=target_params.t2 + 0.02,
        z0=target_params.z0 + 0.1)
    return dict(port=port, lpips=lpips, variables=variables, jgen=jgen,
                jax_lpips=_JittedLPIPS(jax_lpips), lpips_vars=lpips_vars,
                target=out.rgb, cam=cam, init=init)


@pytest.fixture(scope='module')
def setup():
    case = make_case(CONFIG)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_inv, 'render_from_params',
                      _staged_render_from_params(case['jgen'],
                                                 case['variables']))
        yield case


def _rel(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize('loss_type,rows', [
    ('vgg', 1), ('vgg', 15), ('vgg_nocrop', 1), ('l1', 1), ('mse', 1),
    ('mixed', 1)])
def test_loss_monitors_and_gradients_match_jax(setup, loss_type, rows):
    """One evaluation of `inversion_loss` and its gradient to every
    parameter, against JAX's with the same injected transform: loss,
    per-image psnr, lpips monitor and camera, each gradient, relative to
    its largest entry (RTOL)."""
    cfg = inv.InversionConfig(loss_type=loss_type, **CFG)
    jcfg = jax_inv.InversionConfig(loss_type=loss_type, **CFG)
    params = setup['init'].copy(requires_grad=True)
    if rows == 15:
        params = dataclasses.replace(
            params, z=params.z.detach().expand(-1, 15, -1).clone()
            .requires_grad_())
    port_tform, jax_tform = _tforms(10, 1)[0]
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
        loss_fn, has_aux=True)(_to_jax_params(params))

    assert _rel(float(loss.detach()), float(ref_loss)) < RTOL
    assert _rel(monitor['psnr'].numpy(), ref_monitor['psnr']) < RTOL
    assert _rel(float(monitor['lpips']), float(ref_monitor['lpips'])) < RTOL
    assert _rel(monitor['cam'].numpy(), ref_monitor['cam']) < 1e-5
    for (name, _), g in zip(named, grads):
        ref = getattr(ref_grads, name)
        assert np.abs(ref).max() > 0, name
        assert _rel(g.numpy(), ref) < RTOL, (name, _rel(g.numpy(), ref))


def test_three_adam_steps_match_jax(setup):
    """`run_inversion` for three steps against JAX's
    `make_inversion_step` stepped three times with the same transforms:
    per-step loss, psnr, lpips, the five gradient norms and rot_error, and
    the parameters after the third step (RTOL)."""
    cfg = inv.InversionConfig(loss_type='vgg', **CFG)
    jcfg = jax_inv.InversionConfig(loss_type='vgg', **CFG)
    tforms = _tforms(20, 3)
    params, metrics = inv.run_inversion(
        setup['port'], setup['lpips'], setup['init'], setup['target'], cfg,
        3, gt_cam2world=setup['cam'], tforms=[t for t, _ in tforms])

    opt, step = jax_inv.make_inversion_step(
        setup['jgen'], setup['variables'], setup['jax_lpips'],
        setup['lpips_vars'], jcfg, gt_cam2world=jnp.asarray(
            setup['cam'].numpy()))
    jparams = _to_jax_params(setup['init'])
    carry = (jparams, opt.init(jparams), jnp.asarray(
        setup['target'].numpy()))
    ref_metrics = []
    for i, (_, jax_tform) in enumerate(tforms):
        carry, m = step(carry, (jax.random.PRNGKey(i), {'tform': jax_tform}))
        ref_metrics.append(m)

    assert set(metrics) == set(ref_metrics[0])
    for key, values in metrics.items():
        assert values.shape == (3,)
        ref = np.array([float(m[key]) for m in ref_metrics])
        assert _rel(values.numpy(), ref) < RTOL, (key, values, ref)
    for name in PARAM_NAMES:
        ref = np.asarray(getattr(carry[0], name))
        assert _rel(getattr(params, name).numpy(), ref) < RTOL, name
    # The init is left unchanged, and the step moved every parameter.
    for name, t in setup['init'].named():
        assert not t.requires_grad
        assert not torch.equal(getattr(params, name), t), name


def test_pose_frozen_without_optimize_pose(setup):
    """optimize_pose=False zeroes the pose gradients: R, s, t2 and z0 keep
    their (projected) start, and their gradient norms read 0."""
    cfg = inv.InversionConfig(loss_type='l1', optimize_pose=False, **CFG)
    params, metrics = inv.run_inversion(
        setup['port'], setup['lpips'], setup['init'], setup['target'], cfg,
        2, generator=torch.Generator().manual_seed(0))
    for key in ('grad_norm_R', 'grad_norm_s', 'grad_norm_t', 'grad_norm_f'):
        assert (metrics[key] == 0).all()
    assert (metrics['grad_norm_z'] > 0).all()
    init = setup['init']
    r = init.R / init.R.norm(dim=-1, keepdim=True)
    torch.testing.assert_close(params.R, r)
    assert torch.equal(params.s, init.s.abs())
    assert torch.equal(params.t2, init.t2)
    assert 'rot_error' not in metrics


def test_white_background_crops_are_augment_impl(setup):
    """With a white background the crops shift by -1, warp and shift back,
    which is `augment_impl`'s white path (held against JAX in
    `test_torch_port_warp.py`): the loss equals LPIPS on those crops, 1e-6.
    """
    cfg = inv.InversionConfig(loss_type='vgg',
                              **dict(CFG, white_background=True))
    tform, _ = _tforms(30, 1)[0]
    params = setup['init'].copy(requires_grad=False)
    target = setup['target']
    with torch.no_grad():
        loss, _ = inv.inversion_loss(setup['port'], setup['lpips'], params,
                                     target, cfg, tform=tform)
        pred = inv.render_from_params(setup['port'], params, cfg)[0].rgb
        pred, tgt = (x.permute(0, 3, 1, 2) for x in (pred, target))
        crops = [augment.augment_impl(x.repeat_interleave(N_AUG, dim=0),
                                      tform, white_background=True)
                 for x in (pred, tgt)]
        lp = setup['lpips'](torch.cat((pred, crops[0])),
                            torch.cat((tgt, crops[1])))
    torch.testing.assert_close(loss, lp.mean() * BATCH, rtol=1e-6,
                               atol=1e-6)


def test_bf16_decode_passes_gradients_to_planes_and_points(setup):
    """`Generator.sample` with bf16 activations (the card's type) on the
    CPU path: the gradient of its outputs reaches the channel-last planes
    and the points, finite and non-zero, and matches the float32 decode of
    the same planes within bf16 rounding (5e-2 of the largest entry)."""
    rng = np.random.default_rng(5)
    pts = torch.tensor(rng.uniform(-1.2, 1.2, (BATCH, 40, 3)).astype(
        np.float32))
    w = torch.tensor(rng.standard_normal((BATCH, 40, 3)).astype(np.float32))
    f32 = setup['port']
    bf16 = Generator(device='cpu', dtype=torch.bfloat16, **CONFIG)
    bf16.load_state_dict(f32.state_dict())
    with torch.no_grad():
        state = f32.synthesize(setup['init'].z.expand(-1, 15, -1) * 5.0)
    grads = []
    for gen, dtype in ((f32, torch.float32), (bf16, torch.bfloat16)):
        planes_cl = state.planes_cl.detach().to(dtype).requires_grad_()
        x = pts.clone().requires_grad_()
        out = gen.sample(dataclasses.replace(state, planes_cl=planes_cl), x)
        total = (out['rgb'].float() * w).sum() + out['sigma'].float().sum()
        dplanes, dx = torch.autograd.grad(total, (planes_cl, x))
        assert dplanes.dtype == dtype
        assert torch.isfinite(dplanes).all() and torch.isfinite(dx).all()
        assert dplanes.abs().max() > 0 and dx.abs().max() > 0
        grads.append((dplanes.float().numpy(), dx.numpy()))
    for a, b in zip(grads[1], grads[0]):
        assert _rel(a, b) < 5e-2


def test_projection():
    """R renormalized, s -> |s|, z0 clamped to [-4, 4], in place."""
    p = inv.InversionParams(z=torch.zeros(1, 1, 4),
                            R=torch.tensor([[2.0, 0.0, 0.0, 0.0]]),
                            s=torch.tensor([-1.5]),
                            t2=torch.zeros(1, 2), z0=torch.tensor([7.0]))
    inv.project(p)
    assert torch.equal(p.R, torch.tensor([[1.0, 0.0, 0.0, 0.0]]))
    assert float(p.s) == 1.5 and float(p.z0) == 4.0


def test_adam_matches_optax():
    """One parameter, five steps of torch Adam against optax.adam with the
    same settings (eps placed outside the square root in both): 1e-6."""
    rng = np.random.default_rng(0)
    grads = rng.standard_normal((5, 7)).astype(np.float32)
    x = torch.zeros(7, requires_grad=True)
    p = inv.InversionParams(z=x, R=torch.zeros(1), s=torch.zeros(1),
                            t2=torch.zeros(1))
    opt = inv.make_optimizer(p, inv.InversionConfig())
    tx = optax.adam(2e-3, b1=0.9, b2=0.95)
    y = jnp.zeros(7)
    state = tx.init(y)
    for g in grads:
        x.grad = torch.tensor(g)
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, y)
        y = optax.apply_updates(y, updates)
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(y), atol=1e-6)


def test_unknown_loss_type_raises(setup):
    cfg = inv.InversionConfig(loss_type='ssim', **CFG)
    with pytest.raises(ValueError, match='loss_type'):
        inv.inversion_loss(setup['port'], setup['lpips'], setup['init'],
                           setup['target'], cfg,
                           generator=torch.Generator().manual_seed(0))
