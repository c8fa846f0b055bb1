"""The inversion loss in the p3d_car box: the field's box and the
render's are equal (1.4), as the port runs them.

Every ray's first coarse sample lies on a face of that box, where the
field is not smooth: sigma drops to zero outside the box and the
sampler's border clamp has a kink. There the reference itself does not
decide the gradient: the first test moves JAX's points by one ulp and its
gradients move by far more than the tolerance. The second test pins the
samples that lie on a face (within 1e-5 of it, relative) exactly onto it,
with no gradient through their position, in both packages alike, and
holds everything else of the loss and its gradients to the tolerance of
`test_torch_port_inversion.py`. The setup (small generator, random VGG
LPIPS, target, start) is that file's, with the field's box set to 1.4.
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

BOX = base.CFG['scene_range']
CONFIG = dict(base.CONFIG, scene_range=BOX)
# A sample within this relative distance of a face counts as on it. Those
# samples sit within a few ulps of a face, and no other sample comes
# within 1e-3 of one.
FACE_TOL = 1e-5
# A one-ulp move of every point moves some gradient of JAX's loss by at
# least this much, relative to its largest entry.
ULP_SPREAD = 0.1


def _on_face(p, lib):
    return lib.abs(lib.abs(p) - BOX) < FACE_TOL * BOX


def _pin_torch(p):
    face = torch.sign(p) * torch.tensor(BOX, dtype=p.dtype)
    return torch.where(_on_face(p, torch), face.detach(), p)


def _staged_render_from_params(jgen, variables):
    """`base._staged_render_from_params` whose field sees the render's
    points moved up by `ulps` ulps (0 or 1) and, where `pin` is set, the
    face samples pinned onto their face: both are traced arguments, so
    every variant runs one compiled render."""
    synthesize = jax.jit(lambda ws: jgen.apply(
        variables, ws, method=JaxGenerator.synthesize))

    @functools.partial(jax.jit, static_argnums=3)
    def render_stage(state, cam, focal, cfg, ulps, pin):
        def sample_fn(pts, reqs):
            q = jax.lax.stop_gradient(pts)
            pts = pts + ulps * (jnp.nextafter(q, jnp.inf) - q)
            face = jax.lax.stop_gradient(jnp.sign(pts) * jnp.float32(BOX))
            pts = jnp.where(pin & _on_face(pts, jnp), face, pts)
            return jgen.apply(variables, state, pts, reqs,
                              method=JaxGenerator.sample)
        return jax_render(sample_fn, cfg.resolution, cfg.resolution, cam,
                          focal, None, None, cfg.scene_range,
                          cfg.white_background, cfg.depth_samples_per_ray,
                          rng=None, fine_sampling=True)

    def staged(ulps, pin):
        def render_from_params(gen, gen_vars, params, cfg, **unused):
            cam, focal = jax_inv.make_camera(params, cfg.camera_flipped)
            ws = params.z * cfg.lr_gain_z
            if ws.shape[1] == 1:
                ws = jnp.broadcast_to(ws, (ws.shape[0], 15, ws.shape[-1]))
            return render_stage(synthesize(ws), cam, focal, cfg,
                                jnp.float32(ulps), jnp.bool_(pin)), cam, focal
        return render_from_params

    return staged


@pytest.fixture(scope='module')
def case():
    case = base.make_case(CONFIG)
    case['staged'] = _staged_render_from_params(case['jgen'],
                                                case['variables'])
    return case


def _jax_loss_and_grads(case, ulps, pin):
    cfg = jax_inv.InversionConfig(loss_type='vgg', **base.CFG)
    _, jax_tform = base._tforms(10, 1)[0]

    def loss_fn(p):
        return jax_inv.inversion_loss(
            case['jgen'], case['variables'], case['jax_lpips'],
            case['lpips_vars'], p, jnp.asarray(case['target'].numpy()), cfg,
            jax.random.PRNGKey(0), injected={'tform': jax_tform})

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_inv, 'render_from_params',
                      case['staged'](ulps, pin))
        (loss, monitor), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            base._to_jax_params(case['init']))
    return loss, monitor, grads


def test_jax_gradients_move_with_the_points_by_one_ulp(case):
    """JAX against itself, every render point moved up by one ulp: some
    gradient moves by more than ULP_SPREAD, a hundred times the
    tolerance of the comparisons with the port."""
    _, _, grads = _jax_loss_and_grads(case, ulps=0, pin=False)
    _, _, moved = _jax_loss_and_grads(case, ulps=1, pin=False)
    spread = {n: base._rel(getattr(moved, n), getattr(grads, n))
              for n in base.PARAM_NAMES}
    print('one-ulp move, relative change of each gradient:', spread)
    assert max(spread.values()) > ULP_SPREAD, spread


def test_gradients_match_jax_with_face_samples_pinned(case):
    """The 'vgg' loss at equal boxes with the face samples pinned in both
    packages: one such sample per ray, and the loss, per-image psnr,
    lpips monitor and every gradient agree with JAX to base.RTOL."""
    cfg = inv.InversionConfig(loss_type='vgg', **base.CFG)
    port_tform, _ = base._tforms(10, 1)[0]
    params = case['init'].copy(requires_grad=True)
    on_face = []
    render = inv.render

    def pinned_render(sample_fn, *args, **kwargs):
        def pinned(pts, reqs, dirs):
            on_face.append(int(_on_face(pts, torch).any(-1).sum()))
            return sample_fn(_pin_torch(pts), reqs, dirs)
        return render(pinned, *args, **kwargs)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(inv, 'render', pinned_render)
        loss, monitor = inv.inversion_loss(case['port'], case['lpips'],
                                           params, case['target'], cfg,
                                           tform=port_tform)
    named = params.named()
    grads = torch.autograd.grad(loss, [t for _, t in named])
    # The coarse pass sees one face sample per ray, the fine pass none.
    assert on_face == [base.BATCH * base.RES * base.RES, 0]

    ref_loss, ref_monitor, ref_grads = _jax_loss_and_grads(case, ulps=0,
                                                            pin=True)
    assert base._rel(float(loss.detach()), float(ref_loss)) < base.RTOL
    assert base._rel(monitor['psnr'].numpy(),
                     ref_monitor['psnr']) < base.RTOL
    assert base._rel(float(monitor['lpips']),
                     float(ref_monitor['lpips'])) < base.RTOL
    for (name, _), g in zip(named, grads):
        ref = np.asarray(getattr(ref_grads, name))
        assert np.abs(ref).max() > 0, name
        assert base._rel(g.numpy(), ref) < base.RTOL, (
            name, base._rel(g.numpy(), ref))
