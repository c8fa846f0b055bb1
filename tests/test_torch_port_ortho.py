"""Orthographic cameras (cub) against the JAX package and the goldens.

- `get_ray_bundle` with focal None, with and without a bbox crop, against
  `core_golden.npz`'s `ortho_plain_*` and `ortho_bbox_*` (the reference's
  rays) and against JAX's, at 1e-6.
- An orthographic render of a small generator (latent 32, 64^2 planes,
  narrow channels, four attention values), JAX's weights carried to the
  port by `from_jax_params`: rgb and mask within 1e-4.
- One inversion loss and its gradients with an orthographic camera (no
  z0), `test_torch_port_inversion.py`'s setup and JAX stages: the loss
  within 1e-5, each gradient within 1e-3 of its largest entry. As in that
  file, the field's box (1.5) is a little larger than the render's (1.4),
  so no sample lies on a face of the field's box.
- `load_dataset` on a `write_cub` fixture (train, train-eval and test
  splits) against JAX's: every array within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_inversion as base
from nerf_from_image_tpu import config as jax_config
from nerf_from_image_tpu.core import rays as jax_rays
from nerf_from_image_tpu.data import loaders as jax_loaders
from nerf_from_image_tpu.invert import optimizer as jax_inv
from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.render import render as jax_render
from nerf_from_image_tpu_torch import config
from nerf_from_image_tpu_torch.core import rays
from nerf_from_image_tpu_torch.data import fixtures
from nerf_from_image_tpu_torch.data import loaders
from nerf_from_image_tpu_torch.invert import optimizer as inv
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.render.renderer import render
from nerf_from_image_tpu_torch.utils import convert

RAY_TOL = 1e-6
RENDER_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
SPLIT_ATOL = 1e-6
CONFIG = dict(latent_dim=32, scene_range=1.5, attention_values=4,
              img_resolution=64, channel_base=1024, channel_max=64)
BATCH, RES, SAMPLES = 2, 16, 4


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


@pytest.mark.parametrize('crop', ['plain', 'bbox'])
def test_ortho_ray_bundle_matches_golden_and_jax(golden, crop):
    cam = golden['pose_ortho']
    bbox = golden['bbox'] if crop == 'bbox' else None
    o, d = rays.get_ray_bundle(
        8, 9, None, torch.tensor(cam),
        None if bbox is None else torch.tensor(bbox))
    jo, jd = jax_rays.get_ray_bundle(
        8, 9, None, jnp.asarray(cam),
        None if bbox is None else jnp.asarray(bbox))
    for got, ref, want in ((o, jo, golden[f'ortho_{crop}_o']),
                           (d, jd, golden[f'ortho_{crop}_d'])):
        assert got.shape == tuple(want.shape)
        _close(got.numpy(), want, RAY_TOL)
        _close(got.numpy(), ref, RAY_TOL)


def _ortho_cameras(b):
    """Orthographic cameras looking at the box (s 1, 1.1; turned about
    y), through the port's pose_to_matrix, as the inversion builds
    them."""
    quat = np.array([[1.0, 0.1, 0.3, 0.0], [0.9, -0.2, 0.5, 0.1]][:b],
                    np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    return quat, np.array([1.0, 1.1][:b], np.float32), np.array(
        [[0.02, -0.03], [0.0, 0.05]][:b], np.float32)


def test_ortho_render_matches_jax():
    jgen = JaxGenerator(**CONFIG)
    variables = jax.jit(jgen.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((BATCH, CONFIG['latent_dim'])))
    variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    variables['params']['decoder']['fc1']['bias'][0] = -1.5
    port = Generator(device='cpu', **CONFIG)
    convert.load_reference_state_dict(port,
                                      convert.from_jax_params(variables))
    quat, s, t2 = _ortho_cameras(BATCH)
    params = inv.InversionParams(z=torch.zeros(1), R=torch.tensor(quat),
                                 s=torch.tensor(s), t2=torch.tensor(t2))
    cam, focal = inv.make_camera(params, True)
    assert focal is None
    ws = np.random.default_rng(0).standard_normal(
        (BATCH, 15, 512)).astype(np.float32)

    with torch.no_grad():
        state = port.synthesize(torch.tensor(ws))
        out = render(port.field(state), RES, RES, cam, None, 1.4, False,
                     SAMPLES)

    jstate = jax.jit(lambda w: jgen.apply(
        variables, w, method=JaxGenerator.synthesize))(jnp.asarray(ws))

    @jax.jit
    def jax_stage(state, cam):
        def sample_fn(pts, reqs):
            return jgen.apply(variables, state, pts, reqs,
                              method=JaxGenerator.sample)
        return jax_render(sample_fn, RES, RES, cam, None, None, None, 1.4,
                          False, SAMPLES, rng=None, fine_sampling=True)

    ref = jax_stage(jstate, jnp.asarray(cam.numpy()))
    assert float(ref.mask.max()) > 0.3  # the views see the surface
    _close(out.rgb.numpy(), ref.rgb, RENDER_TOL)
    _close(out.mask.numpy(), ref.mask, RENDER_TOL)


@pytest.fixture(scope='module')
def ortho_case():
    case = base.make_case(base.CONFIG)
    init = case['init']
    case['init'] = dataclasses.replace(init, z0=None, s=init.s * 0.8)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_inv, 'render_from_params',
                      base._staged_render_from_params(case['jgen'],
                                                      case['variables']))
        yield case


def test_ortho_inversion_loss_and_gradients_match_jax(ortho_case):
    """`inversion_loss` (VGG, 3 injected crops) from orthographic
    parameters against JAX's, the gradients to z, R, s and t2."""
    cfg = inv.InversionConfig(**base.CFG)
    jcfg = jax_inv.InversionConfig(**base.CFG)
    params = ortho_case['init'].copy(requires_grad=True)
    assert [n for n, _ in params.named()] == ['z', 'R', 's', 't2']
    port_tform, jax_tform = base._tforms(10, 1)[0]
    target = ortho_case['target']
    loss, monitor = inv.inversion_loss(ortho_case['port'],
                                       ortho_case['lpips'], params, target,
                                       cfg, tform=port_tform)
    named = params.named()
    grads = torch.autograd.grad(loss, [t for _, t in named])

    def loss_fn(p):
        return jax_inv.inversion_loss(
            ortho_case['jgen'], ortho_case['variables'],
            ortho_case['jax_lpips'], ortho_case['lpips_vars'], p,
            jnp.asarray(target.numpy()), jcfg, jax.random.PRNGKey(0),
            injected={'tform': jax_tform})

    (ref_loss, ref_monitor), ref_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(base._to_jax_params(params))
    assert ref_grads.z0 is None
    assert base._rel(float(loss.detach()), float(ref_loss)) < LOSS_RTOL
    assert base._rel(monitor['cam'].numpy(), ref_monitor['cam']) < 1e-5
    for (name, _), g in zip(named, grads):
        ref = getattr(ref_grads, name)
        assert np.abs(ref).max() > 0, name
        gap = base._rel(g.numpy(), ref)
        assert gap < GRAD_RTOL, (name, gap)


def test_ortho_render_from_params_options(ortho_case):
    """`render_from_params` without z0: the focal is None, normals and
    semantics come on request, and `override_cam` replaces the camera."""
    cfg = inv.InversionConfig(**base.CFG)
    params = ortho_case['init']
    port = ortho_case['port']
    with torch.no_grad():
        out, cam, focal = inv.render_from_params(
            port, params, cfg, compute_normals=True, compute_semantics=True)
        other = cam.clone()
        other[:, :3, 3] += 0.1
        moved, cam2, _ = inv.render_from_params(port, params, cfg,
                                                override_cam=other)
    assert focal is None
    assert out.normals.shape == (2, 32, 32, 3)
    assert out.semantics.shape == (2, 32, 32, 4)
    assert torch.equal(cam2, other)
    assert not torch.equal(moved.rgb, out.rgb)


def _assert_splits_equal(got, ref):
    assert (got is None) == (ref is None)
    if got is None:
        return
    for field in ('images', 'images_highres', 'tform_cam2world',
                  'focal_length', 'bbox', 'center', 'classes',
                  'num_classes'):
        a, b = getattr(got, field), getattr(ref, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert np.shape(a) == np.shape(b), field
            np.testing.assert_allclose(a, b, rtol=0, atol=SPLIT_ATOL,
                                       err_msg=field)


@pytest.mark.parametrize('extra', [['--run_inversion'], []],
                         ids=['inversion', 'training'])
def test_cub_fixture_loads_as_in_jax(tmp_path, extra):
    """A `write_cub` fixture: train (mirrored, 2x under ADA), train-eval
    and (for the inversion) test splits; ortho cameras (no focal, no
    bbox)."""
    data = str(tmp_path)
    fixtures.write_cub(data, n_train=4, n_test=3, size=(48, 40))
    argv = ['--dataset', 'cub', '--data_path', data, '--resolution',
            '32'] + extra
    got = loaders.load_dataset(config.parse_args(argv))
    ref = jax_loaders.load_dataset(jax_config.parse_args(argv))
    assert got[0] == ref[0]
    for g, r in zip(got[1:], ref[1:]):
        _assert_splits_equal(g, r)
    train, train_eval, test = got[1:]
    assert len(train.images) == 8 and train.focal_length is None
    assert (test is not None) == bool(extra)
    if test is not None:
        assert test.images.shape == (3, 32, 32, 4)
