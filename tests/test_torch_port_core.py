"""The port's core math and resampling against the JAX package.

Each test feeds the same numpy inputs (made from a seed) to the JAX
function and to its counterpart in `nerf_from_image_tpu_torch`, in float32
on the CPU, and where the repo has one, holds the port against the
reference tape in `tests/golden/core_golden.npz` too. Tolerance 1e-4
unless stated: both sides run the same float32 arithmetic and differ only
in the order of sums and in transcendental round-off (~1e-6 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.core import compositing as jax_comp
from nerf_from_image_tpu.core import rays as jax_rays
from nerf_from_image_tpu.core import sampling as jax_sampling
from nerf_from_image_tpu.ops import resample as jax_resample
from nerf_from_image_tpu_torch.core import compositing
from nerf_from_image_tpu_torch.core import rays
from nerf_from_image_tpu_torch.core import sampling
from nerf_from_image_tpu_torch.ops import resample

TOL = 1e-4


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _cameras(rng, b):
    """Random look-at-ish poses around the box: rotation + translation."""
    q, _ = np.linalg.qr(rng.standard_normal((b, 3, 3)))
    cam = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    cam[:, :3, :3] = q
    cam[:, :3, 3] = -2.0 * q[:, :, 2]  # looks through the origin
    return cam.astype(np.float32)


@pytest.fixture(scope='module')
def ray_inputs():
    rng = np.random.default_rng(0)
    cam = _cameras(rng, 3)
    focal = rng.uniform(0.8, 1.6, 3).astype(np.float32)
    return cam, focal


def test_get_ray_bundle(ray_inputs):
    cam, focal = ray_inputs
    o, d = rays.get_ray_bundle(8, 9, _t(focal), _t(cam))
    jo, jd = jax_rays.get_ray_bundle(8, 9, jnp.asarray(focal),
                                     jnp.asarray(cam))
    _close(o, jo)
    _close(d, jd)


def test_get_ray_bundle_golden(golden):
    o, d = rays.get_ray_bundle(8, 9, _t(golden['focal']),
                               _t(golden['pose_persp']))
    _close(o, golden['persp_plain_o'])
    _close(d, golden['persp_plain_d'])


def test_near_far_and_query_points(ray_inputs):
    cam, focal = ray_inputs
    jo, jd = jax_rays.get_ray_bundle(16, 16, jnp.asarray(focal),
                                     jnp.asarray(cam))
    o, d = _t(jo), _t(jd)
    near, far = rays.compute_near_far_planes(o, d, 0.55)
    jnear, jfar = jax_rays.compute_near_far_planes(jo, jd, 0.55)
    _close(near, jnear)
    _close(far, jfar)
    qp, dv = rays.compute_query_points_from_rays(o, d, near, far, 16)
    jqp, jdv = jax_rays.compute_query_points_from_rays(jo, jd, jnear, jfar,
                                                       16)
    _close(qp, jqp)
    _close(dv, jdv)


def test_near_far_and_query_points_golden(golden):
    o, d = _t(golden['nf_o']), _t(golden['nf_d'])
    near, far = rays.compute_near_far_planes(o, d, 0.55)
    _close(near, golden['nf_near'], 1e-5)
    _close(far, golden['nf_far'], 1e-5)
    qp, dv = rays.compute_query_points_from_rays(
        o, d, _t(golden['nf_near']), _t(golden['nf_far']), 16)
    _close(qp, golden['qp_points'], 1e-5)
    _close(dv, golden['qp_depths'], 1e-5)


def test_sample_pdf_and_smoothing():
    rng = np.random.default_rng(1)
    bins = np.sort(rng.uniform(1.0, 3.0, (64, 15)), axis=-1)
    bins = bins.astype(np.float32)
    w = rng.uniform(0.0, 1.0, (64, 16)).astype(np.float32)
    w[:8] = 0.0  # flat pdf rows
    sw = sampling.smooth_weights_eg3d(_t(w))
    jsw = jax_sampling.smooth_weights_eg3d(jnp.asarray(w))
    _close(sw, jsw)
    s = sampling.sample_pdf(_t(bins), sw[..., 1:-1], 24)
    js = jax_sampling.sample_pdf(jnp.asarray(bins), jsw[..., 1:-1], 24)
    _close(s, js)


def test_sample_pdf_and_smoothing_golden(golden):
    s = sampling.sample_pdf(_t(golden['pdf_bins']),
                            _t(golden['pdf_weights']), 24)
    _close(s, golden['pdf_samples'])
    out = sampling.smooth_weights_eg3d(_t(golden['smooth_weights_in']))
    _close(out, golden['smooth_weights_out'], 1e-5)


def test_compositing_sorted(golden):
    args = (golden['comp_sigma'], golden['comp_rgb'], golden['nf_d'],
            golden['qp_depths'])
    rgb_m, depth_m, mask_m = compositing.render_volume_density(
        *map(_t, args), white_background=True)
    _close(rgb_m, golden['comp_rgb_map'])
    _close(depth_m, golden['comp_depth_map'])
    _close(mask_m, golden['comp_mask'])
    w = compositing.render_volume_density_weights_only(
        _t(golden['comp_sigma']), _t(golden['nf_d']),
        _t(golden['qp_depths']))
    jw = jax_comp.render_volume_density_weights_only(
        *map(jnp.asarray, (golden['comp_sigma'], golden['nf_d'],
                           golden['qp_depths'])))
    _close(w, jw)
    _close(w, golden['comp_weights'])


@pytest.mark.parametrize('with_ties', [False, True])
def test_compositing_unsorted_matches_pairwise(with_ties):
    """Sort-then-scan equals the JAX pairwise unsorted formulation, on a
    coarse (sorted) + fine (unsorted) union, with exact depth ties."""
    rng = np.random.default_rng(2)
    r, s = 37, 16
    z1 = np.sort(rng.uniform(1.0, 3.0, (r, s)), axis=-1)
    z2 = rng.uniform(1.0, 3.0, (r, s))
    if with_ties:
        z2[:, ::3] = z1[:, ::3]
    z = np.concatenate((z1, z2), axis=-1).astype(np.float32)
    sigma = rng.uniform(0.0, 5.0, (r, 2 * s)).astype(np.float32)
    rgb = rng.uniform(-1.0, 1.0, (r, 2 * s, 3)).astype(np.float32)
    rd = rng.standard_normal((r, 3)).astype(np.float32)
    port = compositing.render_volume_density(
        _t(sigma), _t(rgb), _t(rd), _t(z), white_background=True)
    ref = jax_comp.render_volume_density(
        *map(jnp.asarray, (sigma, rgb, rd, z)), white_background=True,
        samples_sorted=False)
    for p, j in zip(port, ref[:3]):
        _close(p, j)


@pytest.mark.parametrize('op', ['filter2d', 'filter2d_t', 'upsample2d',
                                'downsample2d'])
def test_resample(op, golden):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 12, 12)).astype(np.float32)
    port_fn, jax_fn, key = {
        'filter2d': (resample.filter2d, jax_resample.filter2d, 'f2d_out'),
        'filter2d_t': (lambda v: resample.filter2d(v, transpose=True),
                       lambda v: jax_resample.filter2d(v, transpose=True),
                       'f2d_t_out'),
        'upsample2d': (resample.upsample2d, jax_resample.upsample2d,
                       'us_out'),
        'downsample2d': (resample.downsample2d, jax_resample.downsample2d,
                         'ds_out'),
    }[op]
    _close(port_fn(_t(x)), jax_fn(jnp.asarray(x)))
    _close(port_fn(_t(golden['us_in'])), golden[key])
    # The gain of the upsampling filter path.
    if op == 'filter2d':
        _close(resample.filter2d(_t(x), gain=4.0),
               jax_resample.filter2d(jnp.asarray(x), gain=4.0))
