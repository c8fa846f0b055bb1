"""The port's pose math and crop transforms against the JAX package and
the reference goldens.

`core/pose.py` is held against `nerf_from_image_tpu/core/pose.py` (values
and gradients) and against `tests/golden/core_golden.npz`, which holds the
reference's own outputs (`quat_mat`, `inv_*`, `p2m_*`, `m2p_*`);
`core/augment.py`'s transform geometry against the JAX package's for the
same transform. Inputs come from numpy seeds and the goldens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.core import augment as jax_augment
from nerf_from_image_tpu.core import pose as jax_pose
from nerf_from_image_tpu_torch.core import augment
from nerf_from_image_tpu_torch.core import pose


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a)
                                          else a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_invert_space_and_quaternion_match_goldens(golden):
    """Against the reference's outputs: 1e-5 (1e-4 for the scaled ortho
    pose, whose scale divides)."""
    _close(pose.invert_space(_t(golden['pose_persp'])), golden['inv_persp'])
    _close(pose.invert_space(_t(golden['pose_ortho'])), golden['inv_ortho'],
           1e-4)
    _close(pose.quaternion_to_matrix(_t(golden['quat'])),
           golden['quat_mat'])


@pytest.mark.parametrize('flipped', [False, True])
def test_pose_to_matrix_matches_goldens(golden, flipped):
    """Perspective and ortho, flipped or not: 1e-4 on the matrices (as
    `test_core_pose.py` holds the JAX package), 1e-5 on the focal."""
    sfx = '_flip' if flipped else ''
    z0, t2, s, q = (_t(golden[k]) for k in ('p2m_z0', 'p2m_t2', 'p2m_s',
                                            'quat'))
    mat, f = pose.pose_to_matrix(z0, t2, s, q, flipped)
    _close(mat, golden[f'p2m_mat{sfx}'], 1e-4)
    _close(f, golden[f'p2m_f{sfx}'])
    mat_o, f_o = pose.pose_to_matrix(None, t2, s, q, flipped)
    assert f_o is None
    _close(mat_o, golden[f'p2m_mat_ortho{sfx}'], 1e-4)


@pytest.mark.parametrize('flipped', [False, True])
def test_matrix_to_pose_matches_goldens(golden, flipped):
    sfx = '_flip' if flipped else ''
    z0, t2, s, q = pose.matrix_to_pose(_t(golden[f'p2m_mat{sfx}']),
                                       _t(golden[f'p2m_f{sfx}']), flipped)
    _close(z0, golden[f'm2p_z0{sfx}'], 1e-4)
    _close(t2, golden[f'm2p_t2{sfx}'], 1e-4)
    _close(s, golden[f'm2p_s{sfx}'], 1e-4)
    _close(q, golden[f'm2p_q{sfx}'], 1e-4)


@pytest.mark.parametrize('perspective', [True, False])
def test_pose_to_matrix_gradients_match_jax(perspective):
    """The vjp of (z0, t2, s, q) -> (matrix, focal) against JAX's, with the
    camera flipped as p3d_car's is: 1e-5 in float32."""
    rng = np.random.default_rng(0)
    b = 4
    z0 = rng.uniform(-0.5, 1.0, b).astype(np.float32)
    t2 = rng.uniform(-0.2, 0.2, (b, 2)).astype(np.float32)
    s = rng.uniform(0.8, 1.2, b).astype(np.float32)
    q = rng.standard_normal((b, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cot = rng.standard_normal((b, 4, 4)).astype(np.float32)
    cot_f = rng.standard_normal(b).astype(np.float32)

    def jax_fn(z0, t2, s, q):
        mat, f = jax_pose.pose_to_matrix(z0 if perspective else None, t2, s,
                                         q, True)
        return jnp.sum(mat * cot) + (jnp.sum(f * cot_f) if perspective
                                     else 0.0)

    ref = jax.grad(jax_fn, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (z0, t2, s, q)))
    args = [_t(a).requires_grad_() for a in (z0, t2, s, q)]
    mat, f = pose.pose_to_matrix(args[0] if perspective else None,
                                 *args[1:], True)
    total = (mat * _t(cot)).sum()
    if perspective:
        total = total + (f * _t(cot_f)).sum()
    grads = torch.autograd.grad(total, args, allow_unused=True)
    for g, r, a in zip(grads, ref, args):
        if g is None:  # z0 of the ortho camera
            assert not perspective and a is args[0]
            continue
        _close(g, r)


def test_rotation_matrix_distance_matches_jax():
    """Degrees between rotations, from 4x4 scaled poses: 1e-3 degrees
    (arccos near 1 amplifies float32 rounding)."""
    rng = np.random.default_rng(1)
    q1 = rng.standard_normal((6, 4)).astype(np.float32)
    q2 = q1 + rng.standard_normal((6, 4)).astype(np.float32) * 0.3
    m1, _ = jax_pose.pose_to_matrix(None, jnp.zeros((6, 2)), jnp.full(6, 1.3),
                                    jnp.asarray(q1 / np.linalg.norm(
                                        q1, axis=-1, keepdims=True)), True)
    m2, _ = jax_pose.pose_to_matrix(None, jnp.zeros((6, 2)), jnp.full(6, 0.7),
                                    jnp.asarray(q2 / np.linalg.norm(
                                        q2, axis=-1, keepdims=True)), True)
    ref = jax_pose.rotation_matrix_distance(m1, m2)
    port = pose.rotation_matrix_distance(_t(m1), _t(m2))
    _close(port, ref, 1e-3)
    assert float(port.max()) > 1.0


def _tform(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-np.pi, np.pi, n).astype(np.float32),
            np.exp2(rng.standard_normal(n) * 0.2).astype(np.float32),
            (rng.standard_normal((n, 2)) * 0.1).astype(np.float32))


@pytest.mark.parametrize('h,w', [(16, 16), (12, 20)])
def test_image_warp_grid_matches_jax(h, w):
    """The crop grid of a transform: 1e-5."""
    rot, scale, trans = _tform(2, 5)
    port = augment.image_warp_grid(
        augment.AffineTransform(_t(rot), _t(scale), _t(trans)), h, w)
    ref = jax_augment.image_warp_grid(
        jax_augment.AffineTransform(rot=jnp.asarray(rot),
                                    scale=jnp.asarray(scale),
                                    translation=jnp.asarray(trans)), h, w)
    assert port.shape == (5, h, w, 2)
    _close(port, ref)


def test_sample_transform_draws_from_the_generator():
    """Same seed, same transform; p = 0 is the identity; p = 1 rotates,
    scales and shifts every sample within the reference's ranges."""
    def draw(seed, p, n=256):
        return augment.sample_transform(torch.Generator().manual_seed(seed),
                                        n, p)

    a, b = draw(0, 1.0), draw(0, 1.0)
    for f in ('rot', 'scale', 'translation'):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert a.rot.shape == (256,) and a.translation.shape == (256, 2)
    assert (a.rot.abs() <= np.pi).all() and (a.rot != 0).all()
    assert (a.scale != 1).all() and 0.1 < float(a.scale.log2().std()) < 0.3
    assert (a.translation != 0).all()
    off = draw(1, 0.0)
    assert (off.rot == 0).all() and (off.scale == 1).all()
    assert (off.translation == 0).all()
    ones = augment.sample_transform(torch.Generator().manual_seed(2), 8, 1.0,
                                    disable_scale=True)
    assert (ones.scale == 1).all()


def test_augment_reuses_a_cached_transform():
    rng = np.random.default_rng(3)
    img = _t(rng.uniform(-1, 1, (4, 3, 16, 16)))
    out, _, _, tform = augment.augment(torch.Generator().manual_seed(0),
                                       img, None, None, 1.0,
                                       white_background=False)
    again, _, _, same = augment.augment(None, img, None, None, 1.0,
                                        white_background=False,
                                        cached_tform=tform)
    assert same is tform and torch.equal(out, again)
