"""The port's copy of the host PnP (`nerf_from_image_tpu_torch/invert/
pnp.py`) against the OpenCV golden, exact poses and the JAX package's
copy.

The port builds `native/pnp.cc` itself into `build/native/` and never
imports the JAX package's module; both load the same solver source, so
on the same inputs their outputs must be equal to the last bit. The
golden and exact-pose checks use `tests/test_pnp.py`'s tolerances.
"""

import pathlib

import numpy as np
import pytest

from nerf_from_image_tpu.invert import pnp as jax_pnp
from nerf_from_image_tpu_torch.invert import pnp

GOLDEN = pathlib.Path(__file__).parent / 'golden' / 'pnp_opencv_golden.npz'
FLIP = np.diag([1.0, -1.0, -1.0])


def _make_problem(rng, h=24, w=24, f=1.8):
    """(coords, mask, R, t) whose exact PnP solution is (R, t), in the
    reference's pixel-grid convention uv = (x / w, y / h) - 0.5."""
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    a, x, y, z = q
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * a), 2 * (x * z + y * a)],
        [2 * (x * y + z * a), 1 - 2 * (x * x + z * z), 2 * (y * z - x * a)],
        [2 * (x * z - y * a), 2 * (y * z + x * a), 1 - 2 * (x * x + y * y)]])
    t = np.array([0.05, -0.08, 3.5]) + rng.standard_normal(3) * 0.05
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    uv = np.stack((xs / w - 0.5, ys / h - 0.5), axis=-1).reshape(-1, 2)
    depths = 3.0 + rng.uniform(size=uv.shape[0])
    pc = np.concatenate((uv * depths[:, None] / f, depths[:, None]), axis=-1)
    coords = ((pc - t) @ rot).reshape(1, h, w, 3)
    mask = np.ones((1, h, w), dtype=bool)
    mask[0, :4, :4] = False
    return coords, mask, rot, t


def test_library_builds_under_build_native():
    pnp.load_library()
    path = pnp.library_path()
    assert path.exists()
    assert path.parent == pnp.REPO / 'build' / 'native'


def test_matches_opencv_golden():
    g = np.load(GOLDEN)
    w2c, _, _ = pnp.compute_pose_pnp(g['epnp_coords'], g['epnp_mask'],
                                     [2.0])
    np.testing.assert_allclose(FLIP @ w2c[0, :3, :3], g['epnp_R'],
                               atol=1e-2)
    np.testing.assert_allclose(FLIP @ w2c[0, :3, 3], g['epnp_t'], atol=5e-2)
    w2c, _, _ = pnp.compute_pose_pnp(g['sqpnp_coords'], g['sqpnp_mask'],
                                     [1.6])
    np.testing.assert_allclose(FLIP @ w2c[0, :3, :3], g['sqpnp_R'],
                               atol=2e-2)
    np.testing.assert_allclose(FLIP @ w2c[0, :3, 3], g['sqpnp_t'], atol=5e-2)


def test_recovers_exact_pose():
    coords, mask, rot, t = _make_problem(np.random.default_rng(0), f=1.8)
    w2c, focal, err = pnp.compute_pose_pnp(coords, mask, [1.2, 1.8, 2.5])
    assert focal[0] == pytest.approx(1.8)
    np.testing.assert_allclose(FLIP @ w2c[0, :3, :3], rot, atol=5e-3)
    np.testing.assert_allclose(FLIP @ w2c[0, :3, 3], t, atol=2e-2)
    assert err[0] < 1e-3


def test_batch_and_dummy_fallback_as_jax():
    """An empty mask takes the dummy pose (error 10, focal 1, tz = +10
    after the flip), and the whole batch equals the JAX package's."""
    coords, mask, _, _ = _make_problem(np.random.default_rng(1))
    coords2 = np.concatenate((coords, coords), axis=0)
    mask2 = np.concatenate((mask, np.zeros_like(mask)), axis=0)
    got = pnp.compute_pose_pnp(coords2, mask2, [1.8])
    assert got[2][1] == pytest.approx(pnp.DUMMY_ERROR)
    assert got[0][1, 2, 3] == pytest.approx(10.0)
    assert got[1][1] == pytest.approx(1.0)
    for a, b in zip(got, jax_pnp.compute_pose_pnp(coords2, mask2, [1.8])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('ortho', [False, True], ids=['persp', 'ortho'])
def test_estimate_poses_batch_equals_jax(ortho):
    """The bootstrap's entry (mask cut at 0.9, the orthographic proxy at
    focal 100) on two images, one with a soft mask partly under the cut
    and one empty: equal to the JAX package's, to the bit."""
    rng = np.random.default_rng(3)
    coords, mask, _, _ = _make_problem(rng, f=100.0 if ortho else 1.6)
    soft = mask[0].astype(np.float32) * rng.uniform(0.8, 1.0, mask.shape[1:])
    coords2 = np.concatenate((coords, coords), axis=0)
    masks = np.stack((soft, np.zeros_like(soft)))
    guesses = None if ortho else pnp.get_focal_guesses(
        rng.uniform(1.2, 2.0, 50))
    got = pnp.estimate_poses_batch(coords2, masks, guesses)
    ref = jax_pnp.estimate_poses_batch(coords2, masks, guesses)
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    assert got[2][1] == pytest.approx(pnp.DUMMY_ERROR)
    assert np.isfinite(got[0]).all()


def test_focal_guesses_as_jax():
    f = np.random.default_rng(4).uniform(1.0, 3.0, 100)
    np.testing.assert_array_equal(pnp.get_focal_guesses(f),
                                  jax_pnp.get_focal_guesses(f))
    assert len(pnp.get_focal_guesses(np.linspace(1.0, 3.0, 100))) == 11
    assert pnp.get_focal_guesses(None) is None
