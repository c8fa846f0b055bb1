"""The port's triplane sampler against the JAX package.

The plain PyTorch version (the CPU path of the CUDA kernel's wrapper) is
held against the JAX XLA quad-table sampler in float32, and against the
JAX Pallas windowed sampler (TPU kernel B1) run in interpret mode, as
`tests/test_triplane.py` runs it. Inputs come from a numpy seed. The CUDA
kernel itself runs only on the card: `chip_smoke.py` holds it against the
plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.core import rays as jax_rays
from nerf_from_image_tpu.ops import triplane as jax_triplane
from nerf_from_image_tpu.ops.pallas import triplane_window
from nerf_from_image_tpu_torch.ops import triplane
from nerf_from_image_tpu_torch.ops import triplane_cuda


def _planes(rng, b, r, c=32):
    return rng.standard_normal((b, 3, c, r, r)).astype(np.float32)


def _port(planes, coords, dtype=torch.float32):
    planes_cl = triplane.planes_channel_last(torch.tensor(planes).to(dtype))
    return triplane_cuda.sample_triplane(
        planes_cl, torch.tensor(coords.reshape(coords.shape[0], -1, 3)))


@pytest.mark.parametrize('chunk_points', [triplane.CHUNK_POINTS, 7])
def test_plain_matches_xla_quad_table(chunk_points, monkeypatch):
    """Float32, in range and outside it (border clamp), at plane borders
    and exactly on texel centres. Tolerance 1e-5: the same 12 float32
    products, summed in another order."""
    rng = np.random.default_rng(0)
    b, r = 2, 16
    planes = _planes(rng, b, r, c=32)
    coords = rng.uniform(-1.3, 1.3, (b, 40, 3)).astype(np.float32)
    coords[:, :4] = [[-1, -1, -1], [1, 1, 1], [1, -1, 0.3],
                     [-1 + 2 / (r - 1), 0, 1 - 4 / (r - 1)]]
    planes_cl = triplane.planes_channel_last(torch.tensor(planes))
    monkeypatch.setattr(triplane, 'CHUNK_POINTS', chunk_points)
    port = triplane.sample_triplane_plain(planes_cl, torch.tensor(coords))
    ref = jax_triplane.sample_triplane(jnp.asarray(planes),
                                       jnp.asarray(coords))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_plain_matches_pallas_windowed_sampler():
    """Against TPU kernel B1 (interpret mode) at R=64, 16x16 rays x 4
    samples of a camera at z=2, f=1.2; in-box points only (outside the box
    the windowed kernel returns window-clamped texels, the port
    border-clamps, and the render zeroes sigma there). Both read the same
    bf16 texels; the Pallas kernel rounds its row tap weights to bf16
    (relative error 2^-9 on a weight) and both round the output to bf16,
    so with N(0, 1) texels the gap stays below 3e-2."""
    rng = np.random.default_rng(1)
    b, r, res, s = 1, 64, 16, 4
    planes = _planes(rng, b, r)
    cam = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    cam[:, 2, 3] = 2.0
    o, d = jax_rays.get_ray_bundle(res, res, jnp.full((b,), 1.2),
                                   jnp.asarray(cam))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    near, far = jax_rays.compute_near_far_planes(o, d, 0.55)
    pts, _ = jax_rays.compute_query_points_from_rays(o, d, near, far, s)
    coords = np.asarray(pts / 0.55, np.float32)  # (B, H, W, S, 3)

    jplanes = jnp.asarray(planes)
    ref, resid = triplane_window.sample_triplane_windowed(
        jplanes, triplane_window.plane_layout_for_dma(jplanes), None,
        jnp.asarray(coords))
    assert int(resid) == 0
    port = _port(planes, coords, torch.bfloat16)
    assert port.dtype == torch.bfloat16

    inbox = np.all(np.abs(coords.reshape(b, -1, 3)) <= 1.0, axis=-1)
    assert inbox.mean() > 0.5
    gap = np.abs(port.float().numpy() - np.asarray(ref, np.float32))
    assert gap[inbox].max() < 3e-2


def test_wrapper_on_cpu_takes_plain_version_without_launching():
    rng = np.random.default_rng(2)
    planes = _planes(rng, 1, 8)
    coords = rng.uniform(-1, 1, (1, 10, 3)).astype(np.float32)
    before = triplane_cuda.launches
    out = _port(planes, coords)
    assert triplane_cuda.launches == before
    planes_cl = triplane.planes_channel_last(torch.tensor(planes))
    ref = triplane.sample_triplane_plain(planes_cl, torch.tensor(coords))
    assert torch.equal(out, ref)


@pytest.mark.parametrize('case', ['channels', 'coords_dtype', 'batch',
                                  'contiguity', 'planes_dtype'])
def test_wrapper_rejects_bad_inputs(case):
    planes_cl = torch.zeros(2, 3, 8, 8, 32)
    coords = torch.zeros(2, 5, 3)
    if case == 'channels':
        planes_cl = torch.zeros(2, 3, 8, 8, 16)
    elif case == 'coords_dtype':
        coords = coords.double()
    elif case == 'batch':
        coords = torch.zeros(1, 5, 3)
    elif case == 'contiguity':
        coords = torch.zeros(2, 3, 5).transpose(1, 2)
    else:
        planes_cl = planes_cl.half()
    with pytest.raises((ValueError, TypeError)):
        triplane_cuda.sample_triplane(planes_cl, coords)


def test_kernel_path_needs_cuda_tensors_and_has_no_backward():
    """The kernel route never takes CPU tensors (no quiet fallback), and
    its backward (TPU kernel B2) raises until it is ported."""
    with pytest.raises(ValueError, match='CUDA'):
        triplane_cuda.launch(torch.zeros(1, 3, 8, 8, 32,
                                         dtype=torch.bfloat16),
                             torch.zeros(1, 4, 3))
    with pytest.raises(NotImplementedError, match='B2'):
        triplane_cuda._TriplaneSample.backward(None, torch.zeros(1))
