"""The port's crop warp against the JAX package.

The plain version (`ops.warp.warp_plain`: the CPU path of
`grid_sample_zeros`, and what kernel B3 is held against on the card) and
its image gradient are held against `core.augment._grid_sample_zeros` of
the JAX package in float32, and against the JAX Pallas windowed warp
(TPU kernel B3, `grid_sample_zeros_windowed`) run in interpret mode, whose
values are bf16-rounded. Inputs and transforms come from a numpy seed;
both packages warp with the same grid. The CUDA kernels run only on the
card: `chip_smoke.py` holds them against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.core import augment as jax_augment
from nerf_from_image_tpu.ops.pallas import warp as jax_warp
from nerf_from_image_tpu_torch.core import augment
from nerf_from_image_tpu_torch.ops import warp

B, C, H, N = 2, 3, 32, 3


def _case(seed, c=C):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (B, c, H, H)).astype(np.float32)
    tform = augment.AffineTransform(
        rot=torch.tensor(rng.uniform(-np.pi, np.pi, B * N), dtype=torch.float32),
        scale=torch.tensor(np.exp2(rng.standard_normal(B * N) * 0.2),
                           dtype=torch.float32),
        translation=torch.tensor(rng.standard_normal((B * N, 2)) * 0.1,
                                 dtype=torch.float32))
    grid = augment.image_warp_grid(tform, H, H).reshape(B, N, H, H, 2)
    cot = rng.standard_normal((B, N, c, H, H)).astype(np.float32)
    return images, grid.numpy(), cot


def _jax_xla(images, grid):
    rep = jnp.repeat(jnp.asarray(images), N, axis=0)
    out = jax_augment._grid_sample_zeros(
        rep, jnp.asarray(grid).reshape(B * N, H, H, 2))
    return out.reshape(B, N, -1, H, H)


def _port(images, grid, cot):
    x = torch.tensor(images).requires_grad_()
    out = warp.grid_sample_zeros(x, torch.tensor(grid))
    dx, = torch.autograd.grad(out, x, torch.tensor(cot))
    return out.detach().numpy(), dx.numpy()


@pytest.mark.parametrize('channels', [3, 6])
def test_plain_warp_and_gradient_match_jax_xla(channels):
    """Forward and image gradient, float32: 1e-5 (the same products,
    summed in another order). The crops leave the image, so zeros padding
    shows."""
    images, grid, cot = _case(0, channels)
    out, dx = _port(images, grid, cot)
    ref, vjp = jax.vjp(lambda im: _jax_xla(im, grid), jnp.asarray(images))
    ref_dx, = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx, np.asarray(ref_dx), rtol=1e-5, atol=1e-5)
    assert (np.asarray(ref) == 0).any()
    assert np.all(out[np.asarray(ref) == 0] == 0)


def test_plain_warp_matches_pallas_windowed_warp():
    """Against TPU kernel B3 (interpret mode): its values are bf16-rounded,
    so 2e-2 on values in [-1, 1], the JAX package's own bound for it; the
    image gradient within 5e-2 of the largest, as `test_pallas_warp.py`
    holds it."""
    images, grid, cot = _case(1)
    out, dx = _port(images, grid, cot)
    ref, vjp = jax.vjp(
        lambda im: jax_warp.grid_sample_zeros_windowed(im, jnp.asarray(grid)),
        jnp.asarray(images))
    ref_dx, = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-2)
    ref_dx = np.asarray(ref_dx)
    assert np.abs(dx - ref_dx).max() / np.abs(ref_dx).max() < 5e-2


def test_warp_on_cpu_launches_nothing():
    images, grid, cot = _case(2)
    before = (warp.launches, warp.grad_launches)
    out, _ = _port(images, grid, cot)
    assert (warp.launches, warp.grad_launches) == before
    expect = augment._grid_sample_zeros(
        torch.tensor(images).repeat_interleave(N, dim=0),
        torch.tensor(grid).reshape(B * N, H, H, 2)).reshape(B, N, C, H, H)
    assert np.array_equal(out, expect.numpy())


def test_augment_impl_is_the_warp_with_the_white_shift():
    """augment_impl's white-background path (shift -1, warp, shift +1)
    equals the JAX package's for the same transform: 1e-5."""
    images, _, _ = _case(3)
    rng = np.random.default_rng(4)
    rot = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    scale = np.exp2(rng.standard_normal(B) * 0.2).astype(np.float32)
    trans = (rng.standard_normal((B, 2)) * 0.1).astype(np.float32)
    port = augment.augment_impl(
        torch.tensor(images), augment.AffineTransform(
            torch.tensor(rot), torch.tensor(scale), torch.tensor(trans)),
        white_background=True)
    ref, _, _ = jax_augment.augment_impl(
        jnp.asarray(images), None, None, jax_augment.AffineTransform(
            rot=jnp.asarray(rot), scale=jnp.asarray(scale),
            translation=jnp.asarray(trans)), white_background=True)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('case', ['channels', 'dtype', 'grid_batch',
                                  'grid_rank'])
def test_warp_rejects_bad_inputs(case):
    images = torch.zeros(2, 3, 8, 8)
    grid = torch.zeros(2, 4, 8, 8, 2)
    if case == 'channels':
        images = torch.zeros(2, 7, 8, 8)
    elif case == 'dtype':
        images = images.double()
    elif case == 'grid_batch':
        grid = torch.zeros(1, 4, 8, 8, 2)
    else:
        grid = torch.zeros(2, 8, 8, 2)
    with pytest.raises((ValueError, TypeError)):
        warp.grid_sample_zeros(images, grid)


def test_kernel_route_needs_cuda_tensors():
    """No quiet fallback: the B3 kernels never take CPU tensors."""
    images = torch.zeros(1, 3, 8, 8)
    grid = torch.zeros(1, 2, 8, 8, 2)
    with pytest.raises(ValueError, match='CUDA'):
        warp.launch(images, grid)
    with pytest.raises(ValueError, match='CUDA'):
        warp.launch_grad(torch.zeros(1, 2, 3, 8, 8), grid, images.shape)
