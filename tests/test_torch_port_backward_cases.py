"""The plain versions of B4 and of B3's backward against the JAX package
at the cases `chip_smoke.py` now holds the kernels to on the card.

On the card the binned planes-only triplane backward
(`triplane_sample_grad_planes.cu`) is held against its plain version on
a pile-up of clamped points, points on 16-texel tile boundaries and on
the last texel, a ragged N with B = 3 and 512^2 planes; the channel-last
crop-warp backward (`warp.cu`) on crops far outside the image and on a
grid of points scattered at random. Here the plain versions are held
against the JAX package at the same cases (small batch and width), so that
the chain kernel -> plain -> JAX covers each one: B4's against the JAX
windowed sampler with `coord_grads=False`, whose backward is the Pallas
kernel `_resident_grad_planes_kernel` run in interpret mode, and B3's
against `jax.vjp` of the XLA warp. Also here: B4's wrapper raises, without
a card, for what the binning cannot take, and its build hash covers the
binning header. Inputs come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.core import augment as jax_augment
from nerf_from_image_tpu.ops.pallas import triplane_window
from nerf_from_image_tpu_torch.ops import cuda_build
from nerf_from_image_tpu_torch.ops import triplane
from nerf_from_image_tpu_torch.ops import triplane_cuda
from nerf_from_image_tpu_torch.ops import warp

C = triplane_window.C  # the Pallas kernel's 32 channels
BLOCK = 256  # the windowed sampler's points a block: 8 x 8 rays x 4


def _b4_coords(case, rng, b, r):
    """(b, n, 3) points of a case, n not necessarily a block multiple."""
    if case == 'pile-up':
        # 90% of the points 1 to 3 half-widths outside the box on every
        # axis: they clamp onto the border texels and the corners.
        u = rng.uniform(0, 1, (b, BLOCK, 3))
        sign = rng.choice([-1.0, 1.0], (b, BLOCK, 3))
        inside = rng.uniform(0, 1, (b, BLOCK, 1)) < 0.1
        return np.where(inside, u * 2 - 1, sign * (1.0 + 2.0 * u)).astype(
            np.float32)
    if case == 'tile boundaries':
        # Every combination of the tile boundaries 16k / (R - 1), the last
        # texel and the first over the three coordinates.
        ticks = [-1.0 + 2.0 * 16 * k / (r - 1) for k in range(r // 16)]
        ticks = np.float32(ticks + [1.0])
        grid = np.stack(np.meshgrid(ticks, ticks, ticks, indexing='ij'),
                        axis=-1).reshape(1, -1, 3)
        return np.repeat(grid, b, axis=0)
    # A ragged N (not a multiple of any block or chunk), in and out of
    # range; the larger R takes points inside the box.
    n = 37 if case == 'ragged N' else BLOCK
    return rng.uniform(-1.2, 1.2, (b, n, 3)).astype(np.float32)


@pytest.mark.parametrize('case,b,r', [('pile-up', 2, 64),
                                      ('tile boundaries', 1, 48),
                                      ('ragged N', 3, 64),
                                      ('larger R', 1, 128)])
def test_plain_grad_planes_matches_pallas_b4_at_the_kernel_cases(case, b, r):
    """B4's plain version against the JAX windowed sampler's planes-only
    backward (the Pallas kernel in interpret mode, the XLA fix-up for the
    points outside their block's window). The JAX sampler takes points in
    blocks of 256, so the case's points are padded with points at the
    origin whose cotangent is zero. The Pallas kernel rounds its weighted
    cotangents to bf16 before it sums them, so the gap is held relative to
    the largest value at 5e-2, the bound of the B4 test in
    `test_torch_port_triplane_grad_planes.py` for the same rounding (the
    cases come to 0.002-0.016; a swapped axis gives 0.8-1.2)."""
    rng = np.random.default_rng({'pile-up': 0, 'tile boundaries': 1,
                                 'ragged N': 2, 'larger R': 3}[case])
    coords = _b4_coords(case, rng, b, r)
    n = coords.shape[1]
    grad_out = torch.tensor(rng.standard_normal((b, n, C)),
                            dtype=torch.float32).bfloat16()
    padded = -(-n // BLOCK) * BLOCK
    coords_jax = np.zeros((b, padded, 3), np.float32)
    coords_jax[:, :n] = coords
    grad_jax = np.zeros((b, padded, C), np.float32)
    grad_jax[:, :n] = grad_out.float().numpy()
    planes = rng.standard_normal((b, 3, C, r, r)).astype(np.float32)
    blocks = padded // BLOCK

    def loss(p):
        pdma = triplane_window.plane_layout_for_dma(p)
        feats, _ = triplane_window.sample_triplane_windowed(
            p, pdma, None,
            jnp.asarray(coords_jax).reshape(b, 8 * blocks, 8, 4, 3),
            coord_grads=False)
        return jnp.sum(feats.astype(jnp.float32) * grad_jax)

    ref = np.asarray(jax.grad(loss)(jnp.asarray(planes)), np.float64)
    dplanes = triplane.sample_triplane_grad_planes_plain(
        (b, 3, r, r, C), torch.tensor(coords), grad_out)
    got = dplanes.permute(0, 1, 4, 2, 3).double().numpy()
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-2
    if case == 'pile-up':  # the clamped points land on the border texels
        border = np.zeros((r, r), bool)
        border[[0, -1], :] = border[:, [0, -1]] = True
        on_border = np.abs(got[..., border]).sum()
        assert on_border > 0.5 * np.abs(got).sum()


def _crops(case, rng, b, n, h):
    """(b, n, h, h, 2) sampling grids: affine crops reaching far outside
    the image, or points scattered at random."""
    if case == 'scattered':
        return rng.uniform(-1.2, 1.2, (b, n, h, h, 2)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, (b * n, 1, 1))
    scale = np.exp2(rng.uniform(-1, 1, (b * n, 1, 1)))
    shift = rng.uniform(-1.5, 1.5, (b * n, 1, 2))
    ys, xs = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, h),
                         indexing='ij')
    gx = scale * (np.cos(theta) * xs - np.sin(theta) * ys)
    gy = scale * (np.sin(theta) * xs + np.cos(theta) * ys)
    return (np.stack((gx, gy), axis=-1) + shift[:, :, None, :]).astype(
        np.float32).reshape(b, n, h, h, 2)


@pytest.mark.parametrize('case,channels', [('outside', 3), ('scattered', 3),
                                           ('outside', 6)])
def test_plain_warp_grad_matches_jax_vjp(case, channels):
    """B3's backward, the plain version's autograd, against `jax.vjp` of
    the JAX package's XLA warp to the images, float32, at 1e-5 (the same
    float32 products, summed in another order): on crops far outside the
    image, on a scattered grid, and with 6 channels (the kernel's second
    layout, two float4 atomics a tap)."""
    rng = np.random.default_rng({'outside': 4, 'scattered': 5}[case] +
                                channels)
    b, n, h = 2, 3, 16
    images = rng.uniform(-1, 1, (b, channels, h, h)).astype(np.float32)
    grid = _crops(case, rng, b, n, h)
    grad_out = rng.standard_normal((b, n, channels, h, h)).astype(np.float32)

    leaf = torch.tensor(images, requires_grad=True)
    out = warp.warp_plain(leaf, torch.tensor(grid))
    got, = torch.autograd.grad(out, leaf, torch.tensor(grad_out))

    def f(img):
        return jax_augment._grid_sample_zeros(
            jnp.repeat(img, n, axis=0),
            jnp.asarray(grid).reshape(b * n, h, h, 2))

    _, vjp = jax.vjp(f, jnp.asarray(images))
    ref, = vjp(jnp.asarray(grad_out).reshape(b * n, channels, h, h))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert np.abs(np.asarray(ref)).max() > 0


@pytest.mark.parametrize('case', ['resolution', 'entries'])
def test_grad_planes_wrapper_raises_for_what_it_cannot_bin(case):
    """B4 bins as B2 does: one image's bin counters in 48 KB of shared
    memory (R up to 1024) and its entries in int32 (B * N * 3 < 2^31).
    The wrapper raises before it allocates or reaches a card (expanded
    tensors take no memory)."""
    if case == 'resolution':
        shape = (1, 3, 1040, 1040, 32)
        coords = torch.zeros(1, 4, 3)
        match = 'R up to 1024'
    else:
        shape = (1, 3, 16, 16, 32)
        coords = torch.zeros(1).expand(1, 2**30, 3)
        match = '2\\^31'
    grad_out = torch.zeros(1).expand(1, coords.shape[1], 32)
    with pytest.raises(ValueError, match=match):
        triplane_cuda.launch_grad_planes(shape, coords, grad_out)
    # The largest plane resolution the binning takes passes the check.
    assert triplane_cuda.grad_scratch_sizes(1, 4, 1024)[0] == 3 * 64 * 64


def test_the_shipped_grad_planes_source_hashes_its_bins_header():
    names = [p.name for p in cuda_build.included_files(
        cuda_build.CSRC_DIR / f'{triplane_cuda.GRAD_PLANES_KERNEL}.cu')]
    assert names == ['triplane_sample_grad_planes.cu', 'triplane_bins.cuh']
