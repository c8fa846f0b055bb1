"""The plain versions of B2 and B3 against the JAX package at the cases
`chip_smoke.py` now holds the kernels to on the card.

On the card the binned triplane backward (`triplane_sample_grad.cu`) and
the patch-tiled crop warp forward (`warp.cu`) are held against their plain
versions on a pile-up of clamped points, points on 16-texel tile
boundaries, a ragged N, 512^2 planes, crops far outside the image and an
odd crop width. Here the plain versions are held against the JAX package
at the same cases (small batch and width), so that the chain kernel ->
plain -> JAX covers each one. Also here: the build's cache key follows
every included header, and the kernels' wrappers raise, without a card,
for the sizes the kernels do not take. Inputs come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.core import augment as jax_augment
from nerf_from_image_tpu.ops import triplane as jax_triplane
from nerf_from_image_tpu_torch.ops import cuda_build
from nerf_from_image_tpu_torch.ops import triplane
from nerf_from_image_tpu_torch.ops import triplane_cuda
from nerf_from_image_tpu_torch.ops import warp

C = 4  # channels of the plain comparisons (the kernels take 32)


def _coords(case, rng, b, r):
    if case == 'pile-up':
        # 90% of the points 1 to 3 half-widths outside the box on every
        # axis: they clamp onto the border texels and the corners.
        u = rng.uniform(0, 1, (b, 300, 3))
        sign = rng.choice([-1.0, 1.0], (b, 300, 3))
        out = sign * (1.0 + 2.0 * u)
        inside = rng.uniform(0, 1, (b, 300, 1)) < 0.1
        return np.where(inside, u * 2 - 1, out).astype(np.float32)
    if case == 'tile boundaries':
        # Every combination of the tile boundaries 16k / (R - 1), the last
        # texel and the first over the three coordinates.
        ticks = [-1.0 + 2.0 * 16 * k / (r - 1) for k in range(r // 16)]
        ticks = np.float32(ticks + [1.0])
        grid = np.stack(np.meshgrid(ticks, ticks, ticks, indexing='ij'),
                        axis=-1).reshape(1, -1, 3)
        return np.repeat(grid, b, axis=0)
    # A ragged N (not a multiple of any block or chunk), in and out of range.
    return rng.uniform(-1.2, 1.2, (b, 37, 3)).astype(np.float32)


@pytest.mark.parametrize('case,r', [('pile-up', 32), ('tile boundaries', 48),
                                    ('ragged N', 40), ('ragged N', 512)])
def test_plain_grad_matches_jax_vjp_at_the_kernel_cases(case, r):
    """B2's plain backward against `jax.vjp` of the XLA sampler, float32,
    at 1e-5 (the same float32 products, summed in another order), at R of
    the flagship's tile multiples, at R = 40 (not a multiple of the 16
    texel tile) and at R = 512."""
    rng = np.random.default_rng(
        {'pile-up': 0, 'tile boundaries': 1, 'ragged N': 2}[case] + r)
    b = 1 if r == 512 else 2
    planes = rng.standard_normal((b, 3, C, r, r)).astype(np.float32)
    coords = _coords(case, rng, b, r)
    grad_out = rng.standard_normal(
        (b, coords.shape[1], C)).astype(np.float32)

    planes_cl = triplane.planes_channel_last(torch.tensor(planes))
    dplanes, dcoords = triplane.sample_triplane_grad_plain(
        planes_cl, torch.tensor(coords), torch.tensor(grad_out))

    def f(p, c):
        return jax_triplane.sample_packed_triplane(
            jax_triplane.pack_triplane(p), c, r)

    _, vjp = jax.vjp(f, jnp.asarray(planes), jnp.asarray(coords))
    ref_planes, ref_coords = vjp(jnp.asarray(grad_out))
    np.testing.assert_allclose(dplanes.permute(0, 1, 4, 2, 3).numpy(),
                               np.asarray(ref_planes), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dcoords.numpy(), np.asarray(ref_coords),
                               rtol=1e-5, atol=1e-5)
    if case == 'pile-up':  # most coordinates clamp: no gradient there
        assert (dcoords.numpy() == 0).mean() > 0.5


@pytest.mark.parametrize('size', [(32, 32), (31, 33)])
def test_plain_warp_matches_jax_at_crops_outside_the_image(size):
    """B3's plain forward against the JAX package's XLA warp, float32,
    1e-5, on crops that reach far outside the image (most of the output is
    the zeros padding) at a square size and at an odd size whose pixel
    count is not a multiple of 4."""
    rng = np.random.default_rng(sum(size))
    b, n, c, h = 2, 3, 3, 32
    oh, ow = size
    images = rng.uniform(-1, 1, (b, c, h, h)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, (b * n, 1, 1))
    scale = np.exp2(rng.uniform(-1, 1, (b * n, 1, 1)))
    shift = rng.uniform(-1.5, 1.5, (b * n, 1, 2))
    ys, xs = np.meshgrid(np.linspace(-1, 1, oh), np.linspace(-1, 1, ow),
                         indexing='ij')
    gx = scale * (np.cos(theta) * xs - np.sin(theta) * ys)
    gy = scale * (np.sin(theta) * xs + np.cos(theta) * ys)
    grid = (np.stack((gx, gy), axis=-1) + shift[:, :, None, :]).astype(
        np.float32).reshape(b, n, oh, ow, 2)

    out = warp.warp_plain(torch.tensor(images), torch.tensor(grid))
    ref = jax_augment._grid_sample_zeros(
        jnp.repeat(jnp.asarray(images), n, axis=0),
        jnp.asarray(grid).reshape(b * n, oh, ow, 2))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref).reshape(b, n, c, oh, ow),
                               rtol=1e-5, atol=1e-5)
    assert (out.numpy() == 0).mean() > 0.3


def test_library_path_follows_included_headers(tmp_path):
    """The build's name hashes the source and every header it reaches
    through quoted includes, so a changed header is never served by a
    stale build; an unrelated file leaves the name as it was."""
    (tmp_path / 'k.cu').write_text('#include "a.cuh"\n#include <cstdint>\n')
    (tmp_path / 'a.cuh').write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / 'b.cuh').write_text('// b\n')
    (tmp_path / 'other.cuh').write_text('// other\n')
    first = cuda_build.library_path('k', tmp_path)
    assert [p.name for p in cuda_build.included_files(tmp_path / 'k.cu')] \
        == ['k.cu', 'a.cuh', 'b.cuh']
    (tmp_path / 'other.cuh').write_text('// other, edited\n')
    assert cuda_build.library_path('k', tmp_path) == first
    (tmp_path / 'b.cuh').write_text('// b, edited\n')
    second = cuda_build.library_path('k', tmp_path)
    assert second != first and second.name.startswith('libk-')
    (tmp_path / 'k.cu').write_text('#include "a.cuh"\n// edited\n')
    assert cuda_build.library_path('k', tmp_path) not in (first, second)


def test_the_shipped_grad_source_hashes_its_bins_header():
    names = [p.name for p in cuda_build.included_files(
        cuda_build.CSRC_DIR / f'{triplane_cuda.GRAD_KERNEL}.cu')]
    assert names == ['triplane_sample_grad.cu', 'triplane_bins.cuh']


@pytest.mark.parametrize('case', ['elements', 'crops', 'grad elements'])
def test_warp_kernels_raise_above_32_bit_sizes(case):
    """The warp kernels take 32-bit offsets and one grid row per crop; the
    wrappers raise before they reach a card (expanded tensors take no
    memory)."""
    if case == 'crops':
        images = torch.zeros(1).expand(70000, 3, 8, 8)
        grid = torch.zeros(1).expand(70000, 1, 8, 8, 2)
    else:
        images = torch.zeros(1).expand(2, 3, 8, 8)
        grid = torch.zeros(1).expand(2, 4, 16384, 16384, 2)
    with pytest.raises(ValueError, match='2\\^31'):
        if case == 'grad elements':
            warp.launch_grad(torch.zeros(1).expand(2, 4, 3, 16384, 16384),
                             grid, images.shape)
        else:
            warp.launch(images, grid)


@pytest.mark.parametrize('case', ['resolution', 'entries'])
def test_binned_backward_raises_for_what_it_cannot_bin(case):
    """The binned backward keeps one image's bin counters in 48 KB of
    shared memory (R <= 1024) and its entries in int32 (B * N * 3 <
    2^31); the wrapper raises before it reaches a card."""
    if case == 'resolution':
        planes = torch.zeros(1).expand(1, 3, 1040, 1040, 32)
        coords = torch.zeros(1, 4, 3)
        match = 'R up to 1024'
    else:
        planes = torch.zeros(1).expand(1, 3, 16, 16, 32)
        coords = torch.zeros(1).expand(1, 2**30, 3)
        match = '2\\^31'
    grad_out = torch.zeros(1).expand(1, coords.shape[1], 32)
    with pytest.raises(ValueError, match=match):
        triplane_cuda.launch_grad_raw(planes, coords, grad_out)


@pytest.mark.parametrize('r', [16, 40, 256, 512])
def test_grad_scratch_holds_every_chunk_of_any_binning(r):
    """The work list the wrapper allocates holds every chunk the kernels
    can cut, whatever the bins' counts: sum(ceil(count / chunk)) stays
    within bins + entries // chunk + 1 for even, skewed and single-bin
    counts."""
    b, n = 2, 5000
    bins, max_work = triplane_cuda.grad_scratch_sizes(b, n, r)
    tiles = -(-r // triplane_cuda.GRAD_TILE)
    assert bins == b * 3 * tiles * tiles
    entries = 3 * b * n
    rng = np.random.default_rng(r)
    chunk = triplane_cuda.GRAD_CHUNK
    for counts in (np.full(bins, entries // bins),
                   rng.multinomial(entries, rng.dirichlet(
                       np.full(bins, 0.05))),
                   np.eye(1, bins, 0, dtype=int)[0] * entries):
        assert -(-counts // chunk).sum() <= max_work
