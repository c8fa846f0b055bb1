"""The plain versions of B1 and B5a against the JAX package at the cases
`chip_smoke.py` now holds the forward kernels to on the card.

On the card the forward sampler (`triplane_sample.cu`) and the fused
sample + decoder tail (`triplane_sample_fused.cu`), which share the
sampling core `triplane_taps.cuh` (four lanes a point, warp tiles of 16
and 32 points, a persistent grid), are held against their plain versions
on a ragged N with B = 3 (tiles that straddle images), a pile-up of
points clamped outside the box, R = 40 and R = 512. Here the plain
versions are held against the JAX package at the first three (small
widths; R = 512 is in `test_torch_port_fused.py`), so that the chain
kernel -> plain -> JAX covers each one. The Pallas kernels take neither
unstructured points nor R below 64, so the reference is the XLA sampler
(`nerf_from_image_tpu/ops/triplane.py:sample_triplane`) and, for the
decode, the Pallas kernel's own decoder tail (`_decode_tail`) on its
features, image by image. Also here: the forward wrappers' raises for
what the kernels' 32-bit offsets and 16-byte loads cannot take, checked
without a card, and the build's hash over the shared header. Inputs come
from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.ops import triplane as jax_triplane
from nerf_from_image_tpu.ops.pallas import triplane_window as tw
from nerf_from_image_tpu_torch.ops import cuda_build
from nerf_from_image_tpu_torch.ops import triplane
from nerf_from_image_tpu_torch.ops import triplane_cuda

CASES = ['ragged N', 'pile-up', 'R 40']
# The fused decode against the Pallas decoder tail: both round the
# features, the hidden units and the probabilities to bf16 and sum in
# float32 in another order, so a rounding can land one bf16 ulp apart
# (two roundings of 2^-8 of the largest value), as in chip_smoke.py.
FUSED_RTOL_OF_MAX = 2e-2


def _case(case):
    """(planes (B, 3, C, R, R), coords (B, N, 3)) float32 of one case."""
    rng = np.random.default_rng(CASES.index(case))
    if case == 'ragged N':
        # N = 8191 is a multiple of no tile, so with B = 3 tiles straddle
        # images.
        b, n, r = 3, 8191, 32
        coords = rng.uniform(-1.2, 1.2, (b, n, 3))
    elif case == 'pile-up':
        # 90% of the points 1 to 3 half-widths outside the box on every
        # axis: they clamp onto the border texels and the corners.
        b, n, r = 2, 3000, 32
        u = rng.uniform(0, 1, (b, n, 3))
        sign = rng.choice([-1.0, 1.0], (b, n, 3))
        inside = rng.uniform(0, 1, (b, n, 1)) < 0.1
        coords = np.where(inside, u * 2 - 1, sign * (1.0 + 2.0 * u))
    else:
        b, n, r = 2, 1000, 40
        coords = rng.uniform(-1.2, 1.2, (b, n, 3))
    planes = rng.standard_normal((b, 3, triplane_cuda.CHANNELS, r, r))
    return planes.astype(np.float32), coords.astype(np.float32)


def _bf16(a):
    """float32 numpy -> the nearest bf16 values, as float32 numpy."""
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', CASES)
def test_plain_sampler_matches_jax_at_the_forward_cases(case, dtype):
    """B1's plain version against the XLA sampler. float32: 1e-5 (the
    same 12 products, summed in another order). bf16 planes, the
    kernel's type: the JAX float32 result on the same bf16 texels, within
    one bf16 rounding of the output (the kernel's 1e-2)."""
    planes, coords = _case(case)
    if dtype == 'bfloat16':
        planes = _bf16(planes)
    planes_cl = triplane.planes_channel_last(torch.tensor(planes)).to(
        getattr(torch, dtype))
    port = triplane.sample_triplane_plain(planes_cl, torch.tensor(coords))
    assert port.dtype == planes_cl.dtype
    ref = np.asarray(jax_triplane.sample_triplane(jnp.asarray(planes),
                                                  jnp.asarray(coords)))
    tol = 1e-5 if dtype == 'float32' else 1e-2
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=tol,
                               atol=tol)
    if case == 'pile-up':  # most points read only border texels
        outside = np.any(np.abs(coords) > 1.0, axis=-1)
        assert outside.mean() > 0.8


@pytest.mark.parametrize('case', CASES)
def test_plain_fused_matches_jax_decode_at_the_forward_cases(case):
    """B5a's plain version against the XLA sampler followed by the Pallas
    kernel's decoder tail, each image with its own palette, on bf16
    texels, weights and palettes (K = 10, the kernel's)."""
    planes, coords = _case(case)
    planes = _bf16(planes)
    b = planes.shape[0]
    rng = np.random.default_rng(10 + CASES.index(case))
    k, hidden = triplane_cuda.FUSED_VALUES, triplane_cuda.HIDDEN
    w0 = _bf16(rng.standard_normal((triplane_cuda.CHANNELS, hidden)) * 0.2)
    b0 = (rng.standard_normal(hidden) * 0.1).astype(np.float32)
    w1 = _bf16(rng.standard_normal((hidden, 1 + k)) * 0.2)
    b1 = (rng.standard_normal(1 + k) * 0.1).astype(np.float32)
    palette = _bf16(rng.standard_normal((b, k, 3)))

    port = triplane_cuda.sample_triplane_fused(
        triplane.planes_channel_last(torch.tensor(planes)),
        torch.tensor(coords),
        *(torch.tensor(t) for t in (w0, b0, w1, b1, palette)))
    assert port.dtype == torch.bfloat16 and port.shape == (b, len(
        coords[0]), 4)

    feats = jax_triplane.sample_triplane(jnp.asarray(planes),
                                         jnp.asarray(coords))
    ref = np.stack([np.asarray(tw._decode_tail(
        feats[i], jnp.asarray(w0, jnp.bfloat16), jnp.asarray(b0),
        jnp.asarray(w1, jnp.bfloat16), jnp.asarray(b1),
        jnp.asarray(palette[i:i + 1], jnp.bfloat16))) for i in range(b)])
    gap = np.abs(port.float().numpy() - ref)
    assert gap.max() <= FUSED_RTOL_OF_MAX * np.abs(ref).max(), (
        gap.max(), np.abs(ref).max())


@pytest.mark.parametrize('case', ['aligned', 'misaligned planes',
                                  'texel offsets', 'points'])
def test_forward_kernels_raise_for_what_they_cannot_take(case):
    """The forward kernels read the planes with 16-byte loads and take
    32-bit texel offsets within an image's planes and 32-bit point
    indices; `check_forward_limits`, which both wrappers run before a
    launch, raises for planes off a 16-byte boundary (a view with a
    storage offset), for 3 R^2 32 and for B N at 2^31 or more (expanded
    tensors take no memory)."""
    planes = torch.zeros(1, 3, 8, 8, 32, dtype=torch.bfloat16)
    coords = torch.zeros(1, 5, 3)
    match = None
    if case == 'misaligned planes':
        flat = torch.zeros(1 + planes.numel(), dtype=torch.bfloat16)
        planes = flat[1:].view(planes.shape)
        assert planes.is_contiguous() and planes.data_ptr() % 16 == 2
        match = '16-byte'
    elif case == 'texel offsets':
        planes = torch.zeros(1, dtype=torch.bfloat16).expand(
            1, 3, 4800, 4800, 32)
        match = '2\\^31 texel'
    elif case == 'points':
        coords = torch.zeros(1).expand(1, 2**31, 3)
        match = '2\\^31 points'
    if match is None:
        triplane_cuda.check_forward_limits(planes, coords)
    else:
        with pytest.raises(ValueError, match=match):
            triplane_cuda.check_forward_limits(planes, coords)


@pytest.mark.parametrize('kernel', [triplane_cuda.KERNEL,
                                    triplane_cuda.FUSED_KERNEL])
def test_forward_sources_hash_their_shared_sampling_core(kernel):
    names = [p.name for p in cuda_build.included_files(
        cuda_build.CSRC_DIR / f'{kernel}.cu')]
    assert names == [f'{kernel}.cu', 'triplane_taps.cuh']
