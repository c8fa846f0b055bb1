"""The port's fused triplane sample + decoder tail (TPU kernels B5a and
B5b) and the plain sampler at 512^2 planes (TPU kernel B6) against the
JAX package.

The plain PyTorch versions (the CPU paths of the CUDA kernels' wrappers)
are held against the JAX package's Pallas kernels run in interpret mode,
as `tests/test_triplane.py` runs them: B5a through
`sample_triplane_windowed(..., decode=...)` at R = 64, and B5b and B6
through `sample_windowed_raw` at R = 512, where the planes no longer fit
the TPU's VMEM and the streamed window kernels take over. The points are
clustered so that every block's window holds its points (no overflow, so
no block goes through the JAX package's XLA fix-up). Inputs come from a
numpy seed. The CUDA kernel runs only on the card: `chip_smoke.py` holds
it against the plain version there.

Tolerance 2e-2 of the largest value throughout: both sides read the same
bf16 texels and weights and sum in float32, but the Pallas kernels round
their row tap weights to bf16, so a feature can land one bf16 rounding
apart, and the output is rounded to bf16 once more (two roundings of
2^-8 each; measured: one ulp, 0.0078 at values near 1.3-2).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.ops.pallas import triplane_window as tw
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.ops import triplane
from nerf_from_image_tpu_torch.ops import triplane_cuda
from nerf_from_image_tpu_torch.utils import convert

RTOL_OF_MAX = 2e-2
DECODE_KEYS = ('w0', 'b0', 'w1', 'b1', 'palette')


def _close(port, ref):
    ref = np.asarray(ref, np.float32)
    gap = np.abs(np.asarray(port, np.float32) - ref)
    assert gap.max() <= RTOL_OF_MAX * np.abs(ref).max(), (gap.max(),
                                                          np.abs(ref).max())


def _clustered(rng, b, h, w, s, spread):
    """(B, H, W, S, 3) points: one random centre per image, each 8x8x4
    tile of the grid jittered within +-spread around it."""
    base = rng.uniform(-0.5, 0.5, (b, 1, 1, 1, 1, 1, 1, 3))
    jitter = rng.uniform(-spread, spread,
                         (b, h // 8, 8, w // 8, 8, s // 4, 4, 3))
    return np.clip(base + jitter, -1, 1).reshape(b, h, w, s, 3).astype(
        np.float32)


def _decode(rng, b, k, hidden=64):
    draw = {'w0': rng.standard_normal((32, hidden)) * 0.2,
            'b0': rng.standard_normal(hidden) * 0.1,
            'w1': rng.standard_normal((hidden, 1 + k)) * 0.2,
            'b1': rng.standard_normal(1 + k) * 0.1,
            'palette': rng.standard_normal((b, k, 3))}
    return {key: v.astype(np.float32) for key, v in draw.items()}


def _port_planes(planes):
    return triplane.planes_channel_last(torch.tensor(planes)).to(
        torch.bfloat16)


def _blocked(coords):
    """The points of a (B, H, W, S, 3) grid in the windowed kernels' block
    order (B, NB * P, 3), as `prepare_blocks` blocks them."""
    b, h, w, s, _ = coords.shape
    t, sl = tw.TILE, tw.SLAB
    return coords.reshape(b, h // t, t, w // t, t, s // sl, sl, 3).transpose(
        0, 1, 3, 5, 2, 4, 6, 7).reshape(b, -1, 3)


@pytest.mark.parametrize('k', [4, 10])
def test_fused_plain_matches_pallas_b5a(k):
    """B5a: the fused plain version against `_resident_kernel_fused` with
    `_decode_tail` (interpret mode), R = 64, 8x8 rays x 4 samples per
    image, two images with their own palettes."""
    rng = np.random.default_rng(0)
    b, r = 2, 64
    planes = rng.standard_normal((b, 3, 32, r, r)).astype(np.float32)
    coords = _clustered(rng, b, 8, 8, 4, 0.04)
    dec = _decode(rng, b, k)
    jp = jnp.asarray(planes)
    _, _, _, overflow = tw.prepare_blocks(jnp.asarray(coords), r, tw.TILE,
                                          tw.SLAB, tw.WIN, tw.WIN_Y)
    assert not np.asarray(overflow).any()
    ref, resid = tw.sample_triplane_windowed(
        jp, tw.plane_layout_for_dma(jp), None, jnp.asarray(coords),
        decode={key: jnp.asarray(v) for key, v in dec.items()})
    assert int(resid) == 0
    port = triplane_cuda.sample_triplane_fused(
        _port_planes(planes), torch.tensor(coords.reshape(b, -1, 3)),
        *(torch.tensor(dec[key]) for key in DECODE_KEYS))
    assert port.dtype == torch.bfloat16 and port.shape == (b, 8 * 8 * 4, 4)
    _close(port.float().numpy(), ref)


def test_fused_plain_is_sampler_then_decoder_tail():
    """The fused plain version equals B1's plain version followed by the
    decoder tail written out with the same roundings (float32 products of
    bf16 values), on points inside and outside the box."""
    rng = np.random.default_rng(1)
    b, r, k = 2, 16, 10
    planes = _port_planes(rng.standard_normal((b, 3, 32, r, r)).astype(
        np.float32))
    coords = torch.tensor(rng.uniform(-1.2, 1.2, (b, 50, 3)).astype(
        np.float32))
    dec = {key: torch.tensor(v) for key, v in _decode(rng, b, k).items()}
    out = triplane.sample_triplane_fused_plain(
        planes, coords, *(dec[key] for key in DECODE_KEYS))

    def bf(t):
        return t.to(torch.bfloat16).double()

    feats = bf(triplane.sample_triplane_plain(planes, coords))
    h = torch.nn.functional.softplus(feats @ bf(dec['w0']) +
                                     dec['b0'].double())
    d = bf(h) @ bf(dec['w1']) + dec['b1'].double()
    rgb = bf(torch.softmax(d[..., 1:], dim=-1)) @ bf(dec['palette'])
    ref = torch.cat((d[..., :1], rgb), dim=-1)
    _close(out.float().numpy(), ref.float().numpy())


@pytest.mark.parametrize('fused', [False, True], ids=['b6', 'b5b'])
def test_plain_matches_pallas_window_kernels_at_512(fused):
    """B6 (`_window_kernel`) and B5b (`_window_kernel_fused`) at R = 512,
    reached through `sample_windowed_raw`, against the plain sampler and
    the fused plain version on the same points in block order: one image,
    two blocks of 256 points."""
    rng = np.random.default_rng(2)
    b, r = 1, 512
    planes = rng.standard_normal((b, 3, 32, r, r)).astype(np.float32)
    coords = _clustered(rng, b, 16, 8, 4, 0.02)
    jc = jnp.asarray(coords)
    u, v, origins, overflow = tw.prepare_blocks(jc, r, tw.TILE, tw.SLAB,
                                                tw.WIN, tw.WIN_Y)
    assert not np.asarray(overflow).any()
    # Too large for the resident variant: the streamed window kernels run.
    assert 2 * 3 * r * r * 32 * 2 > 48 * 1024 * 1024
    dma = tw.plane_layout_for_dma(jnp.asarray(planes))
    points = torch.tensor(_blocked(coords))
    if fused:
        dec = _decode(rng, b, 10)
        ref = tw.sample_windowed_raw(
            dma, u, v, origins,
            decode={key: jnp.asarray(val) for key, val in dec.items()})
        port = triplane_cuda.sample_triplane_fused(
            _port_planes(planes), points,
            *(torch.tensor(dec[key]) for key in DECODE_KEYS))
    else:
        ref = tw.sample_windowed_raw(dma, u, v, origins)
        port = triplane_cuda.sample_triplane(_port_planes(planes), points)
    _close(port.float().numpy(), np.asarray(ref).reshape(port.shape))


CONFIG = dict(latent_dim=32, scene_range=0.55, attention_values=4,
              img_resolution=64, channel_base=1024, channel_max=64)


@pytest.fixture(scope='module')
def generators():
    """A small JAX generator with the Pallas sampler and its fused decode,
    and the port's generator with `fuse_decode` on the same weights."""
    jgen = JaxGenerator(use_pallas=True, fuse_decode=True, **CONFIG)
    variables = jax.jit(jgen.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((2, CONFIG['latent_dim'])))
    variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    # Put the surface inside the box (a fresh decoder's SDF is positive).
    variables['params']['decoder']['fc1']['bias'][0] = -1.5
    port = Generator(device='cpu', **CONFIG)
    convert.load_reference_state_dict(port, convert.from_jax_params(variables))
    return jgen, variables, port.fused_view()


def test_generator_fused_sample_matches_jax(generators):
    """`Generator.sample` with `fuse_decode` against JAX's
    `Generator(use_pallas=True, fuse_decode=True)` on an 8x8x4 grid of
    points per image. rgb at the file's tolerance. sigma is
    laplace_cdf(-d) / alpha, whose slope reaches 1 / (2 beta alpha) = 5
    at the surface, so the one bf16 rounding by which d can differ (2^-8
    of |d| <= 2) moves it by up to 5 * 2^-7 ~ 0.04: tolerance 5e-2."""
    jgen, variables, port = generators
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, CONFIG['latent_dim'])).astype(np.float32)
    pts = _clustered(rng, 2, 8, 8, 4, 0.04) * CONFIG['scene_range']

    @jax.jit
    def jax_sample(z, pts):
        ws = jgen.apply(variables, z, method=JaxGenerator.map)
        state = jgen.apply(variables, ws, method=JaxGenerator.synthesize)
        return jgen.apply(variables, state, pts, ('sigma', 'rgb'),
                          method=JaxGenerator.sample)

    ref = jax_sample(jnp.asarray(z), jnp.asarray(pts))
    before = triplane_cuda.fused_launches
    with torch.no_grad():
        state = port.synthesize(port.map(torch.tensor(z)))
        out = port.sample(state, torch.tensor(pts))
    assert triplane_cuda.fused_launches == before  # CPU: the plain version
    _close(out['rgb'].numpy(), ref['rgb'])
    sigma_gap = np.abs(out['sigma'].numpy() - np.asarray(ref['sigma']))
    assert sigma_gap.max() <= 5e-2, sigma_gap.max()
    assert np.asarray(ref['sigma']).max() > 0.1  # the grid meets the field


def test_generator_fused_sample_raises_under_autograd(generators):
    """The fused call has no backward (nor has JAX's): with autograd on
    and the weights requiring a gradient, `sample` raises rather than
    taking the unfused route."""
    _, _, port = generators
    z = torch.zeros((2, CONFIG['latent_dim']))
    state = port.synthesize(port.map(z))
    pts = torch.zeros((2, 10, 3))
    with pytest.raises(RuntimeError, match='no backward'):
        port.sample(state, pts)


def test_generator_fused_sample_reads_the_tail_synthesize_built(
        generators):
    """With `fuse_decode`, `synthesize` builds the decoder tail in the
    fused call's types once (bf16 weights and palette, float32 biases);
    `sample` raises for a state synthesized without it, and for another
    sampler, rather than ignoring either. The view shares the
    generator's parameters and leaves its `fuse_decode` off."""
    _, _, port = generators
    z = torch.zeros((2, CONFIG['latent_dim']))
    with torch.no_grad():
        state = port.synthesize(port.map(z))
    assert [t.dtype for t in state.fused_tail] == [
        torch.bfloat16, torch.float32, torch.bfloat16, torch.float32,
        torch.bfloat16]
    assert tuple(state.fused_tail[4].shape) == (2, CONFIG['attention_values'],
                                                3)
    plain = copy.copy(port)
    plain.fuse_decode = False
    with torch.no_grad():
        unfused_state = plain.synthesize(plain.map(z))
        pts = torch.zeros((2, 10, 3))
        assert unfused_state.fused_tail is None
        with pytest.raises(ValueError, match='without fuse_decode'):
            port.sample(unfused_state, pts)
        with pytest.raises(ValueError, match='fused call'):
            port.sample(state, pts, sampler=triplane.sample_triplane_gather)
    assert port.beta is plain.beta and port.fuse_decode


def test_fused_wrapper_dispatch():
    """CPU tensors take the plain version without a launch; the kernel's
    route never takes CPU tensors and takes K = 10 only, and the decoder
    tail's shapes are checked."""
    rng = np.random.default_rng(4)
    planes = _port_planes(rng.standard_normal((1, 3, 32, 8, 8)).astype(
        np.float32))
    coords = torch.tensor(rng.uniform(-1, 1, (1, 5, 3)).astype(np.float32))
    dec = {key: torch.tensor(v) for key, v in _decode(rng, 1, 10).items()}
    args = [dec[key] for key in DECODE_KEYS]
    before = triplane_cuda.fused_launches
    out = triplane_cuda.sample_triplane_fused(planes, coords, *args)
    assert triplane_cuda.fused_launches == before
    assert torch.equal(out, triplane.sample_triplane_fused_plain(
        planes, coords, *args))
    cast = [t.to(torch.bfloat16) if key in ('w0', 'w1', 'palette') else t
            for key, t in zip(DECODE_KEYS, args)]
    with pytest.raises(ValueError, match='CUDA'):
        triplane_cuda.launch_fused(planes, coords, *cast)
    four = _decode(rng, 1, 4)
    with pytest.raises(ValueError, match='palette entries'):
        triplane_cuda.launch_fused(planes, coords, *(
            torch.tensor(four[key]) for key in DECODE_KEYS))
    with pytest.raises(ValueError, match='decoder tail'):
        triplane_cuda.sample_triplane_fused(planes, coords, args[0][:16],
                                            *args[1:])


def test_synthesis_at_512_reads_the_last_w_as_jax():
    """At 512^2 planes the synthesis has 15 layers and the generator
    passes 14 ws; JAX's clamped indexing gives every layer of the last
    block the 14th. The port's planes against JAX's on one narrow
    generator (float32; 1e-4 of the largest value)."""
    config = dict(CONFIG, img_resolution=512, channel_base=1024,
                  channel_max=16)
    jgen = JaxGenerator(**config)
    variables = jax.jit(jgen.init)(jax.random.PRNGKey(1),
                                   jnp.zeros((1, CONFIG['latent_dim'])))
    variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    port = Generator(device='cpu', **config)
    convert.load_reference_state_dict(port, convert.from_jax_params(variables))
    z = np.random.default_rng(5).standard_normal(
        (1, CONFIG['latent_dim'])).astype(np.float32)

    @jax.jit
    def jax_planes(z):
        ws = jgen.apply(variables, z, method=JaxGenerator.map)
        return jgen.apply(variables, ws, method=JaxGenerator.synthesize).planes

    ref = np.asarray(jax_planes(jnp.asarray(z)))
    with torch.no_grad():
        planes = port.synthesize(port.map(torch.tensor(z))).planes.numpy()
    assert planes.shape == ref.shape == (1, 3, 32, 512, 512)
    assert np.abs(planes - ref).max() <= 1e-4 * np.abs(ref).max()
