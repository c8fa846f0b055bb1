"""The port's triplane backward against the JAX package.

`sample_triplane_grad_plain` (the plain version of kernel B2, and the CPU
path of the sampler's backward) is held against `jax.vjp` of the XLA
quad-table sampler in float32, against autograd through the port's own
plain forward, and against the JAX Pallas windowed backward (TPU kernel
B2, `_resident_grad_kernel`) run in interpret mode, as
`tests/test_triplane.py` runs it. Inputs come from a numpy seed. The CUDA
kernel itself runs only on the card: `chip_smoke.py` holds it against the
plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.ops import triplane as jax_triplane
from nerf_from_image_tpu.ops.pallas import triplane_window
from nerf_from_image_tpu_torch.ops import triplane
from nerf_from_image_tpu_torch.ops import triplane_cuda


def _inputs(seed, b=2, r=16, n=40, c=32, lo=-1.3, hi=1.3):
    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((b, 3, c, r, r)).astype(np.float32)
    coords = rng.uniform(lo, hi, (b, n, 3)).astype(np.float32)
    grad_out = rng.standard_normal((b, n, c)).astype(np.float32)
    return planes, coords, grad_out


def _port_grad(planes, coords, grad_out, dtype=torch.float32):
    planes_cl = triplane.planes_channel_last(torch.tensor(planes).to(dtype))
    dplanes, dcoords = triplane.sample_triplane_grad_plain(
        planes_cl, torch.tensor(coords), torch.tensor(grad_out))
    # Back to the JAX package's (B, 3, C, R, R) layout.
    return dplanes.float().permute(0, 1, 4, 2, 3).numpy(), dcoords.numpy()


@pytest.mark.parametrize('chunk_points', [triplane.CHUNK_POINTS, 7])
def test_plain_grad_matches_jax_vjp(chunk_points, monkeypatch):
    """Float32, in range and outside it (border clamp: zero coordinate
    gradient), exactly on texel centres and exactly on the borders (JAX's
    clip gives half the slope there). Tolerance 1e-5: the same float32
    products, summed in another order."""
    planes, coords, grad_out = _inputs(0)
    r = planes.shape[-1]
    coords[:, :5] = [[-1, -1, -1], [1, 1, 1], [1, -1, 0.3],
                     [-1 + 2 / (r - 1), 0, 1 - 4 / (r - 1)],
                     [-1.2, 0.1, 1.2]]
    monkeypatch.setattr(triplane, 'CHUNK_POINTS', chunk_points)
    dplanes, dcoords = _port_grad(planes, coords, grad_out)

    def f(p, c):
        return jax_triplane.sample_packed_triplane(
            jax_triplane.pack_triplane(p), c, r)

    _, vjp = jax.vjp(f, jnp.asarray(planes), jnp.asarray(coords))
    ref_planes, ref_coords = vjp(jnp.asarray(grad_out))
    np.testing.assert_allclose(dplanes, np.asarray(ref_planes), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dcoords, np.asarray(ref_coords), rtol=1e-5,
                               atol=1e-5)
    # Clamped axes get no gradient.
    assert dcoords[0, 4, 0] == 0.0 and dcoords[0, 4, 2] == 0.0


def test_plain_grad_matches_autograd_of_plain_forward():
    """The written-out backward equals autograd through the plain forward
    (away from the exact borders, where torch's clamp and JAX's clip
    differ): 1e-5 in float32."""
    planes, coords, grad_out = _inputs(1, n=64)
    planes_cl = triplane.planes_channel_last(
        torch.tensor(planes)).requires_grad_()
    pts = torch.tensor(coords).requires_grad_()
    feats = triplane.sample_triplane_plain(planes_cl, pts)
    ref_planes, ref_coords = torch.autograd.grad(feats, (planes_cl, pts),
                                                 torch.tensor(grad_out))
    dplanes, dcoords = triplane.sample_triplane_grad_plain(
        planes_cl.detach(), pts.detach(), torch.tensor(grad_out))
    torch.testing.assert_close(dplanes, ref_planes, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dcoords, ref_coords, rtol=1e-5, atol=1e-5)


def test_plain_grad_matches_pallas_windowed_backward():
    """Against TPU kernel B2 (interpret mode) at R=64 on a structured
    8x8x4 point grid, as `test_windowed_gradients_match_xla` runs it. The
    Pallas kernel rounds its tap weights to bf16 and both sides read bf16
    texels, so the gap is held relative to the largest value: 5e-2, the
    JAX package's own bound for that kernel against its XLA path."""
    b, r, h, w, s = 1, 64, 8, 8, 4
    rng = np.random.default_rng(2)
    planes = rng.standard_normal((b, 3, 32, r, r)).astype(np.float32)
    base = rng.uniform(-0.5, 0.5, (b, 1, 1, 1, 1, 1, 1, 3))
    jitter = rng.uniform(-0.04, 0.04, (b, 1, 8, 1, 8, 1, 4, 3))
    coords = np.clip(base + jitter, -1, 1).reshape(b, h, w, s, 3).astype(
        np.float32)
    grad_out = rng.standard_normal((b, h * w * s, 32)).astype(np.float32)

    def loss(p, c):
        pdma = triplane_window.plane_layout_for_dma(p)
        feats, _ = triplane_window.sample_triplane_windowed(p, pdma, None, c)
        return jnp.sum(feats.astype(jnp.float32) * grad_out)

    ref_planes, ref_coords = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(planes), jnp.asarray(coords))
    dplanes, dcoords = _port_grad(planes, coords.reshape(b, -1, 3),
                                  grad_out, torch.bfloat16)

    def rel(a, ref):
        ref = np.asarray(ref, np.float64)
        return np.abs(np.asarray(a, np.float64) - ref).max() / np.abs(
            ref).max()

    assert rel(dplanes, ref_planes) < 5e-2
    assert rel(dcoords, np.asarray(ref_coords).reshape(b, -1, 3)) < 5e-2


@pytest.mark.parametrize('wanted', ['both', 'planes', 'coords'])
def test_sampler_backward_on_cpu_is_the_plain_backward(wanted):
    """On CPU tensors the sampler's autograd.Function runs the plain
    backward, launches nothing, and gives no gradient to an input that
    does not want one."""
    planes, coords, grad_out = _inputs(3, n=20)
    planes_cl = triplane.planes_channel_last(torch.tensor(planes))
    pts = torch.tensor(coords)
    planes_cl.requires_grad_(wanted in ('both', 'planes'))
    pts.requires_grad_(wanted in ('both', 'coords'))
    before = (triplane_cuda.launches, triplane_cuda.grad_launches)
    feats = triplane_cuda.sample_triplane(planes_cl, pts)
    feats.backward(torch.tensor(grad_out))
    assert (triplane_cuda.launches, triplane_cuda.grad_launches) == before
    ref_planes, ref_coords = triplane.sample_triplane_grad_plain(
        planes_cl.detach(), pts.detach(), torch.tensor(grad_out))
    if wanted in ('both', 'planes'):
        assert torch.equal(planes_cl.grad, ref_planes)
    if wanted in ('both', 'coords'):
        assert torch.equal(pts.grad, ref_coords)
    if wanted == 'coords':
        assert planes_cl.grad is None


def test_plain_sampler_is_differentiable_in_bf16():
    """`plain_sampler` (what the kernels are held against on the card) in
    bf16: its gradients are the plain backward's, dplanes in bf16."""
    planes, coords, grad_out = _inputs(4, n=30)
    planes_cl = triplane.planes_channel_last(
        torch.tensor(planes).bfloat16()).requires_grad_()
    pts = torch.tensor(coords).requires_grad_()
    feats = triplane.plain_sampler(planes_cl, pts)
    assert feats.dtype == torch.bfloat16
    cot = torch.tensor(grad_out).bfloat16()
    feats.backward(cot)
    ref_planes, ref_coords = triplane.sample_triplane_grad_plain(
        planes_cl.detach(), pts.detach(), cot)
    assert planes_cl.grad.dtype == torch.bfloat16
    assert torch.equal(planes_cl.grad, ref_planes)
    assert torch.equal(pts.grad, ref_coords)


@pytest.mark.parametrize('case', ['device', 'grad_dtype', 'grad_shape'])
def test_grad_kernel_wrapper_rejects_bad_inputs(case):
    """The B2 wrapper never takes CPU tensors and checks the cotangent."""
    planes = torch.zeros(1, 3, 8, 8, 32, dtype=torch.bfloat16)
    coords = torch.zeros(1, 4, 3)
    grad_out = torch.zeros(1, 4, 32, dtype=torch.bfloat16)
    if case == 'grad_dtype':
        grad_out = grad_out.float()
    elif case == 'grad_shape':
        grad_out = torch.zeros(1, 5, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError,
                       match='CUDA' if case == 'device' else 'grad_out'):
        triplane_cuda.launch_grad_raw(planes, coords, grad_out)
