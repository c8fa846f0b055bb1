"""The port's planes-only triplane backward (the plain version of kernel
B4) against the JAX package, and the sampler's dispatch to it.

`sample_triplane_grad_planes_plain` is held against the JAX Pallas
windowed backward with `coord_grads=False` (TPU kernel B4,
`_resident_grad_planes_kernel`) run in interpret mode, as
`tests/test_torch_port_triplane_grad.py` runs B2, and against the dplanes
of the full plain backward. The sampler's autograd function is held to
its dispatch: a backward that wants only the planes runs the planes-only
function and keeps only the coordinates from the forward; one that wants
the coordinates runs the full backward. The CUDA kernel runs only on the
card: `chip_smoke.py` holds it against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.ops.pallas import triplane_window
from nerf_from_image_tpu_torch.ops import triplane
from nerf_from_image_tpu_torch.ops import triplane_cuda


def _inputs(seed, b=2, r=16, n=40, c=32, lo=-1.3, hi=1.3):
    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((b, 3, c, r, r)).astype(np.float32)
    coords = rng.uniform(lo, hi, (b, n, 3)).astype(np.float32)
    grad_out = rng.standard_normal((b, n, c)).astype(np.float32)
    return planes, coords, grad_out


def test_plain_grad_planes_matches_pallas_b4():
    """Against TPU kernel B4 (interpret mode) at R=64 on a structured
    8x8x4 point grid. The Pallas kernel rounds its tap weights and
    cotangents to bf16, so the gap is held relative to the largest value:
    5e-2, the bound of the B2 test for the same rounding."""
    b, r, h, w, s = 1, 64, 8, 8, 4
    rng = np.random.default_rng(2)
    planes = rng.standard_normal((b, 3, 32, r, r)).astype(np.float32)
    base = rng.uniform(-0.5, 0.5, (b, 1, 1, 1, 1, 1, 1, 3))
    jitter = rng.uniform(-0.04, 0.04, (b, 1, 8, 1, 8, 1, 4, 3))
    coords = np.clip(base + jitter, -1, 1).reshape(b, h, w, s, 3).astype(
        np.float32)
    grad_out = rng.standard_normal((b, h * w * s, 32)).astype(np.float32)

    def loss(p):
        pdma = triplane_window.plane_layout_for_dma(p)
        feats, _ = triplane_window.sample_triplane_windowed(
            p, pdma, None, jnp.asarray(coords), coord_grads=False)
        return jnp.sum(feats.astype(jnp.float32) * grad_out)

    ref = np.asarray(jax.grad(loss)(jnp.asarray(planes)), np.float64)
    planes_cl = triplane.planes_channel_last(torch.tensor(planes))
    dplanes = triplane.sample_triplane_grad_planes_plain(
        planes_cl.shape, torch.tensor(coords.reshape(b, -1, 3)),
        torch.tensor(grad_out).bfloat16())
    got = dplanes.permute(0, 1, 4, 2, 3).double().numpy()
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-2


@pytest.mark.parametrize('chunk_points', [triplane.CHUNK_POINTS, 7])
def test_plain_grad_planes_is_the_full_backwards_dplanes(chunk_points,
                                                         monkeypatch):
    """Exactly the dplanes of `sample_triplane_grad_plain` (float32 planes,
    in range, outside it and on the borders): the same float32 products,
    added in the same order."""
    planes, coords, grad_out = _inputs(0)
    coords[:, :3] = [[-1, -1, -1], [1, 1, 1], [-1.2, 0.1, 1.2]]
    monkeypatch.setattr(triplane, 'CHUNK_POINTS', chunk_points)
    planes_cl = triplane.planes_channel_last(torch.tensor(planes))
    ref, _ = triplane.sample_triplane_grad_plain(
        planes_cl, torch.tensor(coords), torch.tensor(grad_out))
    got = triplane.sample_triplane_grad_planes_plain(
        planes_cl.shape, torch.tensor(coords), torch.tensor(grad_out))
    assert got.dtype == torch.float32
    assert torch.equal(got, ref)


@pytest.mark.parametrize('wanted', ['planes', 'coords', 'both'])
def test_backward_dispatch(wanted, monkeypatch):
    """A planes-only backward calls the planes-only function, and the
    forward keeps only the coordinates; a backward that wants the
    coordinates calls the full backward. Nothing launches on the CPU."""
    planes, coords, grad_out = _inputs(3, n=20)
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append(name)
            return fn(*args)
        return wrapped

    monkeypatch.setattr(triplane, 'sample_triplane_grad_plain',
                        spy('full', triplane.sample_triplane_grad_plain))
    monkeypatch.setattr(triplane, 'sample_triplane_grad_planes_plain',
                        spy('planes',
                            triplane.sample_triplane_grad_planes_plain))
    planes_cl = triplane.planes_channel_last(
        torch.tensor(planes)).requires_grad_(wanted != 'coords')
    pts = torch.tensor(coords).requires_grad_(wanted != 'planes')
    before = (triplane_cuda.launches, triplane_cuda.grad_launches,
              triplane_cuda.grad_planes_launches)
    feats = triplane_cuda.sample_triplane(planes_cl, pts)
    saved = feats.grad_fn.saved_tensors
    feats.backward(torch.tensor(grad_out))
    assert (triplane_cuda.launches, triplane_cuda.grad_launches,
            triplane_cuda.grad_planes_launches) == before
    assert calls == (['planes'] if wanted == 'planes' else ['full'])
    assert len(saved) == (1 if wanted == 'planes' else 2)
    if wanted != 'coords':
        ref, _ = triplane.sample_triplane_grad_plain(
            planes_cl.detach(), pts.detach(), torch.tensor(grad_out))
        assert torch.equal(planes_cl.grad, ref)


def test_planes_only_backward_in_bf16_casts_to_the_planes_dtype():
    planes, coords, grad_out = _inputs(4, n=30)
    planes_cl = triplane.planes_channel_last(
        torch.tensor(planes).bfloat16()).requires_grad_()
    feats = triplane.plain_sampler(planes_cl, torch.tensor(coords))
    cot = torch.tensor(grad_out).bfloat16()
    feats.backward(cot)
    ref = triplane.sample_triplane_grad_planes_plain(
        planes_cl.shape, torch.tensor(coords), cot)
    assert planes_cl.grad.dtype == torch.bfloat16
    assert torch.equal(planes_cl.grad, ref.bfloat16())


@pytest.mark.parametrize('case', ['device', 'grad_dtype', 'shape'])
def test_grad_planes_kernel_wrapper_rejects_bad_inputs(case):
    """The B4 wrapper never takes CPU tensors and checks its inputs."""
    shape = (1, 3, 8, 8, 32)
    coords = torch.zeros(1, 4, 3)
    grad_out = torch.zeros(1, 4, 32, dtype=torch.bfloat16)
    match = 'CUDA'
    if case == 'grad_dtype':
        grad_out = grad_out.float()
        match = 'grad_out'
    elif case == 'shape':
        shape = (1, 3, 8, 8, 16)
        match = 'planes'
    with pytest.raises(ValueError, match=match):
        triplane_cuda.launch_grad_planes(shape, coords, grad_out)
