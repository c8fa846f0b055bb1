"""The work counts of `port_bench/work/`: the model FLOPs against
torch.utils.flop_counter on the plain reference at a small width, and the
kernels' bytes against hand arithmetic at one shape."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference import generator as ref_generator
from port_bench.reference import lpips as ref_lpips
from port_bench.work import stylegan_triplane as work
from port_bench.work import triplane_grad, triplane_grad_planes
from port_bench.work import triplane_sample


def counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize('res,base,cmax', [(16, 256, 32), (32, 512, 16)])
def test_synthesis_and_palette_flops(res, base, cmax):
    gen = ref_generator.Generator(512, 1.4, img_resolution=res,
                                  channel_base=base, channel_max=cmax)
    gen.requires_grad_(False)
    ws = torch.randn(2, gen.num_ws, 512)
    total = counted(lambda: gen.synthesize(ws))
    assert total == 2 * (work.synthesis(res, base, cmax) + work.palette())


def test_decode_flops_per_point():
    gen = ref_generator.Generator(512, 1.4, img_resolution=16,
                                  channel_base=256, channel_max=32)
    gen.requires_grad_(False)
    state = gen.synthesize(torch.randn(1, gen.num_ws, 512))
    pts = torch.rand(1, 100, 3) * 2 - 1
    total = counted(lambda: gen.sample(state, pts))
    assert total == 100 * work.decode_point()


@pytest.mark.parametrize('h', [32, 48])
def test_lpips_flops(h):
    lp = ref_lpips.LPIPS('cpu')
    lp.requires_grad_(False)
    x, y = torch.rand(3, 3, h, h), torch.rand(3, 3, h, h)
    total = counted(lambda: lp(x, y))
    assert total == work.lpips(h, h, 3)


def test_lpips_data_gradient_doubles_the_rendered_side():
    """The inversion's backward: the data gradient alone, one F more of
    the differentiated side's VGG and lins."""
    lp = ref_lpips.LPIPS('cpu')
    lp.requires_grad_(False)
    x = torch.rand(2, 3, 32, 32, requires_grad=True)
    y = torch.rand(2, 3, 32, 32)
    total = counted(lambda: lp(x, y).sum().backward())
    assert total == work.lpips(32, 32, 2) + 2 * (work.vgg(32, 32) +
                                                  work.lpips_lins(32, 32))


def test_kernel_bytes_by_hand():
    b, n, r, c = 2, 1000, 64, 32
    plane = b * 3 * r * r * c
    assert triplane_sample.call(b, n, r) == {
        'bytes': plane * 2 + b * n * 12 + b * n * c * 2,
        'flops': b * n * 3 * 4 * c * 2}
    assert triplane_grad.call(b, n, r)['bytes'] == (
        plane * 2 + b * n * 12 + b * n * c * 2 + plane * 4 + b * n * 12)
    assert triplane_grad_planes.call(b, n, r)['bytes'] == (
        b * n * 12 + b * n * c * 2 + plane * 4)


def test_inversion_batch_parts():
    cfg = {'batch': 8, 'resolution': 128, 'plane_resolution': 256,
           'channel_base': 32768, 'channel_max': 512, 'samples_per_ray': 128,
           'crops': 15, 'steps': 30}
    parts = work.inversion_batch(cfg)
    # The flagship's refinement: some 7 TFLOP a step of 8 images.
    assert 5e12 < parts['steps'] / 30 < 1e13
    assert parts['evaluations'] < parts['steps'] / 10


def test_synthesis_data_gradient_is_one_more_forward():
    """The inversion differentiates the render to the latent alone: each
    convolution's and product's data gradient, one F."""
    gen = ref_generator.Generator(512, 1.4, img_resolution=16,
                                  channel_base=256, channel_max=32)
    gen.requires_grad_(False)
    ws = torch.randn(2, gen.num_ws, 512, requires_grad=True)

    def step():
        state = gen.synthesize(ws)
        (state.planes.square().sum() +
         state.attention_values.square().sum()).backward()
    total = counted(step)
    assert total == 2 * (2 * work.synthesis(16, 256, 32) + work.palette() +
                         work.palette_grad())


def _counted_from(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_discriminator_forward_and_step_convention():
    from port_bench.reference import discriminator as ref_disc
    d = ref_disc.Discriminator(resolution=32, nc=4, camera_flipped=True,
                               channel_base=256, channel_max=64)
    b = 8
    x = torch.randn(b, 4, 32, 32)
    pose = torch.eye(4).repeat(b, 1, 1)
    pose[:, 2, 3] = 3.0
    focal = torch.full((b,), 2.0)
    d.requires_grad_(False)
    forward = _counted_from(lambda: d(x, pose, None, focal))
    assert forward == b * work.discriminator(32, 4, 256, 64)
    d.requires_grad_(True)
    leaf = x.clone().requires_grad_()

    def step():
        xr = leaf * 1.0
        logits = d(xr, pose, None, focal)
        g, = torch.autograd.grad(logits.sum(), xr, create_graph=True)
        total = (torch.nn.functional.softplus(-logits).mean() +
                 g.square().sum() +
                 torch.nn.functional.softplus(d(x, pose, None, focal)).mean())
        total.backward()
    # The convention's 9F against what the reference's step multiplies.
    assert 0.95 * 9 * forward < _counted_from(step) <= 9 * forward
