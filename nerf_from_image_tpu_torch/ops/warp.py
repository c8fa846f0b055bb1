"""Image warp into affine crops: the CUDA kernels on the card, the plain
version on the CPU.

The kernels (`csrc/warp.cu`) replace TPU kernel B3,
`grid_sample_zeros_windowed` in `nerf_from_image_tpu/ops/pallas/warp.py`:
a bilinear sample with zeros padding and align_corners=False of
(B, C, H, W) images at (B, N, H', W', 2) grids, N crops per image, and its
backward to the images (the grid is data and gets no gradient). The port
keeps float32 throughout, so it equals the JAX package's XLA path
(`core.augment._grid_sample_zeros`); the Pallas path rounds to bf16.

`grid_sample_zeros` takes the plain version (`warp_plain`: the image
repeated per crop, then `core.augment._grid_sample_zeros` and its
autograd) only for tensors that lie on the CPU; for CUDA tensors it
launches the kernels, through `_Warp`, or raises. The kernels take 32-bit
offsets and one block row per crop: `_check_sizes` raises for a tensor of 2^31
elements or more and for more than 65,535 crops. The backward adds each
tap's channels with one float4 atomic into a channel-last scratch, which
`launch_grad` allocates. `launches` and `grad_launches` count the forward
and backward launches.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_from_image_tpu_torch.core import augment
from nerf_from_image_tpu_torch.ops import cuda_build

KERNEL = 'warp'
MAX_CHANNELS = 6
MAX_ELEMENTS = 2**31 - 1  # the kernels' 32-bit offsets
MAX_CROPS = 65535  # B * N: the kernels' grid rows, one a crop
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 6 + \
    [ctypes.c_void_p]
GRAD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

launches = 0
grad_launches = 0


def _check(images: torch.Tensor, grid: torch.Tensor) -> None:
    if images.device != grid.device:
        raise ValueError(f'images on {images.device}, grid on '
                         f'{grid.device}')
    if images.dtype != torch.float32 or grid.dtype != torch.float32:
        raise TypeError(f'images and grid must be float32, got '
                        f'{images.dtype} and {grid.dtype}')
    if images.ndim != 4 or not 1 <= images.shape[1] <= MAX_CHANNELS:
        raise ValueError(f'images must be (B, C <= {MAX_CHANNELS}, H, W), '
                         f'got {tuple(images.shape)}')
    if (grid.ndim != 5 or grid.shape[0] != images.shape[0] or
            grid.shape[-1] != 2):
        raise ValueError(f'grid must be (B, N, H\', W\', 2), got '
                         f'{tuple(grid.shape)}')


def _check_sizes(images_shape, grid: torch.Tensor) -> None:
    """The kernels' limits: 32-bit offsets, one grid row per crop."""
    b, c, ih, iw = images_shape
    _, n, oh, ow, _ = grid.shape
    if (max(b * c * ih * iw, grid.numel(), b * n * c * oh * ow) >
            MAX_ELEMENTS or b * n > MAX_CROPS):
        raise ValueError(f'the warp kernels take under 2^31 elements a '
                         f'tensor and at most {MAX_CROPS} crops, got images '
                         f'{tuple(images_shape)} and grid '
                         f'{tuple(grid.shape)}')


def _launch(first: torch.Tensor, grid: torch.Tensor, out: torch.Tensor,
            images_shape) -> int:
    """Launches the forward; returns the number of launches made (0 or
    1)."""
    b, c, ih, iw = images_shape
    _, n, oh, ow, _ = grid.shape
    if first.device.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got '
                         f'{first.device}')
    if not (first.is_contiguous() and grid.is_contiguous()):
        raise ValueError('the warp kernels take contiguous tensors')
    if out.numel() == 0 or first.numel() == 0:
        return 0
    fn = cuda_build.function(KERNEL, 'warp_forward_f32', ARGTYPES)
    err = cuda_build.call(fn, first, first.data_ptr(), grid.data_ptr(),
                          out.data_ptr(), b, n, c, ih, iw, oh, ow)
    if err != 0:
        raise RuntimeError(f'warp_forward_f32 launch failed: cudaError {err}')
    return 1


def launch(images: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Runs the forward kernel: (B, C, H, W), (B, N, H', W', 2) ->
    (B, N, C, H', W'), all float32."""
    global launches
    _check(images, grid)
    _check_sizes(images.shape, grid)
    b, c = images.shape[:2]
    _, n, oh, ow, _ = grid.shape
    out = images.new_empty((b, n, c, oh, ow))
    launches += _launch(images, grid, out, images.shape)
    return out


def launch_grad(grad_out: torch.Tensor, grid: torch.Tensor,
                images_shape) -> torch.Tensor:
    """Runs the backward kernels: grad_out (B, N, C, H', W') and the grid
    -> the gradient of the images, (B, C, H, W) float32.

    Every size the wrapper takes (`_check_sizes`: under 2^31 elements a
    tensor, at most 65,535 crops; C at most 6) goes one way: the taps'
    float4 atomics into a channel-last (B, H, W, 4) float32 scratch
    (two float4s a texel above 4 channels), which the wrapper allocates,
    then the scratch written out as (B, C, H, W). No grid or image size
    takes another path."""
    global grad_launches
    _check_sizes(images_shape, grid)
    b, c, ih, iw = images_shape
    _, n, oh, ow, _ = grid.shape
    if (grad_out.shape != (b, n, c, oh, ow) or
            grad_out.dtype != torch.float32 or
            grad_out.device != grid.device):
        raise ValueError(f'grad_out must be float32 {(b, n, c, oh, ow)} on '
                         f'{grid.device}, got {grad_out.dtype} '
                         f'{tuple(grad_out.shape)} on {grad_out.device}')
    if grid.device.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got '
                         f'{grid.device}')
    if not (grad_out.is_contiguous() and grid.is_contiguous()):
        raise ValueError('the warp kernels take contiguous tensors')
    if grad_out.numel() == 0 or b * c * ih * iw == 0:
        return torch.zeros(images_shape, dtype=torch.float32,
                           device=grid.device)
    dimages = torch.empty(images_shape, dtype=torch.float32,
                          device=grid.device)
    scratch = torch.empty((b, ih, iw, 4 * -(-c // 4)), dtype=torch.float32,
                          device=grid.device)
    fn = cuda_build.function(KERNEL, 'warp_backward_f32', GRAD_ARGTYPES)
    err = cuda_build.call(fn, grid, grad_out.data_ptr(), grid.data_ptr(),
                          dimages.data_ptr(), scratch.data_ptr(), b, n, c,
                          ih, iw, oh, ow)
    if err != 0:
        raise RuntimeError(f'warp_backward_f32 launch failed: cudaError '
                           f'{err}')
    grad_launches += 1
    return dimages


class _Warp(torch.autograd.Function):

    @staticmethod
    def forward(ctx, images, grid):
        ctx.save_for_backward(grid)
        ctx.images_shape = tuple(images.shape)
        return launch(images, grid)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[0]:
            return None, None
        grid, = ctx.saved_tensors
        return launch_grad(grad_out.contiguous(), grid,
                           ctx.images_shape), None


def warp_plain(images: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The plain version, on any device: each image repeated per crop,
    then `core.augment._grid_sample_zeros`; differentiated by autograd."""
    b, n, oh, ow, _ = grid.shape
    c = images.shape[1]
    rep = images.repeat_interleave(n, dim=0)
    out = augment._grid_sample_zeros(rep, grid.reshape(b * n, oh, ow, 2))
    return out.reshape(b, n, c, oh, ow)


def grid_sample_zeros(images: torch.Tensor,
                      grid: torch.Tensor) -> torch.Tensor:
    """Bilinear warp of images (B, C, H, W) into crops (B, N, C, H', W')
    at grids (B, N, H', W', 2): zeros padding, align_corners=False,
    float32, differentiable to the images."""
    _check(images, grid)
    if images.device.type == 'cpu':
        return warp_plain(images, grid)
    return _Warp.apply(images.contiguous(), grid.contiguous())
