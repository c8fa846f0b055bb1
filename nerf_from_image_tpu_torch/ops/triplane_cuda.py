"""Triplane sampler entry point: the CUDA kernel on the card, the plain
version on the CPU.

The kernel (`csrc/triplane_sample.cu`) replaces TPU kernel B1,
`_resident_kernel` in `nerf_from_image_tpu/ops/pallas/triplane_window.py`.
`sample_triplane` takes the plain version (`ops/triplane.py`) only for
tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises. The kernel is forward-only: its backward is TPU kernel B2
(`_resident_grad_kernel`), which a later slice ports.

`launches` counts kernel launches, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_from_image_tpu_torch.ops import cuda_build
from nerf_from_image_tpu_torch.ops import triplane

KERNEL = 'triplane_sample'
CHANNELS = 32

launches = 0


def _function():
    fn = cuda_build.load_library(KERNEL).triplane_sample_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(planes_cl: torch.Tensor, coords: torch.Tensor) -> None:
    if planes_cl.device != coords.device:
        raise ValueError(f'planes on {planes_cl.device}, coords on '
                         f'{coords.device}')
    if planes_cl.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'planes must be bfloat16 or float32, got '
                        f'{planes_cl.dtype}')
    if coords.dtype != torch.float32:
        raise TypeError(f'coords must be float32, got {coords.dtype}')
    if (planes_cl.ndim != 5 or planes_cl.shape[1] != 3 or
            planes_cl.shape[2] != planes_cl.shape[3] or
            planes_cl.shape[4] != CHANNELS):
        raise ValueError(f'planes must be (B, 3, R, R, {CHANNELS}), got '
                         f'{tuple(planes_cl.shape)}')
    if (coords.ndim != 3 or coords.shape[0] != planes_cl.shape[0] or
            coords.shape[2] != 3):
        raise ValueError(f'coords must be (B, N, 3), got '
                         f'{tuple(coords.shape)}')
    if not (planes_cl.is_contiguous() and coords.is_contiguous()):
        raise ValueError('planes and coords must be contiguous')


def launch(planes_cl: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Runs the CUDA kernel: (B, 3, R, R, 32) bf16, (B, N, 3) f32 ->
    (B, N, 32) bf16."""
    global launches
    _check(planes_cl, coords)
    if planes_cl.device.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got '
                         f'{planes_cl.device}')
    if planes_cl.dtype != torch.bfloat16:
        raise TypeError(f'the CUDA kernel takes bfloat16 planes, got '
                        f'{planes_cl.dtype}')
    b, _, r, _, c = planes_cl.shape
    n = coords.shape[1]
    out = torch.empty((b, n, c), dtype=planes_cl.dtype,
                      device=planes_cl.device)
    if out.numel() == 0:
        return out
    fn = _function()
    with torch.cuda.device(planes_cl.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(planes_cl.data_ptr(), coords.data_ptr(), out.data_ptr(),
                 b, n, r, stream)
    if err != 0:
        raise RuntimeError(f'{KERNEL} launch failed: cudaError {err}')
    launches += 1
    return out


class _TriplaneSample(torch.autograd.Function):

    @staticmethod
    def forward(ctx, planes_cl, coords):
        return launch(planes_cl, coords)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            'the backward of the CUDA triplane sampler is TPU kernel B2 '
            '(_resident_grad_kernel in nerf_from_image_tpu/ops/pallas/'
            'triplane_window.py), not ported yet')


def sample_triplane(planes_cl: torch.Tensor,
                    coords: torch.Tensor) -> torch.Tensor:
    """Averaged triplane features at normalized coords.

    planes_cl: (B, 3, R, R, 32) channel-last planes; coords: (B, N, 3)
    float32 in [-1, 1]. Returns (B, N, 32) in the planes' dtype. On the
    CPU the planes may be float32 or bfloat16; the kernel takes bfloat16.
    """
    if planes_cl.device.type == 'cpu':
        _check(planes_cl, coords)
        return triplane.sample_triplane_plain(planes_cl, coords)
    return _TriplaneSample.apply(planes_cl, coords)
