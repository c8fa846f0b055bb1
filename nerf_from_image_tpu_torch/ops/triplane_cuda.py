"""Triplane sampler entry point: the CUDA kernels on the card, the plain
versions on the CPU.

The forward kernel (`csrc/triplane_sample.cu`) replaces TPU kernel B1,
`_resident_kernel` in `nerf_from_image_tpu/ops/pallas/triplane_window.py`;
the backward kernel (`csrc/triplane_sample_grad.cu`) replaces TPU kernel
B2, `_resident_grad_kernel` in the same file, and gives the gradients of
the planes and of the coordinates; the planes-only backward kernel
(`csrc/triplane_sample_grad_planes.cu`) replaces TPU kernel B4,
`_resident_grad_planes_kernel`, and runs when the coordinates need no
gradient (the GAN train steps, whose poses are data). `sample_triplane`
runs them through one `autograd.Function` (`ops.triplane.TriplaneSample`):
for tensors that lie on the CPU it takes the plain versions
(`ops/triplane.py`); for CUDA tensors it launches the kernels or raises.

`launches`, `grad_launches` and `grad_planes_launches` count kernel
launches, so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from nerf_from_image_tpu_torch.ops import cuda_build
from nerf_from_image_tpu_torch.ops import triplane

KERNEL = 'triplane_sample'
GRAD_KERNEL = 'triplane_sample_grad'
GRAD_PLANES_KERNEL = 'triplane_sample_grad_planes'
CHANNELS = 32

launches = 0
grad_launches = 0
grad_planes_launches = 0


def _function():
    fn = cuda_build.load_library(KERNEL).triplane_sample_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _grad_function():
    fn = cuda_build.load_library(GRAD_KERNEL).triplane_sample_grad_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _grad_planes_function():
    fn = cuda_build.load_library(
        GRAD_PLANES_KERNEL).triplane_sample_grad_planes_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_void_p]
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


def _check_kernel_inputs(planes_cl: torch.Tensor,
                         coords: torch.Tensor) -> None:
    _check(planes_cl, coords)
    if planes_cl.device.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got '
                         f'{planes_cl.device}')
    if planes_cl.dtype != torch.bfloat16:
        raise TypeError(f'the CUDA kernel takes bfloat16 planes, got '
                        f'{planes_cl.dtype}')


def launch(planes_cl: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Runs the forward kernel: (B, 3, R, R, 32) bf16, (B, N, 3) f32 ->
    (B, N, 32) bf16."""
    global launches
    _check_kernel_inputs(planes_cl, coords)
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


def launch_grad_raw(planes_cl: torch.Tensor, coords: torch.Tensor,
                    grad_out: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs the backward kernel: planes (B, 3, R, R, 32) bf16, coords
    (B, N, 3) f32, grad_out (B, N, 32) bf16 -> (dplanes (B, 3, R, R, 32)
    f32, dcoords (B, N, 3) f32)."""
    global grad_launches
    _check(planes_cl, coords)
    b, _, r, _, c = planes_cl.shape
    n = coords.shape[1]
    if (grad_out.shape != (b, n, c) or grad_out.dtype != torch.bfloat16 or
            grad_out.device != planes_cl.device or
            not grad_out.is_contiguous()):
        raise ValueError(f'grad_out must be contiguous bfloat16 {(b, n, c)} '
                         f'on {planes_cl.device}, got {grad_out.dtype} '
                         f'{tuple(grad_out.shape)} on {grad_out.device}')
    _check_kernel_inputs(planes_cl, coords)
    dplanes = torch.zeros(planes_cl.shape, dtype=torch.float32,
                          device=planes_cl.device)
    dcoords = torch.empty((b, n, 3), dtype=torch.float32,
                          device=coords.device)
    if dcoords.numel() == 0:
        dcoords.zero_()
        return dplanes, dcoords
    fn = _grad_function()
    with torch.cuda.device(planes_cl.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(planes_cl.data_ptr(), coords.data_ptr(),
                 grad_out.data_ptr(), dplanes.data_ptr(), dcoords.data_ptr(),
                 b, n, r, stream)
    if err != 0:
        raise RuntimeError(f'{GRAD_KERNEL} launch failed: cudaError {err}')
    grad_launches += 1
    return dplanes, dcoords


def launch_grad(planes_cl: torch.Tensor, coords: torch.Tensor,
                grad_out: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel with the plain backward's signature: dplanes
    cast to the planes' dtype (bf16), as the JAX custom VJP casts its
    float32 accumulators."""
    dplanes, dcoords = launch_grad_raw(planes_cl, coords, grad_out)
    return dplanes.to(planes_cl.dtype), dcoords


def launch_grad_planes(plane_shape: Sequence[int], coords: torch.Tensor,
                       grad_out: torch.Tensor) -> torch.Tensor:
    """Runs the planes-only backward kernel: coords (B, N, 3) f32 and
    grad_out (B, N, 32) bf16 on the card -> dplanes (B, 3, R, R, 32) f32,
    for planes of `plane_shape`. The planes themselves are not read."""
    global grad_planes_launches
    b, three, r, r2, c = plane_shape
    n = coords.shape[1] if coords.ndim == 3 else -1
    if (three != 3 or r != r2 or c != CHANNELS or coords.ndim != 3 or
            coords.shape[0] != b or coords.shape[2] != 3 or
            coords.dtype != torch.float32 or not coords.is_contiguous()):
        raise ValueError(f'planes (B, 3, R, R, {CHANNELS}) and contiguous '
                         f'float32 coords (B, N, 3), got {tuple(plane_shape)}'
                         f' and {coords.dtype} {tuple(coords.shape)}')
    if (grad_out.shape != (b, n, c) or grad_out.dtype != torch.bfloat16 or
            grad_out.device != coords.device or
            not grad_out.is_contiguous()):
        raise ValueError(f'grad_out must be contiguous bfloat16 {(b, n, c)} '
                         f'on {coords.device}, got {grad_out.dtype} '
                         f'{tuple(grad_out.shape)} on {grad_out.device}')
    if coords.device.type != 'cuda':
        raise ValueError(f'the CUDA kernel needs CUDA tensors, got '
                         f'{coords.device}')
    dplanes = torch.zeros(tuple(plane_shape), dtype=torch.float32,
                          device=coords.device)
    if coords.numel() == 0:
        return dplanes
    fn = _grad_planes_function()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(coords.data_ptr(), grad_out.data_ptr(), dplanes.data_ptr(),
                 b, n, r, stream)
    if err != 0:
        raise RuntimeError(f'{GRAD_PLANES_KERNEL} launch failed: cudaError '
                           f'{err}')
    grad_planes_launches += 1
    return dplanes


def sample_triplane(planes_cl: torch.Tensor,
                    coords: torch.Tensor) -> torch.Tensor:
    """Averaged triplane features at normalized coords, differentiable to
    the planes and the coords.

    planes_cl: (B, 3, R, R, 32) channel-last planes; coords: (B, N, 3)
    float32 in [-1, 1]. Returns (B, N, 32) in the planes' dtype. On the
    CPU the planes may be float32 or bfloat16; the kernels take bfloat16.
    The backward runs B4 when only the planes want a gradient, else B2.
    """
    _check(planes_cl, coords)
    if planes_cl.device.type == 'cpu':
        return triplane.plain_sampler(planes_cl, coords)
    return triplane.TriplaneSample.apply(planes_cl, coords, launch,
                                         launch_grad, launch_grad_planes)
