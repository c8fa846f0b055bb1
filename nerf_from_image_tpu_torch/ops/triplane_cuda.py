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

The fused kernel (`csrc/triplane_sample_fused.cu`) replaces TPU kernels
B5a, `_resident_kernel_fused` with `_decode_tail`, and B5b,
`_window_kernel_fused` (the same function for planes too large for the
TPU's VMEM): the sampler followed by the decoder MLP, the palette softmax
and the palette product, forward only. `sample_triplane_fused` takes its
plain version for CPU tensors and launches it for CUDA tensors. The two
forward kernels share their sampling core (`csrc/triplane_taps.cuh`: four
lanes a point, one 16-byte load a tap), run a persistent grid sized from
the card's SM count, and take 32-bit offsets within one image's planes
(`check_forward_limits`).

`launches`, `grad_launches`, `grad_planes_launches` and `fused_launches`
count kernel launches, so a run can show that its path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from nerf_from_image_tpu_torch.ops import cuda_build
from nerf_from_image_tpu_torch.ops import triplane

KERNEL = 'triplane_sample'
GRAD_KERNEL = 'triplane_sample_grad'
GRAD_PLANES_KERNEL = 'triplane_sample_grad_planes'
FUSED_KERNEL = 'triplane_sample_fused'
CHANNELS = 32
HIDDEN = 64  # the decoder's hidden units
# Palette entries the fused kernel is built for: every reference dataset's.
FUSED_VALUES = 10
# The binned backward (B2): texel tiles of GRAD_TILE^2, bins cut into
# chunks of at most GRAD_CHUNK (point, plane) entries, one block each; the
# histogram keeps one image's 3 * tiles^2 counters in 48 KB of shared
# memory, so R <= GRAD_MAX_TILES * GRAD_TILE.
GRAD_TILE = 16
GRAD_CHUNK = 2048
GRAD_MAX_TILES = 64
MAX_INT32 = 2**31 - 1

launches = 0
grad_launches = 0
grad_planes_launches = 0
fused_launches = 0


_ARGTYPES = {
    (KERNEL, 'triplane_sample_bf16'):
        [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    (GRAD_KERNEL, 'triplane_sample_grad_bf16'):
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    (GRAD_PLANES_KERNEL, 'triplane_sample_grad_planes_bf16'):
        [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_void_p],
    (FUSED_KERNEL, 'triplane_sample_fused_bf16'):
        [ctypes.c_void_p] * 8 + [ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p],
}


def _function(name: str, symbol: str):
    return cuda_build.function(name, symbol, _ARGTYPES[name, symbol])


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


def check_forward_limits(planes_cl: torch.Tensor,
                         coords: torch.Tensor) -> None:
    """Raises where the forward kernels (B1, B5a) would not hold these
    inputs: their texel offsets are 32-bit within one image's three planes
    (3 * R * R * 32 below 2^31), their point indices 32-bit (B * N below
    2^31), and they read the planes with 16-byte loads (a view whose
    storage offset leaves the planes off a 16-byte boundary is refused).
    The outputs are fresh allocations, always aligned."""
    b, _, r, _, c = planes_cl.shape
    if 3 * r * r * c > MAX_INT32:
        raise ValueError(f'the forward kernels take 3 * R * R * {c} below '
                         f'2^31 texel channels an image, got R {r}')
    if b * coords.shape[1] > MAX_INT32:
        raise ValueError(f'the forward kernels take B * N below 2^31 '
                         f'points, got B {b}, N {coords.shape[1]}')
    if planes_cl.data_ptr() % 16:
        raise ValueError('the forward kernels read the planes with 16-byte '
                         'loads: they must start on a 16-byte boundary')


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA card `index`: the forward
    kernels' persistent grids are this many times the blocks an SM holds
    at once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(planes_cl: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Runs the forward kernel: (B, 3, R, R, 32) bf16, (B, N, 3) f32 ->
    (B, N, 32) bf16."""
    global launches
    _check_kernel_inputs(planes_cl, coords)
    check_forward_limits(planes_cl, coords)
    b, _, r, _, c = planes_cl.shape
    n = coords.shape[1]
    out = torch.empty((b, n, c), dtype=planes_cl.dtype,
                      device=planes_cl.device)
    if out.numel() == 0:
        return out
    fn = _function(KERNEL, 'triplane_sample_bf16')
    err = cuda_build.call(fn, planes_cl, planes_cl.data_ptr(),
                          coords.data_ptr(), out.data_ptr(), b, n, r,
                          sm_count(planes_cl.device.index))
    if err != 0:
        raise RuntimeError(f'{KERNEL} launch failed: cudaError {err}')
    launches += 1
    return out


def grad_scratch_sizes(batch: int, n: int, r: int) -> Tuple[int, int]:
    """(bins, most work items) of the binned backward at B = batch, N = n
    and R = r; raises where the kernel's int32 indices or its shared
    histogram would not hold them."""
    tiles = -(-r // GRAD_TILE)
    entries = 3 * batch * n
    planes = batch * 3 * r * r * CHANNELS
    if tiles > GRAD_MAX_TILES:
        raise ValueError(f'the binned backward takes R up to '
                         f'{GRAD_MAX_TILES * GRAD_TILE}, got {r}')
    if max(entries, planes, batch * n * CHANNELS) > MAX_INT32:
        raise ValueError(f'the binned backward takes under 2^31 (point, '
                         f'plane) pairs, texel channels and cotangent '
                         f'values, got B {batch}, N {n}, R {r}')
    bins = batch * 3 * tiles * tiles
    return bins, bins + entries // GRAD_CHUNK + 1


def launch_grad_raw(planes_cl: torch.Tensor, coords: torch.Tensor,
                    grad_out: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs the backward kernels (one count in `grad_launches`; the call
    bins the points, accumulates each bin in shared memory and sums the
    coordinate partials, five CUDA kernels): planes (B, 3, R, R, 32) bf16,
    coords (B, N, 3) f32, grad_out (B, N, 32) bf16 -> (dplanes
    (B, 3, R, R, 32) f32, dcoords (B, N, 3) f32)."""
    global grad_launches
    if planes_cl.ndim == 5 and coords.ndim == 3:
        grad_scratch_sizes(coords.shape[0], coords.shape[1],
                           planes_cl.shape[2])
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
    dev = planes_cl.device
    dplanes = torch.zeros(planes_cl.shape, dtype=torch.float32, device=dev)
    dcoords = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    if dcoords.numel() == 0:
        dcoords.zero_()
        return dplanes, dcoords
    bins, max_work = grad_scratch_sizes(b, n, r)
    partial = torch.empty((3, b * n, 2), dtype=torch.float32, device=dev)
    counts = torch.empty(bins, dtype=torch.int32, device=dev)
    work = torch.empty((max_work, 2), dtype=torch.int32, device=dev)
    work_count = torch.empty(1, dtype=torch.int32, device=dev)
    entries = torch.empty((3 * b * n, 4), dtype=torch.int32, device=dev)
    fn = _function(GRAD_KERNEL, 'triplane_sample_grad_bf16')
    err = cuda_build.call(
        fn, planes_cl, planes_cl.data_ptr(), coords.data_ptr(),
        grad_out.data_ptr(), dplanes.data_ptr(), dcoords.data_ptr(),
        partial.data_ptr(), counts.data_ptr(), work.data_ptr(),
        work_count.data_ptr(), entries.data_ptr(), b, n, r, GRAD_CHUNK,
        max_work)
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
    fn = _function(GRAD_PLANES_KERNEL, 'triplane_sample_grad_planes_bf16')
    err = cuda_build.call(fn, coords, coords.data_ptr(), grad_out.data_ptr(),
                          dplanes.data_ptr(), b, n, r)
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


def _check_decode(planes_cl: torch.Tensor, w0: torch.Tensor,
                  b0: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  palette: torch.Tensor) -> int:
    """Checks the decoder tail's shapes and devices; returns K (>= 1)."""
    b = planes_cl.shape[0]
    k = palette.shape[1] if palette.ndim == 3 else -1
    shapes = ((w0, (CHANNELS, HIDDEN)), (b0, (HIDDEN,)),
              (w1, (HIDDEN, 1 + k)), (b1, (1 + k,)), (palette, (b, k, 3)))
    for t, shape in shapes:
        if tuple(t.shape) != shape or t.device != planes_cl.device:
            raise ValueError(f'decoder tail: expected {shape} on '
                             f'{planes_cl.device}, got {tuple(t.shape)} on '
                             f'{t.device}')
    if k < 1:
        raise ValueError(f'the fused decode needs palette entries, got {k}')
    return k


def launch_fused(planes_cl: torch.Tensor, coords: torch.Tensor,
                 w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """Runs the fused kernel: planes (B, 3, R, R, 32) bf16, coords (B, N, 3)
    f32, w0 (32, 64) bf16, b0 (64,) f32, w1 (64, 11) bf16, b1 (11,) f32,
    palette (B, 10, 3) bf16, all contiguous on the card -> (B, N, 4) bf16,
    [sdf distance | rgb]. The decoder tail's shapes are checked by
    `sample_triplane_fused`, not here."""
    global fused_launches
    k = palette.shape[1]
    if k != FUSED_VALUES:
        raise ValueError(f'the fused kernel is built for {FUSED_VALUES} '
                         f'palette entries, got {k}')
    _check_kernel_inputs(planes_cl, coords)
    check_forward_limits(planes_cl, coords)
    for t, dtype in ((w0, torch.bfloat16), (b0, torch.float32),
                     (w1, torch.bfloat16), (b1, torch.float32),
                     (palette, torch.bfloat16)):
        if t.dtype != dtype or not t.is_contiguous():
            raise TypeError(f'decoder tail: expected contiguous {dtype}, got '
                            f'{t.dtype}')
    b, _, r, _, _ = planes_cl.shape
    n = coords.shape[1]
    out = torch.empty((b, n, 4), dtype=torch.bfloat16,
                      device=planes_cl.device)
    if out.numel() == 0:
        return out
    fn = _function(FUSED_KERNEL, 'triplane_sample_fused_bf16')
    err = cuda_build.call(fn, planes_cl, planes_cl.data_ptr(),
                          coords.data_ptr(), w0.data_ptr(), b0.data_ptr(),
                          w1.data_ptr(), b1.data_ptr(), palette.data_ptr(),
                          out.data_ptr(), b, n, r, k,
                          sm_count(planes_cl.device.index))
    if err != 0:
        raise RuntimeError(f'{FUSED_KERNEL} launch failed: cudaError {err}')
    fused_launches += 1
    return out


def sample_triplane_fused(planes_cl: torch.Tensor, coords: torch.Tensor,
                          w0: torch.Tensor, b0: torch.Tensor,
                          w1: torch.Tensor, b1: torch.Tensor,
                          palette: torch.Tensor) -> torch.Tensor:
    """The sampler fused with the decoder tail, forward only: (B, N, 4)
    bf16, [sdf distance | rgb] (see `triplane.sample_triplane_fused_plain`
    for the function and its roundings).

    The inputs are cast to the kernel's types (bf16 planes, weights and
    palette; float32 biases). For CPU tensors it takes the plain version
    (any K); for CUDA tensors it launches the kernel (K = 10) or raises.
    It has no backward, as the JAX package's fused call has none: it
    raises when autograd would need one.
    """
    _check(planes_cl, coords)
    _check_decode(planes_cl, w0, b0, w1, b1, palette)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (planes_cl, coords, w0, b0, w1, b1,
                                      palette)):
        raise RuntimeError('the fused decode has no backward: run it under '
                           'torch.no_grad(), or sample without fuse_decode')
    planes_cl = planes_cl.to(torch.bfloat16).contiguous()
    w0, w1, palette = (t.to(torch.bfloat16).contiguous()
                       for t in (w0, w1, palette))
    b0, b1 = (t.to(torch.float32).contiguous() for t in (b0, b1))
    if planes_cl.device.type == 'cpu':
        return triplane.sample_triplane_fused_plain(planes_cl, coords, w0, b0,
                                                    w1, b1, palette)
    return launch_fused(planes_cl, coords, w0, b0, w1, b1, palette)
