#!/usr/bin/env python3
"""Times the backward designs that were tried and not kept beside the
kept kernels, on one card, at the same seeded inputs.

    python3 probes/backward_designs.py

Builds `probes/backward_designs.cu` with the port's nvcc flags into
`build/probes/` and loads it with ctypes. Then, for the planes-only
triplane backward (B4) at the flagship coarse pass (bench.py's camera,
8 x 128^2 rays x 64 samples on 256^2 planes), at the coarse pass of
p3d_car training cameras and on a pile-up of points clamped outside the
box, and for the crop-warp backward (B3 bwd) at the inversion's shapes
(8 images of 3 x 128^2 into 15 crops), it holds each design against the
port's plain version (B4 at `chip_smoke.GRAD_RTOL`, B3 at
`chip_smoke.WARP_GRAD_RTOL`, of the largest value) and times it: the
median ms of single calls between CUDA events, the wrapper's allocation
of its output included, and the device ms from a torch.profiler trace.
Prints the card's name and power limit, one JSON line per kernel and
case, and exits non-zero without CUDA or when a design disagrees.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from nerf_from_image_tpu_torch.core import augment  # noqa: E402
from nerf_from_image_tpu_torch.ops import cuda_build  # noqa: E402
from nerf_from_image_tpu_torch.ops import triplane  # noqa: E402
from nerf_from_image_tpu_torch.ops import triplane_cuda  # noqa: E402
from nerf_from_image_tpu_torch.ops import warp  # noqa: E402

SOURCE = ROOT / 'probes' / 'backward_designs.cu'
LIBRARY = ROOT / 'build' / 'probes' / 'libbackward_designs.so'
P, I = ctypes.c_void_p, ctypes.c_int


def build() -> ctypes.CDLL:
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, '-o',
                          str(LIBRARY), str(SOURCE)], capture_output=True,
                         text=True, check=True, timeout=600)
    print(json.dumps({'ptxas': [line.strip() for line in
                                (out.stdout + out.stderr).splitlines()
                                if 'registers' in line or 'spill' in line or
                                'entry function' in line]}), flush=True)
    lib = ctypes.CDLL(str(LIBRARY))
    for name, args in (('probe_grad_planes_unsorted', [P] * 3 + [I] * 3 + [P]),
                       ('probe_warp_backward_plane',
                        [P] * 3 + [I] * 9 + [P])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def stream() -> int:
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def measure(fn, ref: torch.Tensor, rtol: float, what: str) -> dict:
    out = fn()
    torch.cuda.synchronize()
    err = smoke.rel_max(out, ref)
    if err > rtol or not torch.isfinite(out).all():
        raise AssertionError(f'{what} disagrees with the plain version: '
                             f'{err} of the largest value')
    return {'rel_err': err, 'ms': smoke.time_cuda(fn, 10),
            'device_ms': smoke.device_ms(fn)['trace']}


def grad_planes(lib: ctypes.CDLL) -> None:
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(31)
    cam, focal = smoke.p3d_cameras(np.random.default_rng(7), smoke.BATCH, dev)
    cases = {'coarse pass': smoke.coarse_coords(dev),
             'training geometry': smoke.coarse_coords(
                 dev, cam, focal, smoke.TRAIN_CFG.scene_range),
             'pile-up': smoke.pile_up(gen, smoke.BATCH, 1 << 20).contiguous()}
    r = smoke.GEN_KWARGS['img_resolution']
    for what, coords in cases.items():
        b, n = coords.shape[:2]
        shape = (b, 3, r, r, triplane_cuda.CHANNELS)
        grad_out = torch.randn((b, n, triplane_cuda.CHANNELS), generator=gen,
                               device=dev).to(torch.bfloat16)
        ref = triplane.sample_triplane_grad_planes_plain(shape, coords,
                                                         grad_out)

        def probe(name):
            def call():
                dplanes = torch.zeros(shape, dtype=torch.float32, device=dev)
                err = getattr(lib, name)(coords.data_ptr(),
                                         grad_out.data_ptr(),
                                         dplanes.data_ptr(), b, n, r,
                                         stream())
                if err:
                    raise RuntimeError(f'{name}: cudaError {err}')
                return dplanes
            return call

        designs = {
            'kept (binned)': lambda: triplane_cuda.launch_grad_planes(
                shape, coords, grad_out),
            'unsorted float4': probe('probe_grad_planes_unsorted')}
        print(json.dumps({'kernel': 'B4', 'case': what, 'points': b * n, **{
            name: measure(fn, ref, smoke.GRAD_RTOL, f'B4 {name} ({what})')
            for name, fn in designs.items()}}), flush=True)
        del ref, grad_out


def warp_backward(lib: ctypes.CDLL) -> None:
    dev = torch.device('cuda')
    n_aug, res, b = smoke.INV_CFG.num_augmentations, smoke.RES, smoke.BATCH
    gen = torch.Generator(device=dev).manual_seed(3)
    images = torch.rand((b, 3, res, res), generator=gen, device=dev) * 2 - 1
    tform = augment.sample_transform(gen, b * n_aug, 1.0)
    grid = augment.image_warp_grid(tform, res, res).reshape(
        b, n_aug, res, res, 2).contiguous()
    grad_out = torch.randn((b, n_aug, 3, res, res), generator=gen, device=dev)
    leaf = images.clone().requires_grad_()
    ref, = torch.autograd.grad(warp.warp_plain(leaf, grid), leaf, grad_out)

    def probe(name, *extra):
        def call():
            dimages = torch.zeros(images.shape, dtype=torch.float32,
                                  device=dev)
            err = getattr(lib, name)(grad_out.data_ptr(), grid.data_ptr(),
                                     dimages.data_ptr(), b, n_aug, 3, res,
                                     res, res, res, *extra, stream())
            if err:
                raise RuntimeError(f'{name}: cudaError {err}')
            return dimages
        return call

    designs = {'kept (channel-last float4)': lambda: warp.launch_grad(
        grad_out, grid, images.shape)}
    for per_block in (1, 3, 5):
        designs[f'plane a channel, {per_block} crops a block'] = probe(
            'probe_warp_backward_plane', per_block, 0)
        designs[f'image a block, {per_block} crops a block'] = probe(
            'probe_warp_backward_plane', per_block, 1)
    print(json.dumps({'kernel': 'B3 bwd', 'case': 'inversion shapes', **{
        name: measure(fn, ref, smoke.WARP_GRAD_RTOL, f'B3 bwd {name}')
        for name, fn in designs.items()}}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit('backward_designs: CUDA is not available')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    cuda_build.build([triplane_cuda.GRAD_PLANES_KERNEL, warp.KERNEL])
    lib = build()
    grad_planes(lib)
    warp_backward(lib)


if __name__ == '__main__':
    main()
