#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`nerf_from_image_tpu_torch`) on one card.

Drives the port's main path, the flagship render forward, at bench.py's
operating point: the full-width generator (latent 512, 256^2 triplanes of
32 channels, 10 attention values) with random weights from a seed,
batch 8, 128x128 rays, 64 coarse + 64 fine samples, camera at z = 2.0,
focal 1.2, bfloat16 activations. Phases, each printed as one JSON line:

  device   the card, its power limit, the precision settings
  build    nvcc builds every kernel of the path
  kernel   each kernel against its plain PyTorch version on the points of
           one flagship coarse pass; its time, bound and library yardstick
  model    the full-width generator is built
  slice    map -> synthesize -> render through the kernels (launch counts
           reset just before and read just after), output checks, the same
           render with the plain sampler, ms per render and rays/s
  profile  the two stages (map + synthesize, render) timed with CUDA
           events; one forward traced with torch.profiler: device busy
           time, its idle share of the traced wall time, costliest kernels

Then a line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
Any failure raises and the script exits non-zero; without CUDA it exits
non-zero before any result.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from nerf_from_image_tpu_torch.core import rays as rays_lib
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.ops import cuda_build
from nerf_from_image_tpu_torch.ops import triplane
from nerf_from_image_tpu_torch.ops import triplane_cuda
from nerf_from_image_tpu_torch.render.renderer import normalize, render

# bench.py's operating point.
BATCH = 8
RES = 128
SAMPLES = 64
SCENE_RANGE = 0.55
FOCAL = 1.2
CAM_DIST = 2.0
GEN_KWARGS = dict(latent_dim=512, scene_range=SCENE_RANGE,
                  attention_values=10, img_resolution=256,
                  channel_base=32768, channel_max=512)

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores

# Kernel against plain version: both sum the same bf16 texels in float32;
# they differ only in the order of the 12-tap sum and in where the one
# rounding to bf16 lands, i.e. at most one bf16 ulp (2^-8 relative).
KERNEL_ATOL = KERNEL_RTOL = 1e-2
# Render with the kernel against the same render with the plain sampler:
# the bf16 feature differences above move the decoded sigma slightly,
# which moves the coarse weights, the PDF fine depths and the composite
# a little further; 2e-2 on rgb and mask in [0, 1] leaves room for that
# and still fails on any wrong texel, plane or axis.
RENDER_ATOL = 2e-2

TRIPLANE_TPU_KERNEL = 'nerf_from_image_tpu/ops/pallas/triplane_window.py:282'
TRIPLANE_SOURCE = 'nerf_from_image_tpu_torch/ops/csrc/triplane_sample.cu'


def emit(phase: str, started: float, **fields) -> None:
    fields = {'phase': phase, 'seconds': time.perf_counter() - started,
              **fields}
    print(json.dumps(fields), flush=True)


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of `iters` calls, each between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def camera(device: torch.device):
    cam = torch.eye(4, device=device).repeat(BATCH, 1, 1)
    cam[:, 2, 3] = CAM_DIST
    focal = torch.full((BATCH,), FOCAL, device=device)
    return cam, focal


def coarse_coords(device: torch.device) -> torch.Tensor:
    """Normalized points of one flagship coarse pass, (B, N, 3) float32."""
    cam, focal = camera(device)
    origins, dirs = rays_lib.get_ray_bundle(RES, RES, focal, cam)
    dirs = normalize(dirs)
    near, far = rays_lib.compute_near_far_planes(origins, dirs, SCENE_RANGE)
    points, _ = rays_lib.compute_query_points_from_rays(origins, dirs, near,
                                                        far, SAMPLES)
    return (points.reshape(BATCH, -1, 3) / SCENE_RANGE).contiguous()


def touched_texels(planes_cl: torch.Tensor, coords: torch.Tensor) -> int:
    """Distinct texels the points' 2x2 taps read."""
    b, _, r, _, _ = planes_cl.shape
    seen = torch.zeros(b * 3 * r * r, dtype=torch.bool,
                       device=planes_cl.device)
    for start in range(0, coords.shape[1], 1 << 18):
        rows, _ = triplane.tap_offsets(planes_cl,
                                       coords[:, start:start + (1 << 18)])
        seen[rows.reshape(-1)] = True
    return int(seen.sum())


def device_phase() -> dict:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: CUDA is not available')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    # State both float32 precision switches: float32 matmuls and convs
    # run in full float32 (the render itself runs in bfloat16).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': torch.cuda.device_count()}
    emit('device', started, nvidia_smi=smi_line, torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=False, **device)
    return device


def build_phase() -> None:
    started = time.perf_counter()
    cuda_build.build([triplane_cuda.KERNEL])
    ptxas = [line.strip() for line in
             cuda_build.build_log.get(triplane_cuda.KERNEL, '').splitlines()
             if 'registers' in line or 'spill' in line]
    emit('build', started, nvcc_seconds=cuda_build.build_seconds,
         ptxas=ptxas)


def kernel_phase() -> dict:
    """The triplane kernel against its plain version; returns its row."""
    started = time.perf_counter()
    dev = torch.device('cuda')
    coords = coarse_coords(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    r = GEN_KWARGS['img_resolution']
    planes_cl = torch.randn((BATCH, 3, r, r, triplane_cuda.CHANNELS),
                            generator=gen, device=dev).to(torch.bfloat16)

    out = triplane_cuda.launch(planes_cl, coords)
    torch.cuda.synchronize()
    ref = triplane.sample_triplane_plain(planes_cl, coords)
    err = (out.float() - ref.float()).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    bad = int((err > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()).sum())
    if bad or not torch.isfinite(out).all():
        raise AssertionError(f'triplane kernel disagrees with its plain '
                             f'version at {bad} values (max {max_err})')

    ms = time_cuda(lambda: triplane_cuda.launch(planes_cl, coords), 20)
    plain_ms = time_cuda(
        lambda: triplane.sample_triplane_plain(planes_cl, coords), 5, 1)

    # Yardstick only (the port never calls it): grid_sample on the
    # channel-first planes, border padding, align_corners=True, then the
    # mean over the three planes. grid_sample takes its grid in the
    # planes' dtype, and a bf16 grid rounds the coordinates (a different
    # function), so it runs on the same texels in float32.
    n = coords.shape[1]
    planes_cf = planes_cl.permute(0, 1, 4, 2, 3).reshape(
        BATCH * 3, triplane_cuda.CHANNELS, r, r).float().contiguous()
    grid = torch.stack([coords[..., list(axes)]
                        for axes in triplane.PLANE_AXES], dim=1)
    grid = grid.reshape(BATCH * 3, 1, n, 2)

    def library():
        s = F.grid_sample(planes_cf, grid, mode='bilinear',
                          padding_mode='border', align_corners=True)
        return s.reshape(BATCH, 3, -1, n).mean(dim=1)

    library_ms = time_cuda(library, 10)
    library_err = float((library().transpose(1, 2).float() -
                         ref.float()).abs().max())

    points = coords.shape[0] * n
    texels = touched_texels(planes_cl, coords)
    bytes_moved = (coords.numel() * coords.element_size() +
                   out.numel() * out.element_size() +
                   texels * triplane_cuda.CHANNELS * planes_cl.element_size())
    flops = points * 3 * 4 * triplane_cuda.CHANNELS * 2
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    emit('kernel', started, name=triplane_cuda.KERNEL, points=points,
         max_abs_err=max_err, mean_abs_err=mean_err, atol=KERNEL_ATOL,
         rtol=KERNEL_RTOL, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
         library_max_abs_err=library_err, bytes=bytes_moved,
         touched_texels=texels, flops=flops, bound_ms=bound_ms,
         bytes_ms=bytes_ms, flops_ms=flops_ms)
    return {'name': triplane_cuda.KERNEL, 'route': 'cuda',
            'source': TRIPLANE_SOURCE, 'replaces': TRIPLANE_TPU_KERNEL,
            'launches': None, 'max_abs_err': max_err, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': 'bytes' if bytes_ms >= flops_ms else 'operations',
            'library_ms': library_ms}


def slice_phase(rows: dict):
    started = time.perf_counter()
    gen = Generator(dtype=torch.bfloat16, device='cuda', seed=0,
                    **GEN_KWARGS)
    gen.eval()
    emit('model', started, parameters=sum(p.numel()
                                          for p in gen.parameters()))

    started = time.perf_counter()
    dev = torch.device('cuda')
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (BATCH, GEN_KWARGS['latent_dim'])).astype(np.float32)).to(dev)
    cam, focal = camera(dev)

    @torch.no_grad()
    def forward(sampler):
        ws = gen.map(z)
        state = gen.synthesize(ws)
        return render(lambda pts, req: gen.sample(state, pts, req,
                                                  sampler=sampler),
                      RES, RES, cam, focal, SCENE_RANGE, True, SAMPLES)

    torch.cuda.reset_peak_memory_stats()
    triplane_cuda.launches = 0
    out = forward(triplane_cuda.sample_triplane)
    torch.cuda.synchronize()
    launches = triplane_cuda.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows[triplane_cuda.KERNEL]['launches'] = launches
    if launches != 2:
        raise AssertionError(f'{launches} triplane kernel launches in one '
                             f'render, expected 2 (coarse + fine)')
    for name, value, shape in (('rgb', out.rgb, (BATCH, RES, RES, 3)),
                               ('mask', out.mask, (BATCH, RES, RES)),
                               ('depth', out.depth, (BATCH, RES, RES))):
        if tuple(value.shape) != shape or not torch.isfinite(value).all():
            raise AssertionError(f'{name}: shape {tuple(value.shape)}, '
                                 f'finite {bool(torch.isfinite(value).all())}')
    if int(out.overflow_resid) != 0:
        raise AssertionError('overflow_resid must be 0')
    mask_range = (float(out.mask.min()), float(out.mask.max()))

    plain = forward(triplane.sample_triplane_plain)
    rgb_err = float((out.rgb - plain.rgb).abs().max())
    mask_err = float((out.mask - plain.mask).abs().max())
    if rgb_err > RENDER_ATOL or mask_err > RENDER_ATOL:
        raise AssertionError(f'render with the kernel differs from the '
                             f'plain render: rgb {rgb_err}, mask {mask_err}')

    forward(triplane_cuda.sample_triplane)  # warm-up
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(triplane_cuda.sample_triplane)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    render_s = statistics.median(times)
    emit('slice', started, launches=launches, rgb_max_abs_err=rgb_err,
         mask_max_abs_err=mask_err, atol=RENDER_ATOL, mask_range=mask_range,
         render_ms=render_s * 1e3, render_ms_all=[t * 1e3 for t in times],
         rays_per_s=BATCH * RES * RES / render_s, peak_gb=peak_gb)
    return gen, z, cam, focal


def profile_phase(gen, z, cam, focal) -> None:
    """Device time of one render, by stage and by kernel."""
    from torch.profiler import ProfilerActivity, profile
    started = time.perf_counter()

    @torch.no_grad()
    def synthesize():
        return gen.synthesize(gen.map(z))

    @torch.no_grad()
    def render_state(state):
        return render(lambda pts, req: gen.sample(state, pts, req), RES, RES,
                      cam, focal, SCENE_RANGE, True, SAMPLES)

    state = synthesize()
    stages = {'map + synthesize': time_cuda(synthesize, 5, 1),
              'render': time_cuda(lambda: render_state(state), 5, 1)}

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_state(synthesize())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        (e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and
         e.self_device_time_total > 0),
        key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    emit('profile', started, stage_ms=stages, profiled_wall_ms=wall_ms,
         device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
         kernel_launches=sum(e.count for e in kernels),
         top_kernels=[{'name': e.key[:100], 'count': e.count,
                       'device_ms': e.self_device_time_total / 1e3}
                      for e in kernels[:12]])


def main() -> None:
    started = time.perf_counter()
    device = device_phase()
    build_phase()
    row = kernel_phase()
    rows = {row['name']: row}
    profile_phase(*slice_phase(rows))
    emit('done', started)
    print(json.dumps({'kernels': list(rows.values())}), flush=True)
    print(json.dumps({'ok': True, 'device': device}), flush=True)


if __name__ == '__main__':
    main()
