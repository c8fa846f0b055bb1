#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`nerf_from_image_tpu_torch`) on one card.

Drives the port's paths at full width with random weights from a seed
(latent 512, 256^2 triplanes of 32 channels, 10 attention values,
bfloat16 activations, batch 8, 128x128 rays, 64 coarse + 64 fine
samples):

- the render forward at bench.py's operating point (camera at z = 2.0,
  focal 1.2), through the sampler and, with `fuse_decode`, through the
  fused sample + decoder tail; the same at 512^2 planes (the JAX CLI's
  `--plane_resolution 512`);
- the hybrid-inversion refinement step in the p3d_car geometry (scene
  range 1.4, black background, flipped perspective camera with z0 and
  the pose optimized): render -> VGG LPIPS on the image and 15 random
  affine crops -> backward to the latent and the camera -> Adam ->
  projection, against a target rendered from a second latent and a known
  camera;
- GAN training in p3d_car's configuration: a generator step (render with
  jittered depths from ADA-augmented poses, 4-channel discriminator,
  eikonal/tv/entropy, Adam, EMA) and a discriminator step (ADA on the 2x
  real images, R1, fakes rendered without a graph), against a real batch
  rendered once from a second latent at 256^2;
- the hybrid inversion of one batch in the p3d_car geometry: the
  bootstrap encoder (MiT-B5 SegFormer), host PnP, the initial
  parameters, 30 refinement steps with the checkpoint evaluations at
  steps 0 and 30 (front and novel views, their renders through the fused
  sample + decoder tail), and the consolidated report.

Phases, each printed as one JSON line:

  device     the card, its power limit, the precision settings
  build      nvcc builds every kernel source, all at once, while the host
             C++ compiler builds the PnP solver
  kernel     each kernel (B1, B2, B4, B3 forward, B3 backward, B5a) against
             its plain PyTorch version at the shapes its path gives it; its
             time, bound and library yardstick; B1 and B5a also on a ragged
             N with B = 3 (tiles straddle images), a pile-up of clamped
             points, R = 40 and R = 512, B5a with its special-function
             floor (sfu_ms) and B1's time on its points beside it; B2 also
             on one inversion geometry, a pile-up of clamped points, tile
             boundaries, a ragged N and 512^2 planes, and B3's forward on
             crops outside the image at an odd size; for B1, B2, B3's
             forward and B5a, device time (profiler) beside the time a
             call takes
  model      the full-width generator is built
  slice      map -> synthesize -> render through the kernels (launch counts
             reset just before and read just after), output checks, the same
             render with the plain sampler, ms per render and rays/s; the
             render with fuse_decode (B5a) against the plain render
  r512       the render at 512^2 planes: B1 and B5a against their plain
             versions at its coarse pass (the B6 and B5b rows), the render
             unfused and fused, each against the plain render, and their ms
  inversion  run_inversion through the kernels (counts reset just before
             and read just after), ms per step, the per-step metrics, and
             one step against the same step on the plain sampler and warp
  train      G + D step pairs through the kernels (counts reset just before
             and read just after each step), ms per step and per pair,
             images/s, peak memory, the losses; one G step against the same
             step on the plain sampler; one D step at iteration 1
  pipeline   bootstrap -> PnP -> init -> evaluation -> 30 steps ->
             evaluation -> report, ms per stage, launch counts per stage
             (B5a only in the evaluations, never B1 there; never B5a in the
             steps), the report's numbers and PnP's fallback count
  profile    the render's stages timed with CUDA events; one render, one
             inversion step, one G step and one D step traced with
             torch.profiler: device busy time, its idle share of the traced
             wall time, costliest kernels and costliest operators with
             their input shapes

Then a line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
Any failure raises and the script exits non-zero; without CUDA it exits
non-zero before any result.

    python3 chip_smoke.py
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from nerf_from_image_tpu_torch.core import augment
from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.core import rays as rays_lib
from nerf_from_image_tpu_torch.invert import optimizer as inv
from nerf_from_image_tpu_torch.invert import pipeline
from nerf_from_image_tpu_torch.invert import pnp
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.models.generator import palette_rgb
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.ops import cuda_build
from nerf_from_image_tpu_torch.ops import triplane
from nerf_from_image_tpu_torch.ops import triplane_cuda
from nerf_from_image_tpu_torch.ops import warp
from nerf_from_image_tpu_torch.render.renderer import normalize, render
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import convert

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
BF16_FLOPS = 989e12  # bf16 tensor cores
# Special-function results (exp2, log2, reciprocal) per SM per clock.
SFU_PER_SM_CLOCK = 16

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

# B2 against its plain version, on float32 copies of the same bf16 planes:
# both add the same float32 products, the kernel with atomics in another
# order, so the sums agree to float32 rounding of the largest partial sums;
# 1e-4 of the largest value leaves room for that and fails on any wrong
# tap, weight, plane, axis or clamp.
GRAD_RTOL = 1e-4
# B3 forward: the same float32 formula per pixel (the kernel may fuse a
# multiply-add); the crops are of values in [-1, 1].
WARP_ATOL = 1e-5
# B3 backward: each image pixel sums the float32 products of up to 60
# crop-pixel taps, the kernel with atomics in another order.
WARP_GRAD_RTOL = 1e-5
# B5a (and B5b) against its plain version: the same float32 products of
# the same bf16 values, summed in another order, so a rounding to bf16 (of
# a feature, a hidden unit, a probability or the output) can land one ulp
# apart; two such roundings are 2 x 2^-8 of the largest value.
FUSED_RTOL_OF_MAX = 2e-2
# The render with the fused decode against the plain (unfused) render: the
# fused call keeps the decoder's sums in float32 and rounds d once, where
# the unfused bf16 decoder rounds each layer's output, so sigma and rgb
# move by up to two bf16 roundings more than the B1 render does (2e-2).
FUSED_RENDER_ATOL = 3e-2

# The inversion: p3d_car's geometry (nerf_from_image_tpu/config.py:181)
# and the reference's refinement settings.
INV_CFG = inv.InversionConfig(
    resolution=RES, depth_samples_per_ray=SAMPLES, scene_range=1.4,
    white_background=False, camera_flipped=True, loss_type='vgg',
    num_augmentations=15, optimize_pose=True)
INV_STEPS = 5  # steps of the driven run, and timed steps after a warm-up
# One step with the kernels against the same step on the plain sampler and
# warp: B1 and B2 differ from their plain versions by one bf16 rounding of
# a feature or a dplanes texel and by float32 summation order. Those
# differences pass through the bf16 synthesis backward and move the fine
# depths of a few rays, so loss and gradients drift at the level of bf16
# noise, far below what a wrong tap, plane, axis or sign gives (order 1).
STEP_LOSS_RTOL = 1e-2  # |loss_k - loss_p| / |loss_p|
STEP_GRAD_RTOL = 5e-2  # ||g_k - g_p|| / ||g_p||, for z and R

# The hybrid inversion of one batch (nerf_from_image_tpu/cli/inversion.py):
# checkpoint steps 0 and 30, PnP over the percentiles of the focals, the
# encoder's w over every slot.
PIPELINE_STEPS = 30
# The random encoder's coordinate head is rescaled to this spread about
# the origin and its mask logit shifted so that as many pixels pass PnP's
# cut as the targets have foreground, from one forward on the targets:
# with a head drawn at random, the coordinates fall anywhere and the mask
# under the cut, so every image takes the dummy pose, which faces away
# from the box, and all the batch's rays miss it (non-finite depths, in
# the JAX package too). The dummy pose is checked separately on a zeroed
# mask.
COORD_SPREAD = 0.5
PNP_MASK_CUT = 0.9  # invert/pnp.estimate_poses_batch keeps mask > 0.9
PERM_BBOX = ((-0.9, -0.9), (1.8, 1.8))  # the novel views' crop

# GAN training: p3d_car as the JAX CLI builds it
# (nerf_from_image_tpu/config.py:181-186, 224-228), one card's batch of 8.
TRAIN_CFG = gan.GANConfig(
    resolution=RES, latent_dim=512, depth_samples_per_ray=SAMPLES,
    scene_range=1.4, white_background=False, camera_flipped=True,
    supervise_alpha=True, is_highres=True, augment_ada=True,
    augment_p_max=0.8, batch_size=BATCH, attention_values=10,
    plane_resolution=256, channel_base=32768, channel_max=512)
TRAIN_ITERATION = 12500  # past the blur warmup, as all but a run's start
TRAIN_AUGMENT_P = 0.4  # ADA acts on poses and real images
TRAIN_PAIRS = 5  # timed G + D pairs, after one warm-up pair
# Launches per step of each kernel: the G step renders (B1, coarse and
# fine) and backpropagates to the planes only (B4); the D step renders its
# fakes without a graph (B1). No coordinate carries a gradient (no B2), and
# the ADA warp is plain PyTorch (no B3).
G_STEP_LAUNCHES = {'triplane_sample': 2, 'triplane_sample_grad': 0,
                   'triplane_sample_grad_planes': 2, 'warp_forward': 0,
                   'warp_backward': 0, 'triplane_sample_fused': 0}
D_STEP_LAUNCHES = dict(G_STEP_LAUNCHES, triplane_sample_grad_planes=0)

TRIPLANE_TPU_KERNEL = 'nerf_from_image_tpu/ops/pallas/triplane_window.py:282'
TRIPLANE_SOURCE = 'nerf_from_image_tpu_torch/ops/csrc/triplane_sample.cu'
GRAD_TPU_KERNEL = 'nerf_from_image_tpu/ops/pallas/triplane_window.py:305'
GRAD_SOURCE = 'nerf_from_image_tpu_torch/ops/csrc/triplane_sample_grad.cu'
GRAD_PLANES_TPU_KERNEL = (
    'nerf_from_image_tpu/ops/pallas/triplane_window.py:476')
GRAD_PLANES_SOURCE = (
    'nerf_from_image_tpu_torch/ops/csrc/triplane_sample_grad_planes.cu')
WARP_TPU_KERNEL = 'nerf_from_image_tpu/ops/pallas/warp.py:73'
WARP_SOURCE = 'nerf_from_image_tpu_torch/ops/csrc/warp.cu'
FUSED_TPU_KERNEL = 'nerf_from_image_tpu/ops/pallas/triplane_window.py:292'
FUSED_SOURCE = 'nerf_from_image_tpu_torch/ops/csrc/triplane_sample_fused.cu'
WINDOW_FUSED_TPU_KERNEL = (
    'nerf_from_image_tpu/ops/pallas/triplane_window.py:600')
WINDOW_TPU_KERNEL = 'nerf_from_image_tpu/ops/pallas/triplane_window.py:656'
R512 = 512  # the second plane resolution


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


def device_ms(fn, iters: int = 10) -> dict:
    """Device-only ms of one call of `fn`, two ways: the summed duration of
    every kernel and memset that `iters` calls ran, from a torch.profiler
    trace ('trace'); and CUDA events around 100 back-to-back calls, over
    100 ('back_to_back'), which equals the device time only where the host
    enqueues faster than the device runs."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    traced = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(100):
        fn()
    end.record()
    end.synchronize()
    return {'trace': traced / 1e3 / iters if traced > 0 else None,
            'back_to_back': start.elapsed_time(end) / 100}


def camera(device: torch.device):
    cam = torch.eye(4, device=device).repeat(BATCH, 1, 1)
    cam[:, 2, 3] = CAM_DIST
    focal = torch.full((BATCH,), FOCAL, device=device)
    return cam, focal


def coarse_coords(device: torch.device, cam=None, focal=None,
                  scene_range: float = SCENE_RANGE) -> torch.Tensor:
    """Normalized points of one coarse pass, (B, N, 3) float32: bench.py's
    camera unless `cam` and `focal` are given."""
    if cam is None:
        cam, focal = camera(device)
    origins, dirs = rays_lib.get_ray_bundle(RES, RES, focal, cam)
    dirs = normalize(dirs)
    near, far = rays_lib.compute_near_far_planes(origins, dirs, scene_range)
    points, _ = rays_lib.compute_query_points_from_rays(origins, dirs, near,
                                                        far, SAMPLES)
    return (points.reshape(cam.shape[0], -1, 3) / scene_range).contiguous()


def inversion_coords(device: torch.device) -> torch.Tensor:
    """The coarse pass of one inversion geometry: p3d_car's box (1.4),
    cameras at random azimuths (`p3d_cameras`)."""
    cam, focal = p3d_cameras(np.random.default_rng(12), BATCH, device)
    return coarse_coords(device, cam, focal, INV_CFG.scene_range)


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
    sources = [triplane_cuda.KERNEL, triplane_cuda.GRAD_KERNEL,
               triplane_cuda.GRAD_PLANES_KERNEL, warp.KERNEL,
               triplane_cuda.FUSED_KERNEL]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pnp_build = pool.submit(pnp.load_library)
        cuda_build.build(sources)
        pnp_build.result()
    pnp_seconds = time.perf_counter() - started
    # Each kernel's entry, registers, shared memory and spills.
    ptxas = {name: [line.strip() for line in
                    cuda_build.build_log.get(name, '').splitlines()
                    if any(key in line for key in
                           ('entry function', 'registers', 'spill'))]
             for name in sources}
    emit('build', started, nvcc_seconds=cuda_build.build_seconds,
         pnp_library=str(pnp.library_path().name),
         pnp_done_seconds=pnp_seconds, ptxas=ptxas)


def bound(bytes_moved: float, flops: float, bf16_flops: float = 0.0
          ) -> dict:
    """The least time for the work: bytes over the memory rate, float32
    operations over the float32 rate, or bf16 products over the bf16
    tensor-core rate, whichever is largest (the three run on separate
    units, which can overlap)."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    f32_ms = flops / F32_FLOPS * 1e3
    bf16_ms = bf16_flops / BF16_FLOPS * 1e3
    flops_ms = max(f32_ms, bf16_ms)
    return {'bytes': bytes_moved, 'flops': flops, 'bf16_flops': bf16_flops,
            'bytes_ms': bytes_ms, 'f32_ms': f32_ms, 'bf16_ms': bf16_ms,
            'flops_ms': flops_ms,
            'bound_ms': max(bytes_ms, flops_ms),
            'bound_by': 'bytes' if bytes_ms >= flops_ms else 'operations'}


def row(name: str, source: str, replaces: str, max_err: float, ms: float,
        plain_ms: float, library_ms: float, b: dict) -> dict:
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': None, 'max_abs_err': max_err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b['bound_ms'],
            'bound_by': b['bound_by'], 'library_ms': library_ms}


def rel_max(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max |a - ref| / max |ref|."""
    return float((a.float() - ref.float()).abs().max() /
                 ref.float().abs().max().clamp_min(1e-30))


def phase_planes() -> torch.Tensor:
    """The kernel phases' planes: seeded N(0, 1) bf16 (B, 3, 256, 256,
    32), the flagship's shape."""
    gen = torch.Generator(device='cuda').manual_seed(1)
    r = GEN_KWARGS['img_resolution']
    return torch.randn((BATCH, 3, r, r, triplane_cuda.CHANNELS),
                       generator=gen, device='cuda').to(torch.bfloat16)


def kernel_phase() -> dict:
    """The triplane kernel against its plain version at the flagship pass
    and at `forward_cases`; returns its row."""
    started = time.perf_counter()
    cases = {what: sampler_case(planes_cl, coords)
             for what, (planes_cl, coords) in forward_cases().items()}
    return sampler_check(phase_planes(), coarse_coords(torch.device('cuda')),
                         triplane_cuda.KERNEL, TRIPLANE_TPU_KERNEL, started,
                         cases)


def pile_up(gen: torch.Generator, b: int, n: int) -> torch.Tensor:
    """(b, n, 3) points, 90% of them outside the box on every axis they
    leave it on, from 1 to 3 box half-widths out, so they clamp onto the
    border texels and the corners; the rest inside."""
    dev = torch.device('cuda')
    u = torch.rand((b, n, 3), generator=gen, device=dev)
    sign = torch.where(torch.rand((b, n, 3), generator=gen, device=dev) <
                       0.5, -1.0, 1.0)
    inside = torch.rand((b, n, 1), generator=gen, device=dev) < 0.1
    return torch.where(inside, u * 2.0 - 1.0, sign * (1.0 + 2.0 * u))


def forward_cases() -> dict:
    """The forward kernels' (B1, B5a) further cases, each (planes, coords)
    from a seed: a ragged N with B = 3, so that the warps' point tiles
    straddle images; a pile-up of points clamped outside the box; R = 40,
    a resolution no tile divides; and R = 512."""
    gen = torch.Generator(device='cuda').manual_seed(8)

    def planes(b, r):
        return torch.randn((b, 3, r, r, triplane_cuda.CHANNELS),
                           generator=gen, device='cuda').to(torch.bfloat16)

    def uniform(b, n):
        return torch.rand((b, n, 3), generator=gen,
                          device='cuda') * 2.4 - 1.2

    r = GEN_KWARGS['img_resolution']
    return {'ragged N': (planes(3, r), uniform(3, 8191)),
            'pile-up': (planes(BATCH, r), pile_up(gen, BATCH, 1 << 20)),
            'R 40': (planes(2, 40), uniform(2, 100003)),
            'R 512': (planes(2, R512), uniform(2, 100003))}


def sampler_case(planes_cl: torch.Tensor, coords: torch.Tensor) -> dict:
    """B1 against its plain version at KERNEL_ATOL and KERNEL_RTOL on one
    of `forward_cases`, timed where it is the pile-up's full pass."""
    out = triplane_cuda.launch(planes_cl, coords)
    torch.cuda.synchronize()
    ref = triplane.sample_triplane_plain(planes_cl, coords)
    err = (out.float() - ref.float()).abs()
    bad = int((err > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()).sum())
    if bad or not torch.isfinite(out).all():
        raise AssertionError(f'triplane kernel disagrees with its plain '
                             f'version at {bad} values of a forward case '
                             f'(B {coords.shape[0]}, N {coords.shape[1]}, '
                             f'R {planes_cl.shape[2]})')
    case = {'batch': coords.shape[0], 'points': coords.shape[1],
            'plane_resolution': planes_cl.shape[2],
            'max_abs_err': float(err.max())}
    if coords.shape[1] >= 1 << 20:
        fn = lambda: triplane_cuda.launch(planes_cl, coords)  # noqa: E731
        case.update(ms=time_cuda(fn, 10), device_ms=device_ms(fn))
    return case


def sampler_check(planes_cl: torch.Tensor, coords: torch.Tensor, name: str,
                  replaces: str, started: float, cases: dict = None) -> dict:
    """B1 against its plain version on these planes and points, its time
    (per call and on the device), bound and `F.grid_sample` yardstick;
    emits a kernel line (with `cases`, if given) and returns its row."""
    r = planes_cl.shape[2]
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
    dev_ms = device_ms(lambda: triplane_cuda.launch(planes_cl, coords))
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
    library_device_ms = device_ms(library, 5)
    library_err = float((library().transpose(1, 2).float() -
                         ref.float()).abs().max())

    points = coords.shape[0] * n
    texels = touched_texels(planes_cl, coords)
    bytes_moved = (coords.numel() * coords.element_size() +
                   out.numel() * out.element_size() +
                   texels * triplane_cuda.CHANNELS * planes_cl.element_size())
    b = bound(bytes_moved, points * 3 * 4 * triplane_cuda.CHANNELS * 2)
    emit('kernel', started, name=name, plane_resolution=r, points=points,
         max_abs_err=max_err, mean_abs_err=mean_err, atol=KERNEL_ATOL,
         rtol=KERNEL_RTOL, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
         library_ms=library_ms, library_device_ms=library_device_ms,
         library_max_abs_err=library_err, touched_texels=texels,
         cases=cases, **b)
    return row(name, TRIPLANE_SOURCE, replaces, max_err, ms, plain_ms,
               library_ms, b)


def max_sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    smi = subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm',
                          '--format=csv,noheader,nounits'],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def sfu_ms(points: int, k: int) -> float:
    """The fused decode's special-function floor: per point one exp2 and
    one log2 for each hidden unit's softplus and one exp2 for each of the
    K logits, at SFU_PER_SM_CLOCK results per SM per clock at the card's
    highest clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops = points * (2 * triplane_cuda.HIDDEN + k)
    return ops / (sms * SFU_PER_SM_CLOCK * max_sm_clock_hz()) * 1e3


def decode_args(gen: Generator, planes_cl: torch.Tensor,
                coords: torch.Tensor, palette: torch.Tensor) -> tuple:
    """`triplane_cuda.launch_fused`'s arguments: these planes and points,
    the generator's decoder weights and this palette, in the kernel's
    types."""
    with torch.no_grad():
        w0, b0, w1, b1 = gen.fused_decode_weights()
        w0, w1 = w0.to(torch.bfloat16).contiguous(), w1.to(
            torch.bfloat16).contiguous()
        b0, b1 = b0.float().contiguous(), b1.float().contiguous()
    palette = palette.to(torch.bfloat16).contiguous()
    return planes_cl, coords, w0, b0, w1, b1, palette


def fused_error(args: tuple, what: str) -> tuple:
    """B5a against its plain version at FUSED_RTOL_OF_MAX of the largest
    value; returns the kernel's output, the largest error and value."""
    out = triplane_cuda.launch_fused(*args)
    torch.cuda.synchronize()
    ref = triplane.sample_triplane_fused_plain(*args)
    max_err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    if max_err > FUSED_RTOL_OF_MAX * scale or not torch.isfinite(out).all():
        raise AssertionError(f'{what} disagrees with its plain version: max '
                             f'{max_err} against {FUSED_RTOL_OF_MAX} x '
                             f'{scale}')
    return out, max_err, scale


def fused_cases(gen: Generator) -> dict:
    """B5a against its plain version at `forward_cases`, with the
    generator's decoder weights and a seeded palette per image; the
    pile-up's full pass timed."""
    palettes = torch.Generator(device='cuda').manual_seed(9)
    cases = {}
    for what, (planes_cl, coords) in forward_cases().items():
        palette = torch.randn(
            (coords.shape[0], triplane_cuda.FUSED_VALUES, 3),
            generator=palettes, device='cuda')
        args = decode_args(gen, planes_cl, coords, palette)
        _, max_err, scale = fused_error(args, f'fused decode ({what})')
        cases[what] = {'batch': coords.shape[0], 'points': coords.shape[1],
                       'plane_resolution': planes_cl.shape[2],
                       'max_abs_err': max_err, 'largest': scale}
        if coords.shape[1] >= 1 << 20:
            fn = lambda: triplane_cuda.launch_fused(*args)  # noqa: E731
            cases[what].update(ms=time_cuda(fn, 10), device_ms=device_ms(fn))
    return cases


def fused_check(planes_cl: torch.Tensor, coords: torch.Tensor,
                gen: Generator, palette: torch.Tensor, name: str,
                replaces: str, started: float, cases: dict = None) -> dict:
    """B5a against its plain version on these planes and points, with the
    generator's decoder weights and this palette: its time (per call and
    on the device), bound, special-function floor, B1's time on the same
    points (the sampling half), and the port's unfused path on the same
    points (B1, then the decoder MLP, the softmax and the palette product)
    as its yardstick; emits a kernel line (with `cases`, if given) and
    returns its row."""
    r = planes_cl.shape[2]
    args = decode_args(gen, planes_cl, coords, palette)
    planes_cl, coords, w0, b0, w1, b1, palette = args
    out, max_err, scale = fused_error(args, name)

    ms = time_cuda(lambda: triplane_cuda.launch_fused(*args), 20)
    dev_ms = device_ms(lambda: triplane_cuda.launch_fused(*args))
    sampling_ms = time_cuda(lambda: triplane_cuda.launch(planes_cl, coords),
                            20)
    plain_ms = time_cuda(lambda: triplane.sample_triplane_fused_plain(*args),
                         3, 1)

    @torch.no_grad()
    def unfused():
        feats = triplane_cuda.launch(planes_cl, coords)
        dec = gen.decoder.mlp(feats.to(gen.dtype))
        probs = torch.softmax(dec['features'], dim=-1)
        rgb = palette_rgb(probs, palette)
        return torch.cat((dec['density_or_distance'], rgb), dim=-1)

    library_ms = time_cuda(unfused, 10)
    library_device_ms = device_ms(unfused, 5)
    library_err = float((unfused().float() - out.float()).abs().max())

    points = coords.shape[0] * coords.shape[1]
    k = palette.shape[1]
    texels = touched_texels(planes_cl, coords)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in (w0, b0, w1, b1, palette))
    bytes_moved = (coords.numel() * 4 + out.numel() * 2 + weight_bytes +
                   texels * triplane_cuda.CHANNELS * 2)
    hidden = triplane_cuda.HIDDEN
    # float32: the 12 bilinear taps of 32 channels (2 each), softplus on
    # the hidden units (4 each), the softmax (3 per entry); bf16 products:
    # the two layers and the palette (2 per multiply-add).
    f32_flops = points * (3 * 4 * triplane_cuda.CHANNELS * 2 + 4 * hidden +
                          3 * k)
    bf16_flops = points * 2 * (triplane_cuda.CHANNELS * hidden +
                               hidden * (1 + k) + k * 3)
    b = bound(bytes_moved, f32_flops, bf16_flops)
    emit('kernel', started, name=name, plane_resolution=r, points=points,
         max_abs_err=max_err, largest=scale, rtol_of_max=FUSED_RTOL_OF_MAX,
         ms=ms, device_ms=dev_ms, sampling_ms=sampling_ms,
         sfu_ms=sfu_ms(points, k), plain_ms=plain_ms, library_ms=library_ms,
         library_device_ms=library_device_ms,
         library='unfused: B1 + decoder.mlp + softmax + palette_rgb',
         library_max_abs_err=library_err, touched_texels=texels, cases=cases,
         **b)
    return row(name, FUSED_SOURCE, replaces, max_err, ms, plain_ms,
               library_ms, b)


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

    def forward(sampler):
        return render_forward(gen, z, cam, focal, sampler)

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
    fused = fused_render_check(gen, z, cam, focal, plain)
    emit('slice', started, launches=launches, rgb_max_abs_err=rgb_err,
         mask_max_abs_err=mask_err, atol=RENDER_ATOL, mask_range=mask_range,
         render_ms=render_s * 1e3, render_ms_all=[t * 1e3 for t in times],
         rays_per_s=BATCH * RES * RES / render_s, peak_gb=peak_gb,
         fused=fused)
    return gen, z, cam, focal


@torch.no_grad()
def render_forward(gen: Generator, z, cam, focal,
                   sampler=triplane_cuda.sample_triplane):
    """map -> synthesize -> render at bench.py's operating point."""
    state = gen.synthesize(gen.map(z))
    return render(lambda pts, req: gen.sample(state, pts, req,
                                              sampler=sampler),
                  RES, RES, cam, focal, SCENE_RANGE, True, SAMPLES)


def timed_renders(gen: Generator, z, cam, focal, repeats: int = 5
                  ) -> list:
    """ms of `repeats` renders after one warm-up, each on the host clock
    between synchronisations."""
    render_forward(gen, z, cam, focal)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_forward(gen, z, cam, focal)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def fused_render_check(gen: Generator, z, cam, focal, plain) -> dict:
    """The render with `fuse_decode` (B5a on every pass, never B1; counts
    reset just before and read just after) against the plain render
    `plain`, and its ms against the unfused render's in turns."""
    fused = gen.fused_view()
    torch.cuda.synchronize()
    reset_counts()
    out = render_forward(fused, z, cam, focal)
    torch.cuda.synchronize()
    launched = counts()
    expect_launches('fused render', launched,
                    **{triplane_cuda.FUSED_KERNEL: 2})
    rgb_err = float((out.rgb - plain.rgb).abs().max())
    mask_err = float((out.mask - plain.mask).abs().max())
    if (rgb_err > FUSED_RENDER_ATOL or mask_err > FUSED_RENDER_ATOL or
            not torch.isfinite(out.rgb).all()):
        raise AssertionError(f'fused render differs from the plain render: '
                             f'rgb {rgb_err}, mask {mask_err}')
    unfused_ms, fused_ms = [], []
    for _ in range(2):  # in turns: unfused, fused, unfused, fused
        unfused_ms += timed_renders(gen, z, cam, focal, 3)
        fused_ms += timed_renders(fused, z, cam, focal, 3)
    return {'launches': launched, 'rgb_max_abs_err': rgb_err,
            'mask_max_abs_err': mask_err, 'atol': FUSED_RENDER_ATOL,
            'render_ms': statistics.median(fused_ms),
            'render_ms_all': fused_ms,
            'unfused_render_ms': statistics.median(unfused_ms),
            'unfused_render_ms_all': unfused_ms}


def fused_kernel_phase(gen: Generator, z) -> dict:
    """B5a at the flagship coarse pass (the B1 phase's planes and points,
    the seeded generator's decoder weights and the palette of its latents)
    and at `fused_cases`; returns its row."""
    started = time.perf_counter()
    with torch.no_grad():
        palette = gen.synthesize(gen.map(z)).attention_values
    cases = fused_cases(gen)
    return fused_check(phase_planes(), coarse_coords(torch.device('cuda')),
                       gen, palette, triplane_cuda.FUSED_KERNEL,
                       FUSED_TPU_KERNEL, started, cases)


def r512_phase(z, cam, focal, rows: dict) -> None:
    """The render at 512^2 planes (the JAX CLI's --plane_resolution 512),
    where JAX's streamed window kernels B6 and B5b take over from B1 and
    B5a: B1 and B5a against their plain versions at its coarse pass (the
    B6 and B5b rows), then the render unfused and fused, each against the
    plain render."""
    started = time.perf_counter()
    gen = Generator(dtype=torch.bfloat16, device='cuda', seed=0,
                    **dict(GEN_KWARGS, img_resolution=R512))
    gen.eval()
    with torch.no_grad():
        state = gen.synthesize(gen.map(z))
    coords = coarse_coords(torch.device('cuda'))
    b6 = sampler_check(state.planes_cl, coords, 'triplane_sample_r512',
                       WINDOW_TPU_KERNEL, started)
    b5b = fused_check(state.planes_cl, coords, gen, state.attention_values,
                      'triplane_sample_fused_r512', WINDOW_FUSED_TPU_KERNEL,
                      started)
    del state, coords
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    reset_counts()
    out = render_forward(gen, z, cam, focal)
    torch.cuda.synchronize()
    launched = counts()
    expect_launches('512 render', launched, **{triplane_cuda.KERNEL: 2})
    plain = render_forward(gen, z, cam, focal,
                           triplane.sample_triplane_plain)
    rgb_err = float((out.rgb - plain.rgb).abs().max())
    mask_err = float((out.mask - plain.mask).abs().max())
    if (rgb_err > RENDER_ATOL or mask_err > RENDER_ATOL or
            not torch.isfinite(out.rgb).all()):
        raise AssertionError(f'512 render with B1 differs from the plain '
                             f'render: rgb {rgb_err}, mask {mask_err}')
    fused = fused_render_check(gen, z, cam, focal, plain)
    b6['launches'] = launched[triplane_cuda.KERNEL]
    b5b['launches'] = fused['launches'][triplane_cuda.FUSED_KERNEL]
    rows[b6['name']] = b6
    rows[b5b['name']] = b5b
    emit('r512', started, plane_resolution=R512, launches=launched,
         rgb_max_abs_err=rgb_err, mask_max_abs_err=mask_err,
         atol=RENDER_ATOL, mask_range=(float(out.mask.min()),
                                       float(out.mask.max())),
         fused=fused)


def trace(fn) -> dict:
    """One call of `fn` under torch.profiler: wall time, device busy time,
    its idle share, the costliest kernels, and the operators whose own
    launches cost the most device time, with their input shapes."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        (e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and
         e.self_device_time_total > 0),
        key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = sorted(
        (e for e in prof.key_averages(group_by_input_shape=True)
         if e.device_type == torch.autograd.DeviceType.CPU and
         e.self_device_time_total > 0),
        key=lambda e: e.self_device_time_total, reverse=True)
    return {'profiled_wall_ms': wall_ms, 'device_busy_ms': busy_ms,
            'idle_share': 1.0 - busy_ms / wall_ms,
            'kernel_launches': sum(e.count for e in kernels),
            'top_kernels': [{'name': e.key[:100], 'count': e.count,
                             'device_ms': e.self_device_time_total / 1e3}
                            for e in kernels[:12]],
            'top_ops': [{'name': e.key, 'shapes': str(e.input_shapes)[:160],
                         'count': e.count,
                         'device_ms': e.self_device_time_total / 1e3}
                        for e in ops[:10]]}


def profile_phase(gen, z, cam, focal, inversion_step, train_steps) -> None:
    """Device time of one render, by stage and by kernel, of one inversion
    step, and of one G step and one D step."""
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
    render_trace = trace(lambda: render_state(synthesize()))
    g_step, d_step = train_steps
    emit('profile', started, stage_ms=stages, **render_trace,
         inversion_step=trace(inversion_step), g_step=trace(g_step),
         d_step=trace(d_step))


def grad_case(what: str, planes_cl: torch.Tensor, coords: torch.Tensor,
              grad_out: torch.Tensor) -> dict:
    """B2 against its plain version (on float32 copies of the same bf16
    texels, so that both give float32 sums) at GRAD_RTOL of the largest
    value; returns the errors."""
    dplanes, dcoords = triplane_cuda.launch_grad_raw(planes_cl, coords,
                                                     grad_out)
    torch.cuda.synchronize()
    ref_planes, ref_coords = triplane.sample_triplane_grad_plain(
        planes_cl.float(), coords, grad_out)
    err_planes = rel_max(dplanes, ref_planes)
    err_coords = rel_max(dcoords, ref_coords)
    max_err = max(float((dplanes - ref_planes).abs().max()),
                  float((dcoords - ref_coords).abs().max()))
    if (err_planes > GRAD_RTOL or err_coords > GRAD_RTOL or
            not torch.isfinite(dplanes).all() or
            not torch.isfinite(dcoords).all()):
        raise AssertionError(f'triplane grad kernel disagrees with its plain '
                             f'version ({what}): dplanes {err_planes}, '
                             f'dcoords {err_coords} (relative to the '
                             f'largest)')
    return {'points': coords.shape[0] * coords.shape[1],
            'plane_resolution': planes_cl.shape[2],
            'dplanes_rel_err': err_planes, 'dcoords_rel_err': err_coords,
            'max_abs_err': max_err}


def grad_cases(gen: torch.Generator) -> dict:
    """B2's further cases, each against its plain version, with the
    per-call and device times of the ones the inversion and its worst
    case give: the coarse pass of one inversion geometry; a pile-up of
    points clamped outside the box; points exactly on 16-texel tile
    boundaries and on the last texel; a ragged N; and 512^2 planes."""
    dev = torch.device('cuda')
    c = triplane_cuda.CHANNELS

    def inputs(coords, r=GEN_KWARGS['img_resolution']):
        b, n = coords.shape[:2]
        planes = torch.randn((b, 3, r, r, c), generator=gen,
                             device=dev).to(torch.bfloat16)
        grad = torch.randn((b, n, c), generator=gen,
                           device=dev).to(torch.bfloat16)
        return planes, coords.contiguous(), grad

    def timed(args):
        fn = lambda: triplane_cuda.launch_grad_raw(*args)  # noqa: E731
        return {'ms': time_cuda(fn, 10), 'device_ms': device_ms(fn)}

    r = GEN_KWARGS['img_resolution']
    pile = pile_up(gen, BATCH, 1 << 20)
    # Every combination of tile boundaries 16k / (R - 1), the last texel
    # (1.0) and the first (-1.0) over the three coordinates.
    ticks = torch.tensor([-1.0 + 2.0 * 16 * k / (r - 1)
                          for k in range(r // 16)] + [1.0], device=dev)
    grid = torch.stack(torch.meshgrid(ticks, ticks, ticks, indexing='ij'),
                       dim=-1).reshape(1, -1, 3)
    boundaries = grid.expand(2, -1, -1)
    ragged = torch.rand((BATCH, 100003, 3), generator=gen,
                        device=dev) * 2.4 - 1.2

    cases = {}
    args = inputs(inversion_coords(dev))
    cases['inversion geometry'] = {**grad_case('inversion geometry', *args),
                                   **timed(args)}
    args = inputs(pile)
    cases['pile-up'] = {**grad_case('pile-up', *args), **timed(args)}
    del args
    cases['tile boundaries'] = grad_case('tile boundaries',
                                         *inputs(boundaries))
    cases['ragged N'] = grad_case('ragged N', *inputs(ragged))
    args = inputs(coarse_coords(dev), R512)
    cases['512 planes'] = {**grad_case('512 planes', *args), **timed(args)}
    return cases


def triplane_grad_phase() -> dict:
    """B2 against its plain version on the points of one flagship coarse
    pass, then on the further cases of `grad_cases`; returns its row."""
    started = time.perf_counter()
    dev = torch.device('cuda')
    coords = coarse_coords(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    r = GEN_KWARGS['img_resolution']
    c = triplane_cuda.CHANNELS
    planes_cl = torch.randn((BATCH, 3, r, r, c), generator=gen,
                            device=dev).to(torch.bfloat16)
    grad_out = torch.randn((BATCH, coords.shape[1], c), generator=gen,
                           device=dev).to(torch.bfloat16)

    bench = grad_case('coarse pass', planes_cl, coords, grad_out)
    err_planes, err_coords = bench['dplanes_rel_err'], bench['dcoords_rel_err']
    max_err = bench['max_abs_err']

    def call():
        return triplane_cuda.launch_grad_raw(planes_cl, coords, grad_out)

    ms = time_cuda(call, 10)
    dev_ms = device_ms(call)
    plain_ms = time_cuda(lambda: triplane.sample_triplane_grad_plain(
        planes_cl, coords, grad_out), 3, 1)

    # Yardstick only: the backward of F.grid_sample (border,
    # align_corners=True) to the float32 planes and the grid, the same
    # texels, with the mean over the three planes.
    n = coords.shape[1]
    planes_cf = planes_cl.permute(0, 1, 4, 2, 3).reshape(
        BATCH * 3, c, r, r).float().contiguous().requires_grad_()
    grid = torch.stack([coords[..., list(axes)]
                        for axes in triplane.PLANE_AXES], dim=1)
    grid = grid.reshape(BATCH * 3, 1, n, 2).requires_grad_()
    feats = F.grid_sample(planes_cf, grid, mode='bilinear',
                          padding_mode='border', align_corners=True)
    feats = feats.reshape(BATCH, 3, c, n).mean(dim=1)
    cotangent = grad_out.float().transpose(1, 2)

    def library():
        return torch.autograd.grad(feats, (planes_cf, grid), cotangent,
                                   retain_graph=True)

    library_ms = time_cuda(library, 5)
    library_device_ms = device_ms(library, 3)
    del feats, planes_cf, grid, cotangent

    points = BATCH * n
    texels = touched_texels(planes_cl, coords)
    dplanes_bytes = planes_cl.numel() * 4
    bytes_moved = (coords.numel() * 4 + grad_out.numel() * 2 +
                   texels * c * 2 + dplanes_bytes + coords.numel() * 4)
    # Per point, plane and channel: 4 weighted cotangents added (8), two
    # tap differences blended and scaled per axis (10), times g and summed
    # (4).
    flops = points * 3 * c * 22
    b = bound(bytes_moved, flops)
    del planes_cl, coords, grad_out
    cases = grad_cases(gen)
    emit('kernel', started, name=triplane_cuda.GRAD_KERNEL, points=points,
         dplanes_rel_err=err_planes, dcoords_rel_err=err_coords,
         max_abs_err=max_err, rtol=GRAD_RTOL, ms=ms, device_ms=dev_ms,
         plain_ms=plain_ms, library_ms=library_ms,
         library_device_ms=library_device_ms, touched_texels=texels,
         chunk=triplane_cuda.GRAD_CHUNK, cases=cases, **b)
    return row(triplane_cuda.GRAD_KERNEL, GRAD_SOURCE, GRAD_TPU_KERNEL,
               max_err, ms, plain_ms, library_ms, b)


def triplane_grad_planes_phase() -> dict:
    """B4 against its plain version and against B2's dplanes, on the points
    and cotangent of the B2 phase; returns its row."""
    started = time.perf_counter()
    dev = torch.device('cuda')
    coords = coarse_coords(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    r = GEN_KWARGS['img_resolution']
    c = triplane_cuda.CHANNELS
    # The B2 phase's draws: the planes (B4 never reads them; B2 does), then
    # the cotangent.
    planes_cl = torch.randn((BATCH, 3, r, r, c), generator=gen,
                            device=dev).to(torch.bfloat16)
    grad_out = torch.randn((BATCH, coords.shape[1], c), generator=gen,
                           device=dev).to(torch.bfloat16)
    shape = tuple(planes_cl.shape)

    dplanes = triplane_cuda.launch_grad_planes(shape, coords, grad_out)
    torch.cuda.synchronize()
    ref = triplane.sample_triplane_grad_planes_plain(shape, coords, grad_out)
    err_plain = rel_max(dplanes, ref)
    max_err = float((dplanes - ref).abs().max())
    del ref
    b2_planes, _ = triplane_cuda.launch_grad_raw(planes_cl, coords, grad_out)
    err_b2 = rel_max(dplanes, b2_planes)
    del b2_planes
    if (err_plain > GRAD_RTOL or err_b2 > GRAD_RTOL or
            not torch.isfinite(dplanes).all()):
        raise AssertionError(f'planes-only grad kernel disagrees: with its '
                             f'plain version {err_plain}, with B2 {err_b2} '
                             f'(relative to the largest)')

    ms = time_cuda(lambda: triplane_cuda.launch_grad_planes(shape, coords,
                                                            grad_out), 10)
    plain_ms = time_cuda(lambda: triplane.sample_triplane_grad_planes_plain(
        shape, coords, grad_out), 3, 1)

    # Yardstick only: the backward of F.grid_sample (border,
    # align_corners=True) to the float32 planes alone, with the mean over
    # the three planes.
    n = coords.shape[1]
    planes_cf = planes_cl.permute(0, 1, 4, 2, 3).reshape(
        BATCH * 3, c, r, r).float().contiguous().requires_grad_()
    grid = torch.stack([coords[..., list(axes)]
                        for axes in triplane.PLANE_AXES], dim=1)
    grid = grid.reshape(BATCH * 3, 1, n, 2)
    feats = F.grid_sample(planes_cf, grid, mode='bilinear',
                          padding_mode='border', align_corners=True)
    feats = feats.reshape(BATCH, 3, c, n).mean(dim=1)
    cotangent = grad_out.float().transpose(1, 2)
    library_ms = time_cuda(lambda: torch.autograd.grad(
        feats, planes_cf, cotangent, retain_graph=True), 5)
    del feats, planes_cf, grid, cotangent

    points = BATCH * n
    # Each input read once (coordinates, cotangent), the float32 dplanes
    # written once; the caller's zero fill is not counted.
    bytes_moved = (coords.numel() * 4 + grad_out.numel() * 2 +
                   dplanes.numel() * 4)
    # Per point, plane and channel: 4 weights times g, 4 adds (16); the
    # weights themselves are per point and plane.
    flops = points * 3 * c * 16
    b = bound(bytes_moved, flops)
    emit('kernel', started, name=triplane_cuda.GRAD_PLANES_KERNEL,
         points=points, plain_rel_err=err_plain, b2_rel_err=err_b2,
         max_abs_err=max_err, rtol=GRAD_RTOL, ms=ms, plain_ms=plain_ms,
         library_ms=library_ms, **b)
    return row(triplane_cuda.GRAD_PLANES_KERNEL, GRAD_PLANES_SOURCE,
               GRAD_PLANES_TPU_KERNEL, max_err, ms, plain_ms, library_ms, b)


def warp_cases(gen: torch.Generator) -> dict:
    """B3 forward against its plain version at WARP_ATOL on crops that
    reach far outside the image (zeros padding), at the inversion's 128^2
    and at 127^2, whose pixel count is not a multiple of 4 (the kernel's
    one-pixel-at-a-time path)."""
    dev = torch.device('cuda')
    n_aug = INV_CFG.num_augmentations
    images = torch.rand((BATCH, 3, RES, RES), generator=gen,
                        device=dev) * 2.0 - 1.0
    count = BATCH * n_aug
    tform = augment.AffineTransform(
        rot=(torch.rand(count, generator=gen, device=dev) * 2 - 1) * math.pi,
        scale=torch.exp2((torch.rand(count, generator=gen, device=dev) * 2 -
                          1)),
        translation=(torch.rand((count, 2), generator=gen, device=dev) * 2 -
                     1) * 1.5)
    cases = {}
    for size in (RES, RES - 1):
        grid = augment.image_warp_grid(tform, size, size).reshape(
            BATCH, n_aug, size, size, 2).contiguous()
        out = warp.launch(images, grid)
        torch.cuda.synchronize()
        ref = warp.warp_plain(images, grid)
        err = float((out - ref).abs().max())
        if err > WARP_ATOL or not torch.isfinite(out).all():
            raise AssertionError(f'warp forward disagrees with its plain '
                                 f'version on crops outside the image at '
                                 f'{size}^2: {err}')
        cases[f'outside {size}'] = {'max_abs_err': err,
                                    'zero_share': float((ref == 0).float()
                                                        .mean())}
    return cases


def warp_phase() -> list:
    """B3 forward and backward against their plain versions at the
    inversion's shapes: 8 images of 3 x 128^2 into 15 crops each. Returns
    their two rows."""
    started = time.perf_counter()
    dev = torch.device('cuda')
    n_aug = INV_CFG.num_augmentations
    gen = torch.Generator(device=dev).manual_seed(3)
    images = torch.rand((BATCH, 3, RES, RES), generator=gen,
                        device=dev) * 2.0 - 1.0
    tform = augment.sample_transform(gen, BATCH * n_aug, 1.0)
    grid = augment.image_warp_grid(tform, RES, RES).reshape(
        BATCH, n_aug, RES, RES, 2).contiguous()
    grad_out = torch.randn((BATCH, n_aug, 3, RES, RES), generator=gen,
                           device=dev)

    out = warp.launch(images, grid)
    dimages = warp.launch_grad(grad_out, grid, images.shape)
    torch.cuda.synchronize()
    leaf = images.clone().requires_grad_()
    plain_out = warp.warp_plain(leaf, grid)
    plain_dimages, = torch.autograd.grad(plain_out, leaf, grad_out,
                                         retain_graph=True)
    fwd_err = float((out - plain_out.detach()).abs().max())
    bwd_err = float((dimages - plain_dimages).abs().max())
    bwd_rel = rel_max(dimages, plain_dimages)
    if fwd_err > WARP_ATOL or bwd_rel > WARP_GRAD_RTOL:
        raise AssertionError(f'warp kernels disagree with their plain '
                             f'version: forward {fwd_err}, backward '
                             f'{bwd_rel} (relative to the largest)')

    ms = time_cuda(lambda: warp.launch(images, grid), 20)
    dev_ms = device_ms(lambda: warp.launch(images, grid), 20)
    grad_ms = time_cuda(lambda: warp.launch_grad(grad_out, grid,
                                                 images.shape), 20)
    plain_ms = time_cuda(lambda: warp.warp_plain(images, grid), 10)
    plain_grad_ms = time_cuda(lambda: torch.autograd.grad(
        plain_out, leaf, grad_out, retain_graph=True), 10)

    # Yardsticks only: F.grid_sample (zeros, align_corners=False) on the
    # images repeated per crop, and its backward to the images.
    rep = images.repeat_interleave(n_aug, dim=0).requires_grad_()
    flat_grid = grid.reshape(BATCH * n_aug, RES, RES, 2)

    def library():
        return F.grid_sample(rep, flat_grid, mode='bilinear',
                             padding_mode='zeros', align_corners=False)

    library_ms = time_cuda(library, 20)
    library_device_ms = device_ms(library, 20)
    lib_out = library()
    lib_cot = grad_out.reshape(BATCH * n_aug, 3, RES, RES)
    library_grad_ms = time_cuda(lambda: torch.autograd.grad(
        lib_out, rep, lib_cot, retain_graph=True), 20)

    pixels = BATCH * n_aug * RES * RES
    img_bytes = images.numel() * 4
    crop_bytes = out.numel() * 4
    grid_bytes = grid.numel() * 4
    # Per crop pixel: the tap coordinates and weights (about 20), then 4
    # multiply-adds per channel.
    flops = pixels * (20 + 3 * 8)
    fwd_b = bound(img_bytes + grid_bytes + crop_bytes, flops)
    bwd_b = bound(crop_bytes + grid_bytes + img_bytes, flops)
    cases = warp_cases(gen)
    emit('kernel', started, name='warp_forward', pixels=pixels,
         max_abs_err=fwd_err, atol=WARP_ATOL, ms=ms, device_ms=dev_ms,
         plain_ms=plain_ms, library_ms=library_ms,
         library_device_ms=library_device_ms, cases=cases, **fwd_b)
    emit('kernel', started, name='warp_backward', pixels=pixels,
         max_abs_err=bwd_err, rel_err=bwd_rel, rtol=WARP_GRAD_RTOL,
         ms=grad_ms, plain_ms=plain_grad_ms, library_ms=library_grad_ms,
         **bwd_b)
    return [row('warp_forward', WARP_SOURCE, WARP_TPU_KERNEL, fwd_err, ms,
                plain_ms, library_ms, fwd_b),
            row('warp_backward', WARP_SOURCE, WARP_TPU_KERNEL, bwd_err,
                grad_ms, plain_grad_ms, library_grad_ms, bwd_b)]


def counts() -> dict:
    return {triplane_cuda.KERNEL: triplane_cuda.launches,
            triplane_cuda.GRAD_KERNEL: triplane_cuda.grad_launches,
            triplane_cuda.GRAD_PLANES_KERNEL:
                triplane_cuda.grad_planes_launches,
            'warp_forward': warp.launches,
            'warp_backward': warp.grad_launches,
            triplane_cuda.FUSED_KERNEL: triplane_cuda.fused_launches}


def reset_counts() -> None:
    triplane_cuda.launches = triplane_cuda.grad_launches = 0
    triplane_cuda.grad_planes_launches = triplane_cuda.fused_launches = 0
    warp.launches = warp.grad_launches = 0


def expect_launches(what: str, launched: dict, **want) -> None:
    """Every count named in `want` equals it (an int) or, for True, is
    above 0; every other count is 0."""
    for name, count in launched.items():
        expected = want.get(name, 0)
        ok = count > 0 if expected is True else count == expected
        if not ok:
            raise AssertionError(f'{what}: launches {launched}, expected '
                                 f'{want} and 0 for the others')


def inversion_problem(gen: Generator):
    """The target (rendered from a second latent and a known camera) and
    the initial parameters (a third latent, the camera perturbed)."""
    dev = torch.device('cuda')
    rng = np.random.default_rng(2)
    gain = INV_CFG.lr_gain_z

    def latent():
        z = torch.from_numpy(rng.standard_normal(
            (BATCH, GEN_KWARGS['latent_dim'])).astype(np.float32)).to(dev)
        with torch.no_grad():
            return gen.map(z) / gain

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    quat = rng.standard_normal((BATCH, 4)) * 0.3 + [1.0, 0.0, 0.0, 0.0]
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    target_params = inv.InversionParams(
        z=latent(), R=tensor(quat), s=tensor(np.ones(BATCH)),
        t2=tensor(rng.uniform(-0.05, 0.05, (BATCH, 2))),
        z0=tensor(np.full(BATCH, np.log(2.0))))
    with torch.no_grad():
        out, cam, _ = inv.render_from_params(gen, target_params, INV_CFG)
    quat_init = quat + rng.standard_normal((BATCH, 4)) * 0.05
    init = inv.InversionParams(
        z=latent(), R=tensor(quat_init / np.linalg.norm(
            quat_init, axis=-1, keepdims=True)),
        s=target_params.s * 1.05, t2=target_params.t2 + 0.02,
        z0=target_params.z0 + 0.1)
    return out.rgb, out.mask, cam, init


def inversion_stages(gen, lpips, init, target, tform, repeats: int = 3
                     ) -> dict:
    """Median ms of a step's stages, each between CUDA events: the render
    forward, the loss forward (render, crops, LPIPS), the backward, and
    Adam with the projection."""
    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    params = init.copy(requires_grad=True)
    optimizer = inv.make_optimizer(params, INV_CFG)
    tensors = [t for _, t in params.named()]
    times = {'render forward': [], 'loss forward': [], 'backward': [],
             'adam + project': []}
    for _ in range(repeats):
        times['render forward'].append(timed(
            lambda: inv.render_from_params(gen, params, INV_CFG))[1])
        (loss, _), ms = timed(lambda: inv.inversion_loss(
            gen, lpips, params, target, INV_CFG, tform=tform))
        times['loss forward'].append(ms)
        grads, ms = timed(lambda: torch.autograd.grad(loss, tensors))
        times['backward'].append(ms)
        for t, g in zip(tensors, grads):
            t.grad = g
        times['adam + project'].append(timed(
            lambda: (optimizer.step(), inv.project(params)))[1])
    return {k: statistics.median(v) for k, v in times.items()}


def inversion_models():
    """The inversion's full-width generator (p3d_car's box) and VGG
    LPIPS, both from seeds."""
    gen = Generator(dtype=torch.bfloat16, device='cuda', seed=0,
                    **dict(GEN_KWARGS, scene_range=INV_CFG.scene_range))
    gen.eval()
    lpips = LPIPS(device='cuda').eval()
    convert.load_lpips_state_dicts(lpips,
                                   *convert.random_lpips_state_dicts(0))
    return gen, lpips


def inversion_phase(rows: dict, gen: Generator, lpips: LPIPS):
    started = time.perf_counter()
    target, target_mask, gt_cam, init = inversion_problem(gen)
    dev = target.device

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    params, metrics = inv.run_inversion(
        gen, lpips, init, target, INV_CFG, INV_STEPS,
        generator=torch.Generator(device=dev).manual_seed(4),
        gt_cam2world=gt_cam)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # The camera carries a gradient, so the render's backward is B2 and
    # never the planes-only B4.
    if launches.pop(triplane_cuda.GRAD_PLANES_KERNEL) != 0:
        raise AssertionError('the inversion run launched the planes-only '
                             'backward B4')
    if launches.pop(triplane_cuda.FUSED_KERNEL) != 0:
        raise AssertionError('the inversion run launched the fused decode '
                             'B5a')
    for name, count in launches.items():
        rows[name]['launches' if name != triplane_cuda.KERNEL else
                   'inversion_launches'] = count
        if count == 0:
            raise AssertionError(f'kernel {name} was not launched by the '
                                 f'inversion run')
    metrics = {k: v.float().cpu().tolist() for k, v in metrics.items()}
    for key in ('loss', 'grad_norm_z', 'grad_norm_R'):
        if not all(np.isfinite(metrics[key])):
            raise AssertionError(f'{key} not finite: {metrics[key]}')
    for key in ('grad_norm_z', 'grad_norm_R'):
        if not all(v > 0 for v in metrics[key]):
            raise AssertionError(f'{key} has a zero: {metrics[key]}')
    if not all(torch.isfinite(t).all() for _, t in params.named()):
        raise AssertionError('the final parameters are not finite')

    # ms per step: the step that run_inversion runs, one warm-up, then
    # each step on the host clock between synchronisations.
    step_params = init.copy(requires_grad=True)
    optimizer = inv.make_optimizer(step_params, INV_CFG)
    step = inv.make_inversion_step(gen, lpips, INV_CFG, gt_cam)
    step_gen = torch.Generator(device=dev).manual_seed(5)
    times = []
    for _ in range(INV_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(step_params, optimizer, target, step_gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times[1:])

    # The timed step (kernels) against the same step built on the plain
    # sampler and warp, from the same parameters and crops: the loss and
    # the gradients of z and R that the step hands to Adam.
    tform = augment.sample_transform(
        torch.Generator(device=dev).manual_seed(6),
        BATCH * INV_CFG.num_augmentations, 1.0)
    plain_step = inv.make_inversion_step(gen, lpips, INV_CFG, gt_cam,
                                         sampler=triplane.plain_sampler,
                                         warp=warp.warp_plain)

    def loss_and_grads(step_fn):
        p = init.copy(requires_grad=True)
        m = step_fn(p, inv.make_optimizer(p, INV_CFG), target, tform=tform)
        return float(m['loss']), p.z.grad, p.R.grad

    k_loss, k_gz, k_gr = loss_and_grads(step)
    p_loss, p_gz, p_gr = loss_and_grads(plain_step)
    loss_err = abs(k_loss - p_loss) / abs(p_loss)
    gz_err = float((k_gz - p_gz).norm() / p_gz.norm())
    gr_err = float((k_gr - p_gr).norm() / p_gr.norm())
    if (loss_err > STEP_LOSS_RTOL or gz_err > STEP_GRAD_RTOL or
            gr_err > STEP_GRAD_RTOL):
        raise AssertionError(f'step with the kernels differs from the plain '
                             f'step: loss {loss_err}, grad z {gz_err}, '
                             f'grad R {gr_err}')
    stage_ms = inversion_stages(gen, lpips, init, target, tform)
    emit('inversion', started, config=dataclasses.asdict(INV_CFG),
         steps=INV_STEPS, run_s=run_s,
         launches={k: v for k, v in launches.items()},
         launches_per_step={k: v / INV_STEPS for k, v in launches.items()},
         metrics=metrics, step_ms=step_ms, step_ms_all=times,
         stage_ms=stage_ms, peak_gb=peak_gb,
         target_mask_range=(float(target_mask.min()),
                            float(target_mask.max())),
         plain_check={'batch': BATCH, 'loss_kernels': k_loss,
                      'loss_plain': p_loss, 'loss_rel_err': loss_err,
                      'grad_z_rel_err': gz_err, 'grad_R_rel_err': gr_err,
                      'loss_rtol': STEP_LOSS_RTOL,
                      'grad_rtol': STEP_GRAD_RTOL})
    return lambda: step(step_params, optimizer, target, step_gen)


def p3d_cameras(rng: np.random.Generator, b: int, dev: torch.device):
    """Cameras of the inversion phase's form (flipped, focal 1.5, s = 1, a
    small t2) at random azimuths about the vertical axis, slightly tilted.
    Returns (cam2world (B, 4, 4), focal (B,))."""
    theta = rng.uniform(-np.pi, np.pi, b)
    quat = np.stack((np.cos(theta / 2), np.zeros(b), np.sin(theta / 2),
                     np.zeros(b)), axis=-1)
    quat = quat + rng.standard_normal((b, 4)) * 0.05
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return pose_lib.pose_to_matrix(
        tensor(np.full(b, np.log(2.0))), tensor(rng.uniform(-0.05, 0.05,
                                                            (b, 2))),
        tensor(np.ones(b)), tensor(quat), True)


def train_phase(rows: dict):
    """G + D pairs at full width in p3d_car's configuration; returns a G
    step and a D step to trace."""
    started = time.perf_counter()
    dev = torch.device('cuda')
    cfg = TRAIN_CFG
    state = gan.init_train_state(cfg, dtype=torch.bfloat16, device=dev,
                                 seed=0)
    state.iteration = TRAIN_ITERATION
    state.augment_p = TRAIN_AUGMENT_P
    for opt in (state.opt_g, state.opt_d):  # past the lr warmup
        opt.param_groups[0]['count'] = TRAIN_ITERATION // 2
    rng = np.random.default_rng(7)

    def batch():
        cam, focal = p3d_cameras(rng, BATCH, dev)
        z = torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.latent_dim)).astype(np.float32)).to(dev)
        return {'z': z, 'pose': cam, 'focal': focal}

    # The real batch: a second latent rendered once at 256^2 without a
    # graph (image_highres, the mask as its alpha), and its 2x2 mean.
    with torch.no_grad():
        source = batch()
        st = state.gen.synthesize(state.gen.map(source['z']))
        out = render(lambda pts, req: state.gen.sample(st, pts, req),
                     2 * RES, 2 * RES, source['pose'], source['focal'],
                     cfg.scene_range, cfg.white_background, SAMPLES)
        hi = torch.cat((out.rgb, out.mask[..., None]), dim=-1)
        real = {'image_highres': hi,
                'image': hi.reshape(BATCH, RES, 2, RES, 2, 4).mean((2, 4)),
                'pose': source['pose'], 'focal': source['focal']}
        real_mask = (float(out.mask.min()), float(out.mask.max()))
        del st, out, hi
    torch.cuda.empty_cache()

    def timed(fn, want: dict, what: str):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        metrics = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = counts()
        if launched != want:
            raise AssertionError(f'{what}: launches {launched}, expected '
                                 f'{want}')
        return {k: float(v) for k, v in metrics.items()}, ms, launched

    torch.cuda.reset_peak_memory_stats()
    g_ms, d_ms, steps = [], [], []
    for k in range(TRAIN_PAIRS + 1):
        g_batch, fake = batch(), batch()
        g_metrics, gt, g_launched = timed(
            lambda: gan.g_step(state, g_batch, cfg), G_STEP_LAUNCHES,
            'G step')
        d_metrics, dt, d_launched = timed(
            lambda: gan.d_step(state, real, fake, cfg), D_STEP_LAUNCHES,
            'D step')
        steps.append({**g_metrics, **d_metrics})
        if k > 0:  # the first pair is the warm-up
            g_ms.append(gt)
            d_ms.append(dt)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for m in steps:
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f'a step metric is not finite: {m}')
        if m['grad_norm_g'] <= 0 or m['grad_norm_d'] <= 0:
            raise AssertionError(f'a gradient norm is zero: {m}')
    # The launches read in the last timed pair.
    rows[triplane_cuda.GRAD_PLANES_KERNEL]['launches'] = g_launched[
        triplane_cuda.GRAD_PLANES_KERNEL]
    rows[triplane_cuda.KERNEL]['train_launches'] = {
        'g_step': g_launched[triplane_cuda.KERNEL],
        'd_step': d_launched[triplane_cuda.KERNEL]}

    # One G step's loss and gradients through the kernels against the same
    # step on the plain sampler, from the same state and batch with
    # injected draws.
    gen_t = torch.Generator(device=dev).manual_seed(8)
    n = 31  # the regularizers' strata per axis
    fixed = dict(batch(), aug_tform=augment.sample_transform(
        gen_t, BATCH, TRAIN_AUGMENT_P), noise={
            'depth': torch.rand((BATCH, RES, RES, SAMPLES), generator=gen_t,
                                device=dev),
            'pdf_u': torch.rand((BATCH * RES * RES, SAMPLES),
                                generator=gen_t, device=dev),
            'strata': torch.rand((BATCH, n, n, n, 3), generator=gen_t,
                                 device=dev),
            'perturb': torch.randn((BATCH, n ** 3, 3), generator=gen_t,
                                   device=dev)})
    params = list(state.gen.parameters())
    last_layer = getattr(state.gen.synthesis_network,
                         f'b{cfg.plane_resolution}').torgb.weight
    last = [p is last_layer for p in params].index(True)

    def loss_and_grads(sampler):
        loss, _ = gan.generator_loss(state, fixed, cfg, sampler)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads if g is not None]))
        return float(loss.detach()), float(norm), grads[last]

    k_loss, k_norm, k_last = loss_and_grads(triplane_cuda.sample_triplane)
    p_loss, p_norm, p_last = loss_and_grads(triplane.plain_sampler)
    loss_err = abs(k_loss - p_loss) / abs(p_loss)
    norm_err = abs(k_norm - p_norm) / p_norm
    last_err = float((k_last - p_last).norm() / p_last.norm())
    if (loss_err > STEP_LOSS_RTOL or norm_err > STEP_GRAD_RTOL or
            last_err > STEP_GRAD_RTOL):
        raise AssertionError(f'G step with the kernels differs from the '
                             f'plain step: loss {loss_err}, grad norm '
                             f'{norm_err}, last layer {last_err}')

    # One D step at iteration 1: the warmup blur and R1.
    state.iteration = 1
    early = {k: float(v) for k, v in
             gan.d_step(state, real, batch(), cfg).items()}
    if not all(np.isfinite(v) for v in early.values()):
        raise AssertionError(f'D step at iteration 1 not finite: {early}')

    pair_ms = [g + d for g, d in zip(g_ms, d_ms)]
    emit('train', started, config=dataclasses.asdict(cfg),
         iteration=TRAIN_ITERATION, augment_p_start=TRAIN_AUGMENT_P,
         augment_p_end=state.augment_p, pairs=TRAIN_PAIRS,
         g_step_ms=statistics.median(g_ms), d_step_ms=statistics.median(d_ms),
         pair_ms=statistics.median(pair_ms), g_step_ms_all=g_ms,
         d_step_ms_all=d_ms,
         images_per_s=BATCH / (statistics.median(pair_ms) / 1e3),
         peak_gb=peak_gb, g_step_launches=g_launched,
         d_step_launches=d_launched, step_metrics=steps,
         real_mask_range=real_mask,
         plain_check={'loss_kernels': k_loss, 'loss_plain': p_loss,
                      'loss_rel_err': loss_err, 'grad_norm_kernels': k_norm,
                      'grad_norm_plain': p_norm, 'grad_norm_rel_err': norm_err,
                      'last_layer_grad_rel_err': last_err,
                      'loss_rtol': STEP_LOSS_RTOL,
                      'grad_rtol': STEP_GRAD_RTOL},
         d_step_iteration_1=early)

    g_batch, fake = batch(), batch()

    def traced_g():
        state.iteration = TRAIN_ITERATION
        gan.g_step(state, g_batch, cfg)

    def traced_d():
        state.iteration = TRAIN_ITERATION + 1
        gan.d_step(state, real, fake, cfg)

    return traced_g, traced_d


def calibrate_encoder_head(encoder: BootstrapEncoder, images: torch.Tensor,
                           foreground: float) -> None:
    """Rescales the random encoder's coordinate outputs to COORD_SPREAD
    about the origin and shifts its mask logit so that the share
    `foreground` of the pixels passes PNP_MASK_CUT, from one forward on
    `images` (see COORD_SPREAD)."""
    with torch.no_grad():
        coords, mask, _ = encoder(images)
        last = encoder.post[4]
        scale = COORD_SPREAD / coords.std(dim=(0, 1, 2))
        last.weight[:3] *= scale[:, None, None, None]
        last.bias[:3] = (last.bias[:3] - coords.mean(dim=(0, 1, 2))) * scale
        logits = torch.logit(mask.double(), eps=1e-12).flatten()
        cut = math.log(PNP_MASK_CUT / (1.0 - PNP_MASK_CUT))
        last.bias[3] += cut - float(torch.quantile(logits, 1.0 - foreground))


def pipeline_phase(rows: dict, gen: Generator, lpips: LPIPS) -> None:
    """The hybrid inversion of one batch as the JAX CLI runs it
    (nerf_from_image_tpu/cli/inversion.py): bootstrap (MiT-B5 encoder,
    then host PnP), the initial parameters, the evaluation at step 0, 30
    refinement steps, the evaluation at step 30, the report. Targets: a
    second latent rendered from known p3d_car cameras (front view, with
    its mask) and from other cameras with a bbox crop (novel views)."""
    started = time.perf_counter()
    dev = torch.device('cuda')
    cfg = INV_CFG
    rng = np.random.default_rng(9)
    with torch.no_grad():
        ws = gen.map(torch.from_numpy(rng.standard_normal(
            (BATCH, GEN_KWARGS['latent_dim'])).astype(np.float32)).to(dev))
        state = gen.synthesize(ws)

        def field(pts, reqs):
            return gen.sample(state, pts, reqs)

        gt_cam, gt_focal = p3d_cameras(rng, BATCH, dev)
        front = render(field, RES, RES, gt_cam, gt_focal, cfg.scene_range,
                       cfg.white_background, SAMPLES)
        perm_cam, perm_focal = p3d_cameras(rng, BATCH, dev)
        perm_bbox = torch.tensor(PERM_BBOX, device=dev).expand(BATCH, 2, 2)
        novel = render(field, RES, RES, perm_cam, perm_focal,
                       cfg.scene_range, cfg.white_background, SAMPLES,
                       bbox=perm_bbox).rgb
        del state
    target = torch.cat((front.rgb, front.mask[..., None]), dim=-1)
    perm = (perm_cam, perm_focal, None, perm_bbox)

    t0 = time.perf_counter()
    encoder = BootstrapEncoder(GEN_KWARGS['latent_dim'], device=dev).eval()
    encoder.load_state_dict({k: torch.from_numpy(v) for k, v in
                             convert.random_encoder_state_dict(11).items()})
    foreground = float((front.mask > 0.5).float().mean())
    calibrate_encoder_head(encoder, target[..., :3].permute(0, 3, 1, 2),
                           foreground)
    encoder_params = sum(p.numel() for p in encoder.parameters())
    z_avg = gen.average_w(torch.Generator(device=dev).manual_seed(1234))
    focal_guesses = pnp.get_focal_guesses(rng.uniform(1.3, 1.8, 200))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    stage_ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stage_ms[name] = (time.perf_counter() - t) * 1e3
        return out

    reset_counts()
    enc_out = timed('encoder forward',
                    lambda: pipeline.bootstrap_dispatch(encoder, target))
    expect_launches('encoder forward', counts())
    _, mask_np, z_init, cam2world, focal, errors = timed(
        'pnp', lambda: pipeline.bootstrap_finish(
            enc_out, focal_guesses, z_avg, cfg.lr_gain_z))
    fallbacks = int(np.sum(errors == pnp.DUMMY_ERROR))
    # The dummy pose on an empty mask, as the JAX package's PnP takes it.
    dummy = pipeline.bootstrap_finish(
        (enc_out[0], torch.zeros_like(enc_out[1]), enc_out[2]),
        focal_guesses, z_avg, cfg.lr_gain_z)[5]
    if not np.all(dummy == pnp.DUMMY_ERROR):
        raise AssertionError(f'an empty mask did not give the dummy pose: '
                             f'{dummy}')
    params = pipeline.init_inversion_params(z_init, cam2world, focal,
                                            cfg.camera_flipped)

    ctx = pipeline.EvalContext(gen=gen, lpips=lpips, has_mask=True)
    report = pipeline.make_report([0, PIPELINE_STEPS])
    launches = {}

    def evaluate(step, p):
        reset_counts()
        timed(f'evaluation {step}', lambda: pipeline.evaluate_checkpoint(
            ctx, cfg, p, report[step], target, None, None, gt_cam,
            perm_cameras=perm, target_img_random=novel))
        launches[f'evaluation {step}'] = counts()
        expect_launches(f'evaluation {step}', counts(),
                        **{triplane_cuda.FUSED_KERNEL: True})

    evaluate(0, params)
    reset_counts()
    final, metrics = timed(f'{PIPELINE_STEPS} steps', lambda: (
        inv.run_inversion(gen, lpips, params, target[..., :3], cfg,
                          PIPELINE_STEPS,
                          generator=torch.Generator(device=dev).manual_seed(
                              10), gt_cam2world=gt_cam)))
    launches['steps'] = counts()
    expect_launches('refinement steps', counts(),
                    **{triplane_cuda.KERNEL: True,
                       triplane_cuda.GRAD_KERNEL: True,
                       'warp_forward': True, 'warp_backward': True})
    evaluate(PIPELINE_STEPS, final)
    report, report_text = pipeline.consolidate_report(report)

    metrics = {k: v.float().cpu().tolist() for k, v in metrics.items()}
    for key in ('loss', 'psnr', 'lpips', 'rot_error'):
        if not all(np.isfinite(metrics[key])):
            raise AssertionError(f'step {key} not finite: {metrics[key]}')
    averages = {step: {k: v for k, v in entry.items() if k.endswith('_avg')}
                for step, entry in report.items()}
    for step, entry in report.items():
        for key in pipeline.REPORT_SCALARS:
            if not np.all(np.isfinite(entry[key])):
                raise AssertionError(f'report {key} at {step} not finite: '
                                     f'{entry[key]}')
    rows[triplane_cuda.FUSED_KERNEL]['launches'] = launches[
        f'evaluation {PIPELINE_STEPS}'][triplane_cuda.FUSED_KERNEL]
    emit('pipeline', started, config=dataclasses.asdict(cfg),
         steps=PIPELINE_STEPS, encoder_parameters=encoder_params,
         setup_s=setup_s, stage_ms=stage_ms, launches=launches,
         pnp_fallbacks=fallbacks, pnp_errors=errors.tolist(),
         empty_mask_fallbacks=int(np.sum(dummy == pnp.DUMMY_ERROR)),
         target_foreground=foreground,
         mask_pass_share=float((mask_np > PNP_MASK_CUT).mean()),
         step_metrics=metrics, report=averages,
         report_text=report_text.strip().splitlines())


def main() -> None:
    started = time.perf_counter()
    device = device_phase()
    build_phase()
    rows = {}
    for r in [kernel_phase(), triplane_grad_phase(),
              triplane_grad_planes_phase(), *warp_phase()]:
        rows[r['name']] = r
    render_args = slice_phase(rows)
    rows[triplane_cuda.FUSED_KERNEL] = fused_kernel_phase(*render_args[:2])
    r512_phase(*render_args[1:], rows)
    inv_gen, lpips = inversion_models()
    inversion_step = inversion_phase(rows, inv_gen, lpips)
    pipeline_phase(rows, inv_gen, lpips)
    train_steps = train_phase(rows)
    profile_phase(*render_args, inversion_step, train_steps)
    emit('done', started)
    print(json.dumps({'kernels': list(rows.values())}), flush=True)
    print(json.dumps({'ok': True, 'device': device}), flush=True)


if __name__ == '__main__':
    main()
