#!/usr/bin/env python3
"""Two trees of the port on one card, in turns: B2, B3 forward and the
inversion step.

    python3 chip_ab.py PARENT_ROOT CHANGE_ROOT

Each root is a checkout of the repository (for example a `git archive` of
the parent commit unpacked under `build/`). The script runs one process
per turn, in the order parent, change, change, parent; each process
imports the port and `chip_smoke.py` from its own root, builds that
root's kernels, and times, on the same seeded inputs:

- B2 (`triplane_cuda.launch_grad_raw`) at the flagship coarse pass
  (bench.py's camera, 256^2 planes), at the coarse pass of one inversion
  geometry (p3d_car's box, random azimuths) and on a pile-up of points
  clamped outside the box;
- B3 forward (`warp.launch`) at the inversion's 8 images into 15 crops,
  and `F.grid_sample` on the same crops;
- the full-width inversion step (`invert.optimizer.make_inversion_step`,
  as `chip_smoke.py`'s inversion phase builds it), host clock between
  synchronisations.

Kernel times are the median of CUDA-event times around single calls (per
call) and the summed kernel durations of a torch.profiler trace over the
calls (device). Prints the card's name and power limit, one JSON line per
turn and a last summary line; exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time


def device_ms(fn, iters: int = 10) -> float:
    """Summed device time of the kernels that `iters` calls of `fn` ran,
    over iters, from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / iters


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as smoke
    from nerf_from_image_tpu_torch.core import augment
    from nerf_from_image_tpu_torch.core import rays as rays_lib
    from nerf_from_image_tpu_torch.invert import optimizer as inv
    from nerf_from_image_tpu_torch.ops import cuda_build
    from nerf_from_image_tpu_torch.ops import triplane_cuda
    from nerf_from_image_tpu_torch.ops import warp
    from nerf_from_image_tpu_torch.render.renderer import normalize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    cuda_build.build([triplane_cuda.GRAD_KERNEL, warp.KERNEL])
    build_s = time.perf_counter() - t0

    def coarse(cam, focal, scene_range):
        origins, dirs = rays_lib.get_ray_bundle(smoke.RES, smoke.RES, focal,
                                                cam)
        dirs = normalize(dirs)
        near, far = rays_lib.compute_near_far_planes(origins, dirs,
                                                     scene_range)
        points, _ = rays_lib.compute_query_points_from_rays(
            origins, dirs, near, far, smoke.SAMPLES)
        return (points.reshape(cam.shape[0], -1, 3) /
                scene_range).contiguous()

    gen = torch.Generator(device=dev).manual_seed(21)
    b, r, c = smoke.BATCH, smoke.GEN_KWARGS['img_resolution'], 32
    planes = torch.randn((b, 3, r, r, c), generator=gen,
                         device=dev).to(torch.bfloat16)
    cam, focal = smoke.camera(dev)
    inv_cam, inv_focal = smoke.p3d_cameras(np.random.default_rng(12), b, dev)
    n_pile = 1 << 20
    u = torch.rand((b, n_pile, 3), generator=gen, device=dev)
    sign = torch.where(torch.rand((b, n_pile, 3), generator=gen,
                                  device=dev) < 0.5, -1.0, 1.0)
    inside = torch.rand((b, n_pile, 1), generator=gen, device=dev) < 0.1
    cases = {'coarse pass': coarse(cam, focal, smoke.SCENE_RANGE),
             'inversion geometry': coarse(inv_cam, inv_focal,
                                          smoke.INV_CFG.scene_range),
             'pile-up': torch.where(inside, u * 2.0 - 1.0,
                                    sign * (1.0 + 2.0 * u)).contiguous()}
    b2 = {}
    for name, coords in cases.items():
        grad_out = torch.randn((b, coords.shape[1], c), generator=gen,
                               device=dev).to(torch.bfloat16)

        def call():
            return triplane_cuda.launch_grad_raw(planes, coords, grad_out)

        b2[name] = {'ms': smoke.time_cuda(call, 10),
                    'device_ms': device_ms(call)}
        del grad_out

    n_aug = smoke.INV_CFG.num_augmentations
    images = torch.rand((b, 3, smoke.RES, smoke.RES), generator=gen,
                        device=dev) * 2.0 - 1.0
    tform = augment.sample_transform(gen, b * n_aug, 1.0)
    grid = augment.image_warp_grid(tform, smoke.RES, smoke.RES).reshape(
        b, n_aug, smoke.RES, smoke.RES, 2).contiguous()
    rep = images.repeat_interleave(n_aug, dim=0)
    flat_grid = grid.reshape(b * n_aug, smoke.RES, smoke.RES, 2)

    def library():
        return F.grid_sample(rep, flat_grid, mode='bilinear',
                             padding_mode='zeros', align_corners=False)

    def kernel():
        return warp.launch(images, grid)

    b3 = {'ms': smoke.time_cuda(kernel, 50),
          'device_ms': device_ms(kernel, 50),
          'library_ms': smoke.time_cuda(library, 50),
          'library_device_ms': device_ms(library, 50)}

    gen_model, lpips = smoke.inversion_models()
    target, _, gt_cam, init = smoke.inversion_problem(gen_model)
    params = init.copy(requires_grad=True)
    optimizer = inv.make_optimizer(params, smoke.INV_CFG)
    step = inv.make_inversion_step(gen_model, lpips, smoke.INV_CFG, gt_cam)
    step_gen = torch.Generator(device=dev).manual_seed(5)
    times = []
    for _ in range(8):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(params, optimizer, target, step_gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return {'root': root, 'build_s': build_s, 'b2': b2, 'b3_forward': b3,
            'step_ms': statistics.median(times[1:]),
            'step_ms_all': times[1:]}


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == '--worker':
        print(json.dumps(worker(sys.argv[2])), flush=True)
        return
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_ab: CUDA is not available')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    parent, change = (str(pathlib.Path(p).resolve()) for p in sys.argv[1:])
    runs = []
    for label, root in (('parent', parent), ('change', change),
                        ('change', change), ('parent', parent)):
        script = str(pathlib.Path(__file__).resolve())
        out = subprocess.run([sys.executable, script, '--worker', root],
                             capture_output=True, text=True, check=True,
                             cwd=root, timeout=900)
        run = json.loads(out.stdout.strip().splitlines()[-1])
        run['label'] = label
        runs.append(run)
        print(json.dumps(run), flush=True)
    summary = {}
    for label in ('parent', 'change'):
        mine = [r for r in runs if r['label'] == label]
        summary[label] = {
            'b2_ms': {k: [r['b2'][k]['ms'] for r in mine]
                      for k in mine[0]['b2']},
            'b2_device_ms': {k: [r['b2'][k]['device_ms'] for r in mine]
                             for k in mine[0]['b2']},
            'b3_forward_ms': [r['b3_forward']['ms'] for r in mine],
            'b3_forward_device_ms': [r['b3_forward']['device_ms']
                                     for r in mine],
            'grid_sample_ms': [r['b3_forward']['library_ms'] for r in mine],
            'grid_sample_device_ms': [r['b3_forward']['library_device_ms']
                                      for r in mine],
            'step_ms': [r['step_ms'] for r in mine],
            'step_ms_all': [r['step_ms_all'] for r in mine]}
    print(json.dumps({'summary': summary}), flush=True)


if __name__ == '__main__':
    main()
