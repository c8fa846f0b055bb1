#!/usr/bin/env python3
"""Where one full-width inversion refinement step makes the host wait for
the card.

Builds `chip_smoke.py`'s inversion (the full-width generator in p3d_car's
geometry, VGG LPIPS, batch 8, 128^2 rays, 64 + 64 samples, 15 crops),
takes one warm-up step, then one step under
`torch.cuda.set_sync_debug_mode('warn')`, which warns at every call that
synchronizes the host with the card. Each such warning ("called a
synchronizing CUDA operation") is kept with the port's frames of the
Python stack at that moment; any other warning, such as torch's notice
that the debug mode is a prototype, is printed as a notice and not
counted. Prints each synchronizing call site of the port with its count
in the step and the innermost port frames, and writes the list to
`chiprun_out/step_syncs.json`.

A synchronization in a step does not stop the CLI's PnP worker, but the
host waits there until the card has run everything queued before it,
and the card then idles while the host queues what follows.

Needs the card (about a minute, kernels' build included):

    python3 probes/step_syncs.py
"""

from __future__ import annotations

import collections
import json
import os
import pathlib
import sys
import traceback
import warnings

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nerf_from_image_tpu_torch.invert import optimizer as inv  # noqa: E402

PORT = 'nerf_from_image_tpu_torch'


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit('step_syncs: CUDA is not available')
    cs.device_phase()
    cs.build_phase()
    gen, lpips = cs.inversion_models()
    target, _, gt_cam, init = cs.inversion_problem(gen)
    params = init.copy(requires_grad=True)
    optimizer = inv.make_optimizer(params, cs.INV_CFG)
    step = inv.make_inversion_step(gen, lpips, cs.INV_CFG, gt_cam)
    draws = torch.Generator(device='cuda').manual_seed(0)
    step(params, optimizer, target, draws)
    torch.cuda.synchronize()

    records = []

    def keep(message, category, filename, lineno, file=None, line=None):
        frames = [f'{os.path.relpath(f.filename)}:{f.lineno} {f.name}'
                  for f in traceback.extract_stack()[:-1]
                  if PORT in f.filename]
        records.append({'frames': frames[-3:], 'message': str(message)})

    with warnings.catch_warnings():
        warnings.simplefilter('always')
        warnings.showwarning = keep
        torch.cuda.set_sync_debug_mode('warn')
        try:
            step(params, optimizer, target, draws)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()

    sync = 'called a synchronizing CUDA operation'
    notices = [r['message'][:160] for r in records
               if sync not in r['message']]
    records = [r for r in records if sync in r['message']]
    for notice in notices:
        print(f'notice, not counted: {notice}')
    sites = collections.Counter(r['frames'][-1] if r['frames'] else
                                '(outside the port)' for r in records)
    out = []
    for site, count in sites.most_common():
        example = next(r for r in records
                       if (r['frames'][-1] if r['frames'] else
                           '(outside the port)') == site)
        out.append({'site': site, 'count': count,
                    'frames': example['frames'],
                    'message': example['message'][:160]})
        print(f'{count:4d}  {site}  <- {example["frames"][:-1]}')
    print(f'{len(records)} synchronizing calls in one step')
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'step_syncs.json'), 'w') as f:
        json.dump({'total': len(records), 'sites': out,
                   'notices': notices}, f, indent=1)


if __name__ == '__main__':
    main()
