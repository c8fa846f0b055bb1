"""The control of a cell's comparison, and the program's readings
beside it.

    python3 -m port_bench.control --workload p3d_car.invert \
        --seeds 11 12 13 [--out control.jsonl]

For each seed, in one process, the cell's set-up and the program's work
at the cell's size, then the plain reference in float32 and, in the
program's place, the reference a precision below the configuration's
(the control); both go through the cell's comparison, and one JSON line
a seed gives the readings beside the cell's limits. The control has to
fail at least one of them. The benchmark's own runs never run this.

- Inversion (float32): one batch of the program (its first, PnP in
  line); the control is the reference under bf16 autocast: its encoder
  outputs, its start from its own latent and PnP's camera, its steps
  with the batch's draws, its checkpoint metrics.
- Training (bf16): the program's first three steps; the control is the
  reference with fp8-rounded products (`checks/train.fp8_products`); the
  planted fault of half the batch left out is read beside it (a state
  left unchanged reads 1 on change_gap by its definition).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from port_bench import run as run_lib
from port_bench.checks import REFERENCE_ROWS
from port_bench.checks import invert as check_lib
from port_bench.reference import inversion as ref_inv


def control_results(ctl: check_lib.Reference, record, pnp_out, niter: int,
                    rot_error: bool, block: int) -> dict:
    """The control's results for the record's batch, in `compare`'s
    form."""
    targets = record.targets
    img = targets['target_img'][..., :3].permute(0, 3, 1, 2).contiguous()
    with torch.no_grad(), ctl.precision():
        enc = tuple(t.float() for t in ctl.encoder(img))
    dev = ctl.device
    cam2world, focal = pnp_out[2], pnp_out[3]
    start = ref_inv.initial_params(
        enc[2], ctl.gen.num_ws,
        torch.as_tensor(cam2world, dtype=torch.float32, device=dev),
        None if focal is None else torch.as_tensor(
            focal, dtype=torch.float32, device=dev), ctl.cfg)
    b = targets['target_img'].shape[0]
    with ctl.precision():
        final, losses, grad_sq = ref_inv.refine_rows(
            ctl.gen, ctl.lpips, start, targets['target_img'], ctl.cfg,
            check_lib.draws_for(ctl, record.crops_state, b, niter), block)
    gain = ctl.cfg.lr_gain_z
    final = check_lib.as_params({k: v.float() for k, v in final.items()},
                                gain)
    metrics = {}
    for step, params in ((0, check_lib.as_params(start, gain)),
                         (niter, final)):
        m = check_lib.evaluate_rows(ctl, params, targets, rot_error, block)
        metrics[step] = {k: v.double().cpu().numpy() for k, v in m.items()}
    return {'encoder': enc, 'pnp': pnp_out, 'start': start,
            'losses': losses.float(),
            'grad_norms': {k: v.sqrt() for k, v in grad_sq.items()},
            'final': final, 'metrics': metrics}


def one_seed_train(spec: dict, seed: int, device) -> dict:
    from port_bench.checks import train as train_check
    driver = run_lib.load_module(spec['driver_path'])
    t0 = time.perf_counter()
    s = driver.setup(spec, seed, device)
    first = driver.warm_up(s, device)
    s.free_program()
    block = REFERENCE_ROWS
    ref = train_check.follow(s, device, block)
    control = train_check.follow(s, device, block, train_check.fp8_products)
    half = train_check.follow(s, device, block, half_batch=True)
    readings = {'program': train_check.compare(first, ref),
                'control': train_check.compare(control, ref),
                'half_batch': train_check.compare(half, ref)}
    for name, cand in (('program', first), ('control', control)):
        print(f'{name}:', train_check.worst(cand, ref), file=sys.stderr)
    limits = spec['limits']
    return {'seed': seed, **readings, 'limits': limits,
            'control_fails': sorted(k for k, v in readings['control'].items()
                                    if not v <= limits[k]),
            'seconds': time.perf_counter() - t0}


def one_seed(spec: dict, seed: int, device) -> dict:
    if spec['traffic']['driver'] == 'train':
        return one_seed_train(spec, seed, device)
    driver = run_lib.load_module(spec['driver_path'])
    t0 = time.perf_counter()
    s = driver.setup(spec, seed, device)
    loop = driver.Loop(s, device)
    try:
        record = loop.batch()
    finally:
        loop.close()
    s.free_program()
    rot_error = not (s.args.dataset == 'p3d_car' and s.args.inv_use_testset)
    block = REFERENCE_ROWS
    ref = check_lib.Reference(s, spec, device)
    program = check_lib.compare(
        ref, check_lib.program_results(record, s.niter, device),
        record.targets, record.crops_state, s.niter, rot_error, block)
    ctl = check_lib.Reference(s, spec, device, dtype=torch.bfloat16)
    control = check_lib.compare(
        ref, control_results(ctl, record, record.pnp_out, s.niter,
                             rot_error, block),
        record.targets, record.crops_state, s.niter, rot_error, block)
    limits = spec['limits']
    return {'seed': seed, 'program': program, 'control': control,
            'limits': limits,
            'control_fails': sorted(k for k, v in control.items()
                                    if not v <= limits[k]),
            'seconds': time.perf_counter() - t0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    parser.add_argument('--out')
    args = parser.parse_args(argv)
    spec = run_lib.resolve(args.workload)
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    for seed in args.seeds:
        line = json.dumps(one_seed(spec, seed, device))
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
