"""The inversion cells' comparison against a broken program: a run at a
size the CPU holds (the harness's look for a card skipped, the rest of
the run driven as on the card), with the timed path broken underneath,
comes out not correct; the sound run comes out correct."""

import argparse
import time

import pytest
import torch

from nerf_from_image_tpu_torch.invert import optimizer as inv_opt
from nerf_from_image_tpu_torch.invert import pipeline as pipe
from port_bench import run as run_lib
from port_bench.tests.small import small_spec


def unchanged(original):
    """Steps that return the state they were given."""
    def run_inversion(gen, lpips, init, *args, **kwargs):
        _, metrics = original(gen, lpips, init, *args, **kwargs)
        return init.copy(requires_grad=False), metrics
    return run_inversion


def half_batch(original):
    """Steps on the first half of the batch (its loss the mean over that
    half), the rest left at the start."""
    def run_inversion(gen, lpips, init, target, cfg, n, **kwargs):
        h = target.shape[0] // 2
        part = inv_opt.InversionParams(**{k: v[:h] for k, v in init.named()})
        kwargs['gt_cam2world'] = kwargs['gt_cam2world'][:h]
        final, metrics = original(gen, lpips, part, target[:h], cfg, n,
                                  **kwargs)
        return inv_opt.InversionParams(**{
            k: torch.cat((v, getattr(init, k)[h:]))
            for k, v in final.named()}), metrics
    return run_inversion


def one_slot_target_altered(original):
    """Steps that see the batch's last target mirrored: a fault confined
    to one slot's inputs."""
    def run_inversion(gen, lpips, init, target, *args, **kwargs):
        target = torch.cat((target[:-1], target[-1:].flip(2)))
        return original(gen, lpips, init, target, *args, **kwargs)
    return run_inversion


def psnr_altered(original):
    """The checkpoint's psnr 10% off where it is recorded."""
    def evaluate_checkpoint(ctx, cfg, params, entry, *args, **kwargs):
        original(ctx, cfg, params, entry, *args, **kwargs)
        entry['psnr'][-1] = entry['psnr'][-1] * 1.1
    return evaluate_checkpoint


def coords_altered(original):
    """The encoder's coordinates 1% off where they are produced."""
    def bootstrap_dispatch(encoder, target_img):
        coords, mask, w = original(encoder, target_img)
        return coords * 1.01, mask, w
    return bootstrap_dispatch


FAULTS = {'unchanged': (inv_opt, 'run_inversion', unchanged),
          'half_batch': (inv_opt, 'run_inversion', half_batch),
          'one_slot_target_altered': (inv_opt, 'run_inversion',
                                      one_slot_target_altered),
          'psnr_altered': (pipe, 'evaluate_checkpoint', psnr_altered),
          'coords_altered': (pipe, 'bootstrap_dispatch', coords_altered)}


def drive(cell: str) -> dict:
    spec = small_spec(cell)
    driver = run_lib.load_module(spec['driver_path'])
    args = argparse.Namespace(seed=987654321987, seconds=0.0, trace=0)
    return driver.run(spec, args, time.perf_counter(), torch.device('cpu'))


@pytest.mark.parametrize('cell', ['p3d_car.invert'])
def test_sound_run_is_correct(cell):
    torch.set_num_threads(2)
    outcome = drive(cell)
    assert outcome['correct'], outcome['checks']
    assert outcome['failed'] == 0 and outcome['attempted'] > 0


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    torch.set_num_threads(2)
    module, name, make = FAULTS[fault]
    monkeypatch.setattr(module, name, make(getattr(module, name)))
    outcome = drive('p3d_car.invert')
    assert not outcome['correct'], outcome['checks']
