"""The training cell's comparison against a broken program: a run at a
size the CPU holds, in float32 (the CPU's sound run then reads at
round-off), with the steps broken underneath, comes out not correct; the
sound run comes out correct. The control and the half-batch fault at the
cell's own size and type are read on the card by `port_bench.control`."""

import argparse
import time

import pytest
import torch

from nerf_from_image_tpu_torch.train import gan as gan_lib
from port_bench import run as run_lib
from port_bench.tests.small import small_spec


def _half(batch):
    n = batch['z'].shape[0] // 2 if 'z' in batch else \
        batch['image'].shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}


def half_batch(original):
    """Each G step on the first half of its batch."""
    def g_step(state, batch, cfg, *args, **kwargs):
        return original(state, _half(batch), cfg, *args, **kwargs)
    return g_step


def unchanged(original):
    """G steps that leave the generator as they found it."""
    def g_step(state, batch, cfg, *args, **kwargs):
        saved = [p.detach().clone() for p in state.gen.parameters()]
        metrics = original(state, batch, cfg, *args, **kwargs)
        with torch.no_grad():
            for p, v in zip(state.gen.parameters(), saved):
                p.copy_(v)
        return metrics
    return g_step


def loss_altered(original):
    """The G loss doubled where it is reported (the bf16 program's own
    loss gaps reach 0.14 on the card, so a smaller alteration is not
    this comparison's to catch)."""
    def g_step(state, batch, cfg, *args, **kwargs):
        metrics = original(state, batch, cfg, *args, **kwargs)
        metrics['loss_g'] = metrics['loss_g'] * 2.0
        return metrics
    return g_step


FAULTS = {'half_batch': half_batch, 'unchanged': unchanged,
          'loss_altered': loss_altered}


def drive() -> dict:
    torch.set_num_threads(2)
    spec = small_spec('p3d_car.train')
    spec['config']['flags'] += ['--compute_dtype', 'float32']
    driver = run_lib.load_module(spec['driver_path'])
    args = argparse.Namespace(seed=31415926535, seconds=0.0, trace=0)
    return driver.run(spec, args, time.perf_counter(), torch.device('cpu'))


def test_sound_training_run_is_correct():
    outcome = drive()
    assert outcome['correct'], outcome['checks']
    assert outcome['attempted'] > 0


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_training_fault_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(gan_lib, 'g_step', FAULTS[fault](gan_lib.g_step))
    outcome = drive()
    assert not outcome['correct'], outcome['checks']


def test_non_finite_window_counts_as_failed(monkeypatch):
    """A G step of the window that leaves a parameter not finite: every
    image of the window counts as failed."""
    original, calls = gan_lib.g_step, []

    def g_step(state, batch, cfg, *args, **kwargs):
        metrics = original(state, batch, cfg, *args, **kwargs)
        calls.append(1)
        if len(calls) > 2:  # after the two warm-up pairs
            with torch.no_grad():
                state.gen.beta.fill_(float('nan'))
        return metrics
    monkeypatch.setattr(gan_lib, 'g_step', g_step)
    outcome = drive()
    assert outcome['attempted'] > 0
    assert outcome['failed'] == outcome['attempted']
