"""The control at a size a test run holds: the plain reference in bf16
in the program's place fails the cell's comparison, which the program
passes."""

import pytest
import torch

from port_bench import control
from port_bench.tests.small import small_spec


@pytest.mark.parametrize('cell', ['p3d_car.invert'])
def test_control_fails_and_program_passes(cell, monkeypatch):
    torch.set_num_threads(2)
    spec = small_spec(cell)
    out = control.one_seed(spec, 20240611, torch.device('cpu'))
    limits = out['limits']
    assert all(v <= limits[k] for k, v in out['program'].items()), out
    assert out['control_fails'], out
