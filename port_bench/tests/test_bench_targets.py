"""The inversion's targets: the surface placed in the frame, and every
target covering the mix's share of the frame, at a size the CPU holds."""

import pytest
import torch

from port_bench import run as run_lib
from port_bench.common import DISTANCE_BIAS
from port_bench.tests.small import small_spec


def setup(spec: dict):
    torch.set_num_threads(2)
    driver = run_lib.load_module(spec['driver_path'])
    return driver.setup(spec, 2718281828459, torch.device('cpu'))


def test_targets_cover_the_mix_share():
    spec = small_spec('p3d_car.invert')
    s = setup(spec)
    lo, hi = spec['traffic']['mask_coverage']
    cover = torch.cat([b['pnp_mask'].mean(dim=(1, 2)) for b in s.pool])
    assert len(cover) == s.batch_size * spec['traffic']['target_batches']
    assert ((cover >= lo) & (cover <= hi)).all(), cover
    # The program's generator and the reference's draw carry the offset.
    recipe, seed = s.weights['generator']
    offset = recipe.set_leaves[DISTANCE_BIAS]
    drawn = recipe.draw(seed, torch.device('cpu'))[DISTANCE_BIAS]
    program = dict(s.gen.named_parameters())[DISTANCE_BIAS]
    assert torch.equal(drawn, torch.full_like(drawn, offset))
    assert torch.equal(program.detach(), drawn)


def test_unreachable_coverage_fails_set_up():
    spec = small_spec('p3d_car.invert')
    spec['traffic']['mask_coverage'] = [1.5, 2.0]
    with pytest.raises(RuntimeError, match='cover'):
        setup(spec)
