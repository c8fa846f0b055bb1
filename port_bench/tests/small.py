"""A cell's files at a size the CPU tests can hold: the configuration's
flags and widths cut down, the encoder one block a stage."""

from __future__ import annotations

import copy

from port_bench import run as run_lib

SMALL_FLAGS = {'--resolution': '32', '--plane_resolution': '16',
               '--depth_samples_per_ray': '4', '--inv_steps': '3',
               '--batch_size': '8'}


def small_spec(cell: str) -> dict:
    spec = copy.deepcopy(run_lib.resolve(cell))
    flags = list(spec['config']['flags'])
    for flag, value in SMALL_FLAGS.items():
        if flag in flags:
            flags[flags.index(flag) + 1] = value
        else:
            flags += [flag, value]
    spec['config']['flags'] = flags
    spec['config']['gan'] = {'channel_base': 256, 'channel_max': 32}
    spec['config']['encoder'] = {'depths': (1, 1, 1, 1)}
    traffic = spec['traffic']
    if 'target_batches' in traffic:
        traffic['target_batches'] = 2
    if 'real_images' in traffic:
        traffic['real_images'] = 24
    return spec
