"""Stratified volume samples for the SDF regularizers (a frozen copy of
the program's `core/grids.py`; its warm-up blur is not needed past
iteration 12,500, where the benchmark trains).
"""

from __future__ import annotations

from typing import Union

import torch

Draw = Union[torch.Generator, torch.Tensor]


def sample_volume_stratified(rng: Draw, batch_size: int, nstrata: int,
                             scene_range: float) -> torch.Tensor:
    """Stratified samples over [-scene_range, scene_range]^3.

    One uniform jitter per cell of an (nstrata - 1)^3 grid, drawn from the
    `torch.Generator` `rng` on its device, or given as a float array of the
    (B, n, n, n, 3) cell shape (the JAX package's injected draw). Returns
    (B, (nstrata - 1)^3, 3) float32.
    """
    n = nstrata - 1
    device = rng.device
    ax = torch.arange(n, dtype=torch.float32, device=device)
    # meshgrid 'xy' over three identical axes.
    gx, gy, gz = torch.meshgrid(ax, ax, ax, indexing='xy')
    bins = torch.stack((gx, gy, gz), dim=-1)[None].expand(
        batch_size, n, n, n, 3)
    if isinstance(rng, torch.Tensor):
        jitter = rng.reshape(bins.shape).float()
    else:
        jitter = torch.rand(bins.shape, generator=rng, device=device)
    bins = ((bins + jitter) / n) * 2.0 - 1.0
    return bins.reshape(batch_size, n * n * n, 3) * scene_range
