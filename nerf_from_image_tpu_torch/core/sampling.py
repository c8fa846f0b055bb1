"""Hierarchical (PDF) depth resampling (PyTorch port of
`nerf_from_image_tpu/core/sampling.py`).

The JAX package expresses `searchsorted` as masked min/max reductions to
keep gathers off the TPU; a GPU gathers directly, so this port uses
`torch.searchsorted` and `torch.gather`, which select the same entries.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor,
               num_samples: int,
               rng: Optional[Union[torch.Generator, torch.Tensor]] = None
               ) -> torch.Tensor:
    """Inverse-transform sampling of `num_samples` depths.

    Args:
      bins: (..., K) bin positions, sorted ascending.
      weights: (..., K - 1) interval weights (the CDF then has K entries,
        aligned with `bins`).
      rng: None for the deterministic draws linspace(0, 1, num_samples);
        a `torch.Generator` for uniform draws; or the uniform draws
        themselves, a float array of shape (..., num_samples).

    Returns:
      samples: (..., num_samples) depths in the dtype of `bins`.
    """
    weights = weights.float() + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat((torch.zeros_like(cdf[..., :1]), cdf), dim=-1)
    k = cdf.shape[-1]

    shape = cdf.shape[:-1] + (num_samples,)
    if rng is None:
        u = torch.linspace(0.0, 1.0, num_samples, dtype=torch.float32,
                           device=cdf.device).expand(shape).contiguous()
    elif isinstance(rng, torch.Tensor):
        u = rng.reshape(shape).float().contiguous()
    else:
        u = torch.rand(shape, generator=rng, device=cdf.device)
    # below = the largest j with cdf[j] <= u (cdf[0] = 0, so it exists);
    # above = below + 1, clamped to the last entry.
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(k - 1)

    bins_f = bins.float()
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins_f, -1, below)
    bins_above = torch.gather(bins_f, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return (bins_below + t * (bins_above - bins_below)).to(bins.dtype)


def smooth_weights_eg3d(weights: torch.Tensor) -> torch.Tensor:
    """EG3D max-pool(2, pad 1) then avg-pool(2) smoothing + 0.01 floor.

    The output has the input's length; the renderer slices [..., 1:-1]
    to pair it with the S - 1 depth midpoints.
    """
    pad = torch.full_like(weights[..., :1], float('-inf'))
    wp = torch.cat((pad, weights, pad), dim=-1)
    wmax = torch.maximum(wp[..., :-1], wp[..., 1:])
    wavg = 0.5 * (wmax[..., :-1] + wmax[..., 1:])
    return wavg + 0.01
