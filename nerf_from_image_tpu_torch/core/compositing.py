"""Alpha compositing of per-ray samples (PyTorch port of
`nerf_from_image_tpu/core/compositing.py`).

The JAX package composites the unsorted coarse+fine union with a pairwise
(S x S) weight formulation to avoid a TPU sort and gather. Here the
samples are sorted per ray first (a stable sort, so exact depth ties keep
their input order as the pairwise form does) and composited with the
exclusive-cumprod scan; the outputs are the same order-invariant sums,
equal to JAX's `render_volume_density(samples_sorted=False)`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def cumprod_exclusive(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative product along the last axis."""
    cp = torch.cumprod(x[..., :-1], dim=-1)
    return torch.cat((torch.ones_like(cp[..., :1]), cp), dim=-1)


def compute_weights(sigma: torch.Tensor, ray_directions: torch.Tensor,
                    depth_values: torch.Tensor) -> torch.Tensor:
    """Volume-rendering weights w_i = alpha_i * T_i for sorted depths.

    dists_i = depth_{i+1} - depth_i (0 for the last sample), scaled by the
    ray direction norm; alpha = 1 - exp(-sigma * dist).
    """
    dists = torch.cat((depth_values[..., 1:] - depth_values[..., :-1],
                       torch.zeros_like(depth_values[..., :1])), dim=-1)
    dists = dists * torch.linalg.vector_norm(ray_directions, dim=-1,
                                             keepdim=True)
    alpha = 1.0 - torch.exp(-sigma * dists)
    return alpha * cumprod_exclusive(1.0 - alpha + 1e-10)


def composite(sigma: torch.Tensor, rgb: torch.Tensor,
              ray_directions: torch.Tensor, depth_values: torch.Tensor,
              normals: Optional[torch.Tensor] = None,
              semantics: Optional[torch.Tensor] = None,
              white_background: bool = True,
              samples_sorted: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Composites sigma/rgb (and optional per-sample normals and
    semantics) along rays, samples in any per-ray order, or, with
    `samples_sorted`, in ascending depth already (one stratified pass),
    which skips the sort, as the JAX package's `samples_sorted` skips its
    pairwise form.

    Args:
      sigma: (..., S), rgb: (..., S, C), depth_values: (..., S),
      ray_directions: (..., 3), normals: None or (..., S, 3), semantics:
      None or (..., S, K).

    Returns:
      (rgb_map (..., C), depth_map (...), mask (...), normal_map (..., 3)
      or None, semantic_map (..., K) or None), in float32. The depth and
      normal maps use detached weights; rgb, mask and semantics the
      weights themselves, as the JAX package composites them. On a white
      background the normal map gets the same fill as the rgb map.
    """
    sigma = sigma.float()
    rgb = rgb.float()
    depth_values = depth_values.float()
    order = None
    if not samples_sorted:
        depth_values, order = torch.sort(depth_values, dim=-1, stable=True)
        sigma = torch.gather(sigma, -1, order)
        rgb = torch.take_along_dim(rgb, order[..., None], dim=-2)
    weights = compute_weights(sigma, ray_directions.float(), depth_values)

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    weights_sg = weights.detach()
    depth_map = torch.sum(weights_sg * depth_values.detach(), dim=-1)
    mask = torch.sum(weights, dim=-1)

    def per_sample_map(values, w):
        if values is None:
            return None
        values = values.float()
        if order is not None:
            values = torch.take_along_dim(values, order[..., None], dim=-2)
        return torch.sum(w[..., None] * values, dim=-2)

    normal_map = per_sample_map(normals, weights_sg)
    semantic_map = per_sample_map(semantics, weights)
    if white_background:
        rgb_map = rgb_map + (1.0 - mask[..., None])
        if normal_map is not None:
            normal_map = normal_map + (1.0 - mask[..., None])
    return rgb_map, depth_map, mask, normal_map, semantic_map


def render_volume_density(sigma: torch.Tensor, rgb: torch.Tensor,
                          ray_directions: torch.Tensor,
                          depth_values: torch.Tensor,
                          white_background: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """`composite` without normals or semantics: (rgb_map, depth_map,
    mask)."""
    return composite(sigma, rgb, ray_directions, depth_values,
                     white_background=white_background)[:3]


def render_volume_density_weights_only(sigma: torch.Tensor,
                                       ray_directions: torch.Tensor,
                                       depth_values: torch.Tensor
                                       ) -> torch.Tensor:
    return compute_weights(sigma, ray_directions, depth_values)
