"""Ray generation, near/far planes and stratified depths (PyTorch port of
`nerf_from_image_tpu/core/rays.py`).

The slice ports the perspective camera without a principal-point offset
or bbox crop, and deterministic (jitter-free) depths.
"""

from __future__ import annotations

from typing import Tuple

import torch


def get_ray_bundle(height: int, width: int, focal_length: torch.Tensor,
                   cam2world: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ray origins and directions in world space.

    Args:
      height, width: image resolution.
      focal_length: (B,) normalized focal length (perspective camera).
      cam2world: (B, 4, 4) camera-to-world matrices.

    Returns:
      ray_origins, ray_directions: (B, H, W, 3) each. Directions are not
      normalized.
    """
    dtype, device = cam2world.dtype, cam2world.device
    # Pixel grids: ii[r, c] = c / W, jj[r, c] = r / H.
    ii = (torch.arange(width, dtype=dtype, device=device) / width)[None, :]
    jj = (torch.arange(height, dtype=dtype, device=device) / height)[:, None]
    ii = ii.expand(height, width)[None] - 0.5
    jj = jj.expand(height, width)[None] - 0.5
    ii = ii / focal_length[:, None, None]
    jj = jj / focal_length[:, None, None]

    directions = torch.stack((ii, -jj, -torch.ones_like(ii)), dim=-1)
    rot = cam2world[:, :3, :3]
    t = cam2world[:, :3, 3]
    # world_dir = R @ cam_dir.
    ray_directions = torch.einsum('bij,bhwj->bhwi', rot, directions)
    ray_origins = t[:, None, None, :].expand_as(ray_directions)
    return ray_origins, ray_directions


def compute_near_far_planes(ray_origins: torch.Tensor,
                            ray_directions: torch.Tensor,
                            scene_range: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray near/far by slab intersection with the [-r, r]^3 box.

    Rays that miss the box take the batch-wide min near / max far over the
    rays that hit it. Results are clamped to >= 0.1 and
    far >= near + 1e-3. Not differentiated (inputs are detached).
    """
    shape = ray_origins.shape[:-1]
    o = ray_origins.detach().reshape(-1, 3)
    d = ray_directions.detach().reshape(-1, 3)

    invdir = 1.0 / d
    t_lo = (-scene_range - o) * invdir
    t_hi = (scene_range - o) * invdir
    tmin = torch.minimum(t_lo, t_hi)  # per-axis entry
    tmax = torch.maximum(t_lo, t_hi)  # per-axis exit
    xmin, ymin, zmin = tmin.unbind(-1)
    xmax, ymax, zmax = tmax.unbind(-1)

    mask = ~((xmin > ymax) | (ymin > xmax))
    near = torch.maximum(xmin, ymin)
    far = torch.minimum(xmax, ymax)
    mask = mask & ~((near > zmax) | (zmin > far))
    near = torch.maximum(near, zmin)
    far = torch.minimum(far, zmax)

    # Fill misses with the masked global min/max.
    inf = torch.tensor(float('inf'), dtype=near.dtype, device=near.device)
    near_fill = torch.where(mask, near, inf).min()
    far_fill = torch.where(mask, far, -inf).max()
    near = torch.where(mask, near, near_fill)
    far = torch.where(mask, far, far_fill)

    near = near.clamp_min(0.1)
    far = far.clamp_min(0.1)
    eps = 1e-3
    far = torch.where(far - near < eps, near + eps, far)
    return near.reshape(shape), far.reshape(shape)


def compute_query_points_from_rays(ray_origins: torch.Tensor,
                                   ray_directions: torch.Tensor,
                                   near: torch.Tensor, far: torch.Tensor,
                                   num_samples: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evenly spaced depths along each ray: lerp(near, far, i / N).

    Returns (query_points (..., N, 3), depth_values (..., N)).
    """
    frac = torch.arange(num_samples, dtype=ray_origins.dtype,
                        device=ray_origins.device) / num_samples
    depth_values = near[..., None] + (far - near)[..., None] * frac
    query_points = (ray_origins[..., None, :] +
                    ray_directions[..., None, :] * depth_values[..., :, None])
    return query_points, depth_values
