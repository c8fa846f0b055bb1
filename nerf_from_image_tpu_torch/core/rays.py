"""Ray generation, near/far planes and stratified depths (PyTorch port of
`nerf_from_image_tpu/core/rays.py`).

The port has the perspective camera, with an optional principal point
("center") and normalized bbox crop. Depths are evenly spaced, or
jittered within their strata by uniform draws from a `torch.Generator` or
given as a float array (the JAX package's injected draw).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

Draw = Union[torch.Generator, torch.Tensor]


def get_ray_bundle(height: int, width: int, focal_length: torch.Tensor,
                   cam2world: torch.Tensor,
                   bbox: Optional[torch.Tensor] = None,
                   center: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ray origins and directions in world space.

    Args:
      height, width: image resolution.
      focal_length: (B,) normalized focal length (perspective camera).
      cam2world: (B, 4, 4) camera-to-world matrices.
      bbox: optional (B, 2, 2) normalized crop [[x0, y0], [w, h]].
      center: optional (B, 2) principal point in [0, 1].

    Returns:
      ray_origins, ray_directions: (B, H, W, 3) each. Directions are not
      normalized.
    """
    dtype, device = cam2world.dtype, cam2world.device
    # Pixel grids: ii[r, c] = c / W, jj[r, c] = r / H.
    ii = (torch.arange(width, dtype=dtype, device=device) / width)[None, :]
    jj = (torch.arange(height, dtype=dtype, device=device) / height)[:, None]
    ii = ii.expand(height, width)[None]
    jj = jj.expand(height, width)[None]
    if center is not None:
        ii = ii - 0.5 * (2.0 * center[:, 0, None, None] - 1.0) - 0.5
        jj = jj - 0.5 * (2.0 * center[:, 1, None, None] - 1.0) - 0.5
    else:
        ii = ii - 0.5
        jj = jj - 0.5
    if bbox is not None:
        ii = (bbox[:, 1:2, 0, None] * (ii + 0.5) +
              bbox[:, 0:1, 0, None]) * 0.5
        jj = -(bbox[:, 1:2, 1, None] * (-jj + 0.5) +
               bbox[:, 0:1, 1, None]) * 0.5
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
                                   num_samples: int,
                                   rng: Optional[Draw] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stratified depths along each ray: lerp(near, far, i / N), plus
    U[0, 1) * (far - near) / N when `rng` is given (a `torch.Generator`,
    or uniform draws of depth_values' shape).

    Returns (query_points (..., N, 3), depth_values (..., N)).
    """
    frac = torch.arange(num_samples, dtype=ray_origins.dtype,
                        device=ray_origins.device) / num_samples
    depth_values = near[..., None] + (far - near)[..., None] * frac
    if rng is not None:
        if isinstance(rng, torch.Tensor):
            u = rng.reshape(depth_values.shape).to(depth_values.dtype)
        else:
            u = torch.rand(depth_values.shape, generator=rng,
                           device=depth_values.device,
                           dtype=depth_values.dtype)
        depth_values = depth_values + u * ((far - near)[..., None] /
                                           num_samples)
    query_points = (ray_origins[..., None, :] +
                    ray_directions[..., None, :] * depth_values[..., :, None])
    return query_points, depth_values
