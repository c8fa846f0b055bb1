"""Volume renderer: rays -> coarse pass -> PDF resampling -> fine pass ->
composite (PyTorch port of `nerf_from_image_tpu/render/renderer.py`).

The field is `sample_fn(points, requests) -> dict`, as in the JAX package.
The port renders sigma and rgb with a perspective camera (with an optional
principal point and bbox crop), deterministically or with jittered depths
and random PDF draws; normals, semantics and coordinates wait for later
slices. The render differentiates to the field
and to the camera, as JAX's does: near/far, the coarse weights and the
fine depths are detached, and the points of both passes carry the
camera's gradient through the rays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Union

import torch

from nerf_from_image_tpu_torch.core import compositing
from nerf_from_image_tpu_torch.core import rays as rays_lib
from nerf_from_image_tpu_torch.core import sampling

SampleFn = Callable[[torch.Tensor, Sequence[str]], Dict[str, torch.Tensor]]


@dataclass
class RenderOutput:
    rgb: torch.Tensor  # (B, H, W, C)
    depth: torch.Tensor  # (B, H, W)
    mask: torch.Tensor  # (B, H, W)
    # Sum of the passes' overflow_resid (0: a direct gather never
    # overflows; the field exists because the JAX package's callers read
    # it).
    overflow_resid: Optional[torch.Tensor] = None


def normalize(x: torch.Tensor, dim: int = -1,
              eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim,
                                        keepdim=True).clamp_min(eps)


def render(sample_fn: SampleFn, height: int, width: int,
           cam2world: torch.Tensor, focal_length: torch.Tensor,
           scene_range: float, white_background: bool,
           depth_samples_per_ray: int,
           rng: Optional[Union[torch.Generator,
                               Dict[str, torch.Tensor]]] = None,
           center: Optional[torch.Tensor] = None,
           bbox: Optional[torch.Tensor] = None) -> RenderOutput:
    """Renders a batch of views.

    Args:
      cam2world: (B, 4, 4) float32; focal_length: (B,) float32.
      depth_samples_per_ray: S coarse and S fine samples per ray (the
        reference always samples fine: `--fine_sampling` is always true).
      rng: None for deterministic sampling; a `torch.Generator` for
        jittered coarse depths and random PDF draws (drawn in that order);
        or those draws themselves, {'depth': uniform (B, H, W, S),
        'pdf_u': uniform (B * H * W, S)}, as the JAX package injects them.
      center: optional (B, 2) principal point in [0, 1].
      bbox: optional (B, 2, 2) normalized crop [[x0, y0], [w, h]].
    """
    b = cam2world.shape[0]
    s = depth_samples_per_ray
    ray_origins, ray_directions = rays_lib.get_ray_bundle(
        height, width, focal_length, cam2world, bbox, center)
    ray_directions = normalize(ray_directions)
    near, far = rays_lib.compute_near_far_planes(ray_origins,
                                                 ray_directions, scene_range)
    rng_coarse = rng_fine = rng
    if isinstance(rng, dict):
        rng_coarse, rng_fine = rng.get('depth'), rng.get('pdf_u')
    query_points, depth_values = rays_lib.compute_query_points_from_rays(
        ray_origins, ray_directions, near, far, s, rng=rng_coarse)

    requests = ('sigma', 'rgb')

    def unflatten(v):
        return v.reshape(b, height, width, s, -1)

    out_coarse = sample_fn(query_points, requests)
    sigma = unflatten(out_coarse['sigma'])[..., 0]
    rgb = unflatten(out_coarse['rgb'])
    overflow_resid = out_coarse.get('overflow_resid')

    weights = compositing.render_volume_density_weights_only(
        sigma, ray_directions, depth_values).detach()
    weights = sampling.smooth_weights_eg3d(weights.reshape(-1, s))
    z_mid = 0.5 * (depth_values[..., 1:] + depth_values[..., :-1])
    z_samples = sampling.sample_pdf(z_mid.reshape(-1, s - 1),
                                    weights[..., 1:-1], s, rng=rng_fine)
    z_samples = torch.sort(z_samples, dim=-1).values
    z_samples = z_samples.reshape(b, height, width, s).detach()
    query_points_fine = (ray_origins[..., None, :] +
                         ray_directions[..., None, :] *
                         z_samples[..., :, None])

    out_fine = sample_fn(query_points_fine, requests)
    if out_fine.get('overflow_resid') is not None:
        overflow_resid = (out_fine['overflow_resid']
                          if overflow_resid is None else
                          overflow_resid + out_fine['overflow_resid'])
    depth_values = torch.cat((depth_values, z_samples), dim=-1)
    sigma = torch.cat((sigma, unflatten(out_fine['sigma'])[..., 0]), dim=-1)
    rgb = torch.cat((rgb, unflatten(out_fine['rgb'])), dim=-2)

    rgb_map, depth_map, mask = compositing.render_volume_density(
        sigma, rgb, ray_directions, depth_values,
        white_background=white_background)
    return RenderOutput(rgb=rgb_map, depth=depth_map, mask=mask,
                        overflow_resid=overflow_resid)
