"""Volume renderer: rays -> coarse pass -> PDF resampling -> fine pass
(or, without fine sampling, the coarse pass alone) -> composite (PyTorch
port of `nerf_from_image_tpu/render/renderer.py`).

The field is `sample_fn(points, requests, directions) -> dict`: the JAX
package's `sample_fn(points, requests)`, also given the rays' normalized
directions (B, H, W, 3), the same tensor in both passes, which a
view-direction generator reads and any other field ignores. The port renders
sigma and rgb with a perspective camera (with an optional principal point
and bbox crop) or an orthographic one (`focal_length` None, the scale in
cam2world[:, 3, 3]), deterministically or with jittered depths and random
PDF draws, and on request the normals (`compute_normals`, the
GAN evaluation's images), the K-channel palette probabilities
(`compute_semantics`) or the world points in the semantics slot
(`compute_coords`, the encoder distillation's target). The render
differentiates to the field
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

SampleFn = Callable[[torch.Tensor, Sequence[str], torch.Tensor],
                    Dict[str, torch.Tensor]]


@dataclass
class RenderOutput:
    rgb: torch.Tensor  # (B, H, W, C)
    depth: torch.Tensor  # (B, H, W)
    mask: torch.Tensor  # (B, H, W)
    normals: Optional[torch.Tensor] = None  # (B, H, W, 3)
    # The palette probabilities (B, H, W, K), or with `compute_coords` the
    # composited world points (B, H, W, 3).
    semantics: Optional[torch.Tensor] = None
    # Sum of the passes' overflow_resid (0: a direct gather never
    # overflows; the field exists because the JAX package's callers read
    # it).
    overflow_resid: Optional[torch.Tensor] = None


def normalize(x: torch.Tensor, dim: int = -1,
              eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim,
                                        keepdim=True).clamp_min(eps)


def render(sample_fn: SampleFn, height: int, width: int,
           cam2world: torch.Tensor, focal_length: Optional[torch.Tensor],
           scene_range: float, white_background: bool,
           depth_samples_per_ray: int,
           rng: Optional[Union[torch.Generator,
                               Dict[str, torch.Tensor]]] = None,
           center: Optional[torch.Tensor] = None,
           bbox: Optional[torch.Tensor] = None,
           compute_normals: bool = False,
           compute_semantics: bool = False,
           compute_coords: bool = False,
           fine_sampling: bool = True) -> RenderOutput:
    """Renders a batch of views.

    Args:
      cam2world: (B, 4, 4) float32; focal_length: (B,) float32, or None
        for an orthographic camera.
      depth_samples_per_ray: S coarse and, with `fine_sampling`, S fine
        samples per ray.
      rng: None for deterministic sampling; a `torch.Generator` for
        jittered coarse depths and random PDF draws (drawn in that order);
        or those draws themselves, {'depth': uniform (B, H, W, S),
        'pdf_u': uniform (B * H * W, S)}, as the JAX package injects them.
      center: optional (B, 2) principal point in [0, 1].
      bbox: optional (B, 2, 2) normalized crop [[x0, y0], [w, h]].
      compute_normals: also request 'normals' of `sample_fn` and composite
        them with the detached weights into `normals`.
      compute_semantics: also request 'semantics' and composite them with
        the weights themselves into `semantics`.
      compute_coords: also request 'coords' of `sample_fn` and composite
        the coarse and fine points into `semantics` (in place of the
        palette probabilities) with the weights themselves, not detached,
        as the JAX package does.
      fine_sampling: the PDF-resampled fine pass (the reference always
        samples fine: `--fine_sampling` parses as true). Without it the
        stratified coarse pass alone is composited, its samples already
        in depth order.
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

    extra = [name for name, on in (('normals', compute_normals),
                                   ('semantics', compute_semantics),
                                   ('coords', compute_coords)) if on]
    requests = ('sigma', 'rgb') + tuple(extra)

    def unflatten(v):
        return v.reshape(b, height, width, s, -1)

    def field(points):
        return sample_fn(points, requests, ray_directions)

    out_coarse = field(query_points)
    sigma = unflatten(out_coarse['sigma'])[..., 0]
    rgb = unflatten(out_coarse['rgb'])
    overflow_resid = out_coarse.get('overflow_resid')
    per_sample = {k: unflatten(out_coarse[k]) for k in extra}
    if not fine_sampling:
        return _composite(sigma, rgb, ray_directions, depth_values,
                          per_sample, white_background, overflow_resid,
                          samples_sorted=True)

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

    out_fine = field(query_points_fine)
    if out_fine.get('overflow_resid') is not None:
        overflow_resid = (out_fine['overflow_resid']
                          if overflow_resid is None else
                          overflow_resid + out_fine['overflow_resid'])
    depth_values = torch.cat((depth_values, z_samples), dim=-1)
    sigma = torch.cat((sigma, unflatten(out_fine['sigma'])[..., 0]), dim=-1)
    rgb = torch.cat((rgb, unflatten(out_fine['rgb'])), dim=-2)
    for k in extra:
        per_sample[k] = torch.cat((per_sample[k], unflatten(out_fine[k])),
                                  dim=-2)

    return _composite(sigma, rgb, ray_directions, depth_values, per_sample,
                      white_background, overflow_resid)


def _composite(sigma, rgb, ray_directions, depth_values, per_sample,
               white_background, overflow_resid, samples_sorted=False
               ) -> RenderOutput:
    # Coordinates take the semantics slot, as in the JAX package.
    semantics = per_sample.get('coords', per_sample.get('semantics'))
    rgb_map, depth_map, mask, normal_map, semantic_map = \
        compositing.composite(sigma, rgb, ray_directions, depth_values,
                              normals=per_sample.get('normals'),
                              semantics=semantics,
                              white_background=white_background,
                              samples_sorted=samples_sorted)
    return RenderOutput(rgb=rgb_map, depth=depth_map, mask=mask,
                        normals=normal_map, semantics=semantic_map,
                        overflow_resid=overflow_resid)
