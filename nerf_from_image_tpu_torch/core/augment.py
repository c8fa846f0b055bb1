"""ADA-style augmentation: random affine transforms of images and the
matching camera poses (PyTorch port of
`nerf_from_image_tpu/core/augment.py`).

Rotation, scale and translation drawn per sample and gated by a
probability `p`; the image is resampled with a bilinear warp, zeros
padding and align_corners=False (with the white-background -1 shift), and
the pose and focal are compensated so that a render from them shows the
warped image. The inversion loss uses the image path for its 15 crops per
image; GAN training augments real images and all poses. Transforms are
drawn from an explicit `torch.Generator`; the JAX package draws other
numbers from its keys, so tests hand both the same transform.

`_grid_sample_zeros` is the plain version of the warp kernels in
`ops/csrc/warp.cu` (through `ops/warp.py`), forward and, by autograd,
backward.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from nerf_from_image_tpu_torch.core import pose as pose_lib


@dataclass
class AffineTransform:
    rot: torch.Tensor  # (B,)
    scale: torch.Tensor  # (B,)
    translation: torch.Tensor  # (B, 2)


def sample_transform(generator: torch.Generator, batch_size: int, p: float,
                     disable_scale: bool = False) -> AffineTransform:
    """Draws a transform per sample on the generator's device."""
    dev = generator.device

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    rot = (uniform(batch_size) - 0.5) * 2.0 * math.pi
    rot = rot * (uniform(batch_size) < p)
    if disable_scale:
        scale = torch.ones((batch_size,), device=dev)
    else:
        scale = torch.exp2(normal(batch_size) * 0.2)
        scale = 1.0 + (scale - 1.0) * (uniform(batch_size) < p).float()
    translation = normal(batch_size, 2) * 0.1
    translation = translation * (uniform(batch_size, 1) < p).float()
    return AffineTransform(rot=rot, scale=scale, translation=translation)


def _affine_mat(tform: AffineTransform) -> torch.Tensor:
    """(B, 2, 3) torch-convention affine matrix (rotation + translation)."""
    c, s = torch.cos(tform.rot), torch.sin(tform.rot)
    t = tform.translation
    row0 = torch.stack((c, -s, t[:, 0]), dim=-1)
    row1 = torch.stack((s, c, -t[:, 1]), dim=-1)
    return torch.stack((row0, row1), dim=1)


def _grid_sample_zeros(image: torch.Tensor,
                       grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample, zeros padding, align_corners=False.

    image: (B, C, H, W); grid: (B, H', W', 2) xy in [-1, 1]. Returns
    (B, C, H', W').
    """
    b, c, ih, iw = image.shape
    gh, gw = grid.shape[1], grid.shape[2]
    ix = ((grid[..., 0] + 1.0) * iw - 1.0) / 2.0
    iy = ((grid[..., 1] + 1.0) * ih - 1.0) / 2.0
    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    w_nw = (ix0 + 1.0 - ix) * (iy0 + 1.0 - iy)
    w_ne = (ix - ix0) * (iy0 + 1.0 - iy)
    w_sw = (ix0 + 1.0 - ix) * (iy - iy0)
    w_se = (ix - ix0) * (iy - iy0)
    img_flat = image.reshape(b, c, ih * iw).transpose(1, 2)

    def tap(yi, xi, w):
        valid = ((xi >= 0) & (xi <= iw - 1) & (yi >= 0) &
                 (yi <= ih - 1)).to(image.dtype)
        xc = xi.clamp(0, iw - 1).long()
        yc = yi.clamp(0, ih - 1).long()
        idx = (yc * iw + xc).reshape(b, gh * gw)
        vals = torch.take_along_dim(img_flat, idx[..., None], dim=1)
        return vals * (w * valid).reshape(b, -1, 1)

    out = (tap(iy0, ix0, w_nw) + tap(iy0, ix0 + 1, w_ne) +
           tap(iy0 + 1, ix0, w_sw) + tap(iy0 + 1, ix0 + 1, w_se))
    return out.transpose(1, 2).reshape(b, c, gh, gw)


def _affine_grid(mat: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """F.affine_grid(align_corners=False) for output size (h, w)."""
    dev = mat.device
    ys = (2.0 * torch.arange(h, device=dev) + 1.0) / h - 1.0
    xs = (2.0 * torch.arange(w, device=dev) + 1.0) / w - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')  # (h, w) each
    base = torch.stack((gx, gy, torch.ones_like(gx)), dim=-1)
    return torch.einsum('bij,hwj->bhwi', mat, base.to(mat.dtype))


def image_warp_grid(tform: AffineTransform, h: int, w: int) -> torch.Tensor:
    """The (B, h, w, 2) grid that the image is sampled with: scale applied
    multiplicatively, translation rotated back through the rotation
    block."""
    mat = _affine_mat(tform)
    mat_scaled = mat * tform.scale[:, None, None]
    t_rot = torch.einsum('bij,bj->bi', mat[:, :2, :2], mat_scaled[:, :, 2])
    mat_scaled = torch.cat((mat_scaled[:, :, :2], t_rot[..., None]), dim=-1)
    return _affine_grid(mat_scaled, h, w)


def augment_impl(img: torch.Tensor, tform: AffineTransform,
                 white_background: bool) -> torch.Tensor:
    """Applies a transform to images (B, C, H, W)."""
    grid = image_warp_grid(tform, img.shape[-2], img.shape[-1])
    if white_background:
        img = img - 1.0
    out = _grid_sample_zeros(img, grid)
    if white_background:
        out = out + 1.0
    return out


def augment_pose(pose: torch.Tensor, focal: Optional[torch.Tensor],
                 tform: AffineTransform
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The pose and focal that see the transformed image: the camera
    rolled by the rotation, the focal divided by the scale (an
    orthographic camera scales the matrix instead), and the camera shifted
    in its image plane by the translation."""
    mat = _affine_mat(tform)
    b = pose.shape[0]
    roll = torch.eye(4, dtype=pose.dtype, device=pose.device).repeat(b, 1, 1)
    roll[:, :2, :2] = mat[:, :2, :2]
    pose_new = pose @ roll.transpose(-2, -1)
    focal_out = None
    if focal is not None:
        focal_out = focal / tform.scale
    else:
        scale = torch.ones_like(pose_new)
        scale[:, :3, :3] = tform.scale[:, None, None]
        scale[:, 3, 3] = tform.scale
        pose_new = pose_new * scale
    cam_inv = pose_lib.invert_space(pose_new)
    if focal is not None:
        shift = tform.translation * (-cam_inv[:, 2:3, 3] /
                                     (2.0 * focal_out[:, None]))
    else:
        shift = tform.translation * pose_new[:, 3:4, 3]
    offset = torch.zeros_like(cam_inv)
    offset[:, :2, 3] = shift
    pose_out = pose_lib.invert_space(cam_inv - offset)
    if focal is None:
        scale = torch.ones_like(pose_out)
        scale[:, :3, :3] = pose_new[:, 3:4, 3:4]
        scale[:, 3, 3] = pose_new[:, 3, 3]
        pose_out = pose_out * scale
    return pose_out, focal_out


def augment(generator: Optional[torch.Generator],
            img: Optional[torch.Tensor], pose: Optional[torch.Tensor],
            focal: Optional[torch.Tensor], p: float, white_background: bool,
            disable_scale: bool = False,
            cached_tform: Optional[AffineTransform] = None
            ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                       Optional[torch.Tensor], AffineTransform]:
    """Draws (or reuses) a transform and applies it to the images
    (B, C, H, W) and/or the poses (B, 4, 4) and focals (B,), any of which
    may be None. Returns (images, poses, focals, transform)."""
    bs = img.shape[0] if img is not None else pose.shape[0]
    tform = (cached_tform if cached_tform is not None else
             sample_transform(generator, bs, p, disable_scale))
    if img is not None:
        img = augment_impl(img, tform, white_background)
    if pose is not None:
        pose, focal = augment_pose(pose, focal, tform)
    return img, pose, focal, tform
