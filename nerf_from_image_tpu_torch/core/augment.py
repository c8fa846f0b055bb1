"""Random affine crops of images (PyTorch port of the image path of
`nerf_from_image_tpu/core/augment.py`).

Rotation, scale and translation drawn per sample and gated by a
probability `p`; the image is resampled with a bilinear warp, zeros
padding and align_corners=False (with the white-background -1 shift).
The inversion loss uses it for its 15 crops per image. Transforms are
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


def augment(generator: Optional[torch.Generator], img: torch.Tensor,
            p: float, white_background: bool, disable_scale: bool = False,
            cached_tform: Optional[AffineTransform] = None
            ) -> Tuple[torch.Tensor, AffineTransform]:
    """Draws (or reuses) a transform and applies it to the images.
    Returns (images, transform)."""
    tform = (cached_tform if cached_tform is not None else
             sample_transform(generator, img.shape[0], p, disable_scale))
    return augment_impl(img, tform, white_background), tform
