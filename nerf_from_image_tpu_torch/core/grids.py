"""Stratified volume samples and the separable progressive blur (PyTorch
port of the parts of `nerf_from_image_tpu/core/grids.py` that GAN training
uses).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

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


def filter2d_separable(im: torch.Tensor,
                       kernel1d: torch.Tensor) -> torch.Tensor:
    """Depthwise 2D filter with a separable 1D kernel, 'same' zero padding.

    im: (B, C, H, W); kernel1d: (K,), K odd. Two 1-D depthwise convs.
    """
    b, c, h, w = im.shape
    k = kernel1d.shape[0]
    pad = k // 2
    x = im.reshape(b * c, 1, h, w)
    kernel = kernel1d.to(im.dtype)
    x = F.conv2d(x, kernel.reshape(1, 1, k, 1), padding=(pad, 0))
    x = F.conv2d(x, kernel.reshape(1, 1, 1, k), padding=(0, pad))
    return x.reshape(b, c, h, w)


def blur_kernel_1d(iteration: int, blur_warmup_iters: int,
                   device: Optional[torch.device] = None
                   ) -> Optional[torch.Tensor]:
    """Progressive-blur kernel for the iteration, or None once inactive.

    sigma = max(1 - i / warmup, 0) * 10; taps exp2(-(x / sigma)^2) for
    |x| <= floor(3 sigma), normalized.
    """
    blur_sigma = max(1.0 - iteration / blur_warmup_iters, 0.0) * 10.0
    blur_size = int(blur_sigma * 3.0) if blur_sigma > 0 else 0
    if blur_size <= 0:
        return None
    x = torch.arange(-blur_size, blur_size + 1, dtype=torch.float32,
                     device=device)
    f = torch.exp2(-(x / blur_sigma).square())
    return f / f.sum()


def blur(image: torch.Tensor, kernel1d: Optional[torch.Tensor],
         white_background: bool) -> torch.Tensor:
    """Applies the progressive warmup blur; identity if kernel is None.
    A white background blurs the image shifted by -1 (white -> 0)."""
    if kernel1d is None:
        return image
    if white_background:
        image = image - 1.0
    image = filter2d_separable(image, kernel1d)
    if white_background:
        image = image + 1.0
    return image
