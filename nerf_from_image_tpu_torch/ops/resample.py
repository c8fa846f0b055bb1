"""StyleGAN2's 1-3-3-1 bilinear resampling (PyTorch port of
`nerf_from_image_tpu/ops/resample.py`).

The JAX package writes each op as shift-adds because a one-channel
depthwise convolution wastes the TPU's matrix unit; on the GPU the same
filter runs as a depthwise convolution over channels folded into the
batch. Filter: f = [1, 3, 3, 1] / 8 per axis, 2-D kernel outer(f, f).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_filter(dtype=torch.float32, device=None) -> torch.Tensor:
    """The (4, 4) filter outer(f, f), summing to 1."""
    f = torch.tensor([1.0, 3.0, 3.0, 1.0], dtype=dtype, device=device)
    k = f[:, None] * f[None, :]
    return k / k.sum()


def _depthwise(im: torch.Tensor, kernel: torch.Tensor, transpose: bool,
               **kwargs) -> torch.Tensor:
    """Applies a (4, 4) kernel to every channel of (..., H, W)."""
    lead, (h, w) = im.shape[:-2], im.shape[-2:]
    x = im.reshape(-1, 1, h, w)
    k = kernel.to(im.dtype)[None, None]
    op = F.conv_transpose2d if transpose else F.conv2d
    y = op(x, k, **kwargs)
    return y.reshape(lead + y.shape[-2:])


def filter2d(im: torch.Tensor, gain: float = 1.0,
             transpose: bool = False) -> torch.Tensor:
    """4x4 bilinear filter, stride 1: H -> H - 1, or H -> H + 1 with
    `transpose` (the filter is symmetric, so its transpose is the same
    correlation with wider zero padding)."""
    kernel = bilinear_filter(device=im.device) * gain
    return _depthwise(im, kernel, False, padding=2 if transpose else 1)


def upsample2d(im: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling (conv_transpose k4 s2 p1 with kernel * 4):
    (..., H, W) -> (..., 2H, 2W)."""
    kernel = bilinear_filter(device=im.device) * 4.0
    return _depthwise(im, kernel, True, stride=2, padding=1)


def downsample2d(im: torch.Tensor) -> torch.Tensor:
    """2x bilinear downsampling (conv k4 s2 p1):
    (..., H, W) -> (..., H / 2, W / 2)."""
    return _depthwise(im, bilinear_filter(device=im.device), False,
                      stride=2, padding=1)
