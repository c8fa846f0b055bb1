"""StyleGAN2's 1-3-3-1 bilinear resampling (PyTorch port of
`nerf_from_image_tpu/ops/resample.py`).

The JAX package writes each op as shift-adds because a one-channel
depthwise convolution wastes the TPU's matrix unit; on the GPU the same
filter runs as a depthwise convolution over channels folded into the
batch. Filter: f = [1, 3, 3, 1] / 8 per axis, 2-D kernel outer(f, f).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

# The scaled filters the resampling ops apply, one per (gain, dtype,
# device): built once, so that a forward never copies a filter from the
# host (a copy that makes the host wait for the card).
_FILTERS: Dict[Tuple[float, torch.dtype, torch.device], torch.Tensor] = {}


def bilinear_filter(dtype=torch.float32, device=None) -> torch.Tensor:
    """The (4, 4) filter outer(f, f), summing to 1 (a new tensor)."""
    f = torch.tensor([1.0, 3.0, 3.0, 1.0], dtype=dtype, device=device)
    k = f[:, None] * f[None, :]
    return k / k.sum()


def _filter(gain: float, device: torch.device) -> torch.Tensor:
    """bilinear_filter() * gain on `device`, float32, cached. The values
    are exact in float32, so the cache changes no result."""
    key = (gain, torch.float32, device)
    k = _FILTERS.get(key)
    if k is None:
        k = (bilinear_filter() * gain).to(device)
        _FILTERS[key] = k
    return k


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
    return _depthwise(im, _filter(gain, im.device), False,
                      padding=2 if transpose else 1)


def upsample2d(im: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling (conv_transpose k4 s2 p1 with kernel * 4):
    (..., H, W) -> (..., 2H, 2W)."""
    return _depthwise(im, _filter(4.0, im.device), True, stride=2,
                      padding=1)


def downsample2d(im: torch.Tensor) -> torch.Tensor:
    """2x bilinear downsampling (conv k4 s2 p1):
    (..., H, W) -> (..., H / 2, W / 2)."""
    return _depthwise(im, _filter(1.0, im.device), False, stride=2,
                      padding=1)
