"""Image metrics: PSNR, SSIM, IoU on torch tensors (PyTorch port of
`nerf_from_image_tpu/metrics/image.py`).

- PSNR: MSE over CHW of [0, 1]-clamped images, each image capped at 60 dB.
- SSIM: skimage's `structural_similarity` defaults (uniform 7x7 window,
  reflect padding, data_range 1, K1 0.01, K2 0.03, unbiased covariance,
  the window's half-width cropped before the mean).
- IoU: both masks cut at 0.5, (|inter| + eps) / (|union| + eps).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor,
         reduction: str = 'mean') -> torch.Tensor:
    """pred, target: (B, C, H, W) or (B, H, W, C) in [0, 1]."""
    if pred.shape != target.shape or pred.ndim != 4:
        raise ValueError(f'psnr takes two equal 4-D shapes, got '
                         f'{tuple(pred.shape)} and {tuple(target.shape)}')
    mse = (pred.clamp(0.0, 1.0) - target.clamp(0.0, 1.0)).square().mean(
        dim=(1, 2, 3))
    out = (-10.0 * torch.log10(mse)).clamp_max(60.0)
    return out.mean() if reduction == 'mean' else out


def _uniform_filter_2d(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean over a size x size window with reflect padding, (..., H, W)."""
    pad = size // 2
    shape = x.shape
    xp = F.pad(x.reshape(-1, 1, shape[-2], shape[-1]),
               (pad, pad, pad, pad), mode='reflect')
    box = torch.full((1, 1, size, 1), 1.0 / size, dtype=x.dtype,
                     device=x.device)
    out = F.conv2d(F.conv2d(xp, box.transpose(2, 3)), box)
    return out.reshape(shape)


def ssim(pred: torch.Tensor, target: torch.Tensor,
         reduction: str = 'mean') -> torch.Tensor:
    """SSIM with skimage's defaults; pred, target: (B, 3, H, W) in [0, 1].

    reduction='mean' averages over the whole batch as one stack; 'none'
    returns one value per image.
    """
    if pred.shape != target.shape or pred.ndim != 4:
        raise ValueError(f'ssim takes two equal 4-D shapes, got '
                         f'{tuple(pred.shape)} and {tuple(target.shape)}')
    pred = pred.clamp(0.0, 1.0)
    target = target.clamp(0.0, 1.0)
    win = 7
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    n = win * win
    cov_norm = n / (n - 1.0)
    ux = _uniform_filter_2d(pred, win)
    uy = _uniform_filter_2d(target, win)
    uxx = _uniform_filter_2d(pred * pred, win)
    uyy = _uniform_filter_2d(target * target, win)
    uxy = _uniform_filter_2d(pred * target, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))
    pad = win // 2
    s = s[..., pad:-pad, pad:-pad]
    return s.mean() if reduction == 'mean' else s.mean(dim=(1, 2, 3))


def iou(alpha_pred: torch.Tensor, alpha_real: torch.Tensor,
        reduction: str = 'mean') -> torch.Tensor:
    """alpha_*: (B, H, W) or (B, 1, H, W) in [0, 1]."""
    p = alpha_pred > 0.5
    r = alpha_real > 0.5
    inter = (p & r).float().sum(dim=(-2, -1))
    union = (p | r).float().sum(dim=(-2, -1))
    eps = 1e-6
    out = (inter + eps) / (union + eps)
    return out.mean() if reduction == 'mean' else out.reshape(-1)
