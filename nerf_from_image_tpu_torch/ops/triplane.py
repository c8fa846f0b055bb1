"""Plain PyTorch triplane sampler (the function of TPU kernel B1).

Counterpart of `nerf_from_image_tpu/ops/triplane.py`: for points at
normalized [-1, 1] coordinates, the mean over the xy, xz and yz planes of
a bilinear sample with align_corners=True and a border clamp. In each
pair the first coordinate is the width (column) axis and the second the
height (row) axis.

The port keeps the planes channel-last, (B, 3, R, R, C), so that a 2x2 tap
is four contiguous C-vectors. This module is the plain version of the CUDA
kernel in `ops/csrc/triplane_sample.cu`: the CPU path of
`ops.triplane_cuda.sample_triplane`, and what that kernel is held against
on the card. It gathers texels with `index_select` and sums the 12 taps in
float32.
"""

from __future__ import annotations

from typing import Tuple

import torch

# (column coordinate, row coordinate) of planes xy, xz, yz.
PLANE_AXES = ((0, 1), (0, 2), (1, 2))
# Points per batch entry that the plain version takes at a time: bounds its
# (B, chunk, 3, 4, C) float32 taps to 800 MB at the flagship batch of 8.
CHUNK_POINTS = 1 << 16


def planes_channel_last(planes: torch.Tensor) -> torch.Tensor:
    """(B, 3, C, R, R) synthesis layout -> contiguous (B, 3, R, R, C)."""
    return planes.permute(0, 1, 3, 4, 2).contiguous()


def _index_weights(gx: torch.Tensor, gy: torch.Tensor, r: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coords -> (texel offsets (..., 4) of the 2x2 tap, weights (..., 4)).

    Offsets count texels within one (R, R) plane; the taps are ordered
    (y0, x0), (y0, x1), (y1, x0), (y1, x1).
    """
    ix = ((gx + 1.0) * 0.5 * (r - 1)).clamp(0.0, r - 1.0)
    iy = ((gy + 1.0) * 0.5 * (r - 1)).clamp(0.0, r - 1.0)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    fx = ix - x0
    fy = iy - y0
    xi = x0.long().clamp(0, r - 1)
    yi = y0.long().clamp(0, r - 1)
    x1 = (xi + 1).clamp_max(r - 1)
    y1 = (yi + 1).clamp_max(r - 1)
    offsets = torch.stack((yi * r + xi, yi * r + x1, y1 * r + xi,
                           y1 * r + x1), dim=-1)
    weights = torch.stack(((1 - fx) * (1 - fy), fx * (1 - fy),
                           (1 - fx) * fy, fx * fy), dim=-1)
    return offsets, weights


def tap_offsets(planes_cl: torch.Tensor, coords: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All 12 taps of every point, as rows of planes_cl.reshape(-1, C).

    Returns (rows (B, N, 3, 4) int64, weights (B, N, 3, 4) float32).
    """
    b, _, r, _, _ = planes_cl.shape
    pts = coords.float()
    rows, weights = [], []
    for p, (i, j) in enumerate(PLANE_AXES):
        off, w = _index_weights(pts[..., i], pts[..., j], r)
        base = (torch.arange(b, device=coords.device) * 3 + p) * r * r
        rows.append(off + base[:, None, None])
        weights.append(w)
    return torch.stack(rows, dim=2), torch.stack(weights, dim=2)


def sample_triplane_plain(planes_cl: torch.Tensor,
                          coords: torch.Tensor) -> torch.Tensor:
    """Averaged triplane features at normalized 3D coords.

    Args:
      planes_cl: (B, 3, R, R, C) channel-last planes.
      coords: (B, N, 3) coordinates in [-1, 1] (outside: border clamp).

    Returns:
      (B, N, C) in the dtype of the planes; the taps are summed in
      float32.
    """
    b, _, _, _, c = planes_cl.shape
    n = coords.shape[1]
    table = planes_cl.reshape(-1, c)
    out = torch.empty((b, n, c), dtype=planes_cl.dtype,
                      device=planes_cl.device)
    for start in range(0, n, CHUNK_POINTS):
        pts = coords[:, start:start + CHUNK_POINTS]
        rows, weights = tap_offsets(planes_cl, pts)
        taps = table.index_select(0, rows.reshape(-1)).float()
        taps = taps.reshape(rows.shape + (c,))
        feats = (taps * weights[..., None]).sum(dim=(2, 3)) / 3.0
        out[:, start:start + CHUNK_POINTS] = feats.to(out.dtype)
    return out
