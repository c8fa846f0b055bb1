"""Plain PyTorch triplane sampler and its backward (the functions of TPU
kernels B1, B2 and B4), and a gather sampler that autograd differentiates
to any order.

Counterpart of `nerf_from_image_tpu/ops/triplane.py`: for points at
normalized [-1, 1] coordinates, the mean over the xy, xz and yz planes of
a bilinear sample with align_corners=True and a border clamp. In each
pair the first coordinate is the width (column) axis and the second the
height (row) axis.

The port keeps the planes channel-last, (B, 3, R, R, C), so that a 2x2 tap
is four contiguous C-vectors. This module holds the plain versions of the CUDA
kernels in `ops/csrc/triplane_sample.cu` (forward),
`ops/csrc/triplane_sample_grad.cu` (backward to the planes and the
coordinates) and `ops/csrc/triplane_sample_grad_planes.cu` (backward to
the planes only): the CPU path of `ops.triplane_cuda.sample_triplane`, and
what those kernels are held against on the card. The forward gathers
texels with `index_select` and sums the 12 taps in float32; the backward
is written out explicitly (scatter with `index_add_`) rather than left to
autograd, which would keep the (B, N, 12, C) float32 taps of a whole pass
alive.

`sample_triplane_gather` is the port of the JAX package's XLA sampler
(`pack_triplane` + `sample_packed_triplane`): ordinary differentiable
tensor ops, for the SDF regularizers whose eikonal term takes a gradient
of a gradient.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# (column coordinate, row coordinate) of planes xy, xz, yz.
PLANE_AXES = ((0, 1), (0, 2), (1, 2))
# Points per batch entry that the plain version takes at a time: bounds its
# (B, chunk, 3, 4, C) float32 taps to 800 MB at the flagship batch of 8.
CHUNK_POINTS = 1 << 16


def planes_channel_last(planes: torch.Tensor) -> torch.Tensor:
    """(B, 3, C, R, R) synthesis layout -> contiguous (B, 3, R, R, C)."""
    return planes.permute(0, 1, 3, 4, 2).contiguous()


def _axis(g: torch.Tensor, r: int):
    """Normalized coordinate -> (unclamped texel coordinate, lower and upper
    texel index, fraction) along one axis of an (R, R) plane."""
    raw = (g + 1.0) * 0.5 * (r - 1)
    i = raw.clamp(0.0, r - 1.0)
    i0 = torch.floor(i)
    lo = i0.long().clamp(0, r - 1)
    return raw, lo, (lo + 1).clamp_max(r - 1), i - i0


def _clamp_slope(raw: torch.Tensor, r: int) -> torch.Tensor:
    """d(clamped texel coordinate) / d(normalized coordinate).

    (R - 1) / 2 inside the plane and 0 where the border clamp holds. At a
    coordinate exactly on the border it is half that, the mean of the two
    one-sided slopes, as JAX differentiates its clip.
    """
    inside = ((raw > 0) & (raw < r - 1)).float()
    edge = ((raw == 0) | (raw == r - 1)).float()
    return (inside + 0.5 * edge) * (0.5 * (r - 1))


def _taps(x_axis, y_axis, r: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_axis` of both coordinates -> (texel offsets (..., 4) of the 2x2
    tap, weights (..., 4)).

    Offsets count texels within one (R, R) plane; the taps are ordered
    (y0, x0), (y0, x1), (y1, x0), (y1, x1).
    """
    _, xi, x1, fx = x_axis
    _, yi, y1, fy = y_axis
    offsets = torch.stack((yi * r + xi, yi * r + x1, y1 * r + xi,
                           y1 * r + x1), dim=-1)
    weights = torch.stack(((1 - fx) * (1 - fy), fx * (1 - fy),
                           (1 - fx) * fy, fx * fy), dim=-1)
    return offsets, weights


def _index_weights(gx: torch.Tensor, gy: torch.Tensor, r: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coords -> (texel offsets (..., 4), weights (..., 4)); see `_taps`."""
    return _taps(_axis(gx, r), _axis(gy, r), r)


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


def sample_triplane_grad_plain(planes_cl: torch.Tensor, coords: torch.Tensor,
                               grad_out: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of `sample_triplane_plain`, written out.

    Args:
      planes_cl: (B, 3, R, R, C) channel-last planes.
      coords: (B, N, 3) float32 coordinates.
      grad_out: (B, N, C) cotangent of the sampled features.

    Returns:
      dplanes: (B, 3, R, R, C) in the planes' dtype: each point's 12
        bilinear-weighted cotangents (divided by 3), summed in float32.
      dcoords: (B, N, 3) float32: per plane, the tap differences along
        each axis times (R - 1) / 2 (zero where the border clamp holds),
        summed onto that plane's two coordinates.
    """
    b, _, r, _, c = planes_cl.shape
    n = coords.shape[1]
    table = planes_cl.reshape(-1, c)
    dtable = torch.zeros(table.shape, dtype=torch.float32,
                         device=planes_cl.device)
    dcoords = torch.empty((b, n, 3), dtype=torch.float32,
                          device=coords.device)
    for start in range(0, n, CHUNK_POINTS):
        pts = coords[:, start:start + CHUNK_POINTS].float()
        g = grad_out[:, start:start + CHUNK_POINTS].float() / 3.0
        dc = torch.zeros_like(pts)
        for p, (i, j) in enumerate(PLANE_AXES):
            x_axis, y_axis = _axis(pts[..., i], r), _axis(pts[..., j], r)
            raw_x, _, _, fx = x_axis
            raw_y, _, _, fy = y_axis
            rows, weights = _taps(x_axis, y_axis, r)
            rows = rows + ((torch.arange(b, device=coords.device) * 3 + p) *
                           r * r)[:, None, None]
            dtable.index_add_(0, rows.reshape(-1),
                              (weights[..., None] *
                               g[:, :, None, :]).reshape(-1, c))
            taps = table.index_select(0, rows.reshape(-1)).float()
            tg = (taps.reshape(rows.shape + (c,)) *
                  g[:, :, None, :]).sum(dim=-1)
            t00, t01, t10, t11 = tg.unbind(dim=-1)
            dc[..., i] += (((1 - fy) * (t01 - t00) + fy * (t11 - t10)) *
                           _clamp_slope(raw_x, r))
            dc[..., j] += (((1 - fx) * (t10 - t00) + fx * (t11 - t01)) *
                           _clamp_slope(raw_y, r))
        dcoords[:, start:start + CHUNK_POINTS] = dc
    return dtable.reshape(planes_cl.shape).to(planes_cl.dtype), dcoords


def sample_triplane_grad_planes_plain(plane_shape: Sequence[int],
                                      coords: torch.Tensor,
                                      grad_out: torch.Tensor) -> torch.Tensor:
    """The planes half of `sample_triplane_grad_plain`; never reads the
    planes.

    Args:
      plane_shape: (B, 3, R, R, C), the shape of the channel-last planes.
      coords: (B, N, 3) float32 coordinates.
      grad_out: (B, N, C) cotangent of the sampled features.

    Returns:
      dplanes: (B, 3, R, R, C) float32, each point's 12 bilinear-weighted
      cotangents (divided by 3) summed in the same order as
      `sample_triplane_grad_plain`.
    """
    b, _, r, _, c = plane_shape
    n = coords.shape[1]
    dtable = torch.zeros((b * 3 * r * r, c), dtype=torch.float32,
                         device=coords.device)
    for start in range(0, n, CHUNK_POINTS):
        pts = coords[:, start:start + CHUNK_POINTS].float()
        g = grad_out[:, start:start + CHUNK_POINTS].float() / 3.0
        for p, (i, j) in enumerate(PLANE_AXES):
            rows, weights = _index_weights(pts[..., i], pts[..., j], r)
            rows = rows + ((torch.arange(b, device=coords.device) * 3 + p) *
                           r * r)[:, None, None]
            dtable.index_add_(0, rows.reshape(-1),
                              (weights[..., None] *
                               g[:, :, None, :]).reshape(-1, c))
    return dtable.reshape(tuple(plane_shape))


def _gather_weights(g: torch.Tensor, r: int):
    """`_axis` written with differentiable ops: (lower and upper texel
    index, fraction). The clamp is torch.maximum/minimum against tensors,
    which give half the slope at a tie as JAX's clip does."""
    raw = (g + 1.0) * 0.5 * (r - 1)
    i = torch.minimum(torch.maximum(raw, raw.new_zeros(())),
                      raw.new_full((), r - 1.0))
    i0 = torch.floor(i).detach()
    lo = i0.long().clamp(0, r - 1)
    return lo, (lo + 1).clamp_max(r - 1), i - i0


def sample_triplane_gather(planes_cl: torch.Tensor,
                           coords: torch.Tensor) -> torch.Tensor:
    """Averaged triplane features at normalized 3D coords, differentiable
    by autograd to any order in the planes and the coords.

    The port of the JAX package's XLA sampler
    (`nerf_from_image_tpu/ops/triplane.py:sample_packed_triplane`): a
    gather of the 12 taps with `index_select`, multiplied by their
    bilinear weights and summed in the planes' dtype, as JAX does.

    Args:
      planes_cl: (B, 3, R, R, C) channel-last planes.
      coords: (B, N, 3) coordinates in [-1, 1] (outside: border clamp).

    Returns:
      (B, N, C) in the dtype of the planes.
    """
    b, _, r, _, c = planes_cl.shape
    n = coords.shape[1]
    table = planes_cl.reshape(-1, c)
    weighted = []
    for p, (i, j) in enumerate(PLANE_AXES):
        xi, x1, fx = _gather_weights(coords[..., i], r)
        yi, y1, fy = _gather_weights(coords[..., j], r)
        rows, weights = _taps((None, xi, x1, fx), (None, yi, y1, fy), r)
        rows = rows + ((torch.arange(b, device=coords.device) * 3 + p) *
                       r * r)[:, None, None]
        taps = table.index_select(0, rows.reshape(-1)).reshape(b, n, 4, c)
        weighted.append(taps * weights.to(taps.dtype)[..., None])
    return torch.stack(weighted, dim=2).sum(dim=(2, 3)) / 3.0


class TriplaneSample(torch.autograd.Function):
    """Differentiable triplane sample around a forward function and two
    backward functions with the signatures of `sample_triplane_plain`,
    `sample_triplane_grad_plain` and `sample_triplane_grad_planes_plain`
    (the plain versions, or the wrappers of the CUDA kernels).

    When the coordinates need no gradient and the planes do, the backward
    runs the planes-only function and the forward saves only the
    coordinates; otherwise it runs the full backward. It returns None for
    an input that needs no gradient."""

    @staticmethod
    def forward(ctx, planes_cl, coords, forward_fn, grad_fn,
                grad_planes_fn):
        if ctx.needs_input_grad[1]:
            ctx.save_for_backward(planes_cl, coords)
        else:
            ctx.save_for_backward(coords)
        ctx.plane_shape = tuple(planes_cl.shape)
        ctx.plane_dtype = planes_cl.dtype
        ctx.grad_fn = grad_fn
        ctx.grad_planes_fn = grad_planes_fn
        return forward_fn(planes_cl, coords)

    @staticmethod
    def backward(ctx, grad_out):
        want_planes, want_coords = ctx.needs_input_grad[:2]
        if not (want_planes or want_coords):
            return None, None, None, None, None
        grad_out = grad_out.contiguous()
        if not want_coords:
            coords, = ctx.saved_tensors
            dplanes = ctx.grad_planes_fn(ctx.plane_shape, coords, grad_out)
            return dplanes.to(ctx.plane_dtype), None, None, None, None
        planes_cl, coords = ctx.saved_tensors
        dplanes, dcoords = ctx.grad_fn(planes_cl, coords, grad_out)
        return (dplanes if want_planes else None, dcoords, None, None, None)


def plain_sampler(planes_cl: torch.Tensor,
                  coords: torch.Tensor) -> torch.Tensor:
    """`sample_triplane_plain` with `sample_triplane_grad_plain` and
    `sample_triplane_grad_planes_plain` as its backward, on any device:
    what the CUDA kernels are held against in a differentiated render."""
    return TriplaneSample.apply(planes_cl, coords, sample_triplane_plain,
                                sample_triplane_grad_plain,
                                sample_triplane_grad_planes_plain)
