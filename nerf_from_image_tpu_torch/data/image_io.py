"""Image reading and area resizing for the datasets, without OpenCV.

The JAX package reads images with cv2 (or PIL) and resizes them with
cv2's INTER_AREA (`nerf_from_image_tpu/data/datasets.py:32-55`). The
port reads 8-bit PNG itself (stdlib zlib and numpy; gray, gray + alpha,
RGB, RGBA and palette images, non-interlaced, filters 0-4) and JPEG
through PIL when PIL is importable; any other file raises. `resize_area`
is cv2's INTER_AREA in numpy, in both directions:

- shrinking (both factors >= 1) averages over each output pixel's
  fractional footprint, with the weights cv2 tabulates (float32);
- enlarging (either factor < 1) is cv2's linear branch with the weights
  its INTER_AREA mode derives from the cell areas, rows and columns
  clamped at the border.

Both are separable, so a resize is one weight matrix per axis.
`write_png` writes the 8-bit PNGs that the test fixtures read back.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# Channels per PNG color type: gray, RGB, palette, gray + alpha, RGBA.
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def imread(path: str) -> np.ndarray:
    """An image in [0, 1] float64: (H, W) gray, (H, W, 3) RGB or (H, W, 4)
    RGBA (gray + alpha comes back as RGBA, a palette image as RGB, as cv2
    reads them)."""
    with open(path, 'rb') as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        return read_png(path).astype(np.float64) / 255.0
    if head[:3] == b'\xff\xd8\xff':
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(f'{path} is a JPEG, which needs PIL '
                               '(the port reads PNG itself)') from e
        with Image.open(path) as im:
            return np.asarray(im).astype(np.float64) / 255.0
    raise ValueError(f'{path}: not a PNG or JPEG file')


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _paeth_or_average(kind: int, cur: bytearray, prev: bytes,
                      bpp: int) -> None:
    """Undoes filter 3 (average) or 4 (paeth) of one scanline in place:
    each byte depends on the one just left of it, so it is a loop."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        kind = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
                   % 256).astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            _paeth_or_average(kind, buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f'PNG filter type {kind} in row {y}')
        rows[y] = cur
        prev = rows[y]
    return rows


def read_png(path: str) -> np.ndarray:
    """An 8-bit PNG as uint8: (H, W) gray, (H, W, 3) RGB (palette images
    too) or (H, W, 4) RGBA (gray + alpha too)."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f'{path}: not a PNG file')
    header, idat, palette, transparency = None, [], None, None
    for kind, body in _chunks(data):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b'tRNS':
            transparency = body
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None:
        raise ValueError(f'{path}: PNG without IHDR')
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(f'{path}: only 8-bit non-interlaced PNGs are read '
                         f'(bit depth {depth}, color type {color}, '
                         f'interlace {interlace})')
    if transparency is not None:
        raise ValueError(f'{path}: PNG transparency chunks are not read')
    channels = _PNG_CHANNELS[color]
    rows = _unfilter(zlib.decompress(b''.join(idat)), height,
                     width * channels, channels)
    img = rows.reshape(height, width, channels)
    if color == 0:
        return img[..., 0]
    if color == 3:
        if palette is None:
            raise ValueError(f'{path}: palette PNG without PLTE')
        return palette[img[..., 0]]
    if color == 4:
        return np.concatenate((np.repeat(img[..., :1], 3, axis=2),
                               img[..., 1:]), axis=2)
    return img


def write_png(path: str, img: np.ndarray) -> None:
    """Writes uint8 (H, W), (H, W, 3) or (H, W, 4) as an 8-bit PNG (gray,
    RGB or RGBA), every row unfiltered."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    height, width, channels = img.shape
    color = {1: 0, 3: 2, 4: 6}[channels]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack('>I', len(body)) + kind + body +
                struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))

    raw = np.concatenate((np.zeros((height, 1), np.uint8),
                          img.reshape(height, -1)), axis=1)
    data = (PNG_SIGNATURE +
            chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8, color,
                                       0, 0, 0)) +
            chunk(b'IDAT', zlib.compress(raw.tobytes(), 6)) +
            chunk(b'IEND', b''))
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, 'wb') as f:
        f.write(data)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _area_weights(ssize: int, dsize: int, scale: float) -> np.ndarray:
    """(dsize, ssize) weights of cv2's area decimation along one axis
    (`computeResizeAreaTab`): each output cell's fractional overlap with
    the input pixels over the cell's width, as float32 values."""
    weights = np.zeros((dsize, ssize))
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        if sx1 - fsx1 > 1e-3:
            weights[dx, sx1 - 1] = _f32((sx1 - fsx1) / cell)
        weights[dx, sx1:sx2] = _f32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            weights[dx, sx2] = _f32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return weights


def _linear_area_weights(ssize: int, dsize: int, scale: float,
                         inv_scale: float) -> np.ndarray:
    """(dsize, ssize) weights of cv2's linear branch in INTER_AREA mode
    along one axis: two taps at floor(d * scale), the second weighted by
    the fractional part of (d + 1) - (s + 1) / scale (float32), the taps
    clamped to the last pixel."""
    weights = np.zeros((dsize, ssize))
    for dx in range(dsize):
        sx = math.floor(dx * scale)
        fx = np.float32((dx + 1) - (sx + 1) * inv_scale)
        fx = 0.0 if fx <= 0 else float(fx - np.floor(fx))
        if sx >= ssize - 1:
            fx, sx = 0.0, ssize - 1
        weights[dx, sx] += _f32(1.0 - fx)
        if fx:
            weights[dx, min(sx + 1, ssize - 1)] += fx
    return weights


def resize_area(img: np.ndarray, new_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (new_hw[1], new_hw[0]), interpolation=INTER_AREA)
    for a float image (H, W) or (H, W, C), computed in float64 and
    returned in the input's dtype; like cv2, a single channel comes back
    as (H', W')."""
    img = np.asarray(img)
    if not np.issubdtype(img.dtype, np.floating):
        raise TypeError(f'resize_area takes float images, got {img.dtype}')
    src = img if img.ndim == 3 else img[..., None]
    h, w = src.shape[:2]
    dh, dw = int(new_hw[0]), int(new_hw[1])
    if (dh, dw) == (h, w):
        out = src.astype(np.float64)
    else:
        inv_sx, inv_sy = dw / w, dh / h
        sx, sy = 1.0 / inv_sx, 1.0 / inv_sy
        if sx >= 1 and sy >= 1:
            wx, wy = _area_weights(w, dw, sx), _area_weights(h, dh, sy)
        else:
            wx = _linear_area_weights(w, dw, sx, inv_sx)
            wy = _linear_area_weights(h, dh, sy, inv_sy)
        out = np.einsum('yh,hwc,xw->yxc', wy, src.astype(np.float64), wx,
                        optimize=True)
    if out.shape[2] == 1:
        out = out[..., 0]
    return out.astype(img.dtype)
