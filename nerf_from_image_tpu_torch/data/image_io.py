"""Image reading and INTER_AREA resizing for the datasets, a copy of
`nerf_from_image_tpu/data/datasets.py:32-55` (which the port may not
import): cv2 first, PIL and its 8-bit box resize without it, as the JAX
package reads. `read_png` gives a read in uint8 levels; `write_png`
writes the 8-bit PNGs of the fixtures and logs with zlib and numpy alone.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'


def imread(path: str) -> np.ndarray:
    """Reads an RGB image in [0, 1] float64 (like skimage.io.imread/255)."""
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB if img.shape[2] == 3
                               else cv2.COLOR_BGRA2RGBA)
        return img.astype(np.float64) / 255.0
    from PIL import Image
    return np.asarray(Image.open(path)).astype(np.float64) / 255.0


def resize_area(img: np.ndarray, new_hw: Tuple[int, int]) -> np.ndarray:
    """cv2 INTER_AREA resize (reference datasets.py:153)."""
    if cv2 is not None:
        return cv2.resize(img, (new_hw[1], new_hw[0]),
                          interpolation=cv2.INTER_AREA)
    from PIL import Image
    mode_img = Image.fromarray((img * 255).astype(np.uint8))
    return np.asarray(
        mode_img.resize((new_hw[1], new_hw[0]),
                        Image.BOX)).astype(np.float64) / 255.0


def read_png(path: str) -> np.ndarray:
    """An 8-bit image as `imread` reads it, in uint8 levels."""
    img = imread(path) * 255.0
    if img.max(initial=0.0) > 255.0:
        raise ValueError(f'{path}: not an 8-bit image')
    return np.rint(img).astype(np.uint8)


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
