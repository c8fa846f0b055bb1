#!/usr/bin/env python3
"""Whether the port's two JPEG readers give the same pixels on this
machine: cv2, which `data/image_io.imread` calls as the JAX package does
(`nerf_from_image_tpu/data/datasets.py:32-43`), and PIL, its fallback
without cv2 (the JAX package's own branch without cv2).

Writes JPEG files with PIL (RGB at odd and even sizes and a gray image;
qualities 50-100; 4:2:0, 4:2:2 and 4:4:4 chroma; baseline and
progressive) and one RGB file with cv2's own encoder, decodes each with
`image_io.imread` through cv2 and through the PIL fallback, and prints
the versions, the number of files whose pixels differ and the largest
difference in 8-bit levels as one JSON line. Exits 1 when cv2 or PIL is
missing.

Needs no card and no JAX (a few seconds):

    python3 probes/jpeg_decoders.py
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from nerf_from_image_tpu_torch.data import image_io  # noqa: E402

SHAPES = ((16, 24, 3), (17, 23, 3), (101, 77, 3), (375, 500, 3), (33, 45))
# (quality, subsampling (0 4:4:4, 1 4:2:2, 2 4:2:0), progressive)
MODES = ((50, 2, False), (75, 2, True), (90, 1, False), (95, 0, False),
         (100, 0, False))


def _image(rng: np.random.Generator, shape) -> np.ndarray:
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.sin(xx / 6.0 + yy / 9.0)[..., None] * 0.4 + 0.5
    img = np.clip(smooth * np.linspace(0.5, 1.0, 3) +
                  rng.normal(0, 0.1, (h, w, 3)), 0, 1)
    return ((img[..., 0] if len(shape) == 2 else img) * 255).astype(np.uint8)


def _pil_read(path: str) -> np.ndarray:
    """`image_io.imread` through its fallback, as without cv2."""
    cv2, image_io.cv2 = image_io.cv2, None
    try:
        return image_io.imread(path)
    finally:
        image_io.cv2 = cv2


def main() -> int:
    try:
        import cv2
        import PIL
        from PIL import Image
    except ImportError as e:
        print(json.dumps({'error': str(e)}))
        return 1
    rng = np.random.default_rng(0)
    n_files, n_differ, max_levels = 0, 0, 0.0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'a.jpg')
        cases = [(shape, mode) for shape in SHAPES for mode in MODES]
        cases.append(((64, 48, 3), None))  # cv2's encoder, quality 90
        for shape, mode in cases:
            img = _image(rng, shape)
            if mode is None:
                cv2.imwrite(path, img[..., ::-1],
                            [cv2.IMWRITE_JPEG_QUALITY, 90])
            else:
                quality, subsampling, progressive = mode
                Image.fromarray(img).save(
                    path, quality=quality, subsampling=subsampling,
                    progressive=progressive, optimize=progressive)
            got, ref = image_io.imread(path), _pil_read(path)
            n_files += 1
            if got.shape != ref.shape or not np.array_equal(got, ref):
                n_differ += 1
                if got.shape == ref.shape:
                    max_levels = max(max_levels,
                                     float(np.abs(got - ref).max()) * 255)
    print(json.dumps({'cv2': cv2.__version__, 'PIL': PIL.__version__,
                      'files': n_files, 'files_that_differ': n_differ,
                      'max_abs_diff_levels': max_levels}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
