"""Small datasets in the reference's on-disk layout, drawn from a seed, for
the CLI's tests and smoke run (no dataset ships with the repository).

`write_p3d_car` writes both p3d_car splits as `data/datasets.py` reads
them (reference data/datasets.py:33-402, SETUP.md):

- train: `p3d/p3d_car/detections.npy` (an object array of {image_path,
  bbox, mask (COCO RLE)}) and `poses_estimated_singletpl_perspective.bin`
  (torch-saved {indices, z0, s, t, R}), images under
  `p3d/PASCAL3D+_release1.1/Images/car_imagenet/`;
- test: `p3d/p3d_sfm_image/img_anno/car_val.mat` (`images`: structs with
  rel_path, mask, bbox.{x1, y1, x2, y2}, 1-based), images under
  `p3d/PASCAL3D+_release1.1/Images/car_pascal/`.

Each image is a smooth background with an ellipse (the mask) in a bbox
of about half the image; PNG files, written by `image_io.write_png`, or
JPEG files (PASCAL3D+'s own format), written by PIL.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from nerf_from_image_tpu_torch.data import rle
from nerf_from_image_tpu_torch.data.image_io import write_png

IMAGES_DIR = os.path.join('p3d', 'PASCAL3D+_release1.1', 'Images')


def _image(rng: np.random.Generator, height: int, width: int
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(uint8 image (H, W, 3), uint8 mask (H, W), bbox [x1, y1, x2, y2],
    0-based inclusive)."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    phase = rng.uniform(0, 2 * np.pi, 3)
    background = 0.5 + 0.3 * np.sin(xx[..., None] / (7.0 + 5 * rng.random())
                                    + yy[..., None] / 11.0 + phase)
    cx, cy = rng.uniform(0.35, 0.65) * width, rng.uniform(0.35, 0.65) * height
    rx, ry = rng.uniform(0.2, 0.3) * width, rng.uniform(0.2, 0.3) * height
    inside = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0
    color = rng.uniform(0.1, 0.9, 3)
    shade = 0.8 + 0.2 * np.cos(xx[..., None] / 5.0)
    img = np.where(inside[..., None], color * shade, background)
    ys, xs = np.nonzero(inside)
    bbox = np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float64)
    return ((np.clip(img, 0, 1) * 255).round().astype(np.uint8),
            inside.astype(np.uint8), bbox)


def _write_image(path: str, img: np.ndarray) -> None:
    if path.endswith('.png'):
        write_png(path, img)
        return
    from PIL import Image
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path, quality=90)


def write_p3d_car(root: str, n_train: int, n_test: int,
                  size: Tuple[int, int] = (240, 320), seed: int = 0,
                  ext: str = 'png') -> None:
    """Writes `n_train` train and `n_test` test images of `size` (H, W)
    in p3d_car's layout under `root` (the CLI's --data_path), as `ext`
    files: 'png', or 'jpg' (quality 90, needs PIL)."""
    import scipy.io

    if ext not in ('png', 'jpg'):
        raise ValueError(f'ext must be png or jpg, got {ext!r}')
    rng = np.random.default_rng(seed)
    height, width = size
    dets = []
    for i in range(n_train):
        img, mask, bbox = _image(rng, height, width)
        rel = os.path.join(IMAGES_DIR, 'car_imagenet', f'train_{i:04d}.{ext}')
        _write_image(os.path.join(root, rel), img)
        dets.append({'image_path': rel, 'bbox': bbox,
                     'mask': rle.encode(np.asfortranarray(mask))})
    ddir = os.path.join(root, 'p3d', 'p3d_car')
    os.makedirs(ddir, exist_ok=True)
    np.save(os.path.join(ddir, 'detections.npy'),
            np.array(dets, dtype=object))
    theta = rng.uniform(-np.pi, np.pi, n_train)
    quats = np.stack((np.cos(theta / 2), np.zeros(n_train),
                      np.sin(theta / 2), np.zeros(n_train)), axis=-1)
    quats += rng.standard_normal((n_train, 4)) * 0.05
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    torch.save({
        'indices': torch.arange(n_train),
        'z0': torch.from_numpy(rng.uniform(0.6, 1.4, (n_train, 1))),
        's': torch.from_numpy(rng.uniform(1.5, 2.5, (n_train, 1))),
        't': torch.from_numpy(rng.uniform(-0.1, 0.1, (n_train, 2))),
        'R': torch.from_numpy(quats),
    }, os.path.join(ddir, 'poses_estimated_singletpl_perspective.bin'))

    images = []
    for i in range(n_test):
        img, mask, bbox = _image(rng, height, width)
        rel = f'car_pascal/test_{i:04d}.{ext}'
        _write_image(os.path.join(root, IMAGES_DIR, rel), img)
        x1, y1, x2, y2 = (bbox + 1).tolist()
        images.append({'rel_path': rel, 'mask': mask,
                       'bbox': {'x1': x1, 'y1': y1, 'x2': x2, 'y2': y2}})
    adir = os.path.join(root, 'p3d', 'p3d_sfm_image', 'img_anno')
    os.makedirs(adir, exist_ok=True)
    scipy.io.savemat(os.path.join(adir, 'car_val.mat'),
                     {'images': np.array(images, dtype=object)})
