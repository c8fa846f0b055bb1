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

`write_cub` writes cub's train and test splits (reference
data/datasets.py:405-564): `cub/CUB_200_2011/images.txt` and
`image_class_labels.txt`, the images under `cub/CUB_200_2011/images/`,
`cub/data/{split}_cub_cleaned.mat` (`images`: structs with rel_path,
mask, bbox.{x1, y1, x2, y2}, 1-based) and `cub/sfm/anno_{split}.mat`
(`sfm_anno`: structs with the orthographic camera's scale, trans (2,)
in pixels and rot (3, 3)). `write_carla` writes `carla/<i>.png` with
`carla/carla_poses/<i>_extrinsics.npy` (3 x 4 camera-to-world, on a
sphere of radius 10 looking at the origin) and `intrinsics.npy`.

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


def _rotation(rng: np.random.Generator, max_elevation: float) -> np.ndarray:
    """A rotation by a random azimuth about y, then a random elevation
    about x."""
    az = rng.uniform(-np.pi, np.pi)
    el = rng.uniform(-max_elevation, max_elevation)
    ry = np.array([[np.cos(az), 0, np.sin(az)], [0, 1, 0],
                   [-np.sin(az), 0, np.cos(az)]])
    rx = np.array([[1, 0, 0], [0, np.cos(el), -np.sin(el)],
                   [0, np.sin(el), np.cos(el)]])
    return rx @ ry


def write_cub(root: str, n_train: int, n_test: int,
              size: Tuple[int, int] = (240, 320), seed: int = 0) -> None:
    """Writes `n_train` train and `n_test` test images of `size` (H, W) in
    cub's layout under `root` (the CLI's --data_path), as PNG files, with
    an orthographic SfM camera each. Each split needs at least 2 images
    (scipy squeezes a struct array of one)."""
    import scipy.io

    if min(n_train, n_test) < 2:
        raise ValueError('write_cub needs at least 2 images a split')
    rng = np.random.default_rng(seed)
    height, width = size
    base = os.path.join(root, 'cub')
    data_dir = os.path.join(base, 'CUB_200_2011')
    ids, labels = [], []
    for split, n in (('train', n_train), ('test', n_test)):
        images, sfm = [], []
        for i in range(n):
            img, mask, bbox = _image(rng, height, width)
            cls = int(rng.integers(1, 4))
            rel = f'{cls:03d}.Bird_{cls}/{split}_{i:04d}.png'
            _write_image(os.path.join(data_dir, 'images', rel), img)
            ids.append(rel)
            labels.append(cls)
            x1, y1, x2, y2 = (bbox + 1).tolist()
            images.append({'rel_path': rel, 'mask': mask,
                           'bbox': {'x1': x1, 'y1': y1, 'x2': x2,
                                    'y2': y2}})
            sfm.append({
                'scale': rng.uniform(0.3, 0.45) * max(height, width),
                'trans': np.array([(bbox[0] + bbox[2]) / 2,
                                   (bbox[1] + bbox[3]) / 2]),
                'rot': _rotation(rng, 0.4)})
        for sub, name, key, rows in (('data', f'{split}_cub_cleaned.mat',
                                      'images', images),
                                     ('sfm', f'anno_{split}.mat',
                                      'sfm_anno', sfm)):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
            scipy.io.savemat(os.path.join(base, sub, name),
                             {key: np.array(rows, dtype=object)})
    with open(os.path.join(data_dir, 'images.txt'), 'w') as f:
        f.writelines(f'{i + 1} {rel}\n' for i, rel in enumerate(ids))
    with open(os.path.join(data_dir, 'image_class_labels.txt'), 'w') as f:
        f.writelines(f'{i + 1} {c}\n' for i, c in enumerate(labels))


def write_carla(root: str, n: int, size: int = 40, seed: int = 7) -> None:
    """Writes `n` square views of `size` pixels in carla's layout under
    `root`, each camera at distance 10 from the origin looking at it
    (scene range 3.0), with a focal of 1.4 times the size."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, 'carla')
    os.makedirs(os.path.join(base, 'carla_poses'), exist_ok=True)
    for i in range(n):
        img, _, _ = _image(rng, size, size)
        write_png(os.path.join(base, f'{i:05d}.png'), img)
        rot = _rotation(rng, 0.5)
        ext = np.zeros((3, 4))
        ext[:, :3] = rot
        ext[:, 3] = rot @ np.array([0.0, 0.0, 10.0])
        np.save(os.path.join(base, 'carla_poses',
                             f'{i:05d}_extrinsics.npy'), ext)
    f = 1.4 * size
    intr = np.zeros((1, 1, 3, 3))
    intr[0, 0] = [[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]]
    np.save(os.path.join(base, 'carla_poses', 'intrinsics.npy'), intr)
