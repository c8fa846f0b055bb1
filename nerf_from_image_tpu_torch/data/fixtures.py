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
in pixels and rot (3, 3)). `write_imagenet` writes an ImageNet dataset
(`imagenet/<dataset>/`: detections, the multi-template poses, JPEG
images) and `write_shapenet` SRN ShapeNet's multi-view layout (RGBA
views of a sphere on white, a pose file each). `write_carla` writes `carla/<i>.png` with
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


def _write_detections(root: str, det_dir: str, image_dir: str,
                      poses_name: str, n: int, size: Tuple[int, int],
                      rng: np.random.Generator, ext: str) -> None:
    """`n` images of `size` (H, W) under `root`/`image_dir`, and in
    `root`/`det_dir` their `detections.npy` (image path, bbox, COCO RLE
    mask) and the torch-saved poses `poses_name` ({indices, z0, s, t, R}:
    perspective cameras about the y axis, quaternions w-first)."""
    height, width = size
    dets = []
    for i in range(n):
        img, mask, bbox = _image(rng, height, width)
        rel = os.path.join(image_dir, f'train_{i:04d}.{ext}')
        _write_image(os.path.join(root, rel), img)
        dets.append({'image_path': rel, 'bbox': bbox,
                     'mask': rle.encode(np.asfortranarray(mask))})
    ddir = os.path.join(root, det_dir)
    os.makedirs(ddir, exist_ok=True)
    np.save(os.path.join(ddir, 'detections.npy'),
            np.array(dets, dtype=object))
    theta = rng.uniform(-np.pi, np.pi, n)
    quats = np.stack((np.cos(theta / 2), np.zeros(n),
                      np.sin(theta / 2), np.zeros(n)), axis=-1)
    quats += rng.standard_normal((n, 4)) * 0.05
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    torch.save({
        'indices': torch.arange(n),
        'z0': torch.from_numpy(rng.uniform(0.6, 1.4, (n, 1))),
        's': torch.from_numpy(rng.uniform(1.5, 2.5, (n, 1))),
        't': torch.from_numpy(rng.uniform(-0.1, 0.1, (n, 2))),
        'R': torch.from_numpy(quats),
    }, os.path.join(ddir, poses_name))


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
    _write_detections(root, os.path.join('p3d', 'p3d_car'),
                      os.path.join(IMAGES_DIR, 'car_imagenet'),
                      'poses_estimated_singletpl_perspective.bin', n_train,
                      size, rng, ext)

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


def write_imagenet(root: str, dataset: str, n: int,
                   size: Tuple[int, int] = (240, 320), seed: int = 0
                   ) -> None:
    """Writes `n` images of `size` (H, W) in the layout of an ImageNet
    dataset (`imagenet_car`, ...; reference data/datasets.py:33-131) under
    `root`: `imagenet/<dataset>/detections.npy`,
    `poses_estimated_multitpl_perspective.bin` and JPEG images (quality
    90, through PIL) under `imagenet/<dataset>/images/`. ImageNet has no
    test split."""
    if not dataset.startswith('imagenet_'):
        raise ValueError(f'not an ImageNet dataset: {dataset!r}')
    base = os.path.join('imagenet', dataset)
    _write_detections(root, base, os.path.join(base, 'images'),
                      'poses_estimated_multitpl_perspective.bin', n, size,
                      np.random.default_rng(seed), 'jpg')


# SRN ShapeNet's cameras: the focal of SRN cars at 128^2 (its
# intrinsics.txt), and the distance of the cameras from the origin.
SRN_FOCAL_128 = 131.25
SRN_CAMERA_RADIUS = 1.3


def _look_at_origin(position: np.ndarray) -> np.ndarray:
    """4 x 4 camera-to-world of a camera at `position` looking at the
    origin, in SRN's (OpenCV) axes: x right, y down, z forward."""
    forward = -position / np.linalg.norm(position)
    right = np.cross(forward, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    pose = np.eye(4)
    pose[:3, :3] = np.stack((right, down, forward), axis=1)
    pose[:3, 3] = position
    return pose


def _render_sphere(pose: np.ndarray, focal: float, size: int,
                   color: np.ndarray, radius: float) -> np.ndarray:
    """uint8 RGBA (size, size, 4) view of a shaded sphere of `radius` at
    the origin through the pinhole camera `pose` (principal point at the
    centre) on a white background; alpha is the sphere's mask."""
    v, u = np.mgrid[0:size, 0:size].astype(np.float64) + 0.5
    dirs = np.stack(((u - size / 2) / focal, (v - size / 2) / focal,
                     np.ones_like(u)), axis=-1) @ pose[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origin = pose[:3, 3]
    b = dirs @ origin
    disc = b * b - (origin @ origin - radius * radius)
    hit = disc > 0
    depth = -b - np.sqrt(np.maximum(disc, 0.0))
    normal = (origin + depth[..., None] * dirs) / radius
    light = np.array([0.4, -0.8, 0.45]) / np.linalg.norm([0.4, -0.8, 0.45])
    shade = 0.35 + 0.65 * np.clip(normal @ light, 0.0, 1.0)
    stripes = 0.85 + 0.15 * np.sign(np.sin(6.0 * normal[..., 1]))
    rgb = np.where(hit[..., None], color * (shade * stripes)[..., None], 1.0)
    rgba = np.concatenate((rgb, hit[..., None].astype(np.float64)), axis=-1)
    return (np.clip(rgba, 0, 1) * 255).round().astype(np.uint8)


def write_shapenet(root: str, category: str, n_train_objects: int = 2,
                   n_test_objects: int = 1, views_train: int = 50,
                   views_test: int = 251, size: int = 128,
                   seed: int = 0) -> None:
    """Writes SRN ShapeNet's layout (reference data/datasets.py:567-715)
    for `category` ('cars' or 'chairs') under `root`:
    `shapenet/<category>_<stage>/<object>/{intrinsics.txt, rgb/*.png,
    pose/*.txt}` (the chairs' train stage under `chairs_2.0_train/`, as
    SRN ships it), `views_train` and `views_test` views an object. Each
    view is an RGBA PNG of `size`^2 on a white background: a shaded
    sphere of radius 0.3 at the origin seen from a camera on a sphere of
    radius 1.3 looking at it, with SRN cars' focal (131.25 px at 128^2)
    and the principal point at the centre."""
    if category not in ('cars', 'chairs'):
        raise ValueError(f'category must be cars or chairs, got '
                         f'{category!r}')
    rng = np.random.default_rng(seed)
    focal = SRN_FOCAL_128 * size / 128
    for stage, n_objects, n_views in (('train', n_train_objects,
                                       views_train),
                                      ('test', n_test_objects, views_test)):
        base = os.path.join(root, 'shapenet', f'{category}_{stage}')
        if category == 'chairs' and stage == 'train':
            base = os.path.join(base, 'chairs_2.0_train')
        for o in range(n_objects):
            obj = os.path.join(base, f'{stage}_{o:04d}')
            os.makedirs(os.path.join(obj, 'pose'))
            with open(os.path.join(obj, 'intrinsics.txt'), 'w') as f:
                f.write(f'{focal} {size / 2} {size / 2} 0.\n0. 0. 0.\n1.\n'
                        f'{size} {size}\n')
            color = rng.uniform(0.1, 0.8, 3)
            for v in range(n_views):
                az = rng.uniform(-np.pi, np.pi)
                el = rng.uniform(0.05, 1.2)
                position = SRN_CAMERA_RADIUS * np.array(
                    [np.cos(el) * np.sin(az), -np.sin(el),
                     np.cos(el) * np.cos(az)])
                pose = _look_at_origin(position)
                write_png(os.path.join(obj, 'rgb', f'{v:06d}.png'),
                          _render_sphere(pose, focal, size, color, 0.3))
                np.savetxt(os.path.join(obj, 'pose', f'{v:06d}.txt'),
                           pose.reshape(1, 16))
