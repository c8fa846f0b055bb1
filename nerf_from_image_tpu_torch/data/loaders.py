"""Dataset preloading into host arrays + split containers (a copy of
`nerf_from_image_tpu/data/loaders.py`, which the port may not import).

Parity with the reference's data/loaders.py:126-501: each split is fully
materialized in host memory (`DatasetSplit`), with the per-dataset quirks
(train images uncropped / eval images cropped, highres copies for ADA,
CUB's ortho focal/bbox stripping, ShapeNet's shared intrinsics assertion,
CARLA single split). The callers move batches to the device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from nerf_from_image_tpu_torch import config as config_lib
from nerf_from_image_tpu_torch.data import datasets


@dataclasses.dataclass
class DatasetSplit:
    """In-RAM split (loaders.py:176-194 equivalent, numpy arrays)."""
    images: Optional[np.ndarray] = None  # (N, H, W, C) in [-1, 1]
    images_highres: Optional[np.ndarray] = None
    tform_cam2world: Optional[np.ndarray] = None
    focal_length: Optional[np.ndarray] = None
    bbox: Optional[np.ndarray] = None
    center: Optional[np.ndarray] = None
    classes: Optional[np.ndarray] = None
    num_classes: Optional[int] = None

    fid_stats: Optional[tuple] = None
    eval_indices: Optional[np.ndarray] = None
    eval_indices_perm: Optional[np.ndarray] = None

    def gather(self, idx, fields):
        out = []
        for f in fields:
            v = getattr(self, f)
            out.append(None if v is None else v[idx])
        return out


def _avg_pool2x(img_nhwc: np.ndarray) -> np.ndarray:
    n, h, w, c = img_nhwc.shape
    return img_nhwc.reshape(n, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))


def _stack_items(ds, keys, desc=''):
    out = {k: [] for k in keys}
    for i in range(len(ds)):
        item = ds[i]
        for k in keys:
            out[k].append(np.asarray(item[k]))
    return {k: np.stack(v) for k, v in out.items()}


def load_custom(dataset_config, args, manual_image=None):
    """P3D / ImageNet / CUB loader (loaders.py:239-392)."""
    if args.dataset.startswith(('p3d_', 'imagenet_')):
        make = lambda split, size, crop, mirror: datasets.CustomDataset(
            args.dataset, split, size, root_dir=args.data_path, crop=crop,
            add_mirrored=mirror)
    else:
        make = lambda split, size, crop, mirror: datasets.CUBDataset(
            split, size, root_dir=args.data_path, crop=crop,
            add_mirrored=mirror)

    img_size = args.resolution
    img_size_train = img_size * 2 if args.augment_p > 0 else img_size
    dataset = make('train', img_size_train, False, True)
    dataset_fid = make('train', img_size, True, False)

    train_split = DatasetSplit()
    train_eval_split = DatasetSplit()
    test_split = None

    keys = ('img', 'pose', 'focal', 'normalized_bbox', 'class')
    d = _stack_items(dataset, keys)
    imgs = np.clip(d['img'], -1, 1).transpose(0, 2, 3, 1)
    if args.augment_p > 0:
        train_split.images_highres = imgs
        train_split.images = _avg_pool2x(imgs)
    else:
        train_split.images = imgs
    train_split.tform_cam2world = d['pose']
    train_split.focal_length = d['focal'].squeeze(1)
    train_split.bbox = d['normalized_bbox']
    train_split.classes = d['class']
    train_split.num_classes = int(d['class'].max()) + 1

    d = _stack_items(dataset_fid, keys)
    train_eval_split.images = np.clip(d['img'], -1, 1).transpose(0, 2, 3, 1)
    train_eval_split.tform_cam2world = d['pose']
    train_eval_split.focal_length = d['focal'].squeeze(1)
    train_eval_split.bbox = d['normalized_bbox']
    train_eval_split.classes = d['class']
    train_eval_split.num_classes = train_split.num_classes

    if dataset_config['views_per_object_test'] and (args.use_encoder or
                                                    args.run_inversion):
        split_name = ('imagenet_test' if args.dataset == 'p3d_car' and
                      args.inv_use_imagenet_testset else 'test')
        dataset_test = make(split_name, img_size, True, False)
        d = _stack_items(dataset_test, keys)
        test_split = DatasetSplit()
        test_split.images = np.clip(d['img'], -1, 1).transpose(0, 2, 3, 1)
        test_split.tform_cam2world = d['pose']
        test_split.focal_length = d['focal'].squeeze(1)
        test_split.bbox = d['normalized_bbox']
        if manual_image is not None:
            insert_manual_image(dataset_test, test_split, manual_image)

    if manual_image is not None:
        insert_manual_image(dataset, train_split, manual_image)
        insert_manual_image(dataset_fid, train_eval_split, manual_image)

    if args.dataset == 'cub':
        # Ortho camera (loaders.py:371-379).
        train_split.focal_length = None
        train_split.bbox = None
        train_eval_split.focal_length = None
        train_eval_split.bbox = None
        if test_split is not None:
            test_split.focal_length = None
            test_split.bbox = None
    else:
        train_split.bbox = None  # Training images are uncropped.

    if not args.use_class or args.dataset != 'cub':
        for s in (train_split, train_eval_split):
            s.classes = None
            s.num_classes = None

    return train_split, train_eval_split, test_split


def load_shapenet(dataset_config, args, manual_image=None):
    """SRN ShapeNet loader (loaders.py:395-450)."""
    rng = np.random.RandomState(1234)
    category = args.dataset.split('_')[1]
    path = os.path.join(args.data_path, 'shapenet', category)

    def load_stage(stage):
        ds = datasets.SRNDataset(path, stage=stage,
                                 image_size=(args.resolution,
                                             args.resolution), rng=rng)
        images, poses = [], []
        focal = center = None
        for i in range(len(ds)):
            item = ds[i]
            if focal is None:
                focal, center = item['focal'], item['c']
            assert np.allclose(item['focal'], focal)
            assert np.allclose(item['c'], center)
            images.append(item['images'])
            poses.append(item['poses'])
        images = np.concatenate(images, axis=0).transpose(0, 2, 3, 1)
        poses = np.concatenate(poses, axis=0)
        split = DatasetSplit()
        split.images = images
        split.tform_cam2world = poses
        split.focal_length = np.full((len(images),), focal, np.float32)
        # Principal point from the shared SRN intrinsics, threaded through
        # batching into ray generation (reference reads `c` at
        # loaders.py:423-429 and render() accepts `center` at run.py:176).
        split.center = np.broadcast_to(
            np.asarray(center, np.float32), (len(images), 2)).copy()
        return split

    train_split = load_stage('train')
    train_eval_split = DatasetSplit(
        images=train_split.images,
        tform_cam2world=train_split.tform_cam2world,
        focal_length=train_split.focal_length,
        center=train_split.center)
    test_split = None
    if args.use_encoder or args.run_inversion:
        test_split = load_stage('test')
    return train_split, train_eval_split, test_split


def load_carla(dataset_config, args, manual_image=None):
    """CARLA loader (loaders.py:453-501)."""
    ds = datasets.CARLADataset(os.path.join(args.data_path, 'carla'),
                               image_size=args.resolution,
                               upscale=args.augment_p > 0)
    images, poses = [], []
    focal = center = None
    for i in range(len(ds)):
        item = ds[i]
        if focal is None:
            focal = item['focal'][0]
            center = item.get('c')
        images.append(item['image'])
        poses.append(item['pose'])
    images = np.stack(images).transpose(0, 2, 3, 1)
    split = DatasetSplit()
    if args.augment_p > 0:
        split.images_highres = images
        split.images = _avg_pool2x(images)
    else:
        split.images = images
    split.tform_cam2world = np.stack(poses)
    split.focal_length = np.full((len(images),), focal, np.float32)
    if center is not None:
        split.center = np.broadcast_to(
            np.asarray(center, np.float32), (len(images), 2)).copy()
    train_eval = DatasetSplit(images=split.images,
                              tform_cam2world=split.tform_cam2world,
                              focal_length=split.focal_length,
                              center=split.center)
    return split, train_eval, None


def get_dataset_loaders():
    return {
        'shapenet_cars': load_shapenet,
        'shapenet_chairs': load_shapenet,
        'p3d_car': load_custom,
        'cub': load_custom,
        'carla': load_carla,
        'imagenet_car': load_custom,
        'imagenet_airplane': load_custom,
        'imagenet_motorcycle': load_custom,
        'imagenet_zebra': load_custom,
        'imagenet_elephant': load_custom,
    }


def insert_manual_image(dataset, split: DatasetSplit, manual_image):
    """Replaces image 0 with an externally supplied image
    (loaders.py:228-237)."""
    img, mask, _, _, _, _, _, bbox, _ = dataset.forward_img(None,
                                                            manual_image)
    mask = mask.reshape(1, *mask.shape[:2])
    img = img * 2 - 1
    img = img * mask
    img = np.concatenate((img, mask), axis=0).transpose(1, 2, 0)
    n_ch = split.images.shape[-1]
    split.images[0] = img[..., :n_ch].astype(split.images.dtype)
    if split.bbox is not None and split.bbox.shape[-1] == 2:
        split.bbox[0] = np.asarray(bbox, dtype=split.bbox.dtype)


def load_dataset(args, manual_image=None):
    """Entry point (loaders.py:213-225)."""
    config_lib.override_default_args(args)
    dataset_config = config_lib.get_dataset_config(args.dataset)
    loader = get_dataset_loaders()[args.dataset]
    if manual_image is not None:
        args.augment_p = 0
    train, train_eval, test = loader(dataset_config, args,
                                     manual_image=manual_image)
    return dataset_config, train, train_eval, test
