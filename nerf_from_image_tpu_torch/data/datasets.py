"""Dataset parsers: P3D/ImageNet (CustomDataset), CUB, SRN/ShapeNet, CARLA
(a copy of `nerf_from_image_tpu/data/datasets.py`, which the port may not
import).

Each dataset exposes `__len__` / `__getitem__` returning numpy dicts with
the reference's keys and conventions (reference data/datasets.py:33-760):
bbox padding/squaring/cropping, INTER_AREA resizing, mirroring with pose
flips, the perspective pose assembly (flip @ quat-matrix, inverted to
cam2world), CUB's orthographic scale-in-[3,3] matrices, SRN's
intrinsics.txt + per-view pose files with the diag(1,-1,-1,1) coordinate
flip, and CARLA's extrinsics npy files. Images are read and resized by
`data/image_io.py` (cv2, PIL without it, as the JAX package); RLE masks
decode through the native codec (`data/rle.py`); the estimated poses load
with `torch.load`.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Optional, Tuple

import numpy as np

from nerf_from_image_tpu_torch.core.pose import matrix_to_quaternion
from nerf_from_image_tpu_torch.data import rle as rle_codec
from nerf_from_image_tpu_torch.data.image_io import imread, resize_area


def quaternion_to_matrix_wxyz(quaternion: np.ndarray) -> np.ndarray:
    """(w, x, y, z) -> 4x4 rotation (transformations.py convention used by
    the reference, datasets.py:133-147)."""
    q = np.array(quaternion, dtype=np.float64, copy=True)
    n = np.dot(q, q)
    eps = np.finfo(float).eps * 4.0
    if n < eps:
        return np.identity(4)
    q *= math.sqrt(2.0 / n)
    q = np.outer(q, q)
    return np.array([
        [1 - q[2, 2] - q[3, 3], q[1, 2] - q[3, 0], q[1, 3] + q[2, 0], 0.0],
        [q[1, 2] + q[3, 0], 1 - q[1, 1] - q[3, 3], q[2, 3] - q[1, 0], 0.0],
        [q[1, 3] - q[2, 0], q[2, 3] + q[1, 0], 1 - q[1, 1] - q[2, 2], 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ])


def perturb_bbox(bbox, pf=0.0, jf=0.0, rng: Optional[np.random.RandomState]
                 = None):
    out = [c for c in bbox]
    bw = bbox[2] - bbox[0] + 1
    bh = bbox[3] - bbox[1] + 1
    rnd = (lambda: (1 - 2 * rng.rand()) if rng is not None else 0.0)
    out[0] -= pf * bw + rnd() * jf * bw
    out[1] -= pf * bh + rnd() * jf * bh
    out[2] += pf * bw + rnd() * jf * bw
    out[3] += pf * bh + rnd() * jf * bh
    return out


def square_bbox(bbox):
    sq = [int(round(c)) for c in bbox]
    bw = sq[2] - sq[0] + 1
    bh = sq[3] - sq[1] + 1
    maxdim = float(max(bw, bh))
    sq[0] -= int(round((maxdim - bw) / 2.0))
    sq[1] -= int(round((maxdim - bh) / 2.0))
    sq[2] = int(sq[0] + maxdim - 1)
    sq[3] = int(sq[1] + maxdim - 1)
    return sq


def crop_padded(img: np.ndarray, bbox, bgval=0) -> np.ndarray:
    bbox = [int(round(c)) for c in bbox]
    bw = bbox[2] - bbox[0] + 1
    bh = bbox[3] - bbox[1] + 1
    im_h, im_w = img.shape[0], img.shape[1]
    nc = 1 if img.ndim < 3 else img.shape[2]
    img2 = img.reshape(im_h, im_w, nc)
    out = np.ones((bh, bw, nc), dtype=img2.dtype) * bgval
    x0, x1 = max(0, bbox[0]), min(im_w, bbox[2] + 1)
    y0, y1 = max(0, bbox[1]), min(im_h, bbox[3] + 1)
    out[y0 - bbox[1]:y1 - bbox[1], x0 - bbox[0]:x1 - bbox[0]] = \
        img2[y0:y1, x0:x1]
    return out


def compute_normalized_bbox(bbox, img_shape) -> np.ndarray:
    """Normalized crop rectangle for the renderer (datasets.py:318-340)."""
    max_res = max(img_shape[0], img_shape[1])
    bbox_scaled = list(bbox)
    if img_shape[0] < img_shape[1]:
        bbox_scaled[1] += (max_res - img_shape[0]) / 2
    else:
        bbox_scaled[0] += (max_res - img_shape[1]) / 2
    start = np.array([bbox_scaled[0], bbox_scaled[1]]) / max_res
    rng = np.array([bbox[2] - bbox[0] + 1, bbox[3] - bbox[1] + 1])
    assert rng[0] == rng[1], 'bbox must be square'
    rng = rng / max_res
    start = np.array([start[0], 1 - start[1] - rng[1]]) * 2 - 1
    rng = rng * 2
    return np.stack((start, rng), axis=0)


def _load_torch_pickle(path: str):
    import torch
    with open(path, 'rb') as f:
        obj = torch.load(f, map_location='cpu', weights_only=False)

    def to_np(x):
        if hasattr(x, 'detach'):
            return x.detach().cpu().numpy()
        return x

    if isinstance(obj, dict):
        return {k: to_np(v) for k, v in obj.items()}
    return obj


class CustomDataset:
    """P3D / ImageNet single-view datasets (datasets.py:33-402)."""

    def __init__(self, dataset: str, split: str, img_size: int,
                 root_dir: str, crop: bool = False,
                 add_mirrored: bool = False):
        self.img_size = img_size
        self.padding_frac = 0.05
        self.jitter_frac = 0.0
        self.add_mirrored = add_mirrored
        self.crop = crop
        self.root_dir = root_dir

        if 'imagenet' in dataset:
            assert split == 'train', 'ImageNet has no test split'

        if split == 'test':
            assert dataset == 'p3d_car'
            import scipy.io
            anno_path = os.path.join(root_dir, 'p3d', 'p3d_sfm_image',
                                     'img_anno', 'car_val.mat')
            val_images = scipy.io.loadmat(anno_path, struct_as_record=False,
                                          squeeze_me=True)['images']
            self.detections = []
            for img in val_images:
                mask = np.asfortranarray(img.mask.astype(np.uint8))
                self.detections.append({
                    'image_path': os.path.join(
                        'p3d', 'PASCAL3D+_release1.1', 'Images',
                        str(img.rel_path).replace('\\', '/')),
                    'bbox': np.array([img.bbox.x1, img.bbox.y1, img.bbox.x2,
                                      img.bbox.y2], float) - 1,
                    'mask': rle_codec.encode(mask),
                })
            n = len(val_images)
            self.poses = {'f': np.zeros((n, 1)), 't': np.zeros((n, 3)),
                          'R': np.zeros((n, 4))}
            return

        if 'imagenet' in dataset:
            det_path = os.path.join(root_dir, 'imagenet', dataset,
                                    'detections.npy')
            poses_path = os.path.join(
                root_dir, 'imagenet', dataset,
                'poses_estimated_multitpl_perspective.bin')
        else:
            det_path = os.path.join(root_dir, 'p3d', dataset,
                                    'detections.npy')
            poses_path = os.path.join(
                root_dir, 'p3d', dataset,
                'poses_estimated_singletpl_perspective.bin')
        self.detections = np.load(det_path, allow_pickle=True)

        valid_indices = None
        if split == 'imagenet_test':
            aux_dataset = dataset.replace('p3d', 'imagenet')
            det_aux = np.load(os.path.join(root_dir, 'imagenet', aux_dataset,
                                           'detections.npy'),
                              allow_pickle=True)
            poses_path = os.path.join(
                root_dir, 'imagenet', aux_dataset,
                'poses_estimated_multitpl_perspective.bin')
            train_names = {os.path.basename(item['image_path'])
                           for item in self.detections}
            valid_indices = np.array([
                os.path.basename(item['image_path']) not in train_names
                for item in det_aux
            ])
            self.detections = det_aux

        self.poses = _load_torch_pickle(poses_path)
        self.detections = self.detections[self.poses['indices']]
        if valid_indices is not None:
            valid_indices = valid_indices[self.poses['indices']]
            self.detections = self.detections[valid_indices]
            self.poses = {k: v[valid_indices] for k, v in self.poses.items()}

        # Convert estimated (z0, s) parameterization to (f, t) (126-131).
        f = 1.0 + np.exp(self.poses['z0'])
        self.poses['f'] = f
        self.poses['t'] = np.concatenate(
            (self.poses['t'] / self.poses['s'], f / self.poses['s']), axis=-1)
        del self.poses['z0']
        del self.poses['s']

    def __len__(self):
        return (2 if self.add_mirrored else 1) * len(self.detections)

    def _mirror(self, img, mask, sfm_pose, bbox=None):
        img = img[:, ::-1].copy()
        mask = mask[:, ::-1].copy()
        sfm_pose[2] = sfm_pose[2] * np.array([1, 1, -1, -1])
        sfm_pose[1][0] *= -1
        if bbox is not None:
            im_w = img.shape[1]
            bbox = list(bbox)
            bbox[0], bbox[2] = im_w - bbox[2], im_w - bbox[0]
            return img, mask, sfm_pose, bbox
        return img, mask, sfm_pose

    def forward_img(self, idx, manual_image=None):
        if manual_image is None:
            idx_ = idx
            mirrored = self.add_mirrored and idx >= len(self.detections)
            if mirrored:
                idx_ -= len(self.detections)
            item = self.detections[idx_]
            img_path = os.path.join(
                self.root_dir, item['image_path'].replace('datasets/', ''))
            mask = rle_codec.decode(item['mask'])
            bbox = np.asarray(item['bbox']).flatten()
            img = imread(img_path)
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=2)
            img = img[..., :3]
            mask = mask[..., None].astype(np.float64)
            sfm_pose = [np.array(self.poses['f'][idx_], dtype=np.float64),
                        np.array(self.poses['t'][idx_], dtype=np.float64),
                        np.array(self.poses['R'][idx_], dtype=np.float64)]
            path_rel = item['image_path']
        else:
            img = manual_image['image']
            mask = manual_image['mask']
            bbox = manual_image['bbox']
            mirrored = False
            path_rel = ''
            sfm_pose = [np.zeros(1), np.zeros(3), np.zeros(4)]

        if mirrored:
            img, mask, sfm_pose, bbox = self._mirror(img, mask, sfm_pose,
                                                     bbox)

        if self.crop:
            bbox = perturb_bbox(bbox, pf=self.padding_frac, jf=0)
        else:
            bbox = [0, 0, img.shape[1] - 1, img.shape[0] - 1]
        bbox = square_bbox(bbox)
        normalized_bbox = compute_normalized_bbox(bbox, img.shape)

        img = crop_padded(img, bbox, bgval=1)
        mask = crop_padded(mask, bbox, bgval=0)

        scale = self.img_size / float(max(img.shape[0], img.shape[1]))
        img = resize_area(img, (int(round(img.shape[0] * scale)),
                                int(round(img.shape[1] * scale))))
        mask = resize_area(mask, (img.shape[0], img.shape[1]))

        img = np.transpose(img, (2, 0, 1))

        m = quaternion_to_matrix_wxyz(sfm_pose[2])
        m[:3, 3] += sfm_pose[1]
        focal = sfm_pose[0] / 2
        flip = np.diag([1.0, -1.0, -1.0, 1.0])
        m = np.linalg.inv(flip @ m)

        return (img, mask, focal, m, sfm_pose, mirrored, path_rel,
                normalized_bbox, -1)

    def __getitem__(self, index):
        (img, mask, focal, m, sfm_pose, mirrored, path, normalized_bbox,
         class_label) = self.forward_img(index)
        mask = mask.reshape(1, *mask.shape[:2])
        img = img * 2 - 1
        img = img * mask
        img = np.concatenate((img, mask), axis=0)
        return {
            'img': img.astype(np.float32),
            'normalized_bbox': normalized_bbox.astype(np.float32),
            'focal': np.asarray(focal, dtype=np.float32).reshape(1),
            'pose': m.astype(np.float32),
            'mirrored': mirrored,
            'inds': index,
            'path': path,
            'class': class_label,
        }


class CUBDataset(CustomDataset):
    """CUB orthographic dataset (datasets.py:405-564)."""

    def __init__(self, split: str, img_size: int, root_dir: str,
                 crop: bool = False, add_mirrored: bool = False):
        import scipy.io
        self.img_size = img_size
        self.padding_frac = 0.05
        self.jitter_frac = 0.0
        self.add_mirrored = add_mirrored
        self.crop = crop
        self.root_dir = root_dir

        cache_dir = os.path.join(root_dir, 'cub')
        self.data_dir = os.path.join(cache_dir, 'CUB_200_2011')
        self.img_dir = os.path.join(self.data_dir, 'images')
        anno_path = os.path.join(cache_dir, 'data',
                                 f'{split}_cub_cleaned.mat')
        anno_sfm_path = os.path.join(cache_dir, 'sfm', f'anno_{split}.mat')
        if not os.path.exists(anno_path):
            raise ValueError(f'{anno_path} does not exist')
        self.anno = scipy.io.loadmat(anno_path, struct_as_record=False,
                                     squeeze_me=True)['images']
        self.anno_sfm = scipy.io.loadmat(anno_sfm_path,
                                         struct_as_record=False,
                                         squeeze_me=True)['sfm_anno']

        with open(os.path.join(self.data_dir, 'images.txt')) as f:
            ids = {k: v.strip() for k, v in
                   (line.split(' ') for line in f.readlines())}
        with open(os.path.join(self.data_dir,
                               'image_class_labels.txt')) as f:
            classes = {k: int(v.strip()) - 1 for k, v in
                       (line.split(' ') for line in f.readlines())}
        self.filename_to_class = {ids[k]: c for k, c in classes.items()}

    def __len__(self):
        return (2 if self.add_mirrored else 1) * len(self.anno)

    def forward_img(self, idx, manual_image=None):
        if manual_image is not None:
            return super().forward_img(idx, manual_image)
        idx_ = idx
        mirrored = self.add_mirrored and idx >= len(self.anno)
        if mirrored:
            idx_ -= len(self.anno)
        data = self.anno[idx_]
        data_sfm = self.anno_sfm[idx_]

        sfm_pose = [np.copy(data_sfm.scale).astype(np.float64),
                    np.copy(data_sfm.trans).astype(np.float64),
                    np.copy(data_sfm.rot).astype(np.float64)]
        rot4 = np.eye(4)
        rot4[:3, :3] = sfm_pose[2]
        sfm_pose[2] = matrix_to_quaternion(rot4)

        path_rel = str(data.rel_path).replace('\\', '/')
        img = imread(os.path.join(self.img_dir, path_rel))
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        img = img[..., :3]
        mask = np.asarray(data.mask)[..., None].astype(np.float64)
        class_label = self.filename_to_class[path_rel]

        bbox = np.array([data.bbox.x1, data.bbox.y1, data.bbox.x2,
                         data.bbox.y2], float) - 1
        if self.crop:
            bbox = perturb_bbox(bbox, pf=self.padding_frac, jf=0)
        else:
            bbox = [0, 0, img.shape[1] - 1, img.shape[0] - 1]
        bbox = square_bbox(bbox)

        img = crop_padded(img, bbox, bgval=1)
        mask = crop_padded(mask, bbox, bgval=0)
        sfm_pose[1][0] -= bbox[0]
        sfm_pose[1][1] -= bbox[1]

        scale = self.img_size / float(max(img.shape[0], img.shape[1]))
        img = resize_area(img, (int(round(img.shape[0] * scale)),
                                int(round(img.shape[1] * scale))))
        mask = resize_area(mask, (img.shape[0], img.shape[1]))
        sfm_pose[0] = sfm_pose[0] * scale
        sfm_pose[1] = sfm_pose[1] * scale

        img_h, img_w = img.shape[:2]
        sfm_pose[0] *= (1.0 / img_w + 1.0 / img_h)
        sfm_pose[1][0] = 2.0 * (sfm_pose[1][0] / img_w) - 1
        sfm_pose[1][1] = 2.0 * (sfm_pose[1][1] / img_h) - 1

        if mirrored:
            img, mask, sfm_pose = self._mirror(img, mask, sfm_pose)

        img = np.transpose(img, (2, 0, 1))

        m = quaternion_to_matrix_wxyz(sfm_pose[2])
        m[:3, :3] *= sfm_pose[0]
        m[3, 3] *= sfm_pose[0]
        m[:2, 3] += sfm_pose[1][:2]
        m[2, 3] += 10.0
        m[:3, 3] *= sfm_pose[0]
        flip = np.diag([1.0, -1.0, -1.0, 1.0])
        m = np.linalg.inv(flip @ m)

        return (img, mask, np.zeros(1), m, sfm_pose, mirrored, path_rel,
                np.zeros(1), class_label)

    def __getitem__(self, index):
        (img, mask, focal, m, sfm_pose, mirrored, path, normalized_bbox,
         class_label) = self.forward_img(index)
        mask = mask.reshape(1, *mask.shape[:2])
        img = img * 2 - 1
        img = img * mask
        img = np.concatenate((img, mask), axis=0)
        return {
            'img': img.astype(np.float32),
            'normalized_bbox': np.zeros(1, dtype=np.float32),
            'focal': np.zeros(1, dtype=np.float32),
            'pose': m.astype(np.float32),
            'mirrored': mirrored,
            'inds': index,
            'path': path,
            'class': class_label,
        }


class SRNDataset:
    """ShapeNet SRN multi-view dataset (datasets.py:567-715)."""

    def __init__(self, path: str, stage: str = 'train',
                 image_size: Tuple[int, int] = (128, 128),
                 world_scale: float = 1.0, limit: Optional[int] = None,
                 rng: Optional[np.random.RandomState] = None):
        self.base_path = path + '_' + stage
        self.dataset_name = os.path.basename(path)
        self.stage = stage
        assert os.path.exists(self.base_path), self.base_path

        is_chair = 'chair' in self.dataset_name
        if is_chair and stage == 'train':
            tmp = os.path.join(self.base_path, 'chairs_2.0_train')
            if os.path.exists(tmp):
                self.base_path = tmp

        self.intrins = sorted(
            glob.glob(os.path.join(self.base_path, '*', 'intrinsics.txt')))
        self.image_size = image_size
        self.world_scale = world_scale
        self.limit = limit
        self.rng = rng if rng is not None else np.random
        self._coord_trans = np.diag([1.0, -1.0, -1.0, 1.0]).astype(
            np.float32)

    def __len__(self):
        return len(self.intrins)

    def __getitem__(self, index):
        intrin_path = self.intrins[index]
        dir_path = os.path.dirname(intrin_path)
        rgb_paths = sorted(glob.glob(os.path.join(dir_path, 'rgb', '*')))
        pose_paths = sorted(glob.glob(os.path.join(dir_path, 'pose', '*')))
        assert len(rgb_paths) == len(pose_paths)

        with open(intrin_path) as f:
            lines = f.readlines()
            focal, cx, cy, _ = map(float, lines[0].split())

        if self.limit is not None:
            indices = self.rng.choice(len(rgb_paths), size=(self.limit,),
                                      replace=False)
            rgb_paths = [rgb_paths[i] for i in indices]
            pose_paths = [pose_paths[i] for i in indices]

        imgs, poses = [], []
        for rgb_path, pose_path in zip(rgb_paths, pose_paths):
            img = imread(rgb_path)[..., :3]  # [0, 1]
            imgs.append(img * 2.0 - 1.0)
            pose = np.loadtxt(pose_path, dtype=np.float32).reshape(4, 4)
            poses.append(pose @ self._coord_trans)
        imgs = np.stack(imgs).astype(np.float32)  # (V, H, W, 3)
        poses = np.stack(poses).astype(np.float32)

        in_res = imgs.shape[1]
        if (in_res, in_res) != tuple(self.image_size):
            scale = self.image_size[0] / in_res
            focal *= scale
            cx *= scale
            cy *= scale
            imgs = np.stack([
                resize_area(im, tuple(self.image_size)) for im in imgs
            ]).astype(np.float32)

        if self.world_scale != 1.0:
            focal *= self.world_scale
            poses[:, :3, 3] *= self.world_scale
        focal_n = np.float32(focal / self.image_size[0])

        return {
            'img_id': index,
            'focal': focal_n,
            'c': np.asarray([cx, cy], np.float32) / self.image_size[0],
            'images': imgs.transpose(0, 3, 1, 2),  # (V, 3, H, W)
            'poses': poses,
        }


class CARLADataset:
    """CARLA png + extrinsics dataset (datasets.py:718-760)."""

    def __init__(self, dataset_path: str, image_size: int,
                 upscale: bool = False):
        self.img_paths = sorted(glob.glob(os.path.join(dataset_path,
                                                       '*.png')))
        self.image_size = image_size
        self.upscale = 2 if upscale else 1
        poses = []
        for img_path in self.img_paths:
            pose_path = os.path.join(
                dataset_path, 'carla_poses',
                os.path.basename(img_path).replace('.png', '_extrinsics.npy'))
            poses.append(np.load(pose_path))
        self.poses = np.zeros((len(poses), 4, 4), dtype=np.float32)
        if poses:
            self.poses[:, :3] = np.stack(poses, axis=0)
        self.poses[:, 3, 3] = 1
        intrinsics = np.load(os.path.join(dataset_path, 'carla_poses',
                                          'intrinsics.npy'))
        self.c = intrinsics[0, 0, :2, 2].astype(np.float32)
        self.focal = intrinsics[0, 0, 0, 0].astype(np.float32)

    def __len__(self):
        return len(self.img_paths)

    def __getitem__(self, idx):
        img = imread(self.img_paths[idx])[..., :3]
        original_res = img.shape[0]
        size = self.image_size * self.upscale
        img = resize_area(img, (size, size)).astype(np.float32) * 2 - 1
        return {
            'focal': np.asarray([self.focal], np.float32) / original_res,
            'c': self.c / original_res,
            'image': img.transpose(2, 0, 1),
            'pose': self.poses[idx],
        }
