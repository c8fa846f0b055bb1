"""Manual-image demo input loading, the --inv_manual_input_path path
(PyTorch port's copy of `nerf_from_image_tpu/cli/demo.py`, which imports
no JAX; the port keeps its own copy).

Mirrors the reference's lib/utils.py:116-160: loads an image from a path
or a URL, obtains a foreground mask for the requested COCO class, and
returns {image, mask, bbox} for `data.loaders.insert_manual_image`.
Images are read by `data/image_io.py`.

The reference depends on detectron2 Mask R-CNN; here any instance
segmentation callable can be plugged in (`segment_fn`), with fallbacks in
this order: an external mask file, `segment_fn` (detectron2 where it is
installed), an alpha channel, OpenCV's GrabCut (cv2 imported when it is
needed), and the full frame, with a warning.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from nerf_from_image_tpu_torch.data import image_io


def select_largest_of_class(pred_classes: np.ndarray,
                            pred_masks: np.ndarray,
                            coco_class_id: int) -> np.ndarray:
    """Reference instance selection (lib/utils.py:147-153): among
    detections OF THE REQUESTED COCO CLASS, pick the largest mask.
    Raises when the class is absent — the reference errors rather than
    silently segmenting the wrong object."""
    pred_classes = np.asarray(pred_classes)
    pred_masks = np.asarray(pred_masks)
    keep = np.where(pred_classes == coco_class_id)[0]
    if len(keep) == 0:
        raise RuntimeError(
            'Could not detect any object of COCO class '
            f'{coco_class_id} in the provided image')
    areas = pred_masks[keep].reshape(len(keep), -1).sum(axis=1)
    return pred_masks[keep[int(np.argmax(areas))]].astype(np.float64)


def detectron2_segment(img: np.ndarray,
                       coco_class_id: int) -> Optional[np.ndarray]:
    """Class-aware instance segmentation via detectron2 Mask R-CNN with
    the reference's exact config and selection semantics
    (lib/utils.py:116-160). Returns None when detectron2 is not
    installed (callers fall through to the next mask source)."""
    try:
        import detectron2  # noqa: F401
        import detectron2.config
        import detectron2.engine
        import detectron2.model_zoo
    except ImportError:
        return None
    cfg_file = 'COCO-InstanceSegmentation/mask_rcnn_X_101_32x8d_FPN_3x.yaml'
    cfg = detectron2.config.get_cfg()
    cfg.merge_from_file(detectron2.model_zoo.get_config_file(cfg_file))
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.5
    cfg.MODEL.WEIGHTS = detectron2.model_zoo.get_checkpoint_url(cfg_file)
    predictor = detectron2.engine.DefaultPredictor(cfg)
    img8 = np.ascontiguousarray(
        np.clip(np.asarray(img[..., :3], np.float64), 0, 1) * 255
    ).astype(np.uint8)
    out = predictor(img8[:, :, ::-1])['instances']
    return select_largest_of_class(out.pred_classes.cpu().numpy(),
                                   out.pred_masks.cpu().numpy(),
                                   coco_class_id)


def load_mask_file(path: str, image_shape) -> np.ndarray:
    """External mask file: grayscale/binary image, or RGBA (alpha used)."""
    m = np.asarray(image_io.imread(path), np.float64)
    if m.ndim == 3:
        m = m[..., 3] if m.shape[-1] == 4 else m.mean(axis=-1)
    if m.shape != tuple(image_shape[:2]):
        raise ValueError(f'mask shape {m.shape} does not match image '
                         f'{tuple(image_shape[:2])}')
    return (m > 0.5).astype(np.float64)


def load_manual_image(path_or_url: str, coco_class_id: int,
                      segment_fn: Optional[Callable] = None,
                      mask_path: Optional[str] = None) -> dict:
    if path_or_url.startswith(('http://', 'https://')):
        # The reference accepts URLs here (lib/utils.py:116-160).
        import tempfile
        import urllib.request
        try:
            suffix = os.path.splitext(path_or_url.split('?')[0])[1] or '.jpg'
            with urllib.request.urlopen(path_or_url, timeout=30) as r, \
                    tempfile.NamedTemporaryFile(suffix=suffix,
                                                delete=False) as f:
                f.write(r.read())
                path_or_url = f.name
        except Exception as e:
            raise RuntimeError(
                f'could not download {path_or_url} ({e}); if this '
                'machine has no network access, download the image and '
                'pass a local path instead') from e
    img = image_io.imread(path_or_url)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)

    # Mask source precedence (most to least class-aware; each path is
    # announced so the user knows which semantics applied):
    # 1. explicit mask file  2. segment_fn (defaults to detectron2 Mask
    # R-CNN with the reference's class-filtered largest-instance rule)
    # 3. RGBA alpha  4. GrabCut class-agnostic foreground (last resort)
    # 5. full-frame.
    mask = None
    if mask_path:
        mask = load_mask_file(mask_path, img.shape)
        print(f'Using external mask file {mask_path}.')
    if mask is None:
        fn = segment_fn if segment_fn is not None else detectron2_segment
        mask = fn(img, coco_class_id)
        if mask is not None:
            which = ('provided segment_fn' if segment_fn is not None
                     else 'detectron2 Mask R-CNN')
            print(f'Using {which} instance segmentation for COCO class '
                  f'{coco_class_id} (largest instance of the class, '
                  'lib/utils.py:147-153 semantics).')
    if mask is None and img.shape[-1] == 4:
        mask = (img[..., 3] > 0.5).astype(np.float64)
        img = img[..., :3]
        print('Using the alpha channel as the foreground mask.')
    if mask is None:
        mask = grabcut_foreground(img)
        if mask is not None:
            print('WARNING: using CLASS-AGNOSTIC GrabCut foreground '
                  f'segmentation — the requested COCO class '
                  f'{coco_class_id} is not honored (no instance-'
                  'segmentation model installed; the reference uses Mask '
                  'R-CNN, lib/utils.py:116-160). Pass --inv_manual_mask_'
                  'path or install detectron2 for class-aware masks.')
    if mask is None:
        print('WARNING: no segmentation available; using a full-frame '
              'mask. Provide an RGBA image for best results.')
        mask = np.ones(img.shape[:2], dtype=np.float64)

    mask = np.asarray(mask, np.float64)
    ys, xs = np.where(mask > 0.5)
    if len(ys) == 0:
        bbox = np.array([0, 0, img.shape[1] - 1, img.shape[0] - 1], float)
    else:
        bbox = np.array([xs.min(), ys.min(), xs.max(), ys.max()], float)

    return {'image': img[..., :3], 'mask': mask[..., None], 'bbox': bbox}


def grabcut_foreground(img: np.ndarray,
                       border_frac: float = 0.04,
                       iters: int = 5) -> Optional[np.ndarray]:
    """Foreground mask via OpenCV GrabCut, seeded with an image-border
    background prior (the subject of a demo photo is centered). A real
    instance-segmentation callable (`segment_fn`) takes precedence; this
    is the no-extra-model fallback for plain RGB inputs. Returns float64
    (H, W) in {0, 1}, or None when cv2 is unavailable / the result is
    degenerate."""
    try:
        import cv2
    except ImportError:
        return None
    h, w = img.shape[:2]
    if min(h, w) < 32:
        return None
    img8 = np.ascontiguousarray(
        np.clip(np.asarray(img[..., :3], np.float64), 0, 1) * 255
    ).astype(np.uint8)
    gc_mask = np.full((h, w), cv2.GC_PR_FGD, np.uint8)
    b = max(2, int(round(border_frac * min(h, w))))
    gc_mask[:b, :] = cv2.GC_BGD
    gc_mask[-b:, :] = cv2.GC_BGD
    gc_mask[:, :b] = cv2.GC_BGD
    gc_mask[:, -b:] = cv2.GC_BGD
    bg_model = np.zeros((1, 65), np.float64)
    fg_model = np.zeros((1, 65), np.float64)
    try:
        cv2.grabCut(img8, gc_mask, None, bg_model, fg_model, iters,
                    cv2.GC_INIT_WITH_MASK)
    except cv2.error:
        return None
    fg = np.isin(gc_mask, (cv2.GC_FGD, cv2.GC_PR_FGD))
    frac = fg.mean()
    if frac < 0.01 or frac > 0.98:  # degenerate segmentation
        return None
    # Keep the largest connected component (instance-like behavior).
    n, labels = cv2.connectedComponents(fg.astype(np.uint8))
    if n > 2:
        sizes = [(labels == i).sum() for i in range(1, n)]
        fg = labels == (1 + int(np.argmax(sizes)))
    return fg.astype(np.float64)
