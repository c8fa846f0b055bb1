"""GAN training evaluation: FID, the reconstruction metrics and the image
families (PyTorch port of `nerf_from_image_tpu/train/eval.py`).

- The real images' Inception statistics are computed once from the
  train-eval split and cached to `fid_stats_<dataset>_train.npz`
  (`real_stats`).
- The evaluation indices, the novel-view permutation and the frozen
  latents `z_fid` follow the reference's protocol: seed 1234, at most
  8000 images, another view of the same object for the permutation
  (and, where the dataset has `views_per_object_test`, the same for the
  test split, with its own latents `z_fid_test`).
- `evaluate` renders the evaluation set with the EMA generator in batches
  of `eval_batch_size` (a straggler is padded with its last row and the
  padded rows are left out of every statistic). Unconditional: the
  untruncated FID and the `img_eval_gen/*` images of the first batch
  (with normals and semantics, which only the first batch renders). With
  the image encoder: each training image's embedding conditions the
  render of its own view ('front') and of the permuted view
  ('random'); psnr, ssim, LPIPS and (with masks) IoU against the target
  view go to `reconstruction/<metric>_<mode>`, the FIDs to
  `reconstruction/fid_{frontview,randomview}` (the random view's is the
  one that gates `checkpoint_best`), the images to `img_eval_recon_*`;
  with a test split both modes again on it (`_test`, no FID). Under
  class conditioning each render takes its row's class label. Returns
  the FID and whether it is the best so far.
- `log_training_images` logs the `img/*` family: the real images of a
  random training batch, G's render of random latents from their poses
  (rgb, depth, mask, normals) and the EMA generator's (rgb, normals,
  semantics), each conditioned as the evaluation is, and with the encoder
  `img/inference_ref`.

The renders are gradient-free and deterministic (no depth jitter) unless
`render_noise_provider` gives each evaluation batch its depth and PDF
draws, as the JAX package's replay hook does. They run the generator's
default sampler: kernel B1 on the card, and for the normals B1 again and
B2's coordinate gradient. The JAX evaluator renders unfused (its
generator's `fuse_decode` is off), so B5a does not run here. A
noise-enabled generator renders each batch with fresh StyleGAN noise
from a fixed seed (`EVAL_NOISE_SEED`, `TRAIN_IMAGES_NOISE_SEED`); a
view-direction generator with its rays' directions.

`times` accumulates the seconds of the renders, the Inception forwards
(the real images' included), the statistics with their matrix square
root, the reconstruction metrics and the training images.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from nerf_from_image_tpu_torch.device import DeviceLike, resolve_device
from nerf_from_image_tpu_torch.metrics import fid as fid_lib
from nerf_from_image_tpu_torch.metrics import image as image_metrics
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.render.renderer import RenderOutput, render
from nerf_from_image_tpu_torch.utils import io as io_lib

N_IMAGES_FID_MAX = 8000  # the Pix2NeRF protocol
# Seeds of a noise-enabled generator's StyleGAN noise: the training images
# at iteration i draw from TRAIN_IMAGES_NOISE_SEED + i, the evaluation's
# batch at `start` from EVAL_NOISE_SEED + i * 1000003 + start (the JAX
# evaluator's fold-ins of its keys 4242 and 2424).
TRAIN_IMAGES_NOISE_SEED = 4242
EVAL_NOISE_SEED = 2424
RECON_METRICS = ('psnr', 'ssim', 'lpips', 'iou')


def compute_eval_indices(n_images: int, dataset_name: str,
                         rng: np.random.RandomState) -> np.ndarray:
    """The evaluation image indices."""
    if n_images > N_IMAGES_FID_MAX:
        return np.sort(rng.permutation(n_images)[:N_IMAGES_FID_MAX])
    if dataset_name.startswith('imagenet_'):
        out = []
        remaining = n_images
        while remaining > 0:
            out.append(rng.permutation(n_images)[:remaining])
            remaining -= len(out[-1])
        return np.sort(np.concatenate(out))
    return np.arange(n_images)


def compute_view_perm(indices: np.ndarray, views_per_object: Optional[int],
                      rng: np.random.RandomState) -> np.ndarray:
    """Novel-view permutation: the same object, another view."""
    if not views_per_object or views_per_object == 1:
        return indices[rng.permutation(len(indices))]
    obj_index: Dict[int, list] = {}
    for idx in indices:
        obj_index.setdefault(int(idx) // views_per_object, []).append(int(idx))
    perm = []
    for idx in indices:
        views = obj_index[int(idx) // views_per_object]
        if len(views) == 1:
            perm.append(views[0])
            continue
        while True:
            tentative = int(rng.randint(len(views)))
            if views[tentative] != int(idx):
                perm.append(views[tentative])
                break
    return np.asarray(perm, dtype=np.int64)


def _to01(rgb_nhwc: torch.Tensor) -> torch.Tensor:
    return rgb_nhwc.clamp(-1, 1).permute(0, 3, 1, 2).float() / 2 + 0.5


def _nchw01(x: torch.Tensor) -> np.ndarray:
    """(B, H, W, C) in [-1, 1] -> (B, C, H, W) numpy in [0, 1]."""
    return x.permute(0, 3, 1, 2).float().cpu().numpy() / 2 + 0.5


class GANEvaluator:
    """Periodic training evaluation (built once, called at each eval).

    `inception` maps (B, 3, H, W) images in [0, 1] to (B, D) activations
    (`models.inception.InceptionV3FID`); None turns FID off. `lpips` is
    the port's `LPIPS` (images in [-1, 1]) for the encoder mode's
    reconstruction metric; None leaves that metric out.
    """

    def __init__(self, cfg, dataset_config: dict, dataset_name: str,
                 train_split, train_eval_split, test_split=None,
                 inception: Optional[Callable] = None,
                 lpips: Optional[Callable] = None,
                 use_encoder: bool = False, use_class: bool = False,
                 eval_batch_size: int = 8,
                 stats_cache_dir: Optional[str] = None, seed: int = 1234,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.dataset_config = dataset_config
        self.dataset_name = dataset_name
        self.train_split = train_split
        self.train_eval_split = train_eval_split
        self.test_split = test_split
        self.inception = inception
        self.lpips = lpips
        self.use_encoder = use_encoder
        self.use_class = use_class
        self.eval_bs = eval_batch_size
        self.stats_cache_dir = stats_cache_dir
        self.device = resolve_device(device)
        self.best_fid = float('inf')
        # Called once per evaluation batch, in order, when set: returns
        # that render's {'depth', 'pdf_u'} draws.
        self.render_noise_provider: Optional[Callable[[], dict]] = None
        self.times = {'render_s': 0.0, 'inception_s': 0.0, 'stats_s': 0.0,
                      'recon_s': 0.0, 'images_s': 0.0}

        rng = np.random.RandomState(seed)
        n = len(train_eval_split.images)
        if train_eval_split.eval_indices is None:
            train_eval_split.eval_indices = compute_eval_indices(
                n, dataset_name, rng)
        if train_eval_split.eval_indices_perm is None:
            train_eval_split.eval_indices_perm = compute_view_perm(
                train_eval_split.eval_indices,
                dataset_config.get('views_per_object'), rng)
        if test_split is not None and dataset_config.get(
                'views_per_object_test'):
            test_split.eval_indices = np.arange(len(test_split.images))
            if len(test_split.eval_indices) > N_IMAGES_FID_MAX:
                test_split.eval_indices = np.sort(rng.permutation(
                    len(test_split.images))[:N_IMAGES_FID_MAX])
            test_split.eval_indices_perm = compute_view_perm(
                test_split.eval_indices,
                dataset_config['views_per_object_test'], rng)

        # The frozen latents, from the seed again.
        rng2 = np.random.RandomState(seed)
        self.z_fid = rng2.randn(len(train_eval_split.eval_indices),
                                cfg.latent_dim).astype(np.float32)
        self.z_fid_test = None
        if test_split is not None and test_split.eval_indices is not None:
            self.z_fid_test = rng2.randn(len(test_split.eval_indices),
                                         cfg.latent_dim).astype(np.float32)
    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _tensor(self, a) -> Optional[torch.Tensor]:
        if a is None:
            return None
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=self.device)

    def _field(self, split, idx, name) -> Optional[torch.Tensor]:
        v = getattr(split, name)
        return None if v is None else self._tensor(v[idx])

    # ---- Real-data Inception statistics --------------------------------

    def _stats_cache_path(self, tag: str) -> Optional[str]:
        if self.stats_cache_dir is None:
            return None
        return os.path.join(self.stats_cache_dir,
                            f'fid_stats_{self.dataset_name}_{tag}.npz')

    def real_stats(self, split, tag: str):
        """The (mu, sigma) of a split's real images, computed once and
        cached on the split and in `stats_cache_dir`; None without
        Inception."""
        if split.fid_stats is not None:
            return split.fid_stats
        if self.inception is None:
            return None
        path = self._stats_cache_path(tag)
        if path is not None and os.path.exists(path):
            data = io_lib.load_npz(path)
            split.fid_stats = (data['mu'], data['sigma'])
            return split.fid_stats
        acts = []
        images = split.images
        bs = self.eval_bs
        for i in range(0, len(images), bs):
            im = images[i:i + bs]
            pad = bs - len(im)
            if pad:
                im = np.concatenate([im, np.repeat(im[-1:], pad, 0)], 0)
            im = self._tensor(im[..., :3].transpose(0, 3, 1, 2)) / 2 + 0.5
            with torch.no_grad():
                a = self.inception(im).float().cpu().numpy()
            acts.append(a[:bs - pad] if pad else a)
        split.fid_stats = fid_lib.calculate_stats(np.concatenate(acts, 0))
        if path is not None:
            io_lib.save_npz(path, mu=split.fid_stats[0],
                            sigma=split.fid_stats[1])
        return split.fid_stats

    # ---- Rendering ------------------------------------------------------

    def render(self, gen: Generator, z: torch.Tensor, pose: torch.Tensor,
               focal: Optional[torch.Tensor], center: Optional[torch.Tensor],
               bbox: Optional[torch.Tensor], compute_normals: bool,
               compute_semantics: bool,
               noise_seed: Optional[int] = None,
               image: Optional[torch.Tensor] = None,
               labels: Optional[torch.Tensor] = None,
               render_rng: Optional[dict] = None) -> RenderOutput:
        """One gradient-free render of latents `z` from the given cameras
        (the normals take their point gradient inside), conditioned on
        `image` ((B, 3, H, W) in [-1, 1]) with the encoder or on the class
        `labels` under class conditioning. A noise-enabled generator draws
        its StyleGAN noise from a generator seeded `noise_seed` (its
        'const' noise when None); `render_rng` the render's draws (None:
        deterministic)."""
        cfg = self.cfg
        noise = None
        if gen.use_stylegan_noise and noise_seed is not None:
            noise = torch.Generator(device=self.device).manual_seed(
                noise_seed)
        with torch.no_grad():
            c = None
            if self.use_encoder and image is not None:
                c = gen.embed_image(image)
            elif self.use_class and labels is not None:
                c = gen.embed_class(labels)
            state = gen.synthesize(gen.map(z, c), noise=noise)
            return render(gen.field(state), cfg.resolution, cfg.resolution,
                          pose, focal, cfg.scene_range,
                          cfg.white_background, cfg.depth_samples_per_ray,
                          rng=render_rng, center=center, bbox=bbox,
                          compute_normals=compute_normals,
                          compute_semantics=compute_semantics,
                          fine_sampling=cfg.fine_sampling)

    def _labels(self, split, idx) -> Optional[torch.Tensor]:
        if not self.use_class or getattr(split, 'classes', None) is None:
            return None
        return torch.as_tensor(np.asarray(split.classes[idx]),
                               dtype=torch.int64, device=self.device)

    def _images(self, images: np.ndarray) -> torch.Tensor:
        """(B, H, W, C) in [-1, 1] -> the RGB channels, NCHW."""
        return self._tensor(images[..., :3].transpose(0, 3, 1, 2))

    def _semantics_image(self, semantics: torch.Tensor) -> np.ndarray:
        palette = self._tensor(io_lib.get_color_palette(
            self.cfg.attention_values))
        return _nchw01(semantics.float() @ palette)

    # ---- The evaluation -------------------------------------------------

    def evaluate(self, state, iteration: int,
                 writer=None) -> Tuple[Optional[float], bool]:
        """The evaluation of `state.gen_ema`: returns (FID or None,
        whether it is the best FID so far). The FID is the untruncated
        one, or with the encoder the random view's."""
        gen = state.gen_ema
        results = {}
        if not self.use_encoder:
            current = self._evaluate_mode(gen, iteration, writer,
                                          self.z_fid, None, False)
            results['generation/fid_untrunc'] = current
        else:
            front = self._evaluate_mode(gen, iteration, writer, self.z_fid,
                                        'front', False)
            current = self._evaluate_mode(gen, iteration, writer,
                                          self.z_fid, 'random', False)
            results['reconstruction/fid_frontview'] = front
            results['reconstruction/fid_randomview'] = current
            if (self.test_split is not None and
                    self.dataset_config.get('views_per_object_test')):
                for mode in ('front', 'random'):
                    self._evaluate_mode(gen, iteration, writer,
                                        self.z_fid_test, mode, True)
        if writer is not None:
            for k, v in results.items():
                if v is not None:
                    writer.add_scalar(k, v, iteration)
        is_best = current is not None and current < self.best_fid
        if is_best:
            self.best_fid = current
        return current, is_best

    def log_training_images(self, state, iteration: int, writer,
                            rng: np.random.RandomState) -> None:
        """The img/* family: a random training batch's real images, then
        renders of random latents from its poses by G (img/rgb, depth,
        mask, normals) and by its EMA (img/inference, inference_normals,
        inference_semantics)."""
        if writer is None:
            return
        t0 = time.perf_counter()
        cfg = self.cfg
        bs = self.eval_bs
        split = self.train_split
        idx = rng.randint(len(split.images), size=(bs,))
        pose = self._field(split, idx, 'tform_cam2world')
        focal = self._field(split, idx, 'focal_length')
        center = self._field(split, idx, 'center')
        bbox = self._field(split, idx, 'bbox')
        target = split.images[idx]
        z = self._tensor(rng.randn(bs, cfg.latent_dim).astype(np.float32))
        image = self._images(target) if self.use_encoder else None
        labels = self._labels(split, idx)
        writer.add_images('img/ref',
                          target[..., :3].transpose(0, 3, 1, 2) / 2 + 0.5,
                          iteration)
        for tag, gen in (('rgb', state.gen), ('inference', state.gen_ema)):
            # The same noise for G and its EMA, fixed per iteration.
            out = self.render(gen, z, pose, focal, center, bbox, True,
                              cfg.attention_values > 0,
                              noise_seed=TRAIN_IMAGES_NOISE_SEED + iteration,
                              image=image, labels=labels)
            writer.add_images(f'img/{tag}', _to01(out.rgb).cpu().numpy(),
                              iteration)
            if tag == 'rgb':
                depth = out.depth.float().cpu().numpy()
                writer.add_images(
                    'img/depth', (depth / max(depth.max(), 1e-9))[:, None],
                    iteration)
                writer.add_images(
                    'img/mask',
                    np.clip(out.mask.float().cpu().numpy(), 0, 1)[:, None],
                    iteration)
            writer.add_images(
                'img/normals' if tag == 'rgb' else 'img/inference_normals',
                _nchw01(out.normals), iteration)
            if tag == 'inference' and out.semantics is not None:
                writer.add_images('img/inference_semantics',
                                  self._semantics_image(out.semantics),
                                  iteration)
        if self.use_encoder:
            writer.add_images('img/inference_ref',
                              target[..., :3].transpose(0, 3, 1, 2) / 2 +
                              0.5, iteration)
        self.times['images_s'] += time.perf_counter() - t0

    def _evaluate_mode(self, gen: Generator, iteration: int, writer,
                       z_fid: Optional[np.ndarray],
                       recon_mode: Optional[str],
                       use_testset: bool) -> Optional[float]:
        """One pass over a split's evaluation set: unconditional
        (`recon_mode` None) or, with the encoder, each image's own view
        ('front') or the permuted one ('random'), the reconstruction
        metrics where the mode has a target; logs the first batch's images
        and returns the FID against the train-eval split's statistics
        (None on the test split or without Inception)."""
        split = self.test_split if use_testset else self.train_eval_split
        if split is None or z_fid is None:
            return None
        cfg = self.cfg
        target_idx = np.asarray(split.eval_indices)
        target_idx_ = (np.asarray(split.eval_indices_perm)
                       if recon_mode == 'random' else target_idx)
        views_per_object = self.dataset_config.get(
            'views_per_object_test' if use_testset else 'views_per_object')
        compute_recon = recon_mode == 'front' or (
            recon_mode == 'random' and views_per_object is not None and
            views_per_object > 1)
        has_mask = bool(self.dataset_config.get('has_mask'))
        bs = self.eval_bs
        n = len(target_idx)
        total = {name: 0.0 for name in RECON_METRICS}
        activations = []
        for start in range(0, n, bs):
            t0 = time.perf_counter()
            idx_ = target_idx_[start:start + bs]
            idx0 = target_idx[start:start + bs]
            valid = len(idx_)
            z = z_fid[start:start + valid]
            if valid < bs:  # pad the straggler; the padded rows drop below
                idx_ = np.concatenate([idx_, np.repeat(idx_[-1:],
                                                       bs - valid)])
                idx0 = np.concatenate([idx0, np.repeat(idx0[-1:],
                                                       bs - valid)])
                z = np.concatenate([z, np.repeat(z[-1:], bs - valid, 0)])
            image = None
            if self.use_encoder:
                source = (self.test_split if use_testset else
                          self.train_split)
                image = self._images(source.images[idx0])
            first = start == 0
            out = self.render(
                gen, self._tensor(z),
                self._field(split, idx_, 'tform_cam2world'),
                self._field(split, idx_, 'focal_length'),
                self._field(split, idx_, 'center'),
                self._field(split, idx_, 'bbox'), first,
                first and cfg.attention_values > 0,
                noise_seed=EVAL_NOISE_SEED + iteration * 1000003 + start,
                image=image, labels=self._labels(split, idx_),
                render_rng=(self.render_noise_provider()
                            if self.render_noise_provider is not None
                            else None))
            rgb = _to01(out.rgb)
            self._sync()
            t1 = time.perf_counter()
            self.times['render_s'] += t1 - t0

            eval_img = None
            if compute_recon:
                eval_img = self._images(split.images[idx_]) / 2 + 0.5
                weight = torch.zeros(bs, device=self.device)
                weight[:valid] = 1.0
                with torch.no_grad():
                    per_image = {
                        'psnr': image_metrics.psnr(rgb, eval_img,
                                                   reduction='none'),
                        'ssim': image_metrics.ssim(rgb, eval_img,
                                                   reduction='none')}
                    if self.lpips is not None:
                        per_image['lpips'] = self.lpips(
                            rgb * 2 - 1, eval_img * 2 - 1).reshape(-1)
                    if has_mask:
                        per_image['iou'] = image_metrics.iou(
                            out.mask, self._tensor(split.images[idx_][
                                ..., 3]), reduction='none')
                for name, v in per_image.items():
                    total[name] += float((v.float() * weight).sum())
                self.times['recon_s'] += time.perf_counter() - t1

            if first and writer is not None:
                self._log_first_batch(writer, iteration, out, rgb, eval_img,
                                      recon_mode, use_testset)
            if not use_testset and self.inception is not None:
                t1 = time.perf_counter()
                with torch.no_grad():
                    a = self.inception(rgb).float().cpu().numpy()
                activations.append(a[:valid])
                self.times['inception_s'] += time.perf_counter() - t1

        if compute_recon and writer is not None:
            suffix = '_test' if use_testset else ''
            for name in RECON_METRICS:
                if ((name == 'lpips' and self.lpips is None) or
                        (name == 'iou' and not has_mask)):
                    continue
                writer.add_scalar(
                    f'reconstruction/{name}{suffix}_{recon_mode}',
                    total[name] / n, iteration)
        if use_testset or self.inception is None:
            return None
        t0 = time.perf_counter()
        real = self.real_stats(self.train_eval_split, 'train')
        t1 = time.perf_counter()
        self.times['inception_s'] += t1 - t0
        acts = np.concatenate(activations, 0)
        assert len(acts) == n, (len(acts), n)
        fid = float(fid_lib.calculate_frechet_distance(
            *fid_lib.calculate_stats(acts), *real))
        self.times['stats_s'] += time.perf_counter() - t1
        return fid

    def _log_first_batch(self, writer, iteration: int, out: RenderOutput,
                         rgb: torch.Tensor, eval_img: Optional[torch.Tensor],
                         recon_mode: Optional[str], use_testset: bool
                         ) -> None:
        prefix = 'gen' if recon_mode is None else f'recon_{recon_mode}'
        tail = '_untrunc' + ('_test' if use_testset else '')
        if eval_img is not None:
            writer.add_images(f'img_eval_{prefix}/ref{tail}',
                              eval_img.cpu().numpy(), iteration)
        writer.add_images(f'img_eval_{prefix}/static{tail}',
                          rgb.cpu().numpy(), iteration)
        writer.add_images(f'img_eval_{prefix}/static_normals{tail}',
                          _nchw01(out.normals), iteration)
        if out.semantics is not None:
            writer.add_images(f'img_eval_{prefix}/static_semantics{tail}',
                              self._semantics_image(out.semantics),
                              iteration)
