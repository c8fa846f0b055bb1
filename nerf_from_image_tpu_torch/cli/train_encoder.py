"""Encoder distillation CLI: the reference's train_coord_regressor
(PyTorch port of `nerf_from_image_tpu/cli/train_encoder.py`).

Mirrors the reference's run.py:1521-1706: 120,000 steps of rendering
synthetic pairs from the frozen EMA generator and supervising the
SegFormer bootstrap encoder (`train/encoder.py`), the backbone started
from MiT-B5's ImageNet weights where `{root_path}/weights/mit_b5.pth`
exists; the losses logged every 1000 steps, `enc_latest` saved every
10,000 and `enc_<i>` every 20,000, each with the host RandomState and
the batch sampler's state, from which a run resumes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nerf_from_image_tpu_torch import config as config_lib
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.train import encoder as enc_lib
from nerf_from_image_tpu_torch.utils import checkpoint as ckpt_lib
from nerf_from_image_tpu_torch.utils import weights as weights_lib
from nerf_from_image_tpu_torch.utils.io import EndlessSampler

# The reference's step counts: the whole run, the log, `enc_latest` and
# `enc_<i>`.
MAX_ITERS = enc_lib.MAX_ITERS
LOG_EVERY = 1000
SAVE_EVERY = 10000
KEEP_EVERY = 20000


def train_coord_regressor(args, gan_cfg, gen, train_split,
                          ckpt_manager: ckpt_lib.CheckpointManager, writer,
                          device: torch.device) -> BootstrapEncoder:
    """Distills the encoder from the frozen generator `gen` (the EMA
    weights) over `train_split`'s cameras for MAX_ITERS steps, resuming
    from `enc_latest` when `ckpt_manager` holds one. Returns the
    encoder."""
    # A fresh encoder from seed 99, as the JAX CLI's PRNGKey(99): its
    # layers initialise on the host from torch's global generator.
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(99)
        encoder = BootstrapEncoder(args.latent_dim,
                                   separate_backbones=args.inv_use_separate,
                                   device=device)
    # A resumed run's own weights overwrite these below.
    weights_lib.load_mit_backbone(encoder, args.root_path)
    cfg = enc_lib.EncoderConfig(
        resolution=args.resolution, latent_dim=args.latent_dim,
        depth_samples_per_ray=config_lib.depth_samples(args),
        fine_sampling=args.fine_sampling,
        scene_range=gan_cfg.scene_range,
        white_background=gan_cfg.white_background)
    state = enc_lib.init_train_state(encoder, seed=99)

    rng_np = np.random.RandomState(1234)
    sampler = EndlessSampler(len(train_split.images), rng_np)
    if ckpt_manager.exists('enc_latest'):
        ckpt_lib.restore_encoder_checkpoint(ckpt_manager.load('enc_latest'),
                                            state, rng_np, sampler)
        print('Resumed encoder from iteration', state.iteration)

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)

    def save(label):
        ckpt_manager.save(ckpt_lib.encoder_checkpoint(state, rng_np, sampler),
                          label)

    t0 = time.time()
    while state.iteration < MAX_ITERS:
        idx = sampler(args.batch_size)
        batch = {'pose': tensor(train_split.tform_cam2world[idx])}
        for key, values in (('focal', train_split.focal_length),
                            ('bbox', train_split.bbox),
                            ('center', train_split.center)):
            if values is not None:
                batch[key] = tensor(values[idx])
        metrics = enc_lib.train_step(state, batch, gen, cfg)
        i = state.iteration

        if i % LOG_EVERY == 0:
            values = {k: float(v) for k, v in metrics.items()}
            rate = LOG_EVERY * args.batch_size / (time.time() - t0)
            print(f'[{i}] ' + ' '.join(f'{k} {v:.05f}' for k, v in
                                       values.items()) + f' ({rate:.1f} im/s)')
            t0 = time.time()
            for k, v in values.items():
                writer.add_scalar(f'coord_regressor/{k}', v, i)
        if i % SAVE_EVERY == 0:
            save('enc_latest')
            if i % KEEP_EVERY == 0:
                save(f'enc_{i}')
    save('enc_latest')
    return state.encoder
