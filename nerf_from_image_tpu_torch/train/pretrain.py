"""SDF pretraining: fit the field to the unit sphere before GAN training
(PyTorch port of `nerf_from_image_tpu/train/pretrain.py`).

1000 Adam steps (optax's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the
square root; no warmup, no clipping) on the distance MSE to ||x|| - 1 plus
the weighted eikonal loss over stratified volume samples, then EMA <-
params as a copy. A noise-enabled generator pretrains with fresh
StyleGAN noise every step, as the JAX package's does. Both losses decode
on the gather sampler (`ops/triplane.sample_triplane_gather`), as the
JAX package's pretraining decodes through XLA: no kernel runs here. The
JAX package scans the steps in one compiled program; here they are a
Python loop.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch

from nerf_from_image_tpu_torch.models import generator as generator_lib
from nerf_from_image_tpu_torch.models.stylegan import NoiseSource
from nerf_from_image_tpu_torch.ops import triplane
from nerf_from_image_tpu_torch.train import gan as gan_lib

PRETRAIN_STEPS = 1000
REQUESTS = ('sdf_distance_loss', 'sdf_eikonal_loss')
NSTRATA = 32


def sdf_planes(gen: generator_lib.Generator, z: torch.Tensor,
               noise: Optional[NoiseSource] = None) -> torch.Tensor:
    """map -> synthesis of the planes only (the palette is not needed):
    (B, 3, R, R, 32) channel-last, as `sdf_losses` takes them. `noise`:
    a noise-enabled generator's StyleGAN noise source."""
    ws = gen.map(z)
    return triplane.planes_channel_last(
        gen.synthesize_planes(ws[:, :14], noise))


def pretrain_losses(gen: generator_lib.Generator, z: torch.Tensor,
                    rng: Union[torch.Generator, Dict[str, torch.Tensor]],
                    eikonal_weight: float,
                    noise: Optional[NoiseSource] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step's (loss, dist, eik): the batch means of the distance and
    eikonal losses and loss = dist + eikonal_weight * eik. `rng` draws
    the strata (or is {'strata': ...}, as `sdf_losses` takes it); `noise`
    is the StyleGAN noise of a noise-enabled generator."""
    losses = gen.sdf_losses(sdf_planes(gen, z, noise), rng, REQUESTS,
                            NSTRATA)
    dist = losses['sdf_distance_loss'].mean()
    eik = losses['sdf_eikonal_loss'].mean()
    return dist + eikonal_weight * eik, dist, eik


def pretrain_sdf(state: gan_lib.GANTrainState, cfg: gan_lib.GANConfig,
                 eikonal_weight: float, lr: float,
                 n_steps: int = PRETRAIN_STEPS,
                 injected: Optional[Dict[str, torch.Tensor]] = None,
                 return_losses: bool = False,
                 generator: Optional[torch.Generator] = None):
    """Runs the pretraining loop on `state.gen` in place, then copies its
    parameters into `state.gen_ema`.

    Args:
      state: a GAN train state; its optimizers are not used (the loop's
        Adam is fresh) and it runs on the device its modules are on.
      injected: per-step draws stacked over steps, replacing the
        generator's, as the JAX package injects them: 'z' (n_steps, B,
        latent) and 'strata' (n_steps, B, n, n, n, 3) with n = 31.
      return_losses: also return the per-step (dist, eik), two (n_steps,)
        float32 tensors.
      generator: the source of the z, StyleGAN noise (a noise-enabled
        generator's fresh noise, as the JAX package draws it every step)
        and strata draws, in that order each step; None draws from
        `state.rng`.

    Returns the state, and with `return_losses` (state, (dist, eik)).
    """
    gen = state.gen
    rng = state.rng if generator is None else generator
    device = gen.beta.device
    params = list(gen.parameters())
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    dists: List[torch.Tensor] = []
    eiks: List[torch.Tensor] = []
    for step in range(n_steps):
        if injected is not None and 'z' in injected:
            z = injected['z'][step].to(device)
        else:
            z = torch.randn((cfg.batch_size, cfg.latent_dim), generator=rng,
                            device=device)
        reg_rng = rng
        if injected is not None and 'strata' in injected:
            reg_rng = {'strata': injected['strata'][step].to(device)}
        loss, dist, eik = pretrain_losses(gen, z, reg_rng, eikonal_weight,
                                          rng)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        dists.append(dist.detach())
        eiks.append(eik.detach())
    # EMA <- params, copied: the EMA must not move with later G steps.
    with torch.no_grad():
        for e, p in zip(state.gen_ema.parameters(), params):
            e.copy_(p)
    if return_losses:
        return state, (torch.stack(dists).float(), torch.stack(eiks).float())
    return state
