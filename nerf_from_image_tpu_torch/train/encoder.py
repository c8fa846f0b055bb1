"""Bootstrap-encoder distillation: train the SegFormer encoder on pairs
rendered by the frozen GAN (PyTorch port of
`nerf_from_image_tpu/train/encoder.py`).

Each step samples latents, renders image, mask and canonical coordinates
from the frozen EMA generator without a graph (`compute_coords`, so the
passes sample through B1 on the card, never the fused B5a), and trains
the encoder, in train mode with stochastic depth, on the masked L2 of its
coordinates, the L1 of its mask and the MSE of its latent. Adam (b1 0.9,
b2 0.999, eps 1e-8) at 6e-5, divided by 10 from iteration 60,000 of
120,000.

The state is updated in place. Every draw comes from the state's
`torch.Generator` (z, the render's depths and PDF draws, then the
stochastic-depth masks), or from arrays injected as the JAX package
injects them: `batch['z']` and `batch['noise']` ('depth', 'pdf_u', and
'sg_noise' for a noise-enabled generator, which otherwise draws fresh
StyleGAN noise for every target render).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.models.generator import Generator, Sampler
from nerf_from_image_tpu_torch.models.stylegan import NoiseSource
from nerf_from_image_tpu_torch.ops import triplane_cuda
from nerf_from_image_tpu_torch.render.renderer import render

MAX_ITERS = 120000
LR = 6e-5

Batch = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """The fields of the JAX package's `EncoderConfig` that the port
    reads; the schedule's length is MAX_ITERS."""
    resolution: int = 128
    latent_dim: int = 512
    depth_samples_per_ray: int = 64
    fine_sampling: bool = True
    scene_range: float = 0.55
    white_background: bool = True


@dataclasses.dataclass
class EncoderTrainState:
    encoder: BootstrapEncoder
    opt: torch.optim.Adam
    iteration: int
    rng: torch.Generator


def lr_schedule(count: int) -> float:
    """LR below MAX_ITERS // 2 optimizer steps, LR / 10 from there on,
    read at the optimizer's count before the update (as optax reads its
    schedule)."""
    return LR if count < MAX_ITERS // 2 else LR / 10.0


def make_optimizer(encoder: BootstrapEncoder) -> torch.optim.Adam:
    """Adam over the encoder's parameters; `train_step` sets its lr from
    the state's iteration, which counts its steps."""
    return torch.optim.Adam(encoder.parameters(), lr=lr_schedule(0),
                            betas=(0.9, 0.999), eps=1e-8)


def init_train_state(encoder: BootstrapEncoder,
                     seed: int = 0) -> EncoderTrainState:
    """A fresh state at iteration 0 for `encoder` (built on its device:
    CUDA unless it was asked for the CPU); the draws come from a
    generator of `seed` on that device."""
    device = next(encoder.parameters()).device
    return EncoderTrainState(
        encoder=encoder, opt=make_optimizer(encoder), iteration=0,
        rng=torch.Generator(device=device).manual_seed(seed))


@torch.no_grad()
def render_distillation_targets(
        gen: Generator, z: torch.Tensor, pose: torch.Tensor,
        focal: Optional[torch.Tensor], center: Optional[torch.Tensor],
        bbox: Optional[torch.Tensor], cfg: EncoderConfig,
        rng: Union[torch.Generator, Dict[str, torch.Tensor]],
        sampler: Sampler = triplane_cuda.sample_triplane,
        noise: Optional[NoiseSource] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The frozen generator's (image clipped to [-1, 1] (B, H, W, 3), mask
    (B, H, W), canonical coordinates (B, H, W, 3), ws (B, 15, 512)), all
    without a graph. `rng` draws the render's depths and PDF draws, or
    is {'depth', 'pdf_u'}, as `render` takes it. A noise-enabled generator
    renders with fresh StyleGAN noise: `noise` (a generator, or per-layer
    values), else drawn from `rng` when it is a generator, else its
    'const' noise."""
    ws = gen.map(z)
    if noise is None and isinstance(rng, torch.Generator):
        noise = rng
    state = gen.synthesize(ws, noise=noise)
    out = render(gen.field(state, sampler), cfg.resolution, cfg.resolution,
                 pose, focal, cfg.scene_range, cfg.white_background,
                 cfg.depth_samples_per_ray, rng=rng, center=center,
                 bbox=bbox, compute_coords=True,
                 fine_sampling=cfg.fine_sampling)
    return out.rgb.clamp(-1.0, 1.0), out.mask, out.semantics, ws


def distillation_loss(encoder: BootstrapEncoder, target_img: torch.Tensor,
                      target_mask: torch.Tensor,
                      target_coords: torch.Tensor, ws: torch.Tensor,
                      generator: torch.Generator
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The encoder's loss on the targets, in whatever mode the encoder is
    in (`generator` feeds stochastic depth in train mode): (loss,
    {'loss_coords', 'loss_mask', 'loss_latent'})."""
    coords, seg, w = encoder(target_img.permute(0, 3, 1, 2).contiguous(),
                             generator)
    loss_coords = (torch.linalg.vector_norm(coords - target_coords, dim=-1)
                   * target_mask).mean()
    loss_mask = (seg - target_mask).abs().mean()
    loss_latent = (w - ws[:, :1]).square().mean()
    return loss_coords + loss_mask + loss_latent, {
        'loss_coords': loss_coords, 'loss_mask': loss_mask,
        'loss_latent': loss_latent}


def train_step(state: EncoderTrainState, batch: Batch, gen: Generator,
               cfg: EncoderConfig) -> Dict[str, torch.Tensor]:
    """One distillation step on the frozen EMA generator `gen`. `batch`
    holds 'pose', optionally 'focal', 'center', 'bbox', and the injected
    'z' and 'noise'. Returns the three losses."""
    pose = batch['pose']
    z = batch.get('z')
    if z is None:
        z = torch.randn((pose.shape[0], cfg.latent_dim), generator=state.rng,
                        device=pose.device)
    render_rng = state.rng
    noise = batch.get('noise')
    if noise is not None and ('depth' in noise or 'pdf_u' in noise):
        render_rng = {k: noise[k] for k in ('depth', 'pdf_u') if k in noise}
    targets = render_distillation_targets(
        gen, z, pose, batch.get('focal'), batch.get('center'),
        batch.get('bbox'), cfg, render_rng,
        noise=(noise or {}).get('sg_noise', state.rng))

    encoder = state.encoder.train()
    loss, metrics = distillation_loss(encoder, *targets, state.rng)
    params = [p for p in encoder.parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    state.opt.param_groups[0]['lr'] = lr_schedule(state.iteration)
    for p, g in zip(params, grads):
        p.grad = g
    state.opt.step()
    state.opt.zero_grad(set_to_none=True)
    state.iteration += 1
    return {k: v.detach() for k, v in metrics.items()}
