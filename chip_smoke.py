#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`nerf_from_image_tpu_torch`) on one card.

Drives the port's paths at full width with random weights from a seed
(latent 512, 256^2 triplanes of 32 channels, 10 attention values,
bfloat16 activations, batch 8, 128x128 rays, 64 coarse + 64 fine
samples):

- the render forward at bench.py's operating point (camera at z = 2.0,
  focal 1.2), through the sampler and, with `fuse_decode`, through the
  fused sample + decoder tail; the same at 512^2 planes (the JAX CLI's
  `--plane_resolution 512`);
- the hybrid-inversion refinement step in the p3d_car geometry (scene
  range 1.4, black background, flipped perspective camera with z0 and
  the pose optimized): render -> VGG LPIPS on the image and 15 random
  affine crops -> backward to the latent and the camera -> Adam ->
  projection, against a target rendered from a second latent and a known
  camera;
- GAN training in p3d_car's configuration: a generator step (render with
  jittered depths from ADA-augmented poses, 4-channel discriminator,
  eikonal/tv/entropy, Adam, EMA) and a discriminator step (ADA on the 2x
  real images, R1, fakes rendered without a graph), against a real batch
  rendered once from a second latent at 256^2;
- the hybrid inversion of one batch in the p3d_car geometry: the
  bootstrap encoder (MiT-B5 SegFormer), host PnP, the initial
  parameters, 30 refinement steps with the checkpoint evaluations at
  steps 0 and 30 (front and novel views, their renders through the fused
  sample + decoder tail, the Inception activations of a random
  InceptionV3 in the reference's key format), the consolidated report
  and its files;
- a float32 generator's render and inversion step (the inversion CLI's
  precision), the kernels reading its planes rounded to bf16;
- the inversion CLI end to end (`python -m nerf_from_image_tpu_torch.cli
  .run --dataset p3d_car --run_inversion ...`, called in this process at
  its default flags, the generator in float32): a p3d_car fixture
  written to disk (20 test images in car_val.mat's layout, 24 train
  images), a reference-format GAN checkpoint and encoder file, the
  published weight files' layouts, the batches of 8, 8 and 4 with each
  next batch's PnP on a worker thread while the card runs the steps, and
  the report's files with FID;
- the GAN-training CLI end to end (`python -m nerf_from_image_tpu_torch
  .cli.run --dataset p3d_car ...`, in this process at its default flags:
  batch 32, bf16) on the same fixture and weight files: a fresh run
  (50 of the CLI's 1000 SDF pretraining steps, iterations 0-3, the
  iteration-3
  evaluation with FID and the image families with normals and
  semantics, `latest` and `best`) and a resume to iteration 8;
- several cards (`parallel/`): that training CLI resumed for one G and
  one D step under `python -m torch.distributed.run --standalone
  --nproc_per_node 1 -m nerf_from_image_tpu_torch.cli.run --mesh_shape
  data:1` (one rank, NCCL) against the same resume in this process, and
  two processes of this script (`--several-cards-rank`) on the one card
  under a gloo group taking a G and a D step at a global batch of 16
  against one process at 16, with two wrong variants that must fail;
  and the demo (below) on those two ranks at `--mesh_shape
  data:1,rays:2`, each rank rendering half the image rows of the export;
- the demo (`--inv_manual_input_path`) on the same fixture and files: a
  photo as RGBA (its alpha the mask) and as RGB (GrabCut's mask), each
  inverted at batch 1 and written as the strip [input | coords | recon |
  normals | novel view]; and the RGB photo saved as a CMYK JPEG, read
  through the demo's loader as three channels with no alpha mask (the
  images are read through cv2, as the JAX package reads them; the line
  `image_io: cv2 <version>` says so, and the run fails without cv2);
- the other datasets' generator features through both CLIs: a cub
  fixture (StyleGAN noise, orthographic cameras) and a carla fixture (the
  view-direction mapper), each inverted in one batch of 8 and trained for
  one G and one D step at batch 32 from a reference-format checkpoint at
  iteration 12,500;
- SDF pretraining at the CLI's batch of 32 (the same generator, p3d_car's
  box, 31^3 stratified points an image, distance + 0.1 eikonal, Adam at
  0.0025, then EMA <- params);
- encoder distillation at batch 32: the pretrained EMA generator renders
  image, mask and canonical coordinates (through B1, never the fused B5a)
  and the MiT-B5 encoder takes a train-mode step with stochastic depth.

Phases, each printed as one JSON line:

  device     the card, its power limit, the precision settings
  build      nvcc builds every kernel source, all at once, while the host
             C++ compiler builds the PnP solver
  kernel     each kernel (B1, B2, B4, B3 forward, B3 backward, B5a) against
             its plain PyTorch version at the shapes its path gives it; its
             time, bound and library yardstick; B1 and B5a also on a ragged
             N with B = 3 (tiles straddle images), a pile-up of clamped
             points, R = 40 and R = 512, B5a with its special-function
             floor (sfu_ms) and B1's time on its points beside it; B2 also
             on one inversion geometry, a pile-up of clamped points, tile
             boundaries, a ragged N and 512^2 planes; B4 also on p3d_car
             training cameras, a pile-up, tile boundaries, a ragged N with
             B = 3 and 512^2 planes; B3 forward and backward on crops
             outside the image at an odd size, the backward also on a
             scattered grid and 6 channels; for every kernel, device time
             (profiler) beside the time a call takes
  model      the full-width generator is built
  slice      map -> synthesize -> render through the kernels (launch counts
             reset just before and read just after), output checks, the same
             render with the plain sampler, ms per render and rays/s; the
             render with fuse_decode (B5a) against the plain render
  r512       the render at 512^2 planes: B1 and B5a against their plain
             versions at its coarse pass (the B6 and B5b rows), the render
             unfused and fused, each against the plain render, and their ms
  inversion  run_inversion through the kernels (counts reset just before
             and read just after), ms per step, the per-step metrics, and
             one step against the same step on the plain sampler and warp
  train      G + D step pairs through the kernels (counts reset just before
             and read just after each step), ms per step and per pair,
             images/s, peak memory, the losses; one G step against the same
             step on the plain sampler; one D step at iteration 1
  pipeline   bootstrap -> PnP -> init -> evaluation -> 30 steps ->
             evaluation -> report, ms per stage, launch counts per stage
             (B5a only in the evaluations, never B1 there; never B5a in the
             steps), the report's numbers and PnP's fallback count; the
             Inception activations of both evaluations, the Inception
             forward's ms per batch, and the report checkpoint and files
             written and read back in a temporary directory (the report
             without FID: the cli phase's holds it)
  float32    a float32 generator's render (B1 2) and one inversion step
             (B1 2, B2 2, B3 2 + 1) against the plain versions fed the same
             bf16-rounded planes, and the step's ms
  cli        the inversion CLI through `cli.run.main`: the fixture, the
             checkpoint and weight files written in a temporary directory,
             then the whole run; per batch the launches of the steps (B1
             60, B2 60, B3 60 forward and 30 backward) and of the two
             evaluations (B5a 8), counted around each call; per batch the
             wall time, encoder, evaluation and step ms, PnP's seconds on
             its thread and the main thread's wait for it; the dataset
             load, the real images' statistics and the report's
             consolidation; the report's 20 rows, finite means, FIDs and
             logged scalars; the generator's dtype (float32 at the
             default --compute_dtype bfloat16)
  train_cli  the GAN-training CLI through `cli.run.main` on the cli
             phase's fixture: a fresh run of 4 iterations and a resume to
             8; launches around every G step (B1 2, B4 2), D step (B1 2),
             pretraining call (none) and the evaluation (B1 16, B2 6 with
             the training images); G and D ms (CUDA events), pretraining,
             evaluation (render, Inception, `sqrtm`) and checkpoint
             seconds, peak memory; the checkpoints' iterations (4 and 8),
             the logged scalars (finite) and image tags; the evaluation's
             first render with normals against the plain versions
  demo       the demo through `cli.run.main --inv_manual_input_path` on
             the cli phase's fixture, for an RGBA and an RGB photo:
             launches around the 30 steps (B1 60, B2 60, B3 60 + 30), each
             evaluation (B5a 4) and the export renders (B1 6, B2 2), the
             strip read back (128 x 640), each run's wall time
  several_cards
             (a) the training CLI under the launcher (NCCL, one rank),
             resumed from the train_cli phase's `latest` for a G and a D
             step at 32, against the same resume in this process and a
             second one (the card's run-to-run floor): the model's
             tensors within 1e-2 of their largest entry plus twice the
             lr, Adam's moments in norm within max(5e-2, 2 x the floor);
             (b) two ranks on the card under gloo (the device passed
             explicitly), a G and a D step (R1, ADA) in float32 at a
             global batch of 16 with every draw from the states'
             generators, against one process at 16: losses 1e-2,
             gradient norms and G's last and D's first layer 5e-2, D's
             minibatch-stddev channel 5e-2, ADA's transforms 1e-6; the
             rows each rank's fakes came from, its latents, launches of
             B1 and B4, G and D ms, peak GB, init and first-collective
             seconds, a gloo all-reduce of G's gradients; (c) the same
             check must fail per-replica minibatch-stddev groups and
             local draws; (d) the demo phase's RGBA photo through
             `cli.run.main --mesh_shape data:1,rays:2` on two gloo ranks
             on the card: each rank's launches around the steps, the
             evaluations and the export (B1 6, B2 2 on its 64 of the 128
             image rows), how far the ranks' inverted parameters parted
             before rank 0's were broadcast, the gathered export renders
             against the rank's own whole render (rgb, depth and mask
             within 1e-3 of the largest entry, normals 5e-2) beside the
             floor between whole renders and the same split on the plain
             sampler, rank 0's strip against the one-process export
             of the same parameters (uint8 within 2 levels on 99.9% of
             the pixels), and, as readings, against the demo phase's
             strip beside the floor of two inversions (the ranks' own
             parameters, each exported whole); rank 0 alone writing, init
             s, wall s, peak GB; the render check must fail the strips
             gathered in reverse order and every rank rendering the first
             strip
  datasets   cub and carla fixtures (8 images each) through the inversion
             CLI (one batch: launches around the steps, as the cli phase,
             and the evaluations: B5a 4 each for cub, B1 4 each for carla,
             whose view directions keep the decode unfused) and the
             training CLI (resumed at 12,500: one G step, B1 2 + B4 2, one
             D step, B1 2; no pretraining); ms per step (CUDA events),
             peak memory; cub's inversion step (orthographic, injected
             StyleGAN noise) and carla's G step (at the first of batches
             32, 16, 8 at which the plain step fits) against the plain
             versions
  flag_modes GAN training's flag-only modes through the training CLI at
             full width, each resumed from a reference-format checkpoint
             of its configuration at the first of batches 32, 16, 8 that
             fits (the batch and any out-of-memory attempt in the line):
             carla with --use_encoder --dual_discriminator
             --path_length_regularization (two G + D pairs from 14,996,
             then the encoder-mode evaluation at 14,999: reconstruction
             metrics with LPIPS, two FIDs), cub with --use_class, p3d_car
             with --use_encoder --attention_values 0 --perturb_poses 5,
             carla with --use_encoder --dual_discriminator_mse (one G and
             one D step each); launches around every G step (B1 and B4 2 a
             render: 4 under dual D), D step (B1 2 a fake render) and
             evaluation (B1, B2; never B4 or B5a), ms per step (CUDA
             events), peak memory; carla's G step (both renders and the
             path length's backward) and D step (both discriminators, R1)
             at the run's batch (or the first smaller one at which the
             plain steps fit) against the plain sampler, with the noise
             floor of two kernel runs beside them and two wrong kernels
             that must fail (as in every GAN step check); what the path
             length's own backward adds to carla's G step (ms, traced,
             its kernel time by operator group); one inversion step at
             fine_sampling=False, ray_multiplier 4 (256 stratified samples
             a ray: B1 1, B2 1, B3 2 + 1) against the plain versions, and
             its ms
  pretrain   one warm-up step, then 5 pretraining steps (counts reset just
             before and read just after: no kernel runs), ms per step, peak
             memory, dist and eik per step, the EMA a copy of G; one step
             at batch 2 on the card against the same step on the CPU
  distill    one warm-up step, then 5 distillation steps (counts reset
             around each: B1 twice a step, nothing else), ms per step and
             per stage (targets' render, encoder forward + backward,
             Adam), images/s, peak memory, the three losses; the targets
             and one step's loss and gradients against the same on the
             plain sampler
  profile    the render's stages timed with CUDA events; one render, one
             inversion step, one G step, one D step, one pretraining step
             and one distillation step traced with torch.profiler: device
             busy time, its idle share of the traced wall time, costliest
             kernels and costliest operators with their input shapes

Then a line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
Any failure raises and the script exits non-zero; without CUDA it exits
non-zero before any result.

    python3 chip_smoke.py
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from nerf_from_image_tpu_torch import config as port_config
from nerf_from_image_tpu_torch.cli import demo as cli_demo
from nerf_from_image_tpu_torch.cli import inversion as cli_inversion
from nerf_from_image_tpu_torch.cli import run as cli_run
from nerf_from_image_tpu_torch.core import augment
from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.core import rays as rays_lib
from nerf_from_image_tpu_torch.data import fixtures
from nerf_from_image_tpu_torch.data import image_io
from nerf_from_image_tpu_torch.data import loaders
from nerf_from_image_tpu_torch.invert import optimizer as inv
from nerf_from_image_tpu_torch.invert import pipeline
from nerf_from_image_tpu_torch.invert import pnp
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.models.generator import palette_rgb
from nerf_from_image_tpu_torch.models.inception import InceptionV3FID
from nerf_from_image_tpu_torch.models import stylegan
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.ops import cuda_build
from nerf_from_image_tpu_torch.ops import triplane
from nerf_from_image_tpu_torch.ops import triplane_cuda
from nerf_from_image_tpu_torch.ops import warp
from nerf_from_image_tpu_torch.parallel import distributed
from nerf_from_image_tpu_torch.parallel import mesh
from nerf_from_image_tpu_torch.render.renderer import normalize, render
from nerf_from_image_tpu_torch.train import encoder as distill
from nerf_from_image_tpu_torch.train import eval as train_eval
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.train import loop
from nerf_from_image_tpu_torch.train import pretrain
from nerf_from_image_tpu_torch.utils import checkpoint
from nerf_from_image_tpu_torch.utils import convert
from nerf_from_image_tpu_torch.utils import logging as port_logging
from nerf_from_image_tpu_torch.utils import weights

# bench.py's operating point.
BATCH = 8
RES = 128
SAMPLES = 64
SCENE_RANGE = 0.55
FOCAL = 1.2
CAM_DIST = 2.0
GEN_KWARGS = dict(latent_dim=512, scene_range=SCENE_RANGE,
                  attention_values=10, img_resolution=256,
                  channel_base=32768, channel_max=512)

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
BF16_FLOPS = 989e12  # bf16 tensor cores
# Special-function results (exp2, log2, reciprocal) per SM per clock.
SFU_PER_SM_CLOCK = 16

# Kernel against plain version: both sum the same bf16 texels in float32;
# they differ only in the order of the 12-tap sum and in where the one
# rounding to bf16 lands, i.e. at most one bf16 ulp (2^-8 relative).
KERNEL_ATOL = KERNEL_RTOL = 1e-2
# Render with the kernel against the same render with the plain sampler:
# the bf16 feature differences above move the decoded sigma slightly,
# which moves the coarse weights, the PDF fine depths and the composite
# a little further; 2e-2 on rgb and mask in [0, 1] leaves room for that
# and still fails on any wrong texel, plane or axis.
RENDER_ATOL = 2e-2

# B2 against its plain version, on float32 copies of the same bf16 planes:
# both add the same float32 products, the kernel with atomics in another
# order, so the sums agree to float32 rounding of the largest partial sums;
# 1e-4 of the largest value leaves room for that and fails on any wrong
# tap, weight, plane, axis or clamp.
GRAD_RTOL = 1e-4
# B3 forward: the same float32 formula per pixel (the kernel may fuse a
# multiply-add); the crops are of values in [-1, 1].
WARP_ATOL = 1e-5
# B3 backward: each image pixel sums the float32 products of up to 60
# crop-pixel taps, the kernel with atomics in another order.
WARP_GRAD_RTOL = 1e-5
# B5a (and B5b) against its plain version: the same float32 products of
# the same bf16 values, summed in another order, so a rounding to bf16 (of
# a feature, a hidden unit, a probability or the output) can land one ulp
# apart; two such roundings are 2 x 2^-8 of the largest value.
FUSED_RTOL_OF_MAX = 2e-2
# The render with the fused decode against the plain (unfused) render: the
# fused call keeps the decoder's sums in float32 and rounds d once, where
# the unfused bf16 decoder rounds each layer's output, so sigma and rgb
# move by up to two bf16 roundings more than the B1 render does (2e-2).
FUSED_RENDER_ATOL = 3e-2

# The inversion: p3d_car's geometry (nerf_from_image_tpu/config.py:181)
# and the reference's refinement settings.
INV_CFG = inv.InversionConfig(
    resolution=RES, depth_samples_per_ray=SAMPLES, scene_range=1.4,
    white_background=False, camera_flipped=True, loss_type='vgg',
    num_augmentations=15, optimize_pose=True)
INV_STEPS = 5  # steps of the driven run, and timed steps after a warm-up
# One step with the kernels against the same step on the plain sampler and
# warp: B1 and B2 differ from their plain versions by one bf16 rounding of
# a feature or a dplanes texel and by float32 summation order. Those
# differences pass through the bf16 synthesis backward and move the fine
# depths of a few rays, so loss and gradients drift at the level of bf16
# noise, far below what a wrong tap, plane, axis or sign gives (order 1).
STEP_LOSS_RTOL = 1e-2  # |loss_k - loss_p| / |loss_p|
STEP_GRAD_RTOL = 5e-2  # ||g_k - g_p|| / ||g_p||, for z and R
# The GAN step checks' gradient, to the layer checked, of the terms that
# see the kernels' output alone (G's adversarial or recon loss, D's fake
# losses): on an H100 the kernels read 3.6e-2 to 9.7e-2 against the plain
# sampler, two wrong kernels 0.56 to 1.0 in G, 0.17 to 0.22 in D (where
# they fail the whole step's layer gradient, 0.12 to 0.15, instead).
STEP_TERMS_RTOL = 0.2

# The hybrid inversion of one batch (nerf_from_image_tpu/cli/inversion.py):
# checkpoint steps 0 and 30, PnP over the percentiles of the focals, the
# encoder's w over every slot.
PIPELINE_STEPS = 30
# The random encoder's coordinate head is rescaled to this spread about
# the origin and its mask logit shifted so that as many pixels pass PnP's
# cut as the targets have foreground, from one forward on the targets:
# with a head drawn at random, the coordinates fall anywhere and the mask
# under the cut, so every image takes the dummy pose, which faces away
# from the box, and all the batch's rays miss it (non-finite depths, in
# the JAX package too). The dummy pose is checked separately on a zeroed
# mask.
COORD_SPREAD = 0.5
PNP_MASK_CUT = 0.9  # invert/pnp.estimate_poses_batch keeps mask > 0.9
PERM_BBOX = ((-0.9, -0.9), (1.8, 1.8))  # the novel views' crop
# The inversion CLI (`python -m nerf_from_image_tpu_torch.cli.run
# --dataset p3d_car --run_inversion ...`) at its default flags on a p3d_car
# fixture on disk: 20 test images (batches of 8, 8 and a straggler of 4)
# and 24 train images, 240 x 320 PNGs, so that the 256^2 train load
# (augment_p 0.8 doubles 128) and the 128^2 bbox crops both shrink real
# pixels. Launches per batch: the 30 steps run B1 and B2 twice a step, B3
# forward twice and backward once; each of the two evaluations runs B5a 4
# times (two passes of the front and of the novel-view render).
CLI_TEST_IMAGES = 20
CLI_TRAIN_IMAGES = 24
CLI_IMAGE_HW = (240, 320)
CLI_STEPS = 30
CLI_STEP_LAUNCHES = {'triplane_sample': 2 * CLI_STEPS,
                     'triplane_sample_grad': 2 * CLI_STEPS,
                     'warp_forward': 2 * CLI_STEPS,
                     'warp_backward': CLI_STEPS}
CLI_EVAL_LAUNCHES = {'triplane_sample_fused': 4}
# The main thread's wait for a prefetched batch's PnP, as a share of the
# PnP's own time, that the overlap is meant to stay under.
CLI_WAIT_SHARE = 0.1

# The GAN-training CLI (`cli.run.main` without --run_inversion) at its
# default flags on the cli phase's fixture: a fresh run of TRAIN_CLI_ITERS[0]
# iterations (SDF pretraining first), then a resume to TRAIN_CLI_ITERS[1].
# Launches: a G step renders (B1, coarse and fine) and backpropagates to
# the planes (B4); a D step renders its fakes (B1). The iteration-3
# evaluation renders the 24 train-eval images in batches of 8 (B1 per
# pass; the first batch also asks for normals, B1 again and B2's
# coordinate gradient per pass) and then two training-image renders with
# normals (B1 4 and B2 2 each). Pretraining runs no kernel.
TRAIN_CLI_ITERS = (4, 8)
# The fresh run's SDF pretraining steps (the CLI's 1000 cut to keep the
# script within its time; pretrain_phase times the step itself).
TRAIN_CLI_PRETRAIN_STEPS = 50
# --profile_trace_at on the resume: the G step of this (even) iteration is
# traced into one Chrome trace under gan_logs/<name>/trace/, which must
# hold B1's and B4's launches by their CUDA function names.
TRAIN_CLI_TRACE_AT = 6
TRACE_KERNELS = {'triplane_sample': 'triplane_sample_kernel',
                 'triplane_sample_grad_planes': 'grad_planes_tiles_kernel'}
TRAIN_CLI_G = {'triplane_sample': 2, 'triplane_sample_grad_planes': 2}
TRAIN_CLI_D = {'triplane_sample': 2}
TRAIN_CLI_EVAL = {'triplane_sample': 8, 'triplane_sample_grad': 2}
TRAIN_CLI_IMAGES = {'triplane_sample': 8, 'triplane_sample_grad': 4}
# The scalars JAX's loop logs at iteration 0 (a G step; every 100) and its
# evaluator at 3, and the image families of the evaluation.
TRAIN_CLI_SCALARS = {
    0: ('loss/g', 'loss/eikonal', 'loss/tv', 'loss/entropy', 'grad_norm/g',
        'img_per_sec', 'augment/p', 'sdf/beta', 'sdf/alpha', 'sdf/beta_ema',
        'sdf/alpha_ema'),
    3: ('generation/fid_untrunc',)}
TRAIN_CLI_IMAGE_TAGS = (
    'img_eval_gen/static_untrunc', 'img_eval_gen/static_normals_untrunc',
    'img_eval_gen/static_semantics_untrunc', 'img/ref', 'img/rgb',
    'img/depth', 'img/mask', 'img/normals', 'img/inference',
    'img/inference_normals', 'img/inference_semantics')
# The evaluation's first render (batch 8, normals and semantics) through
# the kernels against the same render through the plain versions, both on
# the trained EMA's bf16 planes: rgb, mask and semantics at RENDER_ATOL;
# the normal map where the mask is above 0.5 at NORMAL_ATOL, the step
# checks' 5e-2 for gradients (a normal is a normalized gradient).
# The demo (--inv_manual_input_path) on the cli phase's fixture: one
# image, the CLI's 30 steps (the launches of CLI_STEP_LAUNCHES), the two
# evaluations through B5a and the export renders: the reconstruction with
# normals (B1 twice and B2 once a pass) and the novel view (B1 2).
DEMO_EVAL_LAUNCHES = CLI_EVAL_LAUNCHES
DEMO_EXPORT_LAUNCHES = {'triplane_sample': 6, 'triplane_sample_grad': 2}
DEMO_PANELS = 5  # input | coords | recon | normals | novel view
# The RGB photo as a quality-95 CMYK JPEG read back: its mean absolute
# error against the photo, in [0, 1] (the CPU tests' limit; 4.7e-3 on
# their 48 x 40 photo).
CMYK_JPEG_LOSS = 0.02
# The other datasets' features: cub (StyleGAN noise, orthographic
# cameras) and carla (the view-direction mapper), each through the
# inversion CLI (one batch of 8, no Inception file) and the training CLI
# (resumed at TRAIN_ITERATION for one G and one D step at batch 32).
DATASET_IMAGES = 8
DATASET_IMAGE_HW = {'cub': (240, 320), 'carla': (128, 128)}
DATASET_EVAL_LAUNCHES = {'cub': {'triplane_sample_fused': 4},
                         'carla': {'triplane_sample': 4}}
DATASET_G = TRAIN_CLI_G
DATASET_D = TRAIN_CLI_D
CUB_SCALE = 0.6  # the orthographic step check's camera scale s
# SRN ShapeNet and ImageNet through both CLIs at full width, as cub and
# carla: shapenet_cars' fixture holds one train and one test object of 8
# views each (128^2 RGBA on white, SRN's focal and principal point), so
# the test-set protocol inverts one batch of 8 with the pose frozen
# (--inv_no_optimize_pose) and reports the novel views (`*_random`) and
# no IoU; imagenet_car's holds 8 JPEG images (the train-split protocol:
# the uncropped image inverted, its bbox crop evaluated, the 2x images
# under ADA). Launches as cub's: the steps CLI_STEP_LAUNCHES (B2 still
# runs with the pose frozen: its gradient is taken and zeroed, as JAX
# does), each evaluation B5a 4, G B1 2 + B4 2, D B1 2.
FAMILY_DATASETS = ('shapenet_cars', 'imagenet_car')
FAMILY_IMAGE_HW = {'shapenet_cars': 128, 'imagenet_car': (240, 320)}
FAMILY_EVAL_LAUNCHES = {'triplane_sample_fused': 4}
FAMILY_POSE = ('R', 's', 't2', 'z0')
FAMILY_R_PROJECT_ATOL = 2.4e-7  # two float32 places at 1
# GAN training's flag-only modes through the training CLI at full width,
# each resumed from a reference-format checkpoint of its configuration:
# carla with the encoder, dual discriminators and path-length
# regularization (two G + D pairs from 14,996, then the evaluation at
# 14,999 in encoder mode), cub with class conditioning, p3d_car with the
# encoder, no palette and perturbed poses, and carla with the encoder and
# the MSE reconstruction mode (which cannot take p3d_car's and cub's
# alpha) (one G and one D step from 12,500 each). Each runs at the first
# batch of FLAG_BATCHES that fits on the card.
FLAG_MODES = {
    'carla': ('carla', ['--use_encoder', '--dual_discriminator',
                        '--path_length_regularization']),
    'cub': ('cub', ['--use_class']),
    'p3d_car': ('p3d_car', ['--use_encoder', '--attention_values', '0',
                            '--perturb_poses', '5']),
    'carla_mse': ('carla', ['--use_encoder', '--dual_discriminator_mse']),
}
FLAG_RESUME = {'carla': 14996, 'cub': 12500, 'p3d_car': 12500,
               'carla_mse': 12500}
FLAG_ITERS = {'carla': 4, 'cub': 2, 'p3d_car': 2, 'carla_mse': 2}
FLAG_BATCHES = (32, 16, 8)
# Renders a G step and a D step run: dual D renders twice in each, the
# recon mode's D step only for D2.
FLAG_RENDERS = {'carla': (2, 2), 'cub': (1, 1), 'p3d_car': (1, 1),
                'carla_mse': (2, 1)}
# The evaluation renders through B1 (and B2 for the first batch's
# normals), never B4 or B5a.
FLAG_EVAL = {triplane_cuda.KERNEL: True, triplane_cuda.GRAD_KERNEL: True}
NORMAL_ATOL = 5e-2

# GAN training: p3d_car as the JAX CLI builds it
# (nerf_from_image_tpu/config.py:181-186, 224-228), one card's batch of 8.
TRAIN_CFG = gan.GANConfig(
    resolution=RES, latent_dim=512, depth_samples_per_ray=SAMPLES,
    scene_range=1.4, white_background=False, camera_flipped=True,
    supervise_alpha=True, is_highres=True, augment_ada=True,
    augment_p_max=0.8, batch_size=BATCH, attention_values=10,
    plane_resolution=256, channel_base=32768, channel_max=512)
TRAIN_ITERATION = 12500  # past the blur warmup, as all but a run's start
TRAIN_AUGMENT_P = 0.4  # ADA acts on poses and real images
TRAIN_PAIRS = 5  # timed G + D pairs, after one warm-up pair
# Launches per step of each kernel: the G step renders (B1, coarse and
# fine) and backpropagates to the planes only (B4); the D step renders its
# fakes without a graph (B1). No coordinate carries a gradient (no B2), and
# the ADA warp is plain PyTorch (no B3).
G_STEP_LAUNCHES = {'triplane_sample': 2, 'triplane_sample_grad': 0,
                   'triplane_sample_grad_planes': 2, 'warp_forward': 0,
                   'warp_backward': 0, 'triplane_sample_fused': 0}
D_STEP_LAUNCHES = dict(G_STEP_LAUNCHES, triplane_sample_grad_planes=0)

# SDF pretraining and encoder distillation: the CLI's batch
# (nerf_from_image_tpu/config.py:31), the flagship generator in p3d_car's
# box with bfloat16 activations (the CLI's compute dtype), one warm-up step
# and then STAGE_STEPS timed steps each.
STAGE_BATCH = 32
STAGE_STEPS = 5
# Pretraining's timed steps: the training CLI's fresh run times all 1000.
PRETRAIN_TIMED_STEPS = 2
PRETRAIN_CFG = dataclasses.replace(TRAIN_CFG, batch_size=STAGE_BATCH)
PRETRAIN_LR = 0.0025  # config.py:38
PRETRAIN_EIKONAL = 0.1  # config.py:46
# One pretraining step at batch 2 on the card against the same step on the
# CPU, both in float32 (TF32 off), from the same weights, z and strata: the
# same float32 sums in another order (cuDNN's convolutions, the atomics of
# the gather's backward). On an H100 80GB HBM3 at 700 W they read 5.9e-7
# (loss) and 1.2e-6 (gradients); the limits sit about 20 and 100 times
# above, below what one bfloat16 rounding in a layer moves (about 4e-3).
PRETRAIN_CHECK_BATCH = 2
PRETRAIN_LOSS_RTOL = 1e-5  # |loss_card - loss_cpu| / |loss_cpu|
PRETRAIN_GRAD_RTOL = 1e-4  # ||g_card - g_cpu|| / ||g_cpu||, per tensor
DISTILL_CFG = distill.EncoderConfig(
    resolution=RES, latent_dim=512, depth_samples_per_ray=SAMPLES,
    scene_range=1.4, white_background=False)
# A distillation step renders its targets (B1, coarse and fine) without a
# graph and trains the encoder, which runs no kernel of the port.
DISTILL_LAUNCHES = dict(D_STEP_LAUNCHES)
# At the step's batch (B1 on (32, 3, 256, 256, 32) planes, 33.5M points a
# pass): B1's output in the coarse and the fine pass, and the targets,
# against the plain sampler on the same inputs, as the slice phase holds
# its render (RENDER_ATOL, here of each output's largest value: the
# coordinates reach the box's 1.4); then one step's loss and gradients on
# those targets as the other step checks hold theirs (STEP_LOSS_RTOL,
# STEP_GRAD_RTOL). The plain sampler runs on slices of PLAIN_SLICE views,
# joined back together, so that its gathers fit beside the kept states
# (each view is sampled on its own planes alone).
PLAIN_SLICE = 8
DISTILL_TARGET_RTOL = RENDER_ATOL

TRIPLANE_TPU_KERNEL = 'nerf_from_image_tpu/ops/pallas/triplane_window.py:282'
TRIPLANE_SOURCE = 'nerf_from_image_tpu_torch/ops/csrc/triplane_sample.cu'
GRAD_TPU_KERNEL = 'nerf_from_image_tpu/ops/pallas/triplane_window.py:305'
GRAD_SOURCE = 'nerf_from_image_tpu_torch/ops/csrc/triplane_sample_grad.cu'
GRAD_PLANES_TPU_KERNEL = (
    'nerf_from_image_tpu/ops/pallas/triplane_window.py:476')
GRAD_PLANES_SOURCE = (
    'nerf_from_image_tpu_torch/ops/csrc/triplane_sample_grad_planes.cu')
WARP_TPU_KERNEL = 'nerf_from_image_tpu/ops/pallas/warp.py:73'
WARP_SOURCE = 'nerf_from_image_tpu_torch/ops/csrc/warp.cu'
FUSED_TPU_KERNEL = 'nerf_from_image_tpu/ops/pallas/triplane_window.py:292'
FUSED_SOURCE = 'nerf_from_image_tpu_torch/ops/csrc/triplane_sample_fused.cu'
WINDOW_FUSED_TPU_KERNEL = (
    'nerf_from_image_tpu/ops/pallas/triplane_window.py:600')
WINDOW_TPU_KERNEL = 'nerf_from_image_tpu/ops/pallas/triplane_window.py:656'
R512 = 512  # the second plane resolution

# Several cards (`parallel/`). (a) The training CLI under the launcher a
# user with N cards runs (`python -m torch.distributed.run --standalone
# --nproc_per_node 1 -m nerf_from_image_tpu_torch.cli.run --mesh_shape
# data:1 ...`: one rank, NCCL), resumed from the train_cli phase's
# `latest` for SEVERAL_CLI_STEPS iterations (a G and a D step at the
# CLI's batch of 32), against the same resume in this process without a
# launcher: every tensor of the two `latest` files within SEVERAL_CLI_RTOL
# of the tensor's largest entry plus twice the steps' lr (Adam's
# sign-like step on a gradient at bf16 noise), and Adam's moments (a
# gradient and its square) in norm within the larger of STEP_GRAD_RTOL
# and SEVERAL_FLOOR_FACTOR times the worst moment's reading between two
# plain resumes: the card's own run-to-run noise (cuDNN's and B4's float
# atomics through the bf16 D), which alone passes 5e-2 on a few of D's
# moments. (b) SEVERAL_RANKS processes of this script
# (`--several-cards-rank`) on the one card under a gloo group take a G
# and a D step (R1, ADA's transforms and its controller at i % 8 = 7) in
# float32 (in bf16 cuDNN's algorithms for batches of 8 and 16 alone part
# D's first-layer gradient by 5.8e-2) at the global batch SEVERAL_BATCH,
# every draw from the state's generators, against one process at that
# batch with the same seeds: the losses within STEP_LOSS_RTOL, the gradient norms
# and the gradients of G's last synthesis layer and D's first layer
# within STEP_GRAD_RTOL (the GAN step checks' limits), D's
# minibatch-stddev channel on the real batch within STEP_GRAD_RTOL of its
# largest value, and ADA's transforms within SEVERAL_DRAW_ATOL. (c) Each
# wrong variant must fail that check: groups within each rank's rows
# ('per_replica_mbstd') and draws of each rank's own rows from the shared
# generator ('local_draws').
SEVERAL_CLI_STEPS = 2
SEVERAL_CLI_RTOL = 1e-2
SEVERAL_FLOOR_FACTOR = 2.0
SEVERAL_RANKS = 2
SEVERAL_BATCH = 16
SEVERAL_ITERATION = 12502
SEVERAL_VARIANTS = ('global', 'per_replica_mbstd', 'local_draws')
SEVERAL_TIMED_PAIRS = 1  # after the checked pair, on the global variant
SEVERAL_DRAW_ATOL = 1e-6
SEVERAL_TIMEOUT_S = 600
SEVERAL_LAUNCHES = {'g': G_STEP_LAUNCHES, 'd': D_STEP_LAUNCHES}
# (d) The demo on the rays axis: SEVERAL_RANKS processes of this script
# (`--rays-demo-rank`) on the one card under a gloo group run the demo
# phase's RGBA photo through `cli.run.main --mesh_shape RAYS_MESH`: each
# rank inverts the photo, takes rank 0's parameters and renders its share
# of the image rows of both export views (the export's launches,
# DEMO_EXPORT_LAUNCHES, on each share). Checks: each gathered export
# render against the rank's own whole render from the same parameters
# (rgb, depth, mask, normals; the limit below); rank 0's strip against the
# strip `export_demo` writes in one process from the same parameters,
# uint8 within RAYS_STRIP_LEVELS on at least RAYS_STRIP_SHARE of the
# pixels; rank 0 alone writes. Against the demo phase's one-process strip
# the split strip is read, not held: two inversions of the photo on an
# H100 part by float atomics (the ranks' own, before the broadcast, by
# 1.7e-3 to 2.5e-3 on z at 700 W), and their strips with them (the
# reading beside it: the ranks' own parameters, each exported whole). Each wrong variant of the split must fail the
# render check: the shares gathered in reverse order ('reversed') and
# every rank rendering the first share ('first_strip'). The render check
# holds rgb, depth and mask to RAYS_RENDER_RTOL of the largest entry and
# the normals to NORMAL_ATOL, the limit of every check of normals through
# the kernels: a normal is a normalized gradient of bf16 features, and
# where the random generator's SDF gradient is small it moves with the
# last bits of its input. On an H100 at 700 W the normals of two whole
# renders of the same parameters in one process parted by 3.2e-3 to
# 2.0e-2 of the largest entry, and with the plain sampler the split from
# the whole by 3.8e-3 to 1.4e-2; rgb, depth and mask by under 1e-4. Both
# readings stand beside the check (RAYS_FLOOR_RENDERS more whole renders
# against the first).
RAYS_MESH = 'data:1,rays:2'
RAYS_RENDER_RTOL = 1e-3
RAYS_FLOOR_RENDERS = 3
RAYS_STRIP_LEVELS = 2
RAYS_STRIP_SHARE = 0.999
RAYS_VARIANTS = ('reversed', 'first_strip')
RAYS_MAPS = ('rgb', 'depth', 'mask', 'normals')
RAYS_LIMITS = dict({k: RAYS_RENDER_RTOL for k in RAYS_MAPS},
                   normals=NORMAL_ATOL)
# The kernels of the demo's path: B1, B2, B3 forward and backward, B5a.
RAYS_KERNELS = (triplane_cuda.KERNEL, triplane_cuda.GRAD_KERNEL,
                'warp_forward', 'warp_backward', triplane_cuda.FUSED_KERNEL)


def emit(phase: str, started: float, **fields) -> None:
    fields = {'phase': phase, 'seconds': time.perf_counter() - started,
              **fields}
    print(json.dumps(fields), flush=True)


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of `iters` calls, each between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, iters: int = 10) -> dict:
    """Device-only ms of one call of `fn`, two ways: the summed duration of
    every kernel and memset that `iters` calls ran, from a torch.profiler
    trace ('trace'); and CUDA events around 100 back-to-back calls, over
    100 ('back_to_back'), which equals the device time only where the host
    enqueues faster than the device runs."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    traced = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(100):
        fn()
    end.record()
    end.synchronize()
    return {'trace': traced / 1e3 / iters if traced > 0 else None,
            'back_to_back': start.elapsed_time(end) / 100}


def camera(device: torch.device):
    cam = torch.eye(4, device=device).repeat(BATCH, 1, 1)
    cam[:, 2, 3] = CAM_DIST
    focal = torch.full((BATCH,), FOCAL, device=device)
    return cam, focal


def coarse_coords(device: torch.device, cam=None, focal=None,
                  scene_range: float = SCENE_RANGE) -> torch.Tensor:
    """Normalized points of one coarse pass, (B, N, 3) float32: bench.py's
    camera unless `cam` and `focal` are given."""
    if cam is None:
        cam, focal = camera(device)
    origins, dirs = rays_lib.get_ray_bundle(RES, RES, focal, cam)
    dirs = normalize(dirs)
    near, far = rays_lib.compute_near_far_planes(origins, dirs, scene_range)
    points, _ = rays_lib.compute_query_points_from_rays(origins, dirs, near,
                                                        far, SAMPLES)
    return (points.reshape(cam.shape[0], -1, 3) / scene_range).contiguous()


def inversion_coords(device: torch.device) -> torch.Tensor:
    """The coarse pass of one inversion geometry: p3d_car's box (1.4),
    cameras at random azimuths (`p3d_cameras`)."""
    cam, focal = p3d_cameras(np.random.default_rng(12), BATCH, device)
    return coarse_coords(device, cam, focal, INV_CFG.scene_range)


def touched_texels(planes_cl: torch.Tensor, coords: torch.Tensor) -> int:
    """Distinct texels the points' 2x2 taps read."""
    b, _, r, _, _ = planes_cl.shape
    seen = torch.zeros(b * 3 * r * r, dtype=torch.bool,
                       device=planes_cl.device)
    for start in range(0, coords.shape[1], 1 << 18):
        rows, _ = triplane.tap_offsets(planes_cl,
                                       coords[:, start:start + (1 << 18)])
        seen[rows.reshape(-1)] = True
    return int(seen.sum())


def device_phase() -> dict:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: CUDA is not available')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    # State both float32 precision switches: float32 matmuls and convs
    # run in full float32 (the render itself runs in bfloat16).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': torch.cuda.device_count()}
    emit('device', started, nvidia_smi=smi_line, torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=False, **device)
    return device


def reader_phase() -> None:
    """The image reader: cv2, as the JAX package reads images. The card's
    machine has it, so no read falls back to PIL."""
    if image_io.cv2 is None:
        raise AssertionError('image_io: no cv2; reads would fall back to '
                             'PIL')
    print(f'image_io: cv2 {image_io.cv2.__version__}', flush=True)


def build_phase() -> None:
    started = time.perf_counter()
    sources = [triplane_cuda.KERNEL, triplane_cuda.GRAD_KERNEL,
               triplane_cuda.GRAD_PLANES_KERNEL, warp.KERNEL,
               triplane_cuda.FUSED_KERNEL]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pnp_build = pool.submit(pnp.load_library)
        cuda_build.build(sources)
        pnp_build.result()
    pnp_seconds = time.perf_counter() - started
    # Each kernel's entry, registers, shared memory and spills.
    ptxas = {name: [line.strip() for line in
                    cuda_build.build_log.get(name, '').splitlines()
                    if any(key in line for key in
                           ('entry function', 'registers', 'spill'))]
             for name in sources}
    emit('build', started, nvcc_seconds=cuda_build.build_seconds,
         pnp_library=str(pnp.library_path().name),
         pnp_done_seconds=pnp_seconds, ptxas=ptxas)


def bound(bytes_moved: float, flops: float, bf16_flops: float = 0.0
          ) -> dict:
    """The least time for the work: bytes over the memory rate, float32
    operations over the float32 rate, or bf16 products over the bf16
    tensor-core rate, whichever is largest (the three run on separate
    units, which can overlap)."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    f32_ms = flops / F32_FLOPS * 1e3
    bf16_ms = bf16_flops / BF16_FLOPS * 1e3
    flops_ms = max(f32_ms, bf16_ms)
    return {'bytes': bytes_moved, 'flops': flops, 'bf16_flops': bf16_flops,
            'bytes_ms': bytes_ms, 'f32_ms': f32_ms, 'bf16_ms': bf16_ms,
            'flops_ms': flops_ms,
            'bound_ms': max(bytes_ms, flops_ms),
            'bound_by': 'bytes' if bytes_ms >= flops_ms else 'operations'}


def row(name: str, source: str, replaces: str, max_err: float, ms: float,
        plain_ms: float, library_ms: float, b: dict) -> dict:
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': None, 'max_abs_err': max_err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b['bound_ms'],
            'bound_by': b['bound_by'], 'library_ms': library_ms}


def rel_max(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max |a - ref| / max |ref|."""
    return float((a.float() - ref.float()).abs().max() /
                 ref.float().abs().max().clamp_min(1e-30))


def phase_planes() -> torch.Tensor:
    """The kernel phases' planes: seeded N(0, 1) bf16 (B, 3, 256, 256,
    32), the flagship's shape."""
    gen = torch.Generator(device='cuda').manual_seed(1)
    r = GEN_KWARGS['img_resolution']
    return torch.randn((BATCH, 3, r, r, triplane_cuda.CHANNELS),
                       generator=gen, device='cuda').to(torch.bfloat16)


def kernel_phase() -> dict:
    """The triplane kernel against its plain version at the flagship pass
    and at `forward_cases`; returns its row."""
    started = time.perf_counter()
    cases = {what: sampler_case(planes_cl, coords)
             for what, (planes_cl, coords) in forward_cases().items()}
    return sampler_check(phase_planes(), coarse_coords(torch.device('cuda')),
                         triplane_cuda.KERNEL, TRIPLANE_TPU_KERNEL, started,
                         cases)


def pile_up(gen: torch.Generator, b: int, n: int) -> torch.Tensor:
    """(b, n, 3) points, 90% of them outside the box on every axis they
    leave it on, from 1 to 3 box half-widths out, so they clamp onto the
    border texels and the corners; the rest inside."""
    dev = torch.device('cuda')
    u = torch.rand((b, n, 3), generator=gen, device=dev)
    sign = torch.where(torch.rand((b, n, 3), generator=gen, device=dev) <
                       0.5, -1.0, 1.0)
    inside = torch.rand((b, n, 1), generator=gen, device=dev) < 0.1
    return torch.where(inside, u * 2.0 - 1.0, sign * (1.0 + 2.0 * u))


def forward_cases() -> dict:
    """The forward kernels' (B1, B5a) further cases, each (planes, coords)
    from a seed: a ragged N with B = 3, so that the warps' point tiles
    straddle images; a pile-up of points clamped outside the box; R = 40,
    a resolution no tile divides; and R = 512."""
    gen = torch.Generator(device='cuda').manual_seed(8)

    def planes(b, r):
        return torch.randn((b, 3, r, r, triplane_cuda.CHANNELS),
                           generator=gen, device='cuda').to(torch.bfloat16)

    def uniform(b, n):
        return torch.rand((b, n, 3), generator=gen,
                          device='cuda') * 2.4 - 1.2

    r = GEN_KWARGS['img_resolution']
    return {'ragged N': (planes(3, r), uniform(3, 8191)),
            'pile-up': (planes(BATCH, r), pile_up(gen, BATCH, 1 << 20)),
            'R 40': (planes(2, 40), uniform(2, 100003)),
            'R 512': (planes(2, R512), uniform(2, 100003))}


def sampler_case(planes_cl: torch.Tensor, coords: torch.Tensor) -> dict:
    """B1 against its plain version at KERNEL_ATOL and KERNEL_RTOL on one
    of `forward_cases`, timed where it is the pile-up's full pass."""
    out = triplane_cuda.launch(planes_cl, coords)
    torch.cuda.synchronize()
    ref = triplane.sample_triplane_plain(planes_cl, coords)
    err = (out.float() - ref.float()).abs()
    bad = int((err > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()).sum())
    if bad or not torch.isfinite(out).all():
        raise AssertionError(f'triplane kernel disagrees with its plain '
                             f'version at {bad} values of a forward case '
                             f'(B {coords.shape[0]}, N {coords.shape[1]}, '
                             f'R {planes_cl.shape[2]})')
    case = {'batch': coords.shape[0], 'points': coords.shape[1],
            'plane_resolution': planes_cl.shape[2],
            'max_abs_err': float(err.max())}
    if coords.shape[1] >= 1 << 20:
        fn = lambda: triplane_cuda.launch(planes_cl, coords)  # noqa: E731
        case.update(ms=time_cuda(fn, 10), device_ms=device_ms(fn))
    return case


def sampler_check(planes_cl: torch.Tensor, coords: torch.Tensor, name: str,
                  replaces: str, started: float, cases: dict = None) -> dict:
    """B1 against its plain version on these planes and points, its time
    (per call and on the device), bound and `F.grid_sample` yardstick;
    emits a kernel line (with `cases`, if given) and returns its row."""
    r = planes_cl.shape[2]
    out = triplane_cuda.launch(planes_cl, coords)
    torch.cuda.synchronize()
    ref = triplane.sample_triplane_plain(planes_cl, coords)
    err = (out.float() - ref.float()).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    bad = int((err > KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()).sum())
    if bad or not torch.isfinite(out).all():
        raise AssertionError(f'triplane kernel disagrees with its plain '
                             f'version at {bad} values (max {max_err})')

    ms = time_cuda(lambda: triplane_cuda.launch(planes_cl, coords), 20)
    dev_ms = device_ms(lambda: triplane_cuda.launch(planes_cl, coords))
    plain_ms = time_cuda(
        lambda: triplane.sample_triplane_plain(planes_cl, coords), 5, 1)

    # Yardstick only (the port never calls it): grid_sample on the
    # channel-first planes, border padding, align_corners=True, then the
    # mean over the three planes. grid_sample takes its grid in the
    # planes' dtype, and a bf16 grid rounds the coordinates (a different
    # function), so it runs on the same texels in float32.
    n = coords.shape[1]
    planes_cf = planes_cl.permute(0, 1, 4, 2, 3).reshape(
        BATCH * 3, triplane_cuda.CHANNELS, r, r).float().contiguous()
    grid = torch.stack([coords[..., list(axes)]
                        for axes in triplane.PLANE_AXES], dim=1)
    grid = grid.reshape(BATCH * 3, 1, n, 2)

    def library():
        s = F.grid_sample(planes_cf, grid, mode='bilinear',
                          padding_mode='border', align_corners=True)
        return s.reshape(BATCH, 3, -1, n).mean(dim=1)

    library_ms = time_cuda(library, 10)
    library_device_ms = device_ms(library, 5)
    library_err = float((library().transpose(1, 2).float() -
                         ref.float()).abs().max())

    points = coords.shape[0] * n
    texels = touched_texels(planes_cl, coords)
    bytes_moved = (coords.numel() * coords.element_size() +
                   out.numel() * out.element_size() +
                   texels * triplane_cuda.CHANNELS * planes_cl.element_size())
    b = bound(bytes_moved, points * 3 * 4 * triplane_cuda.CHANNELS * 2)
    emit('kernel', started, name=name, plane_resolution=r, points=points,
         max_abs_err=max_err, mean_abs_err=mean_err, atol=KERNEL_ATOL,
         rtol=KERNEL_RTOL, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
         library_ms=library_ms, library_device_ms=library_device_ms,
         library_max_abs_err=library_err, touched_texels=texels,
         cases=cases, **b)
    return row(name, TRIPLANE_SOURCE, replaces, max_err, ms, plain_ms,
               library_ms, b)


def max_sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    smi = subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm',
                          '--format=csv,noheader,nounits'],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def sfu_ms(points: int, k: int) -> float:
    """The fused decode's special-function floor: per point one exp2 and
    one log2 for each hidden unit's softplus and one exp2 for each of the
    K logits, at SFU_PER_SM_CLOCK results per SM per clock at the card's
    highest clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops = points * (2 * triplane_cuda.HIDDEN + k)
    return ops / (sms * SFU_PER_SM_CLOCK * max_sm_clock_hz()) * 1e3


def decode_args(gen: Generator, planes_cl: torch.Tensor,
                coords: torch.Tensor, palette: torch.Tensor) -> tuple:
    """`triplane_cuda.launch_fused`'s arguments: these planes and points,
    the generator's decoder weights and this palette, in the kernel's
    types."""
    with torch.no_grad():
        w0, b0, w1, b1 = gen.fused_decode_weights()
        w0, w1 = w0.to(torch.bfloat16).contiguous(), w1.to(
            torch.bfloat16).contiguous()
        b0, b1 = b0.float().contiguous(), b1.float().contiguous()
    palette = palette.to(torch.bfloat16).contiguous()
    return planes_cl, coords, w0, b0, w1, b1, palette


def fused_error(args: tuple, what: str) -> tuple:
    """B5a against its plain version at FUSED_RTOL_OF_MAX of the largest
    value; returns the kernel's output, the largest error and value."""
    out = triplane_cuda.launch_fused(*args)
    torch.cuda.synchronize()
    ref = triplane.sample_triplane_fused_plain(*args)
    max_err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    if max_err > FUSED_RTOL_OF_MAX * scale or not torch.isfinite(out).all():
        raise AssertionError(f'{what} disagrees with its plain version: max '
                             f'{max_err} against {FUSED_RTOL_OF_MAX} x '
                             f'{scale}')
    return out, max_err, scale


def fused_cases(gen: Generator) -> dict:
    """B5a against its plain version at `forward_cases`, with the
    generator's decoder weights and a seeded palette per image; the
    pile-up's full pass timed."""
    palettes = torch.Generator(device='cuda').manual_seed(9)
    cases = {}
    for what, (planes_cl, coords) in forward_cases().items():
        palette = torch.randn(
            (coords.shape[0], triplane_cuda.FUSED_VALUES, 3),
            generator=palettes, device='cuda')
        args = decode_args(gen, planes_cl, coords, palette)
        _, max_err, scale = fused_error(args, f'fused decode ({what})')
        cases[what] = {'batch': coords.shape[0], 'points': coords.shape[1],
                       'plane_resolution': planes_cl.shape[2],
                       'max_abs_err': max_err, 'largest': scale}
        if coords.shape[1] >= 1 << 20:
            fn = lambda: triplane_cuda.launch_fused(*args)  # noqa: E731
            cases[what].update(ms=time_cuda(fn, 10), device_ms=device_ms(fn))
    return cases


def fused_check(planes_cl: torch.Tensor, coords: torch.Tensor,
                gen: Generator, palette: torch.Tensor, name: str,
                replaces: str, started: float, cases: dict = None) -> dict:
    """B5a against its plain version on these planes and points, with the
    generator's decoder weights and this palette: its time (per call and
    on the device), bound, special-function floor, B1's time on the same
    points (the sampling half), and the port's unfused path on the same
    points (B1, then the decoder MLP, the softmax and the palette product)
    as its yardstick; emits a kernel line (with `cases`, if given) and
    returns its row."""
    r = planes_cl.shape[2]
    args = decode_args(gen, planes_cl, coords, palette)
    planes_cl, coords, w0, b0, w1, b1, palette = args
    out, max_err, scale = fused_error(args, name)

    ms = time_cuda(lambda: triplane_cuda.launch_fused(*args), 20)
    dev_ms = device_ms(lambda: triplane_cuda.launch_fused(*args))
    sampling_ms = time_cuda(lambda: triplane_cuda.launch(planes_cl, coords),
                            20)
    plain_ms = time_cuda(lambda: triplane.sample_triplane_fused_plain(*args),
                         3, 1)

    @torch.no_grad()
    def unfused():
        feats = triplane_cuda.launch(planes_cl, coords)
        dec = gen.decoder.mlp(feats.to(gen.dtype))
        probs = torch.softmax(dec['features'], dim=-1)
        rgb = palette_rgb(probs, palette)
        return torch.cat((dec['density_or_distance'], rgb), dim=-1)

    library_ms = time_cuda(unfused, 10)
    library_device_ms = device_ms(unfused, 5)
    library_err = float((unfused().float() - out.float()).abs().max())

    points = coords.shape[0] * coords.shape[1]
    k = palette.shape[1]
    texels = touched_texels(planes_cl, coords)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in (w0, b0, w1, b1, palette))
    bytes_moved = (coords.numel() * 4 + out.numel() * 2 + weight_bytes +
                   texels * triplane_cuda.CHANNELS * 2)
    hidden = triplane_cuda.HIDDEN
    # float32: the 12 bilinear taps of 32 channels (2 each), softplus on
    # the hidden units (4 each), the softmax (3 per entry); bf16 products:
    # the two layers and the palette (2 per multiply-add).
    f32_flops = points * (3 * 4 * triplane_cuda.CHANNELS * 2 + 4 * hidden +
                          3 * k)
    bf16_flops = points * 2 * (triplane_cuda.CHANNELS * hidden +
                               hidden * (1 + k) + k * 3)
    b = bound(bytes_moved, f32_flops, bf16_flops)
    emit('kernel', started, name=name, plane_resolution=r, points=points,
         max_abs_err=max_err, largest=scale, rtol_of_max=FUSED_RTOL_OF_MAX,
         ms=ms, device_ms=dev_ms, sampling_ms=sampling_ms,
         sfu_ms=sfu_ms(points, k), plain_ms=plain_ms, library_ms=library_ms,
         library_device_ms=library_device_ms,
         library='unfused: B1 + decoder.mlp + softmax + palette_rgb',
         library_max_abs_err=library_err, touched_texels=texels, cases=cases,
         **b)
    return row(name, FUSED_SOURCE, replaces, max_err, ms, plain_ms,
               library_ms, b)


def slice_phase(rows: dict):
    started = time.perf_counter()
    gen = Generator(dtype=torch.bfloat16, device='cuda', seed=0,
                    **GEN_KWARGS)
    gen.eval()
    emit('model', started, parameters=sum(p.numel()
                                          for p in gen.parameters()))

    started = time.perf_counter()
    dev = torch.device('cuda')
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (BATCH, GEN_KWARGS['latent_dim'])).astype(np.float32)).to(dev)
    cam, focal = camera(dev)

    def forward(sampler):
        return render_forward(gen, z, cam, focal, sampler)

    torch.cuda.reset_peak_memory_stats()
    triplane_cuda.launches = 0
    out = forward(triplane_cuda.sample_triplane)
    torch.cuda.synchronize()
    launches = triplane_cuda.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows[triplane_cuda.KERNEL]['launches'] = launches
    if launches != 2:
        raise AssertionError(f'{launches} triplane kernel launches in one '
                             f'render, expected 2 (coarse + fine)')
    for name, value, shape in (('rgb', out.rgb, (BATCH, RES, RES, 3)),
                               ('mask', out.mask, (BATCH, RES, RES)),
                               ('depth', out.depth, (BATCH, RES, RES))):
        if tuple(value.shape) != shape or not torch.isfinite(value).all():
            raise AssertionError(f'{name}: shape {tuple(value.shape)}, '
                                 f'finite {bool(torch.isfinite(value).all())}')
    if int(out.overflow_resid) != 0:
        raise AssertionError('overflow_resid must be 0')
    mask_range = (float(out.mask.min()), float(out.mask.max()))

    plain = forward(triplane.sample_triplane_plain)
    rgb_err = float((out.rgb - plain.rgb).abs().max())
    mask_err = float((out.mask - plain.mask).abs().max())
    if rgb_err > RENDER_ATOL or mask_err > RENDER_ATOL:
        raise AssertionError(f'render with the kernel differs from the '
                             f'plain render: rgb {rgb_err}, mask {mask_err}')

    forward(triplane_cuda.sample_triplane)  # warm-up
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(triplane_cuda.sample_triplane)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    render_s = statistics.median(times)
    fused = fused_render_check(gen, z, cam, focal, plain)
    emit('slice', started, launches=launches, rgb_max_abs_err=rgb_err,
         mask_max_abs_err=mask_err, atol=RENDER_ATOL, mask_range=mask_range,
         render_ms=render_s * 1e3, render_ms_all=[t * 1e3 for t in times],
         rays_per_s=BATCH * RES * RES / render_s, peak_gb=peak_gb,
         fused=fused)
    return gen, z, cam, focal


@torch.no_grad()
def render_forward(gen: Generator, z, cam, focal,
                   sampler=triplane_cuda.sample_triplane):
    """map -> synthesize -> render at bench.py's operating point."""
    state = gen.synthesize(gen.map(z))
    return render(gen.field(state, sampler), RES, RES, cam, focal,
                  SCENE_RANGE, True, SAMPLES)


def timed_renders(gen: Generator, z, cam, focal, repeats: int = 5
                  ) -> list:
    """ms of `repeats` renders after one warm-up, each on the host clock
    between synchronisations."""
    render_forward(gen, z, cam, focal)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_forward(gen, z, cam, focal)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def fused_render_check(gen: Generator, z, cam, focal, plain) -> dict:
    """The render with `fuse_decode` (B5a on every pass, never B1; counts
    reset just before and read just after) against the plain render
    `plain`, and its ms against the unfused render's in turns."""
    fused = gen.fused_view()
    torch.cuda.synchronize()
    reset_counts()
    out = render_forward(fused, z, cam, focal)
    torch.cuda.synchronize()
    launched = counts()
    expect_launches('fused render', launched,
                    **{triplane_cuda.FUSED_KERNEL: 2})
    rgb_err = float((out.rgb - plain.rgb).abs().max())
    mask_err = float((out.mask - plain.mask).abs().max())
    if (rgb_err > FUSED_RENDER_ATOL or mask_err > FUSED_RENDER_ATOL or
            not torch.isfinite(out.rgb).all()):
        raise AssertionError(f'fused render differs from the plain render: '
                             f'rgb {rgb_err}, mask {mask_err}')
    unfused_ms, fused_ms = [], []
    for _ in range(2):  # in turns: unfused, fused, unfused, fused
        unfused_ms += timed_renders(gen, z, cam, focal, 3)
        fused_ms += timed_renders(fused, z, cam, focal, 3)
    return {'launches': launched, 'rgb_max_abs_err': rgb_err,
            'mask_max_abs_err': mask_err, 'atol': FUSED_RENDER_ATOL,
            'render_ms': statistics.median(fused_ms),
            'render_ms_all': fused_ms,
            'unfused_render_ms': statistics.median(unfused_ms),
            'unfused_render_ms_all': unfused_ms}


def fused_kernel_phase(gen: Generator, z) -> dict:
    """B5a at the flagship coarse pass (the B1 phase's planes and points,
    the seeded generator's decoder weights and the palette of its latents)
    and at `fused_cases`; returns its row."""
    started = time.perf_counter()
    with torch.no_grad():
        palette = gen.synthesize(gen.map(z)).attention_values
    cases = fused_cases(gen)
    return fused_check(phase_planes(), coarse_coords(torch.device('cuda')),
                       gen, palette, triplane_cuda.FUSED_KERNEL,
                       FUSED_TPU_KERNEL, started, cases)


def r512_phase(z, cam, focal, rows: dict) -> None:
    """The render at 512^2 planes (the JAX CLI's --plane_resolution 512),
    where JAX's streamed window kernels B6 and B5b take over from B1 and
    B5a: B1 and B5a against their plain versions at its coarse pass (the
    B6 and B5b rows), then the render unfused and fused, each against the
    plain render."""
    started = time.perf_counter()
    gen = Generator(dtype=torch.bfloat16, device='cuda', seed=0,
                    **dict(GEN_KWARGS, img_resolution=R512))
    gen.eval()
    with torch.no_grad():
        state = gen.synthesize(gen.map(z))
    coords = coarse_coords(torch.device('cuda'))
    b6 = sampler_check(state.planes_cl, coords, 'triplane_sample_r512',
                       WINDOW_TPU_KERNEL, started)
    b5b = fused_check(state.planes_cl, coords, gen, state.attention_values,
                      'triplane_sample_fused_r512', WINDOW_FUSED_TPU_KERNEL,
                      started)
    del state, coords
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    reset_counts()
    out = render_forward(gen, z, cam, focal)
    torch.cuda.synchronize()
    launched = counts()
    expect_launches('512 render', launched, **{triplane_cuda.KERNEL: 2})
    plain = render_forward(gen, z, cam, focal,
                           triplane.sample_triplane_plain)
    rgb_err = float((out.rgb - plain.rgb).abs().max())
    mask_err = float((out.mask - plain.mask).abs().max())
    if (rgb_err > RENDER_ATOL or mask_err > RENDER_ATOL or
            not torch.isfinite(out.rgb).all()):
        raise AssertionError(f'512 render with B1 differs from the plain '
                             f'render: rgb {rgb_err}, mask {mask_err}')
    fused = fused_render_check(gen, z, cam, focal, plain)
    b6['launches'] = launched[triplane_cuda.KERNEL]
    b5b['launches'] = fused['launches'][triplane_cuda.FUSED_KERNEL]
    rows[b6['name']] = b6
    rows[b5b['name']] = b5b
    emit('r512', started, plane_resolution=R512, launches=launched,
         rgb_max_abs_err=rgb_err, mask_max_abs_err=mask_err,
         atol=RENDER_ATOL, mask_range=(float(out.mask.min()),
                                       float(out.mask.max())),
         fused=fused)


def trace(fn, op_groups=None) -> dict:
    """One call of `fn` under torch.profiler: wall time, device busy time
    (the union of the kernels' intervals), its idle share, the kernels'
    summed time (above the busy time where kernels overlap), the costliest
    kernels, and the operators whose own launches cost the most device
    time, with their input shapes. `op_groups` (name: predicate of an
    operator's name and input shapes) adds each group's summed kernel
    time, the rest under 'other'."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        (e for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and
         e.self_device_time_total > 0),
        key=lambda e: e.self_device_time_total, reverse=True)
    sum_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    intervals = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for start, stop in intervals:
        busy_us += max(stop - max(start, end), 0.0)
        end = max(end, stop)
    busy_ms = busy_us / 1e3
    ops = sorted(
        (e for e in prof.key_averages(group_by_input_shape=True)
         if e.device_type == torch.autograd.DeviceType.CPU and
         e.self_device_time_total > 0),
        key=lambda e: e.self_device_time_total, reverse=True)
    groups = {}
    for name, test in (op_groups or {}).items():
        groups[name] = sum(e.self_device_time_total for e in ops
                           if test(e.key, e.input_shapes)) / 1e3
    if op_groups:
        groups['other'] = sum_ms - sum(groups.values())
    return {'profiled_wall_ms': wall_ms, 'device_busy_ms': busy_ms,
            'idle_share': 1.0 - busy_ms / wall_ms,
            'kernel_sum_ms': sum_ms, 'kernel_ms_by_group': groups,
            'kernel_launches': sum(e.count for e in kernels),
            'top_kernels': [{'name': e.key[:100], 'count': e.count,
                             'device_ms': e.self_device_time_total / 1e3}
                            for e in kernels[:12]],
            'top_ops': [{'name': e.key, 'shapes': str(e.input_shapes)[:160],
                         'count': e.count,
                         'device_ms': e.self_device_time_total / 1e3}
                        for e in ops[:10]]}


def profile_phase(gen, z, cam, focal, inversion_step, train_steps,
                  stage_steps) -> None:
    """Device time of one render, by stage and by kernel, of one inversion
    step, of one G step and one D step, and of one pretraining step and
    one distillation step."""
    started = time.perf_counter()

    @torch.no_grad()
    def synthesize():
        return gen.synthesize(gen.map(z))

    @torch.no_grad()
    def render_state(state):
        return render(gen.field(state), RES, RES, cam, focal, SCENE_RANGE,
                      True, SAMPLES)

    state = synthesize()
    stages = {'map + synthesize': time_cuda(synthesize, 5, 1),
              'render': time_cuda(lambda: render_state(state), 5, 1)}
    render_trace = trace(lambda: render_state(synthesize()))
    g_step, d_step = train_steps
    pretrain_step, distill_step = stage_steps
    emit('profile', started, stage_ms=stages, **render_trace,
         inversion_step=trace(inversion_step), g_step=trace(g_step),
         d_step=trace(d_step), pretrain_step=trace(pretrain_step),
         distill_step=trace(distill_step))


def grad_case(what: str, planes_cl: torch.Tensor, coords: torch.Tensor,
              grad_out: torch.Tensor) -> dict:
    """B2 against its plain version (on float32 copies of the same bf16
    texels, so that both give float32 sums) at GRAD_RTOL of the largest
    value; returns the errors."""
    dplanes, dcoords = triplane_cuda.launch_grad_raw(planes_cl, coords,
                                                     grad_out)
    torch.cuda.synchronize()
    ref_planes, ref_coords = triplane.sample_triplane_grad_plain(
        planes_cl.float(), coords, grad_out)
    err_planes = rel_max(dplanes, ref_planes)
    err_coords = rel_max(dcoords, ref_coords)
    max_err = max(float((dplanes - ref_planes).abs().max()),
                  float((dcoords - ref_coords).abs().max()))
    if (err_planes > GRAD_RTOL or err_coords > GRAD_RTOL or
            not torch.isfinite(dplanes).all() or
            not torch.isfinite(dcoords).all()):
        raise AssertionError(f'triplane grad kernel disagrees with its plain '
                             f'version ({what}): dplanes {err_planes}, '
                             f'dcoords {err_coords} (relative to the '
                             f'largest)')
    return {'points': coords.shape[0] * coords.shape[1],
            'plane_resolution': planes_cl.shape[2],
            'dplanes_rel_err': err_planes, 'dcoords_rel_err': err_coords,
            'max_abs_err': max_err}


def tile_boundaries(b: int) -> torch.Tensor:
    """(b, 4913, 3) points: every combination of the 16-texel tile
    boundaries 16k / (R - 1), the last texel (1.0) and the first (-1.0)
    over the three coordinates, at the flagship's R."""
    r = GEN_KWARGS['img_resolution']
    ticks = torch.tensor([-1.0 + 2.0 * 16 * k / (r - 1)
                          for k in range(r // 16)] + [1.0], device='cuda')
    grid = torch.stack(torch.meshgrid(ticks, ticks, ticks, indexing='ij'),
                       dim=-1).reshape(1, -1, 3)
    return grid.expand(b, -1, -1).contiguous()


def grad_cases(gen: torch.Generator) -> dict:
    """B2's further cases, each against its plain version, with the
    per-call and device times of the ones the inversion and its worst
    case give: the coarse pass of one inversion geometry; a pile-up of
    points clamped outside the box; points exactly on 16-texel tile
    boundaries and on the last texel; a ragged N; and 512^2 planes."""
    dev = torch.device('cuda')
    c = triplane_cuda.CHANNELS

    def inputs(coords, r=GEN_KWARGS['img_resolution']):
        b, n = coords.shape[:2]
        planes = torch.randn((b, 3, r, r, c), generator=gen,
                             device=dev).to(torch.bfloat16)
        grad = torch.randn((b, n, c), generator=gen,
                           device=dev).to(torch.bfloat16)
        return planes, coords.contiguous(), grad

    def timed(args):
        fn = lambda: triplane_cuda.launch_grad_raw(*args)  # noqa: E731
        return {'ms': time_cuda(fn, 10), 'device_ms': device_ms(fn)}

    pile = pile_up(gen, BATCH, 1 << 20)
    ragged = torch.rand((BATCH, 100003, 3), generator=gen,
                        device=dev) * 2.4 - 1.2

    cases = {}
    args = inputs(inversion_coords(dev))
    cases['inversion geometry'] = {**grad_case('inversion geometry', *args),
                                   **timed(args)}
    args = inputs(pile)
    cases['pile-up'] = {**grad_case('pile-up', *args), **timed(args)}
    del args
    cases['tile boundaries'] = grad_case('tile boundaries',
                                         *inputs(tile_boundaries(2)))
    cases['ragged N'] = grad_case('ragged N', *inputs(ragged))
    args = inputs(coarse_coords(dev), R512)
    cases['512 planes'] = {**grad_case('512 planes', *args), **timed(args)}
    return cases


def triplane_grad_phase() -> dict:
    """B2 against its plain version on the points of one flagship coarse
    pass, then on the further cases of `grad_cases`; returns its row."""
    started = time.perf_counter()
    dev = torch.device('cuda')
    coords = coarse_coords(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    r = GEN_KWARGS['img_resolution']
    c = triplane_cuda.CHANNELS
    planes_cl = torch.randn((BATCH, 3, r, r, c), generator=gen,
                            device=dev).to(torch.bfloat16)
    grad_out = torch.randn((BATCH, coords.shape[1], c), generator=gen,
                           device=dev).to(torch.bfloat16)

    bench = grad_case('coarse pass', planes_cl, coords, grad_out)
    err_planes, err_coords = bench['dplanes_rel_err'], bench['dcoords_rel_err']
    max_err = bench['max_abs_err']

    def call():
        return triplane_cuda.launch_grad_raw(planes_cl, coords, grad_out)

    ms = time_cuda(call, 10)
    dev_ms = device_ms(call)
    plain_ms = time_cuda(lambda: triplane.sample_triplane_grad_plain(
        planes_cl, coords, grad_out), 3, 1)

    # Yardstick only: the backward of F.grid_sample (border,
    # align_corners=True) to the float32 planes and the grid, the same
    # texels, with the mean over the three planes.
    n = coords.shape[1]
    planes_cf = planes_cl.permute(0, 1, 4, 2, 3).reshape(
        BATCH * 3, c, r, r).float().contiguous().requires_grad_()
    grid = torch.stack([coords[..., list(axes)]
                        for axes in triplane.PLANE_AXES], dim=1)
    grid = grid.reshape(BATCH * 3, 1, n, 2).requires_grad_()
    feats = F.grid_sample(planes_cf, grid, mode='bilinear',
                          padding_mode='border', align_corners=True)
    feats = feats.reshape(BATCH, 3, c, n).mean(dim=1)
    cotangent = grad_out.float().transpose(1, 2)

    def library():
        return torch.autograd.grad(feats, (planes_cf, grid), cotangent,
                                   retain_graph=True)

    library_ms = time_cuda(library, 5)
    library_device_ms = device_ms(library, 3)
    del feats, planes_cf, grid, cotangent

    points = BATCH * n
    texels = touched_texels(planes_cl, coords)
    dplanes_bytes = planes_cl.numel() * 4
    bytes_moved = (coords.numel() * 4 + grad_out.numel() * 2 +
                   texels * c * 2 + dplanes_bytes + coords.numel() * 4)
    # Per point, plane and channel: 4 weighted cotangents added (8), two
    # tap differences blended and scaled per axis (10), times g and summed
    # (4).
    flops = points * 3 * c * 22
    b = bound(bytes_moved, flops)
    del planes_cl, coords, grad_out
    cases = grad_cases(gen)
    emit('kernel', started, name=triplane_cuda.GRAD_KERNEL, points=points,
         dplanes_rel_err=err_planes, dcoords_rel_err=err_coords,
         max_abs_err=max_err, rtol=GRAD_RTOL, ms=ms, device_ms=dev_ms,
         plain_ms=plain_ms, library_ms=library_ms,
         library_device_ms=library_device_ms, touched_texels=texels,
         chunk=triplane_cuda.GRAD_CHUNK, cases=cases, **b)
    return row(triplane_cuda.GRAD_KERNEL, GRAD_SOURCE, GRAD_TPU_KERNEL,
               max_err, ms, plain_ms, library_ms, b)


def grad_planes_case(what: str, coords: torch.Tensor,
                     grad_out: torch.Tensor, r: int) -> dict:
    """B4 against its plain version at GRAD_RTOL of the largest value, on
    planes of resolution r; returns the errors."""
    shape = (coords.shape[0], 3, r, r, triplane_cuda.CHANNELS)
    dplanes = triplane_cuda.launch_grad_planes(shape, coords, grad_out)
    torch.cuda.synchronize()
    ref = triplane.sample_triplane_grad_planes_plain(shape, coords, grad_out)
    err = rel_max(dplanes, ref)
    if err > GRAD_RTOL or not torch.isfinite(dplanes).all():
        raise AssertionError(f'planes-only grad kernel disagrees with its '
                             f'plain version ({what}): {err} (relative to '
                             f'the largest)')
    return {'batch': coords.shape[0], 'points': coords.shape[1],
            'plane_resolution': r, 'plain_rel_err': err,
            'max_abs_err': float((dplanes - ref).abs().max())}


def grad_planes_cases(gen: torch.Generator) -> dict:
    """B4's further cases, each against its plain version, with the
    per-call and device times of the ones a G step and its worst case
    give: the coarse pass of p3d_car training cameras (the G step's
    geometry); a pile-up of points clamped outside the box; points exactly
    on 16-texel tile boundaries and on the last texel; a ragged N with
    B = 3; and 512^2 planes."""
    dev = torch.device('cuda')
    r = GEN_KWARGS['img_resolution']

    def grad(coords):
        return torch.randn((*coords.shape[:2], triplane_cuda.CHANNELS),
                           generator=gen, device=dev).to(torch.bfloat16)

    def timed(coords, grad_out, r):
        shape = (coords.shape[0], 3, r, r, triplane_cuda.CHANNELS)
        fn = lambda: triplane_cuda.launch_grad_planes(  # noqa: E731
            shape, coords, grad_out)
        return {'ms': time_cuda(fn, 10), 'device_ms': device_ms(fn)}

    cam, focal = p3d_cameras(np.random.default_rng(13), BATCH, dev)
    cases = {}
    for what, coords, res, time_it in (
            ('training geometry',
             coarse_coords(dev, cam, focal, TRAIN_CFG.scene_range), r, True),
            ('pile-up', pile_up(gen, BATCH, 1 << 20), r, True),
            ('tile boundaries', tile_boundaries(2), r, False),
            ('ragged N', torch.rand((3, 100003, 3), generator=gen,
                                    device=dev) * 2.4 - 1.2, r, False),
            ('512 planes', coarse_coords(dev), R512, True)):
        coords = coords.contiguous()
        grad_out = grad(coords)
        cases[what] = grad_planes_case(what, coords, grad_out, res)
        if time_it:
            cases[what].update(timed(coords, grad_out, res))
    return cases


def triplane_grad_planes_phase() -> dict:
    """B4 against its plain version and against B2's dplanes, on the points
    and cotangent of the B2 phase, then on the further cases of
    `grad_planes_cases`; returns its row."""
    started = time.perf_counter()
    dev = torch.device('cuda')
    coords = coarse_coords(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    r = GEN_KWARGS['img_resolution']
    c = triplane_cuda.CHANNELS
    # The B2 phase's draws: the planes (B4 never reads them; B2 does), then
    # the cotangent.
    planes_cl = torch.randn((BATCH, 3, r, r, c), generator=gen,
                            device=dev).to(torch.bfloat16)
    grad_out = torch.randn((BATCH, coords.shape[1], c), generator=gen,
                           device=dev).to(torch.bfloat16)
    shape = tuple(planes_cl.shape)

    dplanes = triplane_cuda.launch_grad_planes(shape, coords, grad_out)
    torch.cuda.synchronize()
    ref = triplane.sample_triplane_grad_planes_plain(shape, coords, grad_out)
    err_plain = rel_max(dplanes, ref)
    max_err = float((dplanes - ref).abs().max())
    del ref
    b2_planes, _ = triplane_cuda.launch_grad_raw(planes_cl, coords, grad_out)
    err_b2 = rel_max(dplanes, b2_planes)
    del b2_planes
    if (err_plain > GRAD_RTOL or err_b2 > GRAD_RTOL or
            not torch.isfinite(dplanes).all()):
        raise AssertionError(f'planes-only grad kernel disagrees: with its '
                             f'plain version {err_plain}, with B2 {err_b2} '
                             f'(relative to the largest)')

    def call():
        return triplane_cuda.launch_grad_planes(shape, coords, grad_out)

    ms = time_cuda(call, 10)
    dev_ms = device_ms(call)
    plain_ms = time_cuda(lambda: triplane.sample_triplane_grad_planes_plain(
        shape, coords, grad_out), 3, 1)

    # Yardstick only: the backward of F.grid_sample (border,
    # align_corners=True) to the float32 planes alone, with the mean over
    # the three planes.
    n = coords.shape[1]
    planes_cf = planes_cl.permute(0, 1, 4, 2, 3).reshape(
        BATCH * 3, c, r, r).float().contiguous().requires_grad_()
    grid = torch.stack([coords[..., list(axes)]
                        for axes in triplane.PLANE_AXES], dim=1)
    grid = grid.reshape(BATCH * 3, 1, n, 2)
    feats = F.grid_sample(planes_cf, grid, mode='bilinear',
                          padding_mode='border', align_corners=True)
    feats = feats.reshape(BATCH, 3, c, n).mean(dim=1)
    cotangent = grad_out.float().transpose(1, 2)

    def library():
        return torch.autograd.grad(feats, planes_cf, cotangent,
                                   retain_graph=True)

    library_ms = time_cuda(library, 5)
    library_device_ms = device_ms(library, 3)
    del feats, planes_cf, grid, cotangent

    points = BATCH * n
    # Each input read once (coordinates, cotangent), the float32 dplanes
    # written once; the caller's zero fill is not counted.
    bytes_moved = (coords.numel() * 4 + grad_out.numel() * 2 +
                   dplanes.numel() * 4)
    # Per point, plane and channel: 4 weights times g, 4 adds (16); the
    # weights themselves are per point and plane.
    flops = points * 3 * c * 16
    b = bound(bytes_moved, flops)
    del planes_cl, coords, grad_out, dplanes
    cases = grad_planes_cases(gen)
    emit('kernel', started, name=triplane_cuda.GRAD_PLANES_KERNEL,
         points=points, plain_rel_err=err_plain, b2_rel_err=err_b2,
         max_abs_err=max_err, rtol=GRAD_RTOL, ms=ms, device_ms=dev_ms,
         plain_ms=plain_ms, library_ms=library_ms,
         library_device_ms=library_device_ms,
         chunk=triplane_cuda.GRAD_CHUNK, cases=cases, **b)
    return row(triplane_cuda.GRAD_PLANES_KERNEL, GRAD_PLANES_SOURCE,
               GRAD_PLANES_TPU_KERNEL, max_err, ms, plain_ms, library_ms, b)


def warp_grad_case(what: str, images: torch.Tensor,
                   grid: torch.Tensor, gen: torch.Generator) -> dict:
    """B3's backward against the plain version's autograd at
    WARP_GRAD_RTOL of the largest value, on a seeded cotangent."""
    grad_out = torch.randn((*grid.shape[:2], images.shape[1],
                            *grid.shape[2:4]), generator=gen,
                           device=images.device)
    dimages = warp.launch_grad(grad_out, grid, images.shape)
    torch.cuda.synchronize()
    leaf = images.clone().requires_grad_()
    ref, = torch.autograd.grad(warp.warp_plain(leaf, grid), leaf, grad_out)
    err = rel_max(dimages, ref)
    if err > WARP_GRAD_RTOL or not torch.isfinite(dimages).all():
        raise AssertionError(f'warp backward disagrees with its plain '
                             f'version ({what}): {err} (relative to the '
                             f'largest)')
    return {'channels': images.shape[1], 'grad_rel_err': err,
            'grad_max_abs_err': float((dimages - ref).abs().max())}


def warp_cases(gen: torch.Generator) -> dict:
    """B3 forward (WARP_ATOL) and backward (WARP_GRAD_RTOL) against their
    plain versions on crops that reach far outside the image (zeros
    padding), at the inversion's 128^2 and at 127^2, whose pixel count is
    not a multiple of 4 (the forward's one-pixel-at-a-time path); the
    backward also on a grid of points scattered at random (no crop at
    all) and with 6 channels (two float4 atomics a tap)."""
    dev = torch.device('cuda')
    n_aug = INV_CFG.num_augmentations
    images = torch.rand((BATCH, 3, RES, RES), generator=gen,
                        device=dev) * 2.0 - 1.0
    count = BATCH * n_aug
    tform = augment.AffineTransform(
        rot=(torch.rand(count, generator=gen, device=dev) * 2 - 1) * math.pi,
        scale=torch.exp2((torch.rand(count, generator=gen, device=dev) * 2 -
                          1)),
        translation=(torch.rand((count, 2), generator=gen, device=dev) * 2 -
                     1) * 1.5)
    cases = {}
    for size in (RES, RES - 1):
        grid = augment.image_warp_grid(tform, size, size).reshape(
            BATCH, n_aug, size, size, 2).contiguous()
        out = warp.launch(images, grid)
        torch.cuda.synchronize()
        ref = warp.warp_plain(images, grid)
        err = float((out - ref).abs().max())
        if err > WARP_ATOL or not torch.isfinite(out).all():
            raise AssertionError(f'warp forward disagrees with its plain '
                                 f'version on crops outside the image at '
                                 f'{size}^2: {err}')
        cases[f'outside {size}'] = {
            'max_abs_err': err,
            'zero_share': float((ref == 0).float().mean()),
            **warp_grad_case(f'outside {size}', images, grid, gen)}
    scattered = (torch.rand((BATCH, n_aug, RES, RES, 2), generator=gen,
                            device=dev) * 2.4 - 1.2)
    cases['scattered'] = warp_grad_case('scattered', images, scattered, gen)
    grid = augment.image_warp_grid(tform, RES, RES).reshape(
        BATCH, n_aug, RES, RES, 2).contiguous()
    six = torch.rand((BATCH, warp.MAX_CHANNELS, RES, RES), generator=gen,
                     device=dev)
    cases['6 channels'] = warp_grad_case('6 channels', six, grid, gen)
    return cases


def warp_phase() -> list:
    """B3 forward and backward against their plain versions at the
    inversion's shapes: 8 images of 3 x 128^2 into 15 crops each. Returns
    their two rows."""
    started = time.perf_counter()
    dev = torch.device('cuda')
    n_aug = INV_CFG.num_augmentations
    gen = torch.Generator(device=dev).manual_seed(3)
    images = torch.rand((BATCH, 3, RES, RES), generator=gen,
                        device=dev) * 2.0 - 1.0
    tform = augment.sample_transform(gen, BATCH * n_aug, 1.0)
    grid = augment.image_warp_grid(tform, RES, RES).reshape(
        BATCH, n_aug, RES, RES, 2).contiguous()
    grad_out = torch.randn((BATCH, n_aug, 3, RES, RES), generator=gen,
                           device=dev)

    out = warp.launch(images, grid)
    dimages = warp.launch_grad(grad_out, grid, images.shape)
    torch.cuda.synchronize()
    leaf = images.clone().requires_grad_()
    plain_out = warp.warp_plain(leaf, grid)
    plain_dimages, = torch.autograd.grad(plain_out, leaf, grad_out,
                                         retain_graph=True)
    fwd_err = float((out - plain_out.detach()).abs().max())
    bwd_err = float((dimages - plain_dimages).abs().max())
    bwd_rel = rel_max(dimages, plain_dimages)
    if fwd_err > WARP_ATOL or bwd_rel > WARP_GRAD_RTOL:
        raise AssertionError(f'warp kernels disagree with their plain '
                             f'version: forward {fwd_err}, backward '
                             f'{bwd_rel} (relative to the largest)')

    ms = time_cuda(lambda: warp.launch(images, grid), 20)
    dev_ms = device_ms(lambda: warp.launch(images, grid), 20)
    grad_ms = time_cuda(lambda: warp.launch_grad(grad_out, grid,
                                                 images.shape), 20)
    grad_dev_ms = device_ms(lambda: warp.launch_grad(grad_out, grid,
                                                     images.shape), 20)
    plain_ms = time_cuda(lambda: warp.warp_plain(images, grid), 10)
    plain_grad_ms = time_cuda(lambda: torch.autograd.grad(
        plain_out, leaf, grad_out, retain_graph=True), 10)

    # Yardsticks only: F.grid_sample (zeros, align_corners=False) on the
    # images repeated per crop, and its backward to the images.
    rep = images.repeat_interleave(n_aug, dim=0).requires_grad_()
    flat_grid = grid.reshape(BATCH * n_aug, RES, RES, 2)

    def library():
        return F.grid_sample(rep, flat_grid, mode='bilinear',
                             padding_mode='zeros', align_corners=False)

    library_ms = time_cuda(library, 20)
    library_device_ms = device_ms(library, 20)
    lib_out = library()
    lib_cot = grad_out.reshape(BATCH * n_aug, 3, RES, RES)
    def library_grad():
        return torch.autograd.grad(lib_out, rep, lib_cot, retain_graph=True)

    library_grad_ms = time_cuda(library_grad, 20)
    library_grad_device_ms = device_ms(library_grad, 20)

    pixels = BATCH * n_aug * RES * RES
    img_bytes = images.numel() * 4
    crop_bytes = out.numel() * 4
    grid_bytes = grid.numel() * 4
    # Per crop pixel: the tap coordinates and weights (about 20), then 4
    # multiply-adds per channel.
    flops = pixels * (20 + 3 * 8)
    fwd_b = bound(img_bytes + grid_bytes + crop_bytes, flops)
    bwd_b = bound(crop_bytes + grid_bytes + img_bytes, flops)
    cases = warp_cases(gen)
    emit('kernel', started, name='warp_forward', pixels=pixels,
         max_abs_err=fwd_err, atol=WARP_ATOL, ms=ms, device_ms=dev_ms,
         plain_ms=plain_ms, library_ms=library_ms,
         library_device_ms=library_device_ms, cases=cases, **fwd_b)
    emit('kernel', started, name='warp_backward', pixels=pixels,
         max_abs_err=bwd_err, rel_err=bwd_rel, rtol=WARP_GRAD_RTOL,
         ms=grad_ms, device_ms=grad_dev_ms, plain_ms=plain_grad_ms,
         library_ms=library_grad_ms,
         library_device_ms=library_grad_device_ms,
         cases={k: v for k, v in cases.items() if 'grad_rel_err' in v},
         **bwd_b)
    return [row('warp_forward', WARP_SOURCE, WARP_TPU_KERNEL, fwd_err, ms,
                plain_ms, library_ms, fwd_b),
            row('warp_backward', WARP_SOURCE, WARP_TPU_KERNEL, bwd_err,
                grad_ms, plain_grad_ms, library_grad_ms, bwd_b)]


def counts() -> dict:
    return {triplane_cuda.KERNEL: triplane_cuda.launches,
            triplane_cuda.GRAD_KERNEL: triplane_cuda.grad_launches,
            triplane_cuda.GRAD_PLANES_KERNEL:
                triplane_cuda.grad_planes_launches,
            'warp_forward': warp.launches,
            'warp_backward': warp.grad_launches,
            triplane_cuda.FUSED_KERNEL: triplane_cuda.fused_launches}


def reset_counts() -> None:
    triplane_cuda.launches = triplane_cuda.grad_launches = 0
    triplane_cuda.grad_planes_launches = triplane_cuda.fused_launches = 0
    warp.launches = warp.grad_launches = 0


def expect_launches(what: str, launched: dict, **want) -> None:
    """Every count named in `want` equals it (an int) or, for True, is
    above 0; every other count is 0."""
    for name, count in launched.items():
        expected = want.get(name, 0)
        ok = count > 0 if expected is True else count == expected
        if not ok:
            raise AssertionError(f'{what}: launches {launched}, expected '
                                 f'{want} and 0 for the others')


def inversion_problem(gen: Generator):
    """The target (rendered from a second latent and a known camera) and
    the initial parameters (a third latent, the camera perturbed)."""
    dev = torch.device('cuda')
    rng = np.random.default_rng(2)
    gain = INV_CFG.lr_gain_z

    def latent():
        z = torch.from_numpy(rng.standard_normal(
            (BATCH, GEN_KWARGS['latent_dim'])).astype(np.float32)).to(dev)
        with torch.no_grad():
            return gen.map(z) / gain

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    quat = rng.standard_normal((BATCH, 4)) * 0.3 + [1.0, 0.0, 0.0, 0.0]
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    target_params = inv.InversionParams(
        z=latent(), R=tensor(quat), s=tensor(np.ones(BATCH)),
        t2=tensor(rng.uniform(-0.05, 0.05, (BATCH, 2))),
        z0=tensor(np.full(BATCH, np.log(2.0))))
    with torch.no_grad():
        out, cam, _ = inv.render_from_params(gen, target_params, INV_CFG)
    quat_init = quat + rng.standard_normal((BATCH, 4)) * 0.05
    init = inv.InversionParams(
        z=latent(), R=tensor(quat_init / np.linalg.norm(
            quat_init, axis=-1, keepdims=True)),
        s=target_params.s * 1.05, t2=target_params.t2 + 0.02,
        z0=target_params.z0 + 0.1)
    return out.rgb, out.mask, cam, init


def inversion_stages(gen, lpips, init, target, tform, repeats: int = 3
                     ) -> dict:
    """Median ms of a step's stages, each between CUDA events: the render
    forward, the loss forward (render, crops, LPIPS), the backward, and
    Adam with the projection."""
    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    params = init.copy(requires_grad=True)
    optimizer = inv.make_optimizer(params, INV_CFG)
    tensors = [t for _, t in params.named()]
    times = {'render forward': [], 'loss forward': [], 'backward': [],
             'adam + project': []}
    for _ in range(repeats):
        times['render forward'].append(timed(
            lambda: inv.render_from_params(gen, params, INV_CFG))[1])
        (loss, _), ms = timed(lambda: inv.inversion_loss(
            gen, lpips, params, target, INV_CFG, tform=tform))
        times['loss forward'].append(ms)
        grads, ms = timed(lambda: torch.autograd.grad(loss, tensors))
        times['backward'].append(ms)
        for t, g in zip(tensors, grads):
            t.grad = g
        times['adam + project'].append(timed(
            lambda: (optimizer.step(), inv.project(params)))[1])
    return {k: statistics.median(v) for k, v in times.items()}


def inversion_models():
    """The inversion's full-width generator (p3d_car's box) and VGG
    LPIPS, both from seeds."""
    gen = Generator(dtype=torch.bfloat16, device='cuda', seed=0,
                    **dict(GEN_KWARGS, scene_range=INV_CFG.scene_range))
    gen.eval()
    lpips = LPIPS(device='cuda').eval()
    convert.load_lpips_state_dicts(lpips,
                                   *convert.random_lpips_state_dicts(0))
    return gen, lpips


def inversion_phase(rows: dict, gen: Generator, lpips: LPIPS):
    started = time.perf_counter()
    target, target_mask, gt_cam, init = inversion_problem(gen)
    dev = target.device

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    params, metrics = inv.run_inversion(
        gen, lpips, init, target, INV_CFG, INV_STEPS,
        generator=torch.Generator(device=dev).manual_seed(4),
        gt_cam2world=gt_cam)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # The camera carries a gradient, so the render's backward is B2 and
    # never the planes-only B4.
    if launches.pop(triplane_cuda.GRAD_PLANES_KERNEL) != 0:
        raise AssertionError('the inversion run launched the planes-only '
                             'backward B4')
    if launches.pop(triplane_cuda.FUSED_KERNEL) != 0:
        raise AssertionError('the inversion run launched the fused decode '
                             'B5a')
    for name, count in launches.items():
        rows[name]['launches' if name != triplane_cuda.KERNEL else
                   'inversion_launches'] = count
        if count == 0:
            raise AssertionError(f'kernel {name} was not launched by the '
                                 f'inversion run')
    metrics = {k: v.float().cpu().tolist() for k, v in metrics.items()}
    for key in ('loss', 'grad_norm_z', 'grad_norm_R'):
        if not all(np.isfinite(metrics[key])):
            raise AssertionError(f'{key} not finite: {metrics[key]}')
    for key in ('grad_norm_z', 'grad_norm_R'):
        if not all(v > 0 for v in metrics[key]):
            raise AssertionError(f'{key} has a zero: {metrics[key]}')
    if not all(torch.isfinite(t).all() for _, t in params.named()):
        raise AssertionError('the final parameters are not finite')

    # ms per step: the step that run_inversion runs, one warm-up, then
    # each step on the host clock between synchronisations.
    step_params = init.copy(requires_grad=True)
    optimizer = inv.make_optimizer(step_params, INV_CFG)
    step = inv.make_inversion_step(gen, lpips, INV_CFG, gt_cam)
    step_gen = torch.Generator(device=dev).manual_seed(5)
    times = []
    for _ in range(INV_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(step_params, optimizer, target, step_gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times[1:])

    # The timed step (kernels) against the same step built on the plain
    # sampler and warp, from the same parameters and crops: the loss and
    # the gradients of z and R that the step hands to Adam.
    tform = augment.sample_transform(
        torch.Generator(device=dev).manual_seed(6),
        BATCH * INV_CFG.num_augmentations, 1.0)
    plain_step = inv.make_inversion_step(gen, lpips, INV_CFG, gt_cam,
                                         sampler=triplane.plain_sampler,
                                         warp=warp.warp_plain)

    def loss_and_grads(step_fn):
        p = init.copy(requires_grad=True)
        m = step_fn(p, inv.make_optimizer(p, INV_CFG), target, tform=tform)
        return float(m['loss']), p.z.grad, p.R.grad

    k_loss, k_gz, k_gr = loss_and_grads(step)
    p_loss, p_gz, p_gr = loss_and_grads(plain_step)
    loss_err = abs(k_loss - p_loss) / abs(p_loss)
    gz_err = float((k_gz - p_gz).norm() / p_gz.norm())
    gr_err = float((k_gr - p_gr).norm() / p_gr.norm())
    if (loss_err > STEP_LOSS_RTOL or gz_err > STEP_GRAD_RTOL or
            gr_err > STEP_GRAD_RTOL):
        raise AssertionError(f'step with the kernels differs from the plain '
                             f'step: loss {loss_err}, grad z {gz_err}, '
                             f'grad R {gr_err}')
    stage_ms = inversion_stages(gen, lpips, init, target, tform)
    emit('inversion', started, config=dataclasses.asdict(INV_CFG),
         steps=INV_STEPS, run_s=run_s,
         launches={k: v for k, v in launches.items()},
         launches_per_step={k: v / INV_STEPS for k, v in launches.items()},
         metrics=metrics, step_ms=step_ms, step_ms_all=times,
         stage_ms=stage_ms, peak_gb=peak_gb,
         target_mask_range=(float(target_mask.min()),
                            float(target_mask.max())),
         plain_check={'batch': BATCH, 'loss_kernels': k_loss,
                      'loss_plain': p_loss, 'loss_rel_err': loss_err,
                      'grad_z_rel_err': gz_err, 'grad_R_rel_err': gr_err,
                      'loss_rtol': STEP_LOSS_RTOL,
                      'grad_rtol': STEP_GRAD_RTOL})
    return lambda: step(step_params, optimizer, target, step_gen)


def p3d_cameras(rng: np.random.Generator, b: int, dev: torch.device):
    """Cameras of the inversion phase's form (flipped, focal 1.5, s = 1, a
    small t2) at random azimuths about the vertical axis, slightly tilted.
    Returns (cam2world (B, 4, 4), focal (B,))."""
    theta = rng.uniform(-np.pi, np.pi, b)
    quat = np.stack((np.cos(theta / 2), np.zeros(b), np.sin(theta / 2),
                     np.zeros(b)), axis=-1)
    quat = quat + rng.standard_normal((b, 4)) * 0.05
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return pose_lib.pose_to_matrix(
        tensor(np.full(b, np.log(2.0))), tensor(rng.uniform(-0.05, 0.05,
                                                            (b, 2))),
        tensor(np.ones(b)), tensor(quat), True)


def train_phase(rows: dict):
    """G + D pairs at full width in p3d_car's configuration; returns a G
    step and a D step to trace."""
    started = time.perf_counter()
    dev = torch.device('cuda')
    cfg = TRAIN_CFG
    state = gan.init_train_state(cfg, dtype=torch.bfloat16, device=dev,
                                 seed=0)
    state.iteration = TRAIN_ITERATION
    state.augment_p = TRAIN_AUGMENT_P
    for opt in (state.opt_g, state.opt_d):  # past the lr warmup
        opt.param_groups[0]['count'] = TRAIN_ITERATION // 2
    rng = np.random.default_rng(7)

    def batch():
        cam, focal = p3d_cameras(rng, BATCH, dev)
        z = torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.latent_dim)).astype(np.float32)).to(dev)
        return {'z': z, 'pose': cam, 'focal': focal}

    # The real batch: a second latent rendered once at 256^2 without a
    # graph (image_highres, the mask as its alpha), and its 2x2 mean.
    with torch.no_grad():
        source = batch()
        st = state.gen.synthesize(state.gen.map(source['z']))
        out = render(state.gen.field(st),
                     2 * RES, 2 * RES, source['pose'], source['focal'],
                     cfg.scene_range, cfg.white_background, SAMPLES)
        hi = torch.cat((out.rgb, out.mask[..., None]), dim=-1)
        real = {'image_highres': hi,
                'image': hi.reshape(BATCH, RES, 2, RES, 2, 4).mean((2, 4)),
                'pose': source['pose'], 'focal': source['focal']}
        real_mask = (float(out.mask.min()), float(out.mask.max()))
        del st, out, hi
    torch.cuda.empty_cache()

    def timed(fn, want: dict, what: str):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        metrics = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = counts()
        if launched != want:
            raise AssertionError(f'{what}: launches {launched}, expected '
                                 f'{want}')
        return {k: float(v) for k, v in metrics.items()}, ms, launched

    torch.cuda.reset_peak_memory_stats()
    g_ms, d_ms, steps = [], [], []
    for k in range(TRAIN_PAIRS + 1):
        g_batch, fake = batch(), batch()
        g_metrics, gt, g_launched = timed(
            lambda: gan.g_step(state, g_batch, cfg), G_STEP_LAUNCHES,
            'G step')
        d_metrics, dt, d_launched = timed(
            lambda: gan.d_step(state, real, fake, cfg), D_STEP_LAUNCHES,
            'D step')
        steps.append({**g_metrics, **d_metrics})
        if k > 0:  # the first pair is the warm-up
            g_ms.append(gt)
            d_ms.append(dt)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for m in steps:
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f'a step metric is not finite: {m}')
        if m['grad_norm_g'] <= 0 or m['grad_norm_d'] <= 0:
            raise AssertionError(f'a gradient norm is zero: {m}')
    # The launches read in the last timed pair.
    rows[triplane_cuda.GRAD_PLANES_KERNEL]['launches'] = g_launched[
        triplane_cuda.GRAD_PLANES_KERNEL]
    rows[triplane_cuda.KERNEL]['train_launches'] = {
        'g_step': g_launched[triplane_cuda.KERNEL],
        'd_step': d_launched[triplane_cuda.KERNEL]}

    # One G step's loss and gradients through the kernels against the same
    # step on the plain sampler, from the same state and batch with
    # injected draws.
    gen_t = torch.Generator(device=dev).manual_seed(8)
    n = 31  # the regularizers' strata per axis
    fixed = dict(batch(), aug_tform=augment.sample_transform(
        gen_t, BATCH, TRAIN_AUGMENT_P), noise={
            'depth': torch.rand((BATCH, RES, RES, SAMPLES), generator=gen_t,
                                device=dev),
            'pdf_u': torch.rand((BATCH * RES * RES, SAMPLES),
                                generator=gen_t, device=dev),
            'strata': torch.rand((BATCH, n, n, n, 3), generator=gen_t,
                                 device=dev),
            'perturb': torch.randn((BATCH, n ** 3, 3), generator=gen_t,
                                   device=dev)})
    params = list(state.gen.parameters())
    last_layer = getattr(state.gen.synthesis_network,
                         f'b{cfg.plane_resolution}').torgb.weight
    last = [p is last_layer for p in params].index(True)

    def loss_and_grads(sampler):
        loss, _ = gan.generator_loss(state, fixed, cfg, sampler)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads if g is not None]))
        return float(loss.detach()), float(norm), grads[last]

    k_loss, k_norm, k_last = loss_and_grads(triplane_cuda.sample_triplane)
    p_loss, p_norm, p_last = loss_and_grads(triplane.plain_sampler)
    loss_err = abs(k_loss - p_loss) / abs(p_loss)
    norm_err = abs(k_norm - p_norm) / p_norm
    last_err = float((k_last - p_last).norm() / p_last.norm())
    if (loss_err > STEP_LOSS_RTOL or norm_err > STEP_GRAD_RTOL or
            last_err > STEP_GRAD_RTOL):
        raise AssertionError(f'G step with the kernels differs from the '
                             f'plain step: loss {loss_err}, grad norm '
                             f'{norm_err}, last layer {last_err}')

    # One D step at iteration 1: the warmup blur and R1.
    state.iteration = 1
    early = {k: float(v) for k, v in
             gan.d_step(state, real, batch(), cfg).items()}
    if not all(np.isfinite(v) for v in early.values()):
        raise AssertionError(f'D step at iteration 1 not finite: {early}')

    pair_ms = [g + d for g, d in zip(g_ms, d_ms)]
    emit('train', started, config=dataclasses.asdict(cfg),
         iteration=TRAIN_ITERATION, augment_p_start=TRAIN_AUGMENT_P,
         augment_p_end=state.augment_p, pairs=TRAIN_PAIRS,
         g_step_ms=statistics.median(g_ms), d_step_ms=statistics.median(d_ms),
         pair_ms=statistics.median(pair_ms), g_step_ms_all=g_ms,
         d_step_ms_all=d_ms,
         images_per_s=BATCH / (statistics.median(pair_ms) / 1e3),
         peak_gb=peak_gb, g_step_launches=g_launched,
         d_step_launches=d_launched, step_metrics=steps,
         real_mask_range=real_mask,
         plain_check={'loss_kernels': k_loss, 'loss_plain': p_loss,
                      'loss_rel_err': loss_err, 'grad_norm_kernels': k_norm,
                      'grad_norm_plain': p_norm, 'grad_norm_rel_err': norm_err,
                      'last_layer_grad_rel_err': last_err,
                      'loss_rtol': STEP_LOSS_RTOL,
                      'grad_rtol': STEP_GRAD_RTOL},
         d_step_iteration_1=early)

    g_batch, fake = batch(), batch()

    def traced_g():
        state.iteration = TRAIN_ITERATION
        gan.g_step(state, g_batch, cfg)

    def traced_d():
        state.iteration = TRAIN_ITERATION + 1
        gan.d_step(state, real, fake, cfg)

    return traced_g, traced_d


def pretrain_check(state: gan.GANTrainState, cfg: gan.GANConfig) -> dict:
    """One pretraining step's loss and the gradients of the synthesis's
    last layer and the decoder at PRETRAIN_CHECK_BATCH, on the card
    against the CPU: float32 copies of G's weights, the same z and
    strata."""
    sd = state.gen.state_dict()
    draws = torch.Generator().manual_seed(21)
    n = pretrain.NSTRATA - 1
    z = torch.randn((PRETRAIN_CHECK_BATCH, cfg.latent_dim), generator=draws)
    strata = torch.rand((PRETRAIN_CHECK_BATCH, n, n, n, 3), generator=draws)

    def loss_and_grads(device):
        gen = Generator(device=device, seed=0,
                        **dict(GEN_KWARGS, scene_range=cfg.scene_range))
        gen.load_state_dict(sd)
        picks = [getattr(gen.synthesis_network,
                         f'b{cfg.plane_resolution}').torgb.weight,
                 gen.decoder.net[0].weight, gen.decoder.net[2].weight]
        loss, dist, eik = pretrain.pretrain_losses(
            gen, z.to(device), {'strata': strata.to(device)},
            PRETRAIN_EIKONAL)
        grads = torch.autograd.grad(loss, picks)
        return float(loss.detach()), [g.cpu() for g in grads]

    t0 = time.perf_counter()
    c_loss, c_grads = loss_and_grads(torch.device('cuda'))
    p_loss, p_grads = loss_and_grads(torch.device('cpu'))
    loss_err = abs(c_loss - p_loss) / abs(p_loss)
    grad_errs = [float((c - p).norm() / p.norm())
                 for c, p in zip(c_grads, p_grads)]
    if loss_err > PRETRAIN_LOSS_RTOL or max(grad_errs) > PRETRAIN_GRAD_RTOL:
        raise AssertionError(f'pretraining step on the card differs from the '
                             f'CPU: loss {loss_err}, grads {grad_errs}')
    return {'batch': PRETRAIN_CHECK_BATCH, 'loss_card': c_loss,
            'loss_cpu': p_loss, 'loss_rel_err': loss_err,
            'grad_rel_err': dict(zip(('torgb', 'decoder.net.0',
                                      'decoder.net.2'), grad_errs)),
            'loss_rtol': PRETRAIN_LOSS_RTOL, 'grad_rtol': PRETRAIN_GRAD_RTOL,
            'seconds': time.perf_counter() - t0}


def pretrain_phase(rows: dict):
    """SDF pretraining at the CLI's batch on the full-width generator:
    one warm-up call of one step, then one call of PRETRAIN_TIMED_STEPS
    steps (the
    loop's Adam is fresh in each call). Returns the state and a
    one-step call to trace."""
    started = time.perf_counter()
    dev = torch.device('cuda')
    cfg = PRETRAIN_CFG
    state = gan.init_train_state(cfg, dtype=torch.bfloat16, device=dev,
                                 seed=0)
    draws = torch.Generator(device=dev).manual_seed(20)

    def run(n):
        return pretrain.pretrain_sdf(state, cfg, PRETRAIN_EIKONAL, PRETRAIN_LR,
                                     n_steps=n, return_losses=True,
                                     generator=draws)[1]

    run(1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    dist, eik = run(PRETRAIN_TIMED_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / PRETRAIN_TIMED_STEPS
    launched = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect_launches('pretraining steps', launched)
    dist, eik = dist.tolist(), eik.tolist()
    if not all(np.isfinite(dist + eik)):
        raise AssertionError(f'pretraining losses not finite: {dist}, {eik}')
    for p, e in zip(state.gen.parameters(), state.gen_ema.parameters()):
        if not torch.equal(p, e) or p.data_ptr() == e.data_ptr():
            raise AssertionError('the EMA is not a copy of the parameters')
    rows[triplane_cuda.KERNEL]['pretrain_launches'] = launched[
        triplane_cuda.KERNEL]
    check = pretrain_check(state, cfg)
    emit('pretrain', started, batch=cfg.batch_size, nstrata=pretrain.NSTRATA,
         points_per_image=(pretrain.NSTRATA - 1) ** 3, lr=PRETRAIN_LR,
         eikonal=PRETRAIN_EIKONAL, steps=PRETRAIN_TIMED_STEPS, step_ms=step_ms,
         images_per_s=cfg.batch_size / (step_ms / 1e3), peak_gb=peak_gb,
         launches=launched, dist=dist, eik=eik, ema_is_a_copy=True,
         cpu_check=check)
    return state, lambda: pretrain.pretrain_sdf(
        state, cfg, PRETRAIN_EIKONAL, PRETRAIN_LR, n_steps=1,
        generator=draws)


def distill_stages(state: distill.EncoderTrainState, gen: Generator,
                   batch: dict, repeats: int = 3) -> dict:
    """Median ms of a distillation step's stages, each between CUDA events:
    the targets' render, the encoder forward and backward, and Adam."""
    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    cfg = DISTILL_CFG
    encoder = state.encoder.train()
    params = list(encoder.parameters())
    times = {'targets render': [], 'encoder forward + backward': [],
             'adam': []}
    for _ in range(repeats):
        z = torch.randn((STAGE_BATCH, cfg.latent_dim), generator=state.rng,
                        device=gen.beta.device)
        targets, ms = timed(lambda: distill.render_distillation_targets(
            gen, z, batch['pose'], batch['focal'], None, None, cfg,
            state.rng))
        times['targets render'].append(ms)

        def forward_backward():
            loss, _ = distill.distillation_loss(encoder, *targets, state.rng)
            return torch.autograd.grad(loss, params)

        grads, ms = timed(forward_backward)
        times['encoder forward + backward'].append(ms)
        for p, g in zip(params, grads):
            p.grad = g
        times['adam'].append(timed(state.opt.step)[1])
        state.opt.zero_grad(set_to_none=True)
    return {k: statistics.median(v) for k, v in times.items()}


def sliced_plain(planes_cl: torch.Tensor,
                 coords: torch.Tensor) -> torch.Tensor:
    """The plain sampler on slices of PLAIN_SLICE views, joined."""
    return torch.cat([triplane.plain_sampler(planes_cl[i:i + PLAIN_SLICE],
                                             coords[i:i + PLAIN_SLICE])
                      for i in range(0, planes_cl.shape[0], PLAIN_SLICE)])


def sliced_rel_max(a: torch.Tensor, ref: torch.Tensor) -> float:
    """`rel_max` over slices of PLAIN_SLICE views (no full-size float32
    temporaries)."""
    err = peak = 0.0
    for i in range(0, ref.shape[0], PLAIN_SLICE):
        r = ref[i:i + PLAIN_SLICE].float()
        err = max(err, float((a[i:i + PLAIN_SLICE].float() - r).abs().max()))
        peak = max(peak, float(r.abs().max()))
    return err / max(peak, 1e-30)


def distill_check(state: distill.EncoderTrainState, gen: Generator,
                  dev: torch.device) -> dict:
    """At STAGE_BATCH views, the distillation step's shape: B1's output in
    the targets render's coarse and fine pass against `sliced_plain` on
    the same planes and points, the targets with B1 against the same
    render on `sliced_plain`, then the train-mode loss and gradients on
    each (the same encoder, the same stochastic-depth draws)."""
    cfg = DISTILL_CFG
    b = STAGE_BATCH
    draws = torch.Generator(device=dev).manual_seed(24)
    cam, focal = p3d_cameras(np.random.default_rng(25), b, dev)
    z = torch.randn((b, cfg.latent_dim), generator=draws, device=dev)
    noise = {'depth': torch.rand((b, RES, RES, SAMPLES), generator=draws,
                                 device=dev),
             'pdf_u': torch.rand((b * RES * RES, SAMPLES), generator=draws,
                                 device=dev)}
    passes = []

    def recorded(planes_cl, coords):
        feats = triplane_cuda.sample_triplane(planes_cl, coords)
        passes.append((planes_cl, coords, feats))
        return feats

    encoder = state.encoder.train()
    params = list(encoder.parameters())
    last = [p is encoder.post[4].weight for p in params].index(True)
    out = {}
    for name, sampler in (('kernels', recorded), ('plain', sliced_plain)):
        targets = distill.render_distillation_targets(
            gen, z, cam, focal, None, None, cfg, noise, sampler)
        if name == 'kernels':
            if len(passes) != 2:
                raise AssertionError(f'the targets render sampled '
                                     f'{len(passes)} times, expected 2')
            with torch.no_grad():
                b1_errs = {
                    what: sliced_rel_max(feats, sliced_plain(planes, coords))
                    for what, (planes, coords, feats)
                    in zip(('coarse', 'fine'), passes)}
            points = [int(coords.shape[0] * coords.shape[1])
                      for _, coords, _ in passes]
            passes.clear()
        loss, _ = distill.distillation_loss(
            encoder, *targets, torch.Generator(device=dev).manual_seed(26))
        grads = torch.autograd.grad(loss, params)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        out[name] = (targets, float(loss.detach()), float(norm), grads[last])
    (k_t, k_loss, k_norm, k_last), (p_t, p_loss, p_norm, p_last) = (
        out['kernels'], out['plain'])
    target_errs = {name: rel_max(a, ref) for name, a, ref in
                   zip(('image', 'mask', 'coords'), k_t[:3], p_t[:3])}
    loss_err = abs(k_loss - p_loss) / abs(p_loss)
    norm_err = abs(k_norm - p_norm) / p_norm
    last_err = float((k_last - p_last).norm() / p_last.norm())
    if (max(b1_errs.values()) > DISTILL_TARGET_RTOL or
            max(target_errs.values()) > DISTILL_TARGET_RTOL or
            loss_err > STEP_LOSS_RTOL or norm_err > STEP_GRAD_RTOL or
            last_err > STEP_GRAD_RTOL):
        raise AssertionError(f'distillation with the kernels differs from '
                             f'the plain sampler: B1 {b1_errs}, targets '
                             f'{target_errs}, loss {loss_err}, grad norm '
                             f'{norm_err}, last layer {last_err}')
    return {'batch': b, 'plain_slice': PLAIN_SLICE, 'b1_points': points,
            'b1_rel_err': b1_errs, 'target_rel_err': target_errs,
            'target_rtol': DISTILL_TARGET_RTOL, 'loss_kernels': k_loss,
            'loss_plain': p_loss, 'loss_rel_err': loss_err,
            'grad_norm_rel_err': norm_err, 'last_layer_grad_rel_err': last_err,
            'loss_rtol': STEP_LOSS_RTOL, 'grad_rtol': STEP_GRAD_RTOL,
            'mask_range': (float(k_t[1].min()), float(k_t[1].max()))}


def distill_phase(rows: dict, gen: Generator):
    """Encoder distillation at the CLI's batch: the frozen EMA generator
    `gen` renders the targets, the MiT-B5 encoder (random weights, drop
    path 0.1 from the state's generator) takes Adam steps. One warm-up
    step, then STAGE_STEPS steps, each with its launch counts. Returns a
    step to trace."""
    started = time.perf_counter()
    dev = torch.device('cuda')
    cfg = DISTILL_CFG
    encoder = BootstrapEncoder(cfg.latent_dim, device=dev)
    encoder.load_state_dict({k: torch.from_numpy(v) for k, v in
                             convert.random_encoder_state_dict(11).items()})
    state = distill.init_train_state(encoder, seed=22)
    rng = np.random.default_rng(23)

    def batch():
        cam, focal = p3d_cameras(rng, STAGE_BATCH, dev)
        return {'pose': cam, 'focal': focal}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, steps = [], []
    for k in range(STAGE_STEPS + 1):
        b = batch()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        metrics = distill.train_step(state, b, gen, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = counts()
        if launched != DISTILL_LAUNCHES:
            raise AssertionError(f'distillation step {k}: launches '
                                 f'{launched}, expected {DISTILL_LAUNCHES}')
        steps.append({n: float(v) for n, v in metrics.items()})
        if k > 0:  # the first step is the warm-up
            times.append(ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for m in steps:
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f'a distillation loss is not finite: {m}')
    rows[triplane_cuda.KERNEL]['distill_launches'] = launched[
        triplane_cuda.KERNEL]
    step_ms = statistics.median(times)
    stage_ms = distill_stages(state, gen, batch())
    check = distill_check(state, gen, dev)
    emit('distill', started, config=dataclasses.asdict(cfg),
         batch=STAGE_BATCH, steps=STAGE_STEPS, iteration=state.iteration,
         encoder_parameters=sum(p.numel() for p in encoder.parameters()),
         drop_path_rate=0.1, step_ms=step_ms, step_ms_all=times,
         stage_ms=stage_ms, images_per_s=STAGE_BATCH / (step_ms / 1e3),
         peak_gb=peak_gb, launches_per_step=launched, step_metrics=steps,
         plain_check=check)
    traced = batch()
    return lambda: distill.train_step(state, traced, gen, cfg)


def calibrate_encoder_head(encoder: BootstrapEncoder, images: torch.Tensor,
                           foreground: float) -> None:
    """Rescales the random encoder's coordinate outputs to COORD_SPREAD
    about the origin and shifts its mask logit so that the share
    `foreground` of the pixels passes PNP_MASK_CUT, from one forward on
    `images` (see COORD_SPREAD)."""
    with torch.no_grad():
        coords, mask, _ = encoder(images)
        last = encoder.post[4]
        scale = COORD_SPREAD / coords.std(dim=(0, 1, 2))
        last.weight[:3] *= scale[:, None, None, None]
        last.bias[:3] = (last.bias[:3] - coords.mean(dim=(0, 1, 2))) * scale
        logits = torch.logit(mask.double(), eps=1e-12).flatten()
        cut = math.log(PNP_MASK_CUT / (1.0 - PNP_MASK_CUT))
        last.bias[3] += cut - float(torch.quantile(logits, 1.0 - foreground))


def pipeline_phase(rows: dict, gen: Generator, lpips: LPIPS) -> None:
    """The hybrid inversion of one batch as the JAX CLI runs it
    (nerf_from_image_tpu/cli/inversion.py): bootstrap (MiT-B5 encoder,
    then host PnP), the initial parameters, the evaluation at step 0, 30
    refinement steps, the evaluation at step 30, the report. Targets: a
    second latent rendered from known p3d_car cameras (front view, with
    its mask) and from other cameras with a bbox crop (novel views)."""
    started = time.perf_counter()
    dev = torch.device('cuda')
    cfg = INV_CFG
    rng = np.random.default_rng(9)
    with torch.no_grad():
        ws = gen.map(torch.from_numpy(rng.standard_normal(
            (BATCH, GEN_KWARGS['latent_dim'])).astype(np.float32)).to(dev))
        field = gen.field(gen.synthesize(ws))

        gt_cam, gt_focal = p3d_cameras(rng, BATCH, dev)
        front = render(field, RES, RES, gt_cam, gt_focal, cfg.scene_range,
                       cfg.white_background, SAMPLES)
        perm_cam, perm_focal = p3d_cameras(rng, BATCH, dev)
        perm_bbox = torch.tensor(PERM_BBOX, device=dev).expand(BATCH, 2, 2)
        novel = render(field, RES, RES, perm_cam, perm_focal,
                       cfg.scene_range, cfg.white_background, SAMPLES,
                       bbox=perm_bbox).rgb
        del field
    target = torch.cat((front.rgb, front.mask[..., None]), dim=-1)
    perm = (perm_cam, perm_focal, None, perm_bbox)

    t0 = time.perf_counter()
    encoder = BootstrapEncoder(GEN_KWARGS['latent_dim'], device=dev).eval()
    encoder.load_state_dict({k: torch.from_numpy(v) for k, v in
                             convert.random_encoder_state_dict(11).items()})
    foreground = float((front.mask > 0.5).float().mean())
    calibrate_encoder_head(encoder, target[..., :3].permute(0, 3, 1, 2),
                           foreground)
    encoder_params = sum(p.numel() for p in encoder.parameters())
    z_avg = gen.average_w(torch.Generator(device=dev).manual_seed(1234))
    focal_guesses = pnp.get_focal_guesses(rng.uniform(1.3, 1.8, 200))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    stage_ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stage_ms[name] = (time.perf_counter() - t) * 1e3
        return out

    reset_counts()
    enc_out = timed('encoder forward',
                    lambda: pipeline.bootstrap_dispatch(encoder, target))
    expect_launches('encoder forward', counts())
    _, mask_np, z_init, cam2world, focal, errors = timed(
        'pnp', lambda: pipeline.bootstrap_finish(
            enc_out, focal_guesses, z_avg, cfg.lr_gain_z))
    fallbacks = int(np.sum(errors == pnp.DUMMY_ERROR))
    # The dummy pose on an empty mask, as the JAX package's PnP takes it.
    dummy = pipeline.bootstrap_finish(
        (enc_out[0], torch.zeros_like(enc_out[1]), enc_out[2]),
        focal_guesses, z_avg, cfg.lr_gain_z)[5]
    if not np.all(dummy == pnp.DUMMY_ERROR):
        raise AssertionError(f'an empty mask did not give the dummy pose: '
                             f'{dummy}')
    params = pipeline.init_inversion_params(z_init, cam2world, focal,
                                            cfg.camera_flipped)

    inception = InceptionV3FID(device=dev)
    convert.load_inception_state_dict(inception,
                                      convert.random_inception_state_dict(0))
    with torch.no_grad():
        inception_ms = time_cuda(lambda: inception(
            target[..., :3].permute(0, 3, 1, 2) / 2 + 0.5), 5)

    ctx = pipeline.EvalContext(gen=gen, lpips=lpips, has_mask=True,
                               inception=inception)
    report = pipeline.make_report([0, PIPELINE_STEPS])
    launches = {}

    def evaluate(step, p):
        reset_counts()
        timed(f'evaluation {step}', lambda: pipeline.evaluate_checkpoint(
            ctx, cfg, p, report[step], target, None, None, gt_cam,
            perm_cameras=perm, target_img_random=novel))
        launches[f'evaluation {step}'] = counts()
        expect_launches(f'evaluation {step}', counts(),
                        **{triplane_cuda.FUSED_KERNEL: True})

    evaluate(0, params)
    reset_counts()
    final, metrics = timed(f'{PIPELINE_STEPS} steps', lambda: (
        inv.run_inversion(gen, lpips, params, target[..., :3], cfg,
                          PIPELINE_STEPS,
                          generator=torch.Generator(device=dev).manual_seed(
                              10), gt_cam2world=gt_cam)))
    launches['steps'] = counts()
    expect_launches('refinement steps', counts(),
                    **{triplane_cuda.KERNEL: True,
                       triplane_cuda.GRAD_KERNEL: True,
                       'warp_forward': True, 'warp_backward': True})
    evaluate(PIPELINE_STEPS, final)
    for step, entry in report.items():
        for key in ('inception_activations_front',
                    'inception_activations_random'):
            acts = entry[key]
            if (len(acts) != 1 or acts[0].shape != (BATCH, 2048) or
                    not np.all(np.isfinite(acts[0]))):
                raise AssertionError(f'{key} at {step}: '
                                     f'{[a.shape for a in acts]}')
    files = report_files_round_trip(report)
    # Without the real statistics: the cli phase's report holds FID (its
    # matrix square roots take about 12 s each on the host).
    report, report_text = timed('consolidate', lambda: (
        pipeline.consolidate_report(report)))
    files.update(report_save_round_trip(report, report_text))

    metrics = {k: v.float().cpu().tolist() for k, v in metrics.items()}
    for key in ('loss', 'psnr', 'lpips', 'rot_error'):
        if not all(np.isfinite(metrics[key])):
            raise AssertionError(f'step {key} not finite: {metrics[key]}')
    averages = {step: {k: v for k, v in entry.items() if k.endswith('_avg')}
                for step, entry in report.items()}
    for step, entry in report.items():
        for key in pipeline.REPORT_SCALARS:
            if not np.all(np.isfinite(entry[key])):
                raise AssertionError(f'report {key} at {step} not finite: '
                                     f'{entry[key]}')
    rows[triplane_cuda.FUSED_KERNEL]['launches'] = launches[
        f'evaluation {PIPELINE_STEPS}'][triplane_cuda.FUSED_KERNEL]
    emit('pipeline', started, config=dataclasses.asdict(cfg),
         steps=PIPELINE_STEPS, encoder_parameters=encoder_params,
         setup_s=setup_s, stage_ms=stage_ms, launches=launches,
         pnp_fallbacks=fallbacks, pnp_errors=errors.tolist(),
         empty_mask_fallbacks=int(np.sum(dummy == pnp.DUMMY_ERROR)),
         target_foreground=foreground,
         mask_pass_share=float((mask_np > PNP_MASK_CUT).mean()),
         step_metrics=metrics, report=averages,
         inception_ms_per_batch=inception_ms, report_files=files,
         report_text=report_text.strip().splitlines())


def cli_assets(root: str) -> dict:
    """What a user of the CLI brings, written under `root` from seeds: the
    p3d_car fixture, a reference-format GAN checkpoint of the full-width
    generator (EMA = G), a reference-format MiT-B5 encoder file (its head
    calibrated on the fixture's test crops, see COORD_SPREAD) and the
    published weight files' layouts under weights/ (random LPIPS and
    Inception). Returns the paths and what each took."""
    seconds = {}
    t = time.perf_counter()
    data = os.path.join(root, 'data')
    fixtures.write_p3d_car(data, CLI_TRAIN_IMAGES, CLI_TEST_IMAGES,
                           CLI_IMAGE_HW, seed=12)
    seconds['fixture'] = time.perf_counter() - t

    t = time.perf_counter()
    gan_path = os.path.join(root, 'gan.pth')
    checkpoint.save(checkpoint.gan_checkpoint(
        gan.init_train_state(TRAIN_CFG, device='cpu', seed=0)), gan_path)
    seconds['gan_checkpoint'] = time.perf_counter() - t

    t = time.perf_counter()
    test = loaders.load_dataset(port_config.parse_args(
        ['--dataset', 'p3d_car', '--run_inversion', '--data_path',
         data]))[3]
    images = torch.from_numpy(np.ascontiguousarray(
        test.images[:BATCH].transpose(0, 3, 1, 2))).cuda()
    encoder = BootstrapEncoder(GEN_KWARGS['latent_dim'], device='cuda')
    encoder.load_state_dict({k: torch.from_numpy(v) for k, v in
                             convert.random_encoder_state_dict(11).items()})
    foreground = float((images[:, 3] > 0.5).float().mean())
    calibrate_encoder_head(encoder.eval(), images[:, :3].contiguous(),
                           foreground)
    enc_path = os.path.join(root, 'encoder.pth')
    torch.save({k: v.cpu() for k, v in encoder.state_dict().items()},
               enc_path)
    del encoder, images
    seconds['encoder_file'] = time.perf_counter() - t

    t = time.perf_counter()
    wdir = os.path.join(root, 'out', 'weights')
    os.makedirs(wdir)
    for name, sd in zip(weights.LPIPS_FILES + (weights.INCEPTION_FILE,),
                        (*convert.random_lpips_state_dicts(0),
                         convert.random_inception_state_dict(0))):
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   os.path.join(wdir, name))
    seconds['weight_files'] = time.perf_counter() - t
    return {'data': data, 'gan': gan_path, 'encoder': enc_path,
            'root': os.path.join(root, 'out'),
            'target_foreground': foreground, 'seconds': seconds}


def cli_phase(assets: dict) -> None:
    """The inversion CLI end to end, in this process, through
    `cli.run.main` with the default flags (batches of 8, 30 steps,
    checkpoints 0 and 30, FID; the generator in float32 whatever
    --compute_dtype says, as the JAX CLI builds it): the p3d_car test
    split from disk, the EMA weights from the GAN checkpoint, the encoder
    file, the weight files, the report's files. Launches are counted
    around each call of the refinement steps and of the evaluation (never
    B5a in the steps nor B1 in an evaluation); each batch's times are the
    CLI's own."""
    started = time.perf_counter()
    calls = []
    dtypes = []
    originals = (inv.run_inversion, pipeline.evaluate_checkpoint,
                 loaders.load_dataset, cli_inversion.run_inversion_cli)

    def counted(kind, fn):
        def wrapper(*args, **kwargs):
            before = counts()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            calls.append((kind, time.perf_counter() - t, {
                name: n - before[name] for name, n in counts().items()}))
            return out
        return wrapper

    def run_inversion_cli(args, cfg, dataset_config, gen, *rest):
        dtypes.append((args.compute_dtype, str(gen.dtype),
                       str(next(gen.parameters()).dtype)))
        return originals[3](args, cfg, dataset_config, gen, *rest)

    argv = ['--dataset', 'p3d_car', '--run_inversion', '--resume_from',
            assets['gan'], '--coord_resume_from', assets['encoder'],
            '--root_path', assets['root'], '--data_path', assets['data']]
    inv.run_inversion = counted('steps', originals[0])
    pipeline.evaluate_checkpoint = counted('evaluation', originals[1])
    loaders.load_dataset = counted('dataset', originals[2])
    cli_inversion.run_inversion_cli = run_inversion_cli
    try:
        reset_counts()
        t0 = time.perf_counter()
        out = cli_run.main(argv)
        cli_s = time.perf_counter() - t0
        total = counts()
    finally:
        (inv.run_inversion, pipeline.evaluate_checkpoint,
         loaders.load_dataset, cli_inversion.run_inversion_cli) = originals
    report_dir = out['report_dir']
    report = dict(np.load(os.path.join(report_dir, 'report.npz')))
    with open(os.path.join(report_dir, 'report.txt')) as f:
        report_text = f.read()
    with open(os.path.join(report_dir, 'scalars.jsonl')) as f:
        tags = {json.loads(line)['tag'] for line in f}
    torch.cuda.empty_cache()
    if dtypes != [('bfloat16', 'torch.float32', 'torch.float32')]:
        raise AssertionError(f'the inversion generator: {dtypes}')

    batches = out['batches']
    if [b['images'] for b in batches] != [8, 8, 4] or [
            b['serial'] for b in batches] != [True, False, False]:
        raise AssertionError(f'cli batches: {batches}')
    per_batch = [c for c in calls if c[0] != 'dataset']
    if [c[0] for c in per_batch] != ['evaluation', 'steps',
                                     'evaluation'] * len(batches):
        raise AssertionError(f'cli calls: {[c[0] for c in per_batch]}')
    launches = []
    for i in range(len(batches)):
        ev0, steps, ev30 = (c[2] for c in per_batch[3 * i:3 * i + 3])
        expect_launches(f'cli batch {i + 1} steps', steps,
                        **CLI_STEP_LAUNCHES)
        for ev in (ev0, ev30):
            expect_launches(f'cli batch {i + 1} evaluation', ev,
                            **CLI_EVAL_LAUNCHES)
        launches.append({'steps': steps, 'evaluations': {
            name: ev0[name] + ev30[name] for name in ev0}})
    want = {name: sum(b['steps'][name] + b['evaluations'][name]
                      for b in launches) for name in total}
    if total != want:
        raise AssertionError(f'cli launches {total}, per call {want}')

    rows = {}
    for step in (0, CLI_STEPS):
        for key in ('ws', 'R', 's', 't2', 'z0', 'psnr', 'ssim', 'lpips',
                    'iou'):
            arr = report[f'{step}/{key}']
            if arr.shape[0] != CLI_TEST_IMAGES or not np.all(
                    np.isfinite(arr)):
                raise AssertionError(f'report {step}/{key}: {arr.shape}')
            rows[f'{step}/{key}'] = arr.shape[0]
        for key in ('fid_front', 'fid_random', 'fid_front_test',
                    'fid_random_test', 'psnr_avg', 'ssim_avg', 'lpips_avg',
                    'iou_avg'):
            if not np.isfinite(report[f'{step}/{key}']):
                raise AssertionError(f'report {step}/{key} not finite')
    for tag in ('monitor_b0/psnr', 'monitor_b0/grad_norm_z', 'report/psnr',
                'report/fid_front', 'report/fid_random_test'):
        if tag not in tags:
            raise AssertionError(f'{tag} not in scalars.jsonl')

    for b in batches:
        b['pnp_wait_share'] = (None if b['pnp_wait_s'] is None else
                               b['pnp_wait_s'] / b['pnp_s'])
    dataset_s = sum(c[1] for c in calls if c[0] == 'dataset')
    emit('cli', started, argv=[os.path.basename(a) for a in argv],
         dtype={'compute_dtype': dtypes[0][0], 'generator': dtypes[0][1],
                'parameters': dtypes[0][2]},
         test_images=CLI_TEST_IMAGES, train_images=CLI_TRAIN_IMAGES,
         image_hw=CLI_IMAGE_HW, assets_seconds=assets['seconds'],
         target_foreground=assets['target_foreground'], cli_s=cli_s,
         dataset_load_s=dataset_s, real_stats_s=out['real_stats_s'],
         consolidate_s=out['consolidate_s'], batches=batches,
         per_image_s=sum(b['wall_s'] for b in batches) / CLI_TEST_IMAGES,
         wait_share_limit=CLI_WAIT_SHARE,
         overlap_held=all(b['pnp_wait_share'] < CLI_WAIT_SHARE
                          for b in batches[1:]),
         launches=launches, report_rows=rows,
         fid={step: {k: float(report[f'{step}/{k}']) for k in
                     ('fid_front', 'fid_random')}
              for step in (0, CLI_STEPS)},
         report_text=report_text.strip().splitlines())


def float32_phase(lpips: LPIPS) -> None:
    """The inversion in float32, as the CLI now runs it: a float32
    generator's render and one refinement step through the kernels (B1,
    B2 and B3, the planes rounded to bf16 at the kernels' boundary)
    against the same render and step through the plain versions fed the
    same bf16-rounded planes (`triplane_cuda.sample_bf16_planes` with the
    plain functions): the render within B1's KERNEL_ATOL, the step within
    STEP_LOSS_RTOL and STEP_GRAD_RTOL; the step's ms beside it."""
    started = time.perf_counter()
    dev = torch.device('cuda')
    gen = Generator(dtype=torch.float32, device=dev, seed=0,
                    **dict(GEN_KWARGS, scene_range=INV_CFG.scene_range))
    gen.eval()
    target, _, gt_cam, init = inversion_problem(gen)

    plain = plain_bf16_rounded

    with torch.no_grad():
        reset_counts()
        k_out = inv.render_from_params(gen, init, INV_CFG)[0]
        render_launches = counts()
        p_out = inv.render_from_params(gen, init, INV_CFG, sampler=plain)[0]
    expect_launches('float32 render', render_launches,
                    **{triplane_cuda.KERNEL: 2})
    render_err = {k: float((getattr(k_out, k) - getattr(p_out, k)).abs()
                           .max()) for k in ('rgb', 'mask', 'depth')}
    if max(render_err['rgb'], render_err['mask']) > KERNEL_ATOL:
        raise AssertionError(f'float32 render with the kernels differs from '
                             f'the plain render: {render_err}')

    tform = augment.sample_transform(
        torch.Generator(device=dev).manual_seed(6),
        BATCH * INV_CFG.num_augmentations, 1.0)
    step = inv.make_inversion_step(gen, lpips, INV_CFG, gt_cam)
    plain_step = inv.make_inversion_step(gen, lpips, INV_CFG, gt_cam,
                                         sampler=plain, warp=warp.warp_plain)

    def loss_and_grads(step_fn):
        p = init.copy(requires_grad=True)
        m = step_fn(p, inv.make_optimizer(p, INV_CFG), target, tform=tform)
        return float(m['loss']), p.z.grad, p.R.grad

    reset_counts()
    k_loss, k_gz, k_gr = loss_and_grads(step)
    step_launches = counts()
    expect_launches('float32 step', step_launches,
                    **{triplane_cuda.KERNEL: 2, triplane_cuda.GRAD_KERNEL: 2,
                       'warp_forward': 2, 'warp_backward': 1})
    p_loss, p_gz, p_gr = loss_and_grads(plain_step)
    loss_err = abs(k_loss - p_loss) / abs(p_loss)
    gz_err = float((k_gz - p_gz).norm() / p_gz.norm())
    gr_err = float((k_gr - p_gr).norm() / p_gr.norm())
    if (loss_err > STEP_LOSS_RTOL or gz_err > STEP_GRAD_RTOL or
            gr_err > STEP_GRAD_RTOL):
        raise AssertionError(f'float32 step with the kernels differs from '
                             f'the plain step: loss {loss_err}, grad z '
                             f'{gz_err}, grad R {gr_err}')
    params = init.copy(requires_grad=True)
    optimizer = inv.make_optimizer(params, INV_CFG)
    step_ms = time_cuda(lambda: step(params, optimizer, target, tform=tform),
                        INV_STEPS, warmup=1)
    del gen
    torch.cuda.empty_cache()
    emit('float32', started, render_launches=render_launches,
         render_err=render_err, render_atol=KERNEL_ATOL,
         step_launches=step_launches, step_ms=step_ms,
         plain_check={'loss_kernels': k_loss, 'loss_plain': p_loss,
                      'loss_rel_err': loss_err, 'grad_z_rel_err': gz_err,
                      'grad_R_rel_err': gr_err, 'loss_rtol': STEP_LOSS_RTOL,
                      'grad_rtol': STEP_GRAD_RTOL})


def train_cli_phase(assets: dict, rows: dict) -> None:
    """The GAN-training CLI end to end, in this process, through
    `cli.run.main` at its default flags (batch 32, bf16, 128^2, 64 + 64
    samples, p3d_car's ADA, R1, blur and regularizers) on the cli phase's
    fixture and weight files: a fresh run of 4 iterations
    (TRAIN_CLI_PRETRAIN_STEPS steps of SDF pretraining, G, D, G, D, the iteration-3 evaluation, `latest` and
    `best`) and a resume by name to 8. Launches are counted around every
    G step, D step, evaluation and pretraining call; the steps' ms come
    from CUDA events around each; the evaluation's seconds from the
    evaluator's own clock. Then the evaluation's first render through the
    kernels against the same render through the plain versions."""
    started = time.perf_counter()
    calls = []
    images = set()
    saves = []
    originals = (gan.g_step, gan.d_step, pretrain.pretrain_sdf,
                 train_eval.GANEvaluator.evaluate,
                 train_eval.GANEvaluator.log_training_images,
                 checkpoint.CheckpointManager.save,
                 port_logging.SummaryWriter.add_images)

    def counted(kind, fn, events=False):
        def wrapper(*args, **kwargs):
            before = counts()
            if events:
                timer = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                timer[0].record()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            if events:
                timer[1].record()
            else:
                torch.cuda.synchronize()
            calls.append({'kind': kind, 'timer': timer if events else None,
                          'seconds': time.perf_counter() - t,
                          'launches': {name: n - before[name]
                                       for name, n in counts().items()}})
            return out
        return wrapper

    def save(self, obj, label='latest'):
        t = time.perf_counter()
        originals[5](self, obj, label)
        saves.append((label, obj['iteration'], time.perf_counter() - t))

    def add_images(self, tag, imgs, step):
        images.add((tag, int(step)))
        return originals[6](self, tag, imgs, step)

    root = os.path.join(os.path.dirname(assets['root']), 'train_out')
    os.makedirs(root)
    os.symlink(os.path.join(assets['root'], 'weights'),
               os.path.join(root, 'weights'))
    argv = ['--dataset', 'p3d_car', '--root_path', root, '--data_path',
            assets['data']]
    gan.g_step = counted('g', originals[0], events=True)
    gan.d_step = counted('d', originals[1], events=True)
    pretrain.pretrain_sdf = counted(
        'pretrain', lambda *a, **k: originals[2](
            *a, **dict(k, n_steps=TRAIN_CLI_PRETRAIN_STEPS)))
    train_eval.GANEvaluator.evaluate = counted('evaluate', originals[3])
    train_eval.GANEvaluator.log_training_images = counted('images',
                                                          originals[4])
    checkpoint.CheckpointManager.save = save
    port_logging.SummaryWriter.add_images = add_images
    runs = []
    try:
        for extra in (['--iterations', str(TRAIN_CLI_ITERS[0])],
                      ['--iterations', str(TRAIN_CLI_ITERS[1]),
                       '--profile_trace_at', str(TRAIN_CLI_TRACE_AT),
                       '--resume_from', None]):
            if extra[-1] is None:
                extra[-1] = os.path.basename(runs[0]['out']['checkpoint_dir'])
            calls.clear()
            saves.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            out = cli_run.main(argv + extra)
            torch.cuda.synchronize()
            ckpt_dir = out['checkpoint_dir']
            runs.append({
                'out': out, 'seconds': time.perf_counter() - t0,
                'peak_gb': torch.cuda.max_memory_allocated() / 1e9,
                'total': counts(), 'calls': list(calls),
                'saves': list(saves),
                'labels': {f: checkpoint.load(os.path.join(ckpt_dir, f))[
                    'iteration'] for f in sorted(os.listdir(ckpt_dir))},
                'scalars': [json.loads(line) for line in open(
                    os.path.join(out['log_dir'], 'scalars.jsonl'))]})
            torch.cuda.empty_cache()
    finally:
        (gan.g_step, gan.d_step, pretrain.pretrain_sdf,
         train_eval.GANEvaluator.evaluate,
         train_eval.GANEvaluator.log_training_images,
         checkpoint.CheckpointManager.save,
         port_logging.SummaryWriter.add_images) = originals

    want = {'g': TRAIN_CLI_G, 'd': TRAIN_CLI_D, 'evaluate': TRAIN_CLI_EVAL,
            'images': TRAIN_CLI_IMAGES, 'pretrain': {}}
    kinds = (['pretrain'] + ['g', 'd'] * 2 + ['evaluate', 'images'],
             ['g', 'd'] * 2)
    summary = []
    for run, kind_list, n_iter in zip(runs, kinds, TRAIN_CLI_ITERS):
        if [c['kind'] for c in run['calls']] != kind_list:
            raise AssertionError(f'train cli calls: '
                                 f'{[c["kind"] for c in run["calls"]]}')
        for c in run['calls']:
            expect_launches(f'train cli {c["kind"]}', c['launches'],
                            **want[c['kind']])
        total = {name: sum(c['launches'][name] for c in run['calls'])
                 for name in run['total']}
        if total != run['total']:
            raise AssertionError(f'train cli launches {run["total"]}, per '
                                 f'call {total}')
        if run['out']['state'].iteration != n_iter:
            raise AssertionError(f'train cli iteration '
                                 f'{run["out"]["state"].iteration}')
        step_ms = {k: [c['timer'][0].elapsed_time(c['timer'][1])
                       for c in run['calls'] if c['kind'] == k]
                   for k in ('g', 'd')}
        summary.append({
            'seconds': run['seconds'], 'peak_gb': run['peak_gb'],
            'pretrained': run['out']['pretrained'],
            'launches': run['total'], 'g_ms': step_ms['g'],
            'd_ms': step_ms['d'],
            'seconds_by_call': {k: sum(c['seconds'] for c in run['calls']
                                       if c['kind'] == k)
                                for k in ('pretrain', 'evaluate', 'images')},
            'checkpoints': run['saves'], 'labels': run['labels']})
    fresh, resumed = runs
    if not fresh['out']['pretrained'] or resumed['out']['pretrained']:
        raise AssertionError('pretraining: fresh run '
                             f'{fresh["out"]["pretrained"]}, resumed run '
                             f'{resumed["out"]["pretrained"]}')
    if fresh['labels'] != {'checkpoint_best.pth': 4,
                           'checkpoint_latest.pth': 4} or resumed[
            'labels'] != {'checkpoint_best.pth': 4,
                          'checkpoint_latest.pth': 8}:
        raise AssertionError(f'checkpoints {fresh["labels"]}, '
                             f'{resumed["labels"]}')
    logged = {(s['tag'], s['step']): s['value'] for s in fresh['scalars']}
    for step, tags in TRAIN_CLI_SCALARS.items():
        for tag in tags:
            if not np.isfinite(logged.get((tag, step), np.nan)):
                raise AssertionError(f'scalar {tag} at {step}: '
                                     f'{logged.get((tag, step))}')
    if len(resumed['scalars']) != len(fresh['scalars']):
        raise AssertionError('the resumed run logged scalars')
    missing = {(t, 3) for t in TRAIN_CLI_IMAGE_TAGS} - images
    if missing:
        raise AssertionError(f'images not logged: {sorted(missing)}')

    trace = trace_check(os.path.join(resumed['out']['log_dir'], 'trace'))
    evaluator = fresh['out']['evaluator']
    check = train_normals_check(fresh['out']['state'].gen_ema, evaluator)
    for name, key in ((triplane_cuda.KERNEL, 'triplane_sample'),
                      (triplane_cuda.GRAD_PLANES_KERNEL,
                       'triplane_sample_grad_planes'),
                      (triplane_cuda.GRAD_KERNEL, 'triplane_sample_grad')):
        rows[name]['train_cli_launches'] = {
            'g_step': TRAIN_CLI_G.get(key, 0),
            'd_step': TRAIN_CLI_D.get(key, 0),
            'evaluation': TRAIN_CLI_EVAL.get(key, 0) +
            TRAIN_CLI_IMAGES.get(key, 0)}
    emit('train_cli', started, argv=[os.path.basename(a) for a in argv],
         iterations=TRAIN_CLI_ITERS, runs=summary,
         fid=logged[('generation/fid_untrunc', 3)],
         eval_seconds=evaluator.times,
         scalars={f'{t}@{s}': v for (t, s), v in logged.items()},
         images=sorted(f'{t}@{s}' for t, s in images),
         normals_check=check, profile_trace=trace)


def trace_check(trace_dir: str) -> dict:
    """The training CLI's --profile_trace_at output: exactly one Chrome
    trace in `trace_dir` (no other iteration left one), whose kernel
    events hold B1's and B4's launches of the traced G step (at least
    TRAIN_CLI_G of each) by their CUDA function names."""
    files = sorted(os.listdir(trace_dir))
    if len(files) != 1 or not files[0].endswith('.json'):
        raise AssertionError(f'trace files: {files}')
    path = os.path.join(trace_dir, files[0])
    with open(path) as f:
        events = json.load(f)['traceEvents']
    kernels = [e for e in events if e.get('cat') == 'kernel']
    found = {key: sum(name in e.get('name', '') for e in kernels)
             for key, name in TRACE_KERNELS.items()}
    for key, n in found.items():
        if n < TRAIN_CLI_G[key]:
            raise AssertionError(f'trace {files[0]}: {n} launches of '
                                 f'{TRACE_KERNELS[key]}, want at least '
                                 f'{TRAIN_CLI_G[key]}')
    return {'file': files[0], 'mb': os.path.getsize(path) / 1e6,
            'kernel_events': len(kernels), 'launches': found,
            'kernel_ms': sum(e.get('dur', 0) for e in kernels) / 1e3}


def manual_photo(assets: dict, root: str) -> dict:
    """A user's photo from the fixture's first test image: as RGBA with
    its mask (car_val.mat's) as the alpha channel, and as RGB."""
    import scipy.io
    data = assets['data']
    rgb = image_io.read_png(os.path.join(data, fixtures.IMAGES_DIR,
                                         'car_pascal', 'test_0000.png'))
    anno = scipy.io.loadmat(
        os.path.join(data, 'p3d', 'p3d_sfm_image', 'img_anno',
                     'car_val.mat'), struct_as_record=False,
        squeeze_me=True)['images'][0]
    alpha = (np.asarray(anno.mask) > 0).astype(np.uint8) * 255
    paths = {'rgba': os.path.join(root, 'photo_rgba.png'),
             'rgb': os.path.join(root, 'photo_rgb.png')}
    image_io.write_png(paths['rgba'], np.concatenate((rgb, alpha[..., None]),
                                                     axis=-1))
    image_io.write_png(paths['rgb'], rgb)
    return paths


def cmyk_photo_check(rgb_path: str, work: str) -> dict:
    """The RGB photo saved as a CMYK JPEG with PIL (ImageNet's train set
    and users' photos hold such files), read through the demo's loader:
    three channels within JPEG loss of the photo, and a mask not taken
    from an alpha channel (a reader that kept the four raw channels gave
    K as the alpha)."""
    from PIL import Image
    rgb = image_io.read_png(rgb_path)
    path = os.path.join(work, 'photo_cmyk.jpg')
    Image.fromarray(rgb).convert('CMYK').save(path, quality=95)
    channels = image_io.imread(path).shape
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        loaded = cli_demo.load_manual_image(path, 3)
    said = said.getvalue()
    err = np.abs(loaded['image'] - rgb / 255.0)
    found = {'read_shape': list(channels),
             'mean_abs_err': float(err.mean()),
             'max_abs_err': float(err.max()),
             'mask': ('alpha' if 'alpha channel' in said else
                      'grabcut' if 'GrabCut' in said else
                      'full frame' if 'full-frame' in said else said),
             'mask_share': float(loaded['mask'].mean())}
    if (channels != rgb.shape or found['mask'] == 'alpha' or
            not found['mean_abs_err'] < CMYK_JPEG_LOSS):
        raise AssertionError(f'demo CMYK photo: {found}')
    return found


def counted_calls(calls: list, kind: str, fn):
    """`fn`, appending (kind, ms on CUDA events, launches during the call)
    to `calls` at each call."""
    def wrapper(*args, **kwargs):
        before = counts()
        timer = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
        timer[0].record()
        out = fn(*args, **kwargs)
        timer[1].record()
        timer[1].synchronize()
        calls.append((kind, timer[0].elapsed_time(timer[1]), {
            name: n - before[name] for name, n in counts().items()}))
        return out
    return wrapper


def move_surface_into_box(saved: dict) -> dict:
    """Lowers the SDF of a GAN checkpoint's random generators by 1.5, as
    the CPU tests do, so that its zero level lies in the box: the views
    see a surface, not the background."""
    for key in ('model', 'model_ema'):
        bias = saved[key]['decoder.net.2.bias'].clone()
        bias[0] -= 1.5
        saved[key]['decoder.net.2.bias'] = bias
    return saved


def demo_phase(assets: dict) -> dict:
    """The demo end to end through `cli.run.main --inv_manual_input_path`
    on the cli phase's fixture and files (its GAN with the surface moved
    into the box): an RGBA photo (its alpha is the mask), then the same
    photo as RGB (GrabCut's mask, cv2). Each inverts
    the photo at batch 1 (30 steps, evaluations at 0 and 30) and writes
    the strip [input | coords | recon | normals | novel view]; launches
    are counted around the steps, each evaluation and the export; the
    strip is read back. The RGB photo as a CMYK JPEG goes through the
    demo's loader (`cmyk_photo_check`). Returns the photos, the
    checkpoint and each run's strip."""
    started = time.perf_counter()
    work = os.path.join(os.path.dirname(assets['root']), 'demo')
    os.makedirs(work)
    photos = manual_photo(assets, work)
    cmyk = cmyk_photo_check(photos['rgb'], work)
    gan_path = os.path.join(work, 'gan.pth')
    checkpoint.save(move_surface_into_box(checkpoint.load(assets['gan'])),
                    gan_path)
    calls = []
    originals = (inv.run_inversion, pipeline.evaluate_checkpoint,
                 cli_inversion.export_demo)
    inv.run_inversion = counted_calls(calls, 'steps', originals[0])
    pipeline.evaluate_checkpoint = counted_calls(calls, 'evaluation',
                                                 originals[1])
    cli_inversion.export_demo = counted_calls(calls, 'export', originals[2])
    cwd = os.getcwd()
    runs = {}
    try:
        os.chdir(work)
        for kind in ('rgba', 'rgb'):
            calls.clear()
            reset_counts()
            t0 = time.perf_counter()
            out = cli_run.main(
                ['--dataset', 'p3d_car', '--inv_manual_input_path',
                 photos[kind], '--resume_from', gan_path,
                 '--coord_resume_from', assets['encoder'], '--root_path',
                 assets['root'], '--data_path', assets['data']])
            wall_s = time.perf_counter() - t0
            strip = image_io.read_png(os.path.join(work, out['demo_path']))
            os.rename(os.path.join(work, out['demo_path']),
                      os.path.join(work, f'{kind}.png'))
            runs[kind] = {'wall_s': wall_s, 'calls': list(calls),
                          'total': counts(), 'out': out, 'strip': strip}
    finally:
        os.chdir(cwd)
        (inv.run_inversion, pipeline.evaluate_checkpoint,
         cli_inversion.export_demo) = originals

    summary = {}
    for kind, run in runs.items():
        kinds = [c[0] for c in run['calls']]
        if kinds != ['evaluation', 'steps', 'evaluation', 'export']:
            raise AssertionError(f'demo {kind} calls: {kinds}')
        want = {'steps': CLI_STEP_LAUNCHES, 'evaluation': DEMO_EVAL_LAUNCHES,
                'export': DEMO_EXPORT_LAUNCHES}
        for what, _, launched in run['calls']:
            expect_launches(f'demo {kind} {what}', launched, **want[what])
        total = {name: sum(c[2][name] for c in run['calls'])
                 for name in run['total']}
        if total != run['total']:
            raise AssertionError(f'demo launches {run["total"]}, per call '
                                 f'{total}')
        strip = run['strip']
        if strip.shape != (RES, DEMO_PANELS * RES, 3) or strip.dtype != \
                np.uint8:
            raise AssertionError(f'demo {kind} strip {strip.shape} '
                                 f'{strip.dtype}')
        panels = strip.reshape(RES, DEMO_PANELS, RES, 3).std(axis=(0, 2, 3))
        if not np.all(np.isfinite(panels)) or min(panels) == 0:
            raise AssertionError(f'demo {kind} panels flat: {panels}')
        batches = run['out']['batches']
        if [b['images'] for b in batches] != [1]:
            raise AssertionError(f'demo {kind} batches {batches}')
        summary[kind] = {
            'wall_s': run['wall_s'], 'demo_s': run['out']['demo_s'],
            'batch': batches[0],
            'launches': {c[0] + ('_0' if i == 0 else '') if c[0] ==
                         'evaluation' else c[0]: c[2]
                         for i, c in enumerate(run['calls'])},
            'ms_by_call': [(c[0], c[1]) for c in run['calls']],
            'strip_shape': strip.shape,
            'panel_std': panels.tolist()}
    emit('demo', started, runs=summary, cmyk_photo=cmyk)
    return {'photos': photos, 'gan_path': gan_path,
            'strips': {kind: run['strip'] for kind, run in runs.items()}}


def dataset_gan_checkpoint(dataset: str, path: str, flags=(),
                           iteration: int = TRAIN_ITERATION,
                           num_classes=None) -> gan.GANConfig:
    """A reference-format GAN checkpoint of the full-width generator and
    discriminators in `dataset`'s CLI configuration with `flags`, from
    seeds, at `iteration`, its noise strengths and the view-direction
    mapper's output layer drawn away from their zero start. Returns the
    config."""
    args = port_config.parse_args(['--dataset', dataset, *flags])
    port_config.override_default_args(args)
    cfg = cli_run.make_gan_config(args, port_config.get_dataset_config(
        dataset), num_classes)
    state = gan.init_train_state(cfg, device='cpu', seed=0)
    draws = torch.Generator().manual_seed(13)
    with torch.no_grad():
        for name, p in state.gen.named_parameters():
            if name.endswith('noise_strength') and cfg.use_stylegan_noise:
                p.copy_(torch.randn((), generator=draws) * 0.1)
        if cfg.use_viewdir:
            out = state.gen.viewdir_mapper.output.weight
            out.copy_(torch.randn(out.shape, generator=draws))
    state.gen_ema.load_state_dict(state.gen.state_dict())
    state.iteration = iteration
    checkpoint.save(move_surface_into_box(checkpoint.gan_checkpoint(state)),
                    path)
    return cfg


def dataset_step_check(what: str, gan_path: str, lpips: LPIPS,
                       scene_range: float, stylegan_noise: bool,
                       scale: Optional[float] = None) -> dict:
    """One inversion step in a dataset's geometry (`scene_range` the box,
    p3d_car's black background and flipped camera; with `scale` cub's
    orthographic camera of that scale s and no z0, else a perspective
    camera at z0 = log 2; the float32 generator, with StyleGAN noise as
    `stylegan_noise` says, as the CLI inverts) through B1, B2 and B3
    against the same step through the plain versions (the planes rounded
    to bf16 at the same boundary), with the same injected per-layer noise
    and crops: the loss within STEP_LOSS_RTOL, the gradients of z and R
    within STEP_GRAD_RTOL; the step's ms."""
    dev = torch.device('cuda')
    gen = Generator(dtype=torch.float32, device=dev, seed=0,
                    use_stylegan_noise=stylegan_noise,
                    **dict(GEN_KWARGS, scene_range=scene_range))
    convert.load_reference_state_dict(gen, checkpoint.load(gan_path)[
        'model_ema'])
    gen.eval()
    cfg = dataclasses.replace(INV_CFG, scene_range=scene_range)
    rng = np.random.default_rng(14)

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def latent():
        z = tensor(rng.standard_normal((BATCH, GEN_KWARGS['latent_dim'])))
        with torch.no_grad():
            return gen.map(z) / cfg.lr_gain_z

    quat = rng.standard_normal((BATCH, 4)) * 0.3 + [1.0, 0.0, 0.0, 0.0]
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    z0 = None if scale is not None else tensor(np.full(BATCH, np.log(2.0)))
    target_params = inv.InversionParams(
        z=latent(), R=tensor(quat),
        s=tensor(np.full(BATCH, 1.0 if scale is None else scale)),
        t2=tensor(rng.uniform(-0.05, 0.05, (BATCH, 2))), z0=z0)
    with torch.no_grad():
        target_out = inv.render_from_params(gen, target_params, cfg)[0]
    target, target_mask = target_out.rgb, target_out.mask
    if float(target_mask.max()) < 0.3:
        raise AssertionError(f'{what} step: the target sees no surface')
    init = inv.InversionParams(
        z=latent(), R=target_params.R, s=target_params.s * 1.05,
        t2=target_params.t2 + 0.02, z0=None if z0 is None else z0 + 0.1)
    noise = (gen.synthesis_network.noise_values(
        BATCH, torch.Generator(device=dev).manual_seed(15), dev)
        if stylegan_noise else None)
    tform = augment.sample_transform(
        torch.Generator(device=dev).manual_seed(16),
        BATCH * cfg.num_augmentations, 1.0)

    plain = plain_bf16_rounded

    step = inv.make_inversion_step(gen, lpips, cfg)
    plain_step = inv.make_inversion_step(gen, lpips, cfg, sampler=plain,
                                         warp=warp.warp_plain)

    def loss_and_grads(step_fn):
        p = init.copy(requires_grad=True)
        m = step_fn(p, inv.make_optimizer(p, cfg), target, tform=tform,
                    noise=noise)
        return float(m['loss']), p.z.grad, p.R.grad

    reset_counts()
    k_loss, k_gz, k_gr = loss_and_grads(step)
    launches = counts()
    expect_launches(f'{what} step', launches,
                    **{triplane_cuda.KERNEL: 2, triplane_cuda.GRAD_KERNEL: 2,
                       'warp_forward': 2, 'warp_backward': 1})
    p_loss, p_gz, p_gr = loss_and_grads(plain_step)
    loss_err = abs(k_loss - p_loss) / abs(p_loss)
    gz_err = float((k_gz - p_gz).norm() / p_gz.norm())
    gr_err = float((k_gr - p_gr).norm() / p_gr.norm())
    if (loss_err > STEP_LOSS_RTOL or gz_err > STEP_GRAD_RTOL or
            gr_err > STEP_GRAD_RTOL):
        raise AssertionError(f'{what} step with the kernels differs from '
                             f'the plain step: loss {loss_err}, grad z '
                             f'{gz_err}, grad R {gr_err}')
    params = init.copy(requires_grad=True)
    optimizer = inv.make_optimizer(params, cfg)
    step_ms = time_cuda(lambda: step(params, optimizer, target, tform=tform,
                                     noise=noise), 3, warmup=1)
    del gen
    torch.cuda.empty_cache()
    return {'launches': launches, 'step_ms': step_ms,
            'loss_kernels': k_loss, 'loss_plain': p_loss,
            'loss_rel_err': loss_err, 'grad_z_rel_err': gz_err,
            'grad_R_rel_err': gr_err, 'loss_rtol': STEP_LOSS_RTOL,
            'grad_rtol': STEP_GRAD_RTOL,
            'target_mask_mean': float(target_mask.mean())}


def datasets_phase(assets: dict, lpips: LPIPS) -> None:
    """cub and carla through both CLIs at full width: each fixture (8
    images) runs the inversion CLI (one batch of 8, 30 steps, evaluations
    at 0 and 30; no Inception file) and the training CLI resumed from a
    reference-format checkpoint at iteration 12,500 for one G step and one
    D step at batch 32 (no pretraining). Launches are counted around every
    step and evaluation: carla's evaluations run B1 (the view-direction
    generator decodes unfused), cub's B5a. Then cub's inversion step and
    carla's G step against the plain versions."""
    started = time.perf_counter()
    base = os.path.join(os.path.dirname(assets['root']), 'datasets')
    weights_dir = os.path.join(base, 'weights')
    os.makedirs(weights_dir)
    for name in weights.LPIPS_FILES:  # no Inception file: FID off
        os.symlink(os.path.join(assets['root'], 'weights', name),
                   os.path.join(weights_dir, name))
    calls = []
    originals = (inv.run_inversion, pipeline.evaluate_checkpoint,
                 gan.g_step, gan.d_step, pretrain.pretrain_sdf,
                 loop.train_gan)

    for module, name, kind, fn in zip(
            (inv, pipeline, gan, gan, pretrain),
            ('run_inversion', 'evaluate_checkpoint', 'g_step', 'd_step',
             'pretrain_sdf'),
            ('steps', 'evaluation', 'g', 'd', 'pretrain'), originals):
        setattr(module, name, counted_calls(calls, kind, fn))

    def train_gan(state, cfg, split, num_iters, **kwargs):
        # cub's overrides set --iterations to 200,000 (as the JAX CLI's
        # do): the loop stops two iterations after the resume.
        return originals[5](state, cfg, split, TRAIN_ITERATION + 2,
                            **kwargs)

    loop.train_gan = train_gan
    results = {}
    try:
        for dataset in ('cub', 'carla'):
            data = os.path.join(base, f'data_{dataset}')
            t = time.perf_counter()
            if dataset == 'cub':
                fixtures.write_cub(data, DATASET_IMAGES, DATASET_IMAGES,
                                   DATASET_IMAGE_HW['cub'], seed=21)
            else:
                fixtures.write_carla(data, DATASET_IMAGES,
                                     DATASET_IMAGE_HW['carla'][0], seed=22)
            gan_path = os.path.join(base, f'gan_{dataset}.pth')
            cfg = dataset_gan_checkpoint(dataset, gan_path)
            assets_s = time.perf_counter() - t
            runs = {}
            for mode, extra in (
                    ('inversion', ['--run_inversion', '--coord_resume_from',
                                   assets['encoder']]),
                    ('training', [])):
                calls.clear()
                reset_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = cli_run.main(['--dataset', dataset, '--resume_from',
                                    gan_path, '--root_path', base,
                                    '--data_path', data] + extra)
                torch.cuda.synchronize()
                runs[mode] = {'wall_s': time.perf_counter() - t0,
                              'peak_gb': torch.cuda.max_memory_allocated()
                              / 1e9, 'calls': list(calls),
                              'total': counts(), 'out': out}
                torch.cuda.empty_cache()
            results[dataset] = {'cfg': cfg, 'runs': runs,
                                'assets_s': assets_s, 'data': data}
    finally:
        (inv.run_inversion, pipeline.evaluate_checkpoint, gan.g_step,
         gan.d_step, pretrain.pretrain_sdf, loop.train_gan) = originals

    summary = {}
    for dataset, res in results.items():
        runs = res['runs']
        want = {'steps': CLI_STEP_LAUNCHES,
                'evaluation': DATASET_EVAL_LAUNCHES[dataset],
                'g': DATASET_G, 'd': DATASET_D}
        kinds = {'inversion': ['evaluation', 'steps', 'evaluation'],
                 'training': ['g', 'd']}
        for mode, run in runs.items():
            got = [c[0] for c in run['calls']]
            if got != kinds[mode]:
                raise AssertionError(f'{dataset} {mode} calls: {got}')
            for what, _, launched in run['calls']:
                expect_launches(f'{dataset} {mode} {what}', launched,
                                **want[what])
            total = {name: sum(c[2][name] for c in run['calls'])
                     for name in run['total']}
            if total != run['total']:
                raise AssertionError(f'{dataset} {mode} launches '
                                     f'{run["total"]}, per call {total}')
        inversion, training = runs['inversion']['out'], runs['training'][
            'out']
        report = inversion['report']
        for step in (0, CLI_STEPS):
            for key in ('ws', 'R', 's', 't2', 'psnr', 'ssim', 'lpips'):
                arr = np.asarray(report[step][key])
                if arr.shape[0] != DATASET_IMAGES or not np.all(
                        np.isfinite(arr)):
                    raise AssertionError(f'{dataset} report {step}/{key}: '
                                         f'{arr.shape}')
            if ('z0' in report[step]) != (dataset != 'cub'):
                raise AssertionError(f'{dataset}: z0 in the report '
                                     f'{"z0" in report[step]}')
        state = training['state']
        if state.iteration != TRAIN_ITERATION + 2 or training['pretrained']:
            raise AssertionError(f'{dataset} training: iteration '
                                 f'{state.iteration}, pretrained '
                                 f'{training["pretrained"]}')
        if (state.gen.use_stylegan_noise != (dataset == 'cub') or
                state.gen.use_viewdir != (dataset == 'carla')):
            raise AssertionError(f'{dataset}: the generator\'s features')
        step_ms = {kind: [c[1] for c in runs[mode]['calls'] if c[0] == kind]
                   for mode, kinds_ in (('inversion', ('steps',
                                                       'evaluation')),
                                        ('training', ('g', 'd')))
                   for kind in kinds_}
        summary[dataset] = {
            'assets_s': res['assets_s'],
            'config': {k: v for k, v in dataclasses.asdict(res['cfg']).items()
                       if k in ('scene_range', 'white_background',
                                'camera_flipped', 'supervise_alpha',
                                'use_viewdir', 'use_stylegan_noise',
                                'batch_size', 'resolution')},
            'inversion_wall_s': runs['inversion']['wall_s'],
            'inversion_batch': inversion['batches'][0],
            'steps_ms_per_step': step_ms['steps'][0] / CLI_STEPS,
            'evaluation_ms': step_ms['evaluation'],
            'training_wall_s': runs['training']['wall_s'],
            'g_ms': step_ms['g'], 'd_ms': step_ms['d'],
            'peak_gb': {m: runs[m]['peak_gb'] for m in runs},
            'launches': {m: [(c[0], c[2]) for c in runs[m]['calls']]
                         for m in runs},
            'report_means': {step: {k: float(np.mean(report[step][k]))
                                    for k in ('psnr', 'ssim', 'lpips')}
                             for step in (0, CLI_STEPS)}}

    summary['cub']['step_check'] = dataset_step_check(
        'cub', os.path.join(base, 'gan_cub.pth'), lpips, 2.0, True,
        CUB_SCALE)
    carla = results['carla']
    args = port_config.parse_args(['--dataset', 'carla', '--data_path',
                                   carla['data']])
    train_split = loaders.load_dataset(args)[1]
    summary['carla']['g_step_check'] = gan_step_check(
        'carla', carla['runs']['training']['out']['state'], carla['cfg'],
        train_split, FLAG_BATCHES, DATASET_G)
    emit('datasets', started, images=DATASET_IMAGES,
         image_hw=DATASET_IMAGE_HW, **summary)
    return {dataset: res['data'] for dataset, res in results.items()}


def families_phase(assets: dict, lpips: LPIPS) -> None:
    """shapenet_cars and imagenet_car through both CLIs at full width
    (FAMILY_DATASETS): the inversion CLI (one batch of 8, 30 steps,
    evaluations at 0 and 30, no Inception file) and the training CLI
    resumed from a reference-format checkpoint at iteration 12,500 for
    one G step and one D step at batch 32. Launches are counted around
    every step and evaluation; every report row must be finite, ShapeNet's
    report must hold the novel views and no IoU and its pose must leave
    the 30 steps unchanged. Then imagenet_car's inversion step and
    shapenet_cars' G step (its principal point in every batch) against
    the plain versions. Prints each dataset's seconds and peak memory."""
    started = time.perf_counter()
    base = os.path.join(os.path.dirname(assets['root']), 'families')
    weights_dir = os.path.join(base, 'weights')
    os.makedirs(weights_dir)
    for name in weights.LPIPS_FILES:  # no Inception file: FID off
        os.symlink(os.path.join(assets['root'], 'weights', name),
                   os.path.join(weights_dir, name))
    calls = []
    originals = (inv.run_inversion, pipeline.evaluate_checkpoint,
                 gan.g_step, gan.d_step, pretrain.pretrain_sdf,
                 loop.train_gan)
    for module, name, kind, fn in zip(
            (inv, pipeline, gan, gan, pretrain),
            ('run_inversion', 'evaluate_checkpoint', 'g_step', 'd_step',
             'pretrain_sdf'),
            ('steps', 'evaluation', 'g', 'd', 'pretrain'), originals):
        setattr(module, name, counted_calls(calls, kind, fn))
    loop.train_gan = lambda state, cfg, split, num_iters, **kwargs: (
        originals[5](state, cfg, split, TRAIN_ITERATION + 2, **kwargs))
    results = {}
    try:
        for seed, dataset in enumerate(FAMILY_DATASETS):
            data = os.path.join(base, f'data_{dataset}')
            t = time.perf_counter()
            if dataset == 'shapenet_cars':
                fixtures.write_shapenet(data, 'cars', 1, 1, DATASET_IMAGES,
                                        DATASET_IMAGES,
                                        FAMILY_IMAGE_HW[dataset],
                                        seed=23 + seed)
            else:
                fixtures.write_imagenet(data, dataset, DATASET_IMAGES,
                                        FAMILY_IMAGE_HW[dataset],
                                        seed=23 + seed)
            gan_path = os.path.join(base, f'gan_{dataset}.pth')
            cfg = dataset_gan_checkpoint(dataset, gan_path)
            runs = {'assets_s': time.perf_counter() - t}
            for mode, extra in (
                    ('inversion', ['--run_inversion', '--coord_resume_from',
                                   assets['encoder']]),
                    ('training', [])):
                calls.clear()
                reset_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = cli_run.main(['--dataset', dataset, '--resume_from',
                                    gan_path, '--root_path', base,
                                    '--data_path', data] + extra)
                torch.cuda.synchronize()
                runs[mode] = {'wall_s': time.perf_counter() - t0,
                              'peak_gb': torch.cuda.max_memory_allocated()
                              / 1e9, 'calls': list(calls),
                              'total': counts(), 'out': out}
                torch.cuda.empty_cache()
            results[dataset] = {'cfg': cfg, 'runs': runs, 'data': data}
    finally:
        (inv.run_inversion, pipeline.evaluate_checkpoint, gan.g_step,
         gan.d_step, pretrain.pretrain_sdf, loop.train_gan) = originals

    want = {'steps': CLI_STEP_LAUNCHES, 'evaluation': FAMILY_EVAL_LAUNCHES,
            'g': DATASET_G, 'd': DATASET_D}
    kinds = {'inversion': ['evaluation', 'steps', 'evaluation'],
             'training': ['g', 'd']}
    summary = {}
    for dataset, res in results.items():
        runs = res['runs']
        for mode in kinds:
            run = runs[mode]
            got = [c[0] for c in run['calls']]
            if got != kinds[mode]:
                raise AssertionError(f'{dataset} {mode} calls: {got}')
            for what, _, launched in run['calls']:
                expect_launches(f'{dataset} {mode} {what}', launched,
                                **want[what])
            total = {name: sum(c[2][name] for c in run['calls'])
                     for name in run['total']}
            if total != run['total']:
                raise AssertionError(f'{dataset} {mode} launches '
                                     f'{run["total"]}, per call {total}')
        report = runs['inversion']['out']['report']
        shapenet = dataset.startswith('shapenet')
        keys = ['ws', 'R', 's', 't2', 'z0', 'psnr', 'ssim', 'lpips']
        keys += (['psnr_random', 'ssim_random', 'lpips_random'] if shapenet
                 else ['iou'])
        for step in (0, CLI_STEPS):
            for key in keys:
                arr = np.asarray(report[step][key])
                if arr.shape[0] != DATASET_IMAGES or not np.all(
                        np.isfinite(arr)):
                    raise AssertionError(f'{dataset} report {step}/{key}: '
                                         f'{arr.shape}')
            if ('iou' in report[step]) == shapenet:
                raise AssertionError(f'{dataset}: iou in the report '
                                     f'{"iou" in report[step]}')
        pose_moved = {key: float(np.abs(np.asarray(report[CLI_STEPS][key]) -
                                        np.asarray(report[0][key])).max())
                      for key in FAMILY_POSE}
        # Each step renormalizes the quaternion R (as JAX's does), which
        # moves it by up to a float32 place; s, t2 and z0 stay as they are.
        if shapenet and (pose_moved['R'] > FAMILY_R_PROJECT_ATOL or any(
                pose_moved[k] for k in FAMILY_POSE if k != 'R')):
            raise AssertionError(f'{dataset}: the frozen pose moved '
                                 f'{pose_moved}')
        state = runs['training']['out']['state']
        if (state.iteration != TRAIN_ITERATION + 2 or
                runs['training']['out']['pretrained']):
            raise AssertionError(f'{dataset} training: iteration '
                                 f'{state.iteration}')
        step_ms = {kind: [c[1] for c in runs[mode]['calls'] if c[0] == kind]
                   for mode in kinds for kind in set(kinds[mode])}
        summary[dataset] = {
            'assets_s': runs['assets_s'],
            'config': {k: v for k, v in dataclasses.asdict(res['cfg']).items()
                       if k in ('scene_range', 'white_background',
                                'camera_flipped', 'supervise_alpha',
                                'is_highres', 'augment_p_max', 'batch_size',
                                'resolution')},
            'inversion_wall_s': runs['inversion']['wall_s'],
            'inversion_batch': runs['inversion']['out']['batches'][0],
            'steps_ms_per_step': step_ms['steps'][0] / CLI_STEPS,
            'evaluation_ms': step_ms['evaluation'],
            'training_wall_s': runs['training']['wall_s'],
            'g_ms': step_ms['g'], 'd_ms': step_ms['d'],
            'peak_gb': {m: runs[m]['peak_gb'] for m in kinds},
            'launches': {m: [(c[0], c[2]) for c in runs[m]['calls']]
                         for m in kinds},
            'pose_moved': pose_moved,
            'report_means': {step: {k: float(np.mean(report[step][k]))
                                    for k in keys[5:]}
                             for step in (0, CLI_STEPS)}}

    summary['imagenet_car']['step_check'] = dataset_step_check(
        'imagenet_car', os.path.join(base, 'gan_imagenet_car.pth'), lpips,
        1.4, False)
    shapenet = results['shapenet_cars']
    args = port_config.parse_args(['--dataset', 'shapenet_cars',
                                   '--data_path', shapenet['data']])
    train_split = loaders.load_dataset(args)[1]
    summary['shapenet_cars']['g_step_check'] = gan_step_check(
        'shapenet_cars', shapenet['runs']['training']['out']['state'],
        shapenet['cfg'], train_split, FLAG_BATCHES, DATASET_G)
    emit('families', started, images=DATASET_IMAGES,
         image_hw=FAMILY_IMAGE_HW, **summary)


def step_batches(state: gan.GANTrainState, cfg: gan.GANConfig,
                 split, seed: int, b: int) -> dict:
    """G's batch and second poses, D's real, fake, second real and second
    fake batches of `b` of the split's views (with their principal
    points where the split has them), every draw injected (the path
    length's noise too), for the step checks."""
    dev = torch.device('cuda')
    gen_t = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    res, s, n = cfg.resolution, cfg.depth_samples_per_ray, 31

    def views(latent):
        idx = rng.integers(0, len(split.images), b)
        out = {'pose': torch.from_numpy(np.ascontiguousarray(
            split.tform_cam2world[idx], np.float32)).to(dev),
            'image': torch.from_numpy(np.ascontiguousarray(
                split.images[idx], np.float32)).to(dev),
            'aug_tform': augment.sample_transform(gen_t, b, 0.5)}
        for key, name in (('focal', 'focal_length'), ('center', 'center')):
            if getattr(split, name) is not None:
                out[key] = torch.from_numpy(np.ascontiguousarray(
                    getattr(split, name)[idx], np.float32)).to(dev)
        if latent:
            out['z'] = torch.randn((b, cfg.latent_dim), generator=gen_t,
                                   device=dev)
            out['noise'] = {
                'depth': torch.rand((b, res, res, s), generator=gen_t,
                                    device=dev),
                'pdf_u': torch.rand((b * res * res, s), generator=gen_t,
                                    device=dev)}
        return out

    g = views(True)
    r = cfg.plane_resolution
    g['noise'].update(
        strata=torch.rand((b, n, n, n, 3), generator=gen_t, device=dev),
        perturb=torch.randn((b, n ** 3, 3), generator=gen_t, device=dev),
        ppl_planes=torch.randn((b, 96, r, r), generator=gen_t, device=dev),
        ppl_attn=torch.randn((b, max(cfg.attention_values, 1), 3),
                             generator=gen_t, device=dev))
    if state.gen.use_stylegan_noise:
        g['noise']['sg_noise'] = state.gen.synthesis_network.noise_values(
            b, gen_t, dev)
    return {'g': g, 'g2': views(True), 'real': views(False),
            'fake': views(True), 'real2': views(False), 'fake2': views(True)}


# Wrong kernels for the step checks' control: the plain sampler with each
# plane's two axes swapped, and one that writes nothing (zeros).
WRONG_SAMPLERS = {
    'axes_swapped': lambda planes_cl, coords: triplane.plain_sampler(
        planes_cl.transpose(2, 3).contiguous(), coords),
    'zeros': lambda planes_cl, coords: triplane.plain_sampler(
        planes_cl * 0, coords),
}


def plain_bf16_rounded(planes_cl: torch.Tensor,
                       coords: torch.Tensor) -> torch.Tensor:
    """The plain sampler on the planes rounded to bf16, its output rounded
    to bf16, as `triplane_cuda.sample_bf16_planes` rounds the kernels'."""
    return triplane_cuda.sample_bf16_planes(
        planes_cl, coords, triplane.sample_triplane_plain,
        triplane.sample_triplane_grad_plain,
        triplane.sample_triplane_grad_planes_plain)


def _sample_reordered(planes_cl: torch.Tensor,
                      coords: torch.Tensor) -> torch.Tensor:
    """`triplane.sample_triplane_plain` with its 12 weighted taps summed
    one by one in reverse order: the same function in float32, rounded to
    the planes' dtype at the end, differing only in summation order."""
    b, _, _, _, c = planes_cl.shape
    n = coords.shape[1]
    table = planes_cl.reshape(-1, c)
    out = torch.empty((b, n, c), dtype=planes_cl.dtype,
                      device=planes_cl.device)
    for start in range(0, n, triplane.CHUNK_POINTS):
        pts = coords[:, start:start + triplane.CHUNK_POINTS]
        rows, weights = triplane.tap_offsets(planes_cl, pts)
        taps = table.index_select(0, rows.reshape(-1)).float().reshape(
            rows.shape + (c,)) * weights[..., None]
        acc = taps[:, :, 2, 3]
        for p, t in reversed([(p, t) for p in range(3) for t in range(4)]
                             [:-1]):
            acc = acc + taps[:, :, p, t]
        out[:, start:start + triplane.CHUNK_POINTS] = (acc / 3.0).to(
            out.dtype)
    return out


def plain_reordered(planes_cl: torch.Tensor,
                    coords: torch.Tensor) -> torch.Tensor:
    """A control for the step checks: the plain sampler with another
    summation order (forward), its backward the plain one's."""
    return triplane.TriplaneSample.apply(
        planes_cl, coords, _sample_reordered,
        triplane.sample_triplane_grad_plain,
        triplane.sample_triplane_grad_planes_plain)


# Readings beside each GAN step check's: how far samplers that differ from
# the plain one only in rounding part from it (ROADMAP C's D-step gap).
CONTROL_SAMPLERS = {'bf16_rounded_plain': plain_bf16_rounded,
                    'reordered_plain': plain_reordered}


def _tensor_gap(a: torch.Tensor, b: torch.Tensor) -> dict:
    """How far `a` parts from `b`: the share of entries that differ, the
    largest difference, the relative L2 distance and, for bf16 tensors,
    the largest difference in units of b's last place."""
    bf16 = b.dtype == torch.bfloat16
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    out = {'share_differ': float((diff > 0).float().mean()),
           'max_abs': float(diff.max()),
           'rel_l2': float(diff.norm() / b.norm().clamp_min(1e-30))}
    if bf16:
        # bf16 keeps 8 significant bits: one place of the larger of the
        # two values is 2^(e - 7).
        place = torch.exp2(torch.floor(torch.log2(torch.maximum(
            a.abs(), b.abs()).clamp_min(1e-30))) - 7)
        out['max_places'] = float((diff / place).max())
    return out


def d_step_bisect(state: gan.GANTrainState, cfg: gan.GANConfig,
                  batches: dict) -> dict:
    """The D step's fake render (D1's, without a graph), through the
    kernels, the plain sampler and the controls, with every tensor on its
    way to D recorded: the sampler's features (each pass), the decoded
    SDF, sigma and D's input (the composite and its mask). For each
    sampler, how far each tensor parts from the plain sampler's; the
    first tensor in that order that parts is where the gap starts."""
    gen = state.gen
    samplers = {'kernels': triplane_cuda.sample_triplane,
                'plain': triplane.plain_sampler, **CONTROL_SAMPLERS}
    order = ('features', 'sdf', 'sigma', 'd_input')
    records = {}
    original_sigma = gen.sdf_to_sigma
    for name, sampler in samplers.items():
        rec = {k: [] for k in order}

        def recording_sampler(planes_cl, coords, sampler=sampler, rec=rec):
            out = sampler(planes_cl, coords)
            rec['features'].append(out.detach())
            return out

        def recording_sigma(density_or_distance, out_of_bounds_mask,
                            rec=rec):
            rec['sdf'].append(density_or_distance[..., -1].detach())
            sigma = original_sigma(density_or_distance, out_of_bounds_mask)
            rec['sigma'].append(sigma.detach())
            return sigma

        gen.sdf_to_sigma = recording_sigma
        try:
            with torch.no_grad():
                img = gan._render_fake(state, batches['fake'], cfg,
                                       recording_sampler, True)[0]
        finally:
            del gen.sdf_to_sigma
        rec['d_input'].append(img.detach())
        records[name] = rec
    out = {}
    for name in samplers:
        if name == 'plain':
            continue
        gaps = {}
        for key in order:
            pairs = list(zip(records[name][key], records['plain'][key]))
            gaps[key] = [_tensor_gap(a, b) for a, b in pairs]
        first = next((k for k in order
                      if any(g['share_differ'] > 0 for g in gaps[k])), None)
        out[name] = {'first_to_part': first, **gaps}
    feats = records['kernels']['features'][0]
    out['features_dtype'] = str(feats.dtype)
    del records
    torch.cuda.empty_cache()
    return out


def gan_step_check(what: str, state: gan.GANTrainState, cfg: gan.GANConfig,
                   split, batches_to_try, g_launches: dict,
                   d_launches=None) -> dict:
    """The G step (both renders under dual D, and the path length's own
    backward under PPL) and, with `d_launches`, the D step (both
    discriminators, R1) of a CLI run's state through the kernels against
    the same steps on the plain sampler, with the same injected draws of
    the split's views, at the first batch of `batches_to_try` at which
    the plain steps fit: each loss within STEP_LOSS_RTOL, the gradient
    norm and the last synthesis layer's (D: the last discriminator's
    first layer's) gradient within STEP_GRAD_RTOL, that layer's gradient
    of the terms that see the kernels' output alone within
    STEP_TERMS_RTOL. The check's render must see a surface (mask max
    0.3), and each wrong kernel (WRONG_SAMPLERS) must fail the check;
    beside each reading, the same errors between two runs of the kernels'
    step (the noise floor) and of each wrong kernel."""
    g_params = list(state.gen.parameters())
    last_layer = getattr(state.gen.synthesis_network,
                         f'b{cfg.plane_resolution}').torgb.weight
    g_last = [p is last_layer for p in g_params].index(True)
    d_params = [p for params, _, _ in gan.discriminator_params(state)
                for p in params]
    d_layer = len(d_params) - len(list(
        (state.disc2 if state.disc2 is not None else state.disc).parameters()))

    def norm(grads):
        return float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads
             if g is not None])))

    def g_step(batches, sampler):
        g = batches['g']
        sg_noise = g['noise'].get('sg_noise')
        loss, metrics = gan.generator_loss(
            state, g, cfg, sampler,
            batches['g2'] if cfg.dual_discriminator else None, sg_noise)
        terms = metrics['loss_g']
        if cfg.dual_discriminator:
            terms = (terms + metrics['loss_g_uncond']) / 2.0
        grads = torch.autograd.grad(loss, g_params, allow_unused=True,
                                    retain_graph=True)
        launches = counts()
        # A second backward of the renders: its launches are the check's.
        terms_grad, = torch.autograd.grad(terms, last_layer)
        loss = float(loss.detach())
        if cfg.path_length_regularization:
            weighted, _, _ = gan.path_length_loss(state, g, cfg, sg_noise)
            ppl = torch.autograd.grad(weighted, g_params, allow_unused=True)
            grads = [a if b is None else b if a is None else a + b
                     for a, b in zip(grads, ppl)]
            loss += float(weighted.detach())
        return (loss, norm(grads), grads[g_last], float(terms.detach()),
                terms_grad), launches

    def d_step(batches, sampler):
        # An odd iteration: the D step with R1, as the loop runs it.
        state.iteration += 1
        try:
            total, metrics = gan.discriminator_loss(
                state, batches['real'], batches['fake'], cfg, sampler,
                batches['real2'], batches['fake2'])
        finally:
            state.iteration -= 1
        terms = sum(v for k, v in metrics.items()
                    if k.startswith('loss_d_fake'))
        grads = torch.autograd.grad(total, d_params, allow_unused=True,
                                    retain_graph=True)
        launches = counts()
        terms_grad, = torch.autograd.grad(terms, d_params[d_layer])
        return (float(total.detach()), norm(grads), grads[d_layer],
                float(terms.detach()), terms_grad), launches

    def rel(a, b):
        return float((a - b).float().norm() / b.float().norm())

    def errors(a, b):
        # The step's whole loss and gradients, and (render_terms) the
        # terms that see the kernels' output alone: G's adversarial or
        # reconstruction loss, D's fake losses.
        return {'loss_rel_err': abs(a[0] - b[0]) / abs(b[0]),
                'grad_norm_rel_err': abs(a[1] - b[1]) / b[1],
                'layer_grad_rel_err': rel(a[2], b[2]),
                'render_terms': {
                    'loss_rel_err': abs(a[3] - b[3]) / abs(b[3]),
                    'layer_grad_rel_err': rel(a[4], b[4])}}

    def fails(errs):
        return (errs['loss_rel_err'] > STEP_LOSS_RTOL or
                errs['grad_norm_rel_err'] > STEP_GRAD_RTOL or
                errs['layer_grad_rel_err'] > STEP_GRAD_RTOL or
                errs['render_terms']['layer_grad_rel_err'] >
                STEP_TERMS_RTOL)

    steps = [('g_step', g_step, g_launches)]
    if d_launches is not None:
        steps.append(('d_step', d_step, d_launches))
    out_of_memory = {}
    for b in batches_to_try:
        out = {'batch': b, 'out_of_memory': out_of_memory,
               'loss_rtol': STEP_LOSS_RTOL, 'grad_rtol': STEP_GRAD_RTOL}
        batches = step_batches(state, cfg, split, 31, b)
        g = batches['g']
        with torch.no_grad():
            mask = gan.generator_forward(
                state.gen, g['z'], g['pose'], g.get('focal'), cfg,
                state.rng, noise=g['noise'],
                cond=gan.embed_condition(state.gen, cfg, g))[0].mask
        if float(mask.max()) < 0.3:
            raise AssertionError(f'{what}: the render sees no surface')
        out['mask_mean'] = float(mask.mean())
        del mask
        try:
            for name, fn, want in steps:
                reset_counts()
                kernels, launches = fn(batches, triplane_cuda.sample_triplane)
                expect_launches(f'{what} {name}', launches, **want)
                # The same step again: the floor of run-to-run noise.
                repeat = errors(
                    fn(batches, triplane_cuda.sample_triplane)[0], kernels)
                plain = fn(batches, triplane.plain_sampler)[0]
                errs = errors(kernels, plain)
                if fails(errs):
                    raise AssertionError(f'{what} {name} with the kernels '
                                         f'differs from the plain step: '
                                         f'{errs}')
                wrong = {k: errors(fn(batches, sampler)[0], plain)
                         for k, sampler in WRONG_SAMPLERS.items()}
                if not all(map(fails, wrong.values())):
                    raise AssertionError(f'{what} {name}: the check passes '
                                         f'a wrong kernel: {wrong}')
                controls = {}
                for k, sampler in CONTROL_SAMPLERS.items():
                    control = fn(batches, sampler)[0]
                    controls[k] = {'vs_plain': errors(control, plain),
                                   'kernels_vs_it': errors(kernels, control)}
                out[name] = {'launches': launches, 'loss_kernels': kernels[0],
                             'loss_plain': plain[0], **errs,
                             'repeat': repeat, 'wrong_kernels': wrong,
                             'controls': controls}
                del kernels, plain, control
                if name == 'd_step':
                    out[name]['bisect'] = d_step_bisect(state, cfg, batches)
        except torch.cuda.OutOfMemoryError as e:
            out_of_memory[b] = str(e).splitlines()[0]
            del batches
            gc.collect()
            torch.cuda.empty_cache()
            continue
        return out
    raise AssertionError(f'{what}: no batch fits: {out_of_memory}')


def _conv_shapes(name: str, shapes) -> list:
    """The first two input shapes of a 4-d convolution operator, else []."""
    if 'convolution' not in name or len(shapes) < 2:
        return []
    return shapes[:2] if all(len(x) == 4 for x in shapes[:2]) else []


# The path length's backward by operator: the constant resampling filter's
# gradient (both inputs [1, C*B, H, W] at full size), the filter applied to
# each channel (inputs [C*B, 1, H, W]), the other convolutions (the
# modulated ones, their data and weight gradients), the rest.
PPL_OP_GROUPS = {
    'filter_gradient': lambda name, shapes: bool(_conv_shapes(
        name, shapes)) and shapes[0][0] == 1 and shapes[1][0] == 1 and
    shapes[1][-1] > 4,
    'filter_depthwise': lambda name, shapes: bool(_conv_shapes(
        name, shapes)) and shapes[0][1] == 1 and shapes[0][0] > 1,
    'other_convolutions': lambda name, shapes: bool(_conv_shapes(
        name, shapes)) and not (shapes[0][0] == 1 or shapes[0][1] == 1),
}


def ppl_cost(state: gan.GANTrainState, cfg: gan.GANConfig, split,
             batch: int) -> dict:
    """What path-length regularization adds to carla's G step at the
    run's batch: ms (CUDA events, median of 3 after a warm-up) of the
    loss's forward and backward (both renders, B1 and B4) and of the path
    length's own (the synthesis differentiated twice, no kernel), and a
    trace of the latter with its kernel time by PPL_OP_GROUPS."""
    batches = step_batches(state, cfg, split, 33, batch)
    params = list(state.gen.parameters())
    g = batches['g']

    def main():
        loss, _ = gan.generator_loss(state, g, cfg, batch2=batches['g2'])
        torch.autograd.grad(loss, params, allow_unused=True)

    def path_length():
        weighted, _, _ = gan.path_length_loss(state, g, cfg,
                                              g['noise'].get('sg_noise'))
        torch.autograd.grad(weighted, params, allow_unused=True)

    return {'batch': batch, 'loss_ms': time_cuda(main, 3, 1),
            'ppl_ms': time_cuda(path_length, 3, 1),
            'ppl_trace': trace(path_length, PPL_OP_GROUPS)}


def nofine_step_check(gen: Generator, lpips: LPIPS) -> dict:
    """One inversion step at fine_sampling=False, ray_multiplier 4 (one
    pass of 256 stratified samples a ray, no PDF draw) through B1, B2 and
    B3 against the same step on the plain versions: the loss within
    STEP_LOSS_RTOL, the gradients of z and R within STEP_GRAD_RTOL; the
    step's launches and ms."""
    cfg = dataclasses.replace(INV_CFG, fine_sampling=False)
    target, _, gt_cam, init = inversion_problem(gen)
    dev = target.device
    tform = augment.sample_transform(
        torch.Generator(device=dev).manual_seed(32),
        BATCH * cfg.num_augmentations, 1.0)
    step = inv.make_inversion_step(gen, lpips, cfg, gt_cam)
    plain_step = inv.make_inversion_step(gen, lpips, cfg, gt_cam,
                                         sampler=triplane.plain_sampler,
                                         warp=warp.warp_plain)

    def loss_and_grads(step_fn):
        p = init.copy(requires_grad=True)
        m = step_fn(p, inv.make_optimizer(p, cfg), target, tform=tform)
        return float(m['loss']), p.z.grad, p.R.grad

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    k_loss, k_gz, k_gr = loss_and_grads(step)
    launches = counts()
    expect_launches('non-fine inversion step', launches,
                    **{triplane_cuda.KERNEL: 1, triplane_cuda.GRAD_KERNEL: 1,
                       'warp_forward': 2, 'warp_backward': 1})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    p_loss, p_gz, p_gr = loss_and_grads(plain_step)
    errs = {'loss_rel_err': abs(k_loss - p_loss) / abs(p_loss),
            'grad_z_rel_err': float((k_gz - p_gz).norm() / p_gz.norm()),
            'grad_R_rel_err': float((k_gr - p_gr).norm() / p_gr.norm())}
    if (errs['loss_rel_err'] > STEP_LOSS_RTOL or
            errs['grad_z_rel_err'] > STEP_GRAD_RTOL or
            errs['grad_R_rel_err'] > STEP_GRAD_RTOL):
        raise AssertionError(f'non-fine step with the kernels differs from '
                             f'the plain step: {errs}')
    params = init.copy(requires_grad=True)
    optimizer = inv.make_optimizer(params, cfg)
    step_ms = time_cuda(lambda: step(params, optimizer, target, tform=tform),
                        3, warmup=1)
    return {'samples_per_ray': cfg.depth_samples_per_ray *
            cfg.ray_multiplier, 'batch': BATCH, 'launches': launches,
            'step_ms': step_ms, 'peak_gb': peak_gb, 'loss_kernels': k_loss,
            'loss_plain': p_loss, **errs}


def flag_modes_phase(assets: dict, data: dict, rows: dict,
                     gen: Generator, lpips: LPIPS) -> None:
    """GAN training's flag-only modes through `cli.run.main` at full width
    (FLAG_MODES), each resumed from a reference-format checkpoint of its
    configuration at the first batch of FLAG_BATCHES that fits; launches
    and ms (CUDA events) around every G step, D step and evaluation, and
    the peak memory. Then the carla run's G and D steps against the plain
    sampler, and one non-fine inversion step."""
    started = time.perf_counter()
    base = os.path.join(os.path.dirname(assets['root']), 'flag_modes')
    os.makedirs(os.path.join(base, 'weights'))
    for name in weights.LPIPS_FILES:  # no Inception file: a random one
        os.symlink(os.path.join(assets['root'], 'weights', name),
                   os.path.join(base, 'weights', name))
    paths = {'carla': data['carla'], 'cub': data['cub'],
             'p3d_car': assets['data']}
    paths.update({mode: paths[dataset]
                  for mode, (dataset, _) in FLAG_MODES.items()})
    calls = []
    seen = {}
    originals = (gan.g_step, gan.d_step, train_eval.GANEvaluator.evaluate,
                 loop.train_gan)
    gan.g_step = counted_calls(calls, 'g', originals[0])
    gan.d_step = counted_calls(calls, 'd', originals[1])
    train_eval.GANEvaluator.evaluate = counted_calls(calls, 'evaluate',
                                                     originals[2])

    def train_gan(state, cfg, split, num_iters, **kwargs):
        seen['split'] = split
        return originals[3](state, cfg, split,
                            state.iteration + seen['iters'], **kwargs)

    loop.train_gan = train_gan
    results = {}
    try:
        for mode, (dataset, flags) in FLAG_MODES.items():
            args = port_config.parse_args(
                ['--dataset', dataset, '--data_path', paths[mode]] +
                flags)
            port_config.override_default_args(args)
            split = loaders.load_dataset(args)[1]
            t = time.perf_counter()
            gan_path = os.path.join(base, f'gan_{mode}.pth')
            cfg = dataset_gan_checkpoint(dataset, gan_path, flags,
                                         FLAG_RESUME[mode],
                                         split.num_classes)
            assets_s = time.perf_counter() - t
            seen['iters'] = FLAG_ITERS[mode]
            tried = {}
            for batch in FLAG_BATCHES:
                calls.clear()
                reset_counts()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                try:
                    out = cli_run.main(
                        ['--dataset', dataset, '--resume_from', gan_path,
                         '--root_path', base, '--data_path', paths[mode],
                         '--batch_size', str(batch)] + flags)
                except torch.cuda.OutOfMemoryError as e:
                    tried[batch] = (f'out of memory after '
                                    f'{time.perf_counter() - t0:.1f} s: '
                                    f'{str(e).splitlines()[0]}')
                    calls.clear()
                    gc.collect()
                    continue
                torch.cuda.synchronize()
                break
            else:
                raise AssertionError(f'{mode}: no batch fits: {tried}')
            results[mode] = {
                'cfg': cfg, 'batch': batch, 'out_of_memory': tried,
                'wall_s': time.perf_counter() - t0, 'assets_s': assets_s,
                'peak_gb': torch.cuda.max_memory_allocated() / 1e9,
                'calls': list(calls), 'total': counts(), 'out': out,
                'poses_moved': bool(np.any(
                    seen['split'].tform_cam2world != split.tform_cam2world))}
            if mode != 'carla':
                del out
                results[mode]['out'] = None
                torch.cuda.empty_cache()
    finally:
        (gan.g_step, gan.d_step, train_eval.GANEvaluator.evaluate,
         loop.train_gan) = originals

    summary = {}
    for mode, res in results.items():
        renders_g, renders_d = FLAG_RENDERS[mode]
        want = {'g': {triplane_cuda.KERNEL: 2 * renders_g,
                      triplane_cuda.GRAD_PLANES_KERNEL: 2 * renders_g},
                'd': {triplane_cuda.KERNEL: 2 * renders_d},
                'evaluate': FLAG_EVAL}
        kinds = ['g', 'd'] * (FLAG_ITERS[mode] // 2) + (
            ['evaluate'] if mode == 'carla' else [])
        got = [c[0] for c in res['calls']]
        if got != kinds:
            raise AssertionError(f'{mode} flag-mode calls: {got}')
        for what, _, launched in res['calls']:
            expect_launches(f'{mode} {what}', launched, **want[what])
        summary[mode] = {
            'dataset': FLAG_MODES[mode][0], 'flags': FLAG_MODES[mode][1],
            'batch': res['batch'], 'out_of_memory': res['out_of_memory'],
            'resumed_at': FLAG_RESUME[mode], 'assets_s': res['assets_s'],
            'wall_s': res['wall_s'], 'peak_gb': res['peak_gb'],
            'g_ms': [c[1] for c in res['calls'] if c[0] == 'g'],
            'd_ms': [c[1] for c in res['calls'] if c[0] == 'd'],
            'evaluate_ms': [c[1] for c in res['calls']
                            if c[0] == 'evaluate'],
            'launches': [(c[0], c[2]) for c in res['calls']],
            'poses_moved': res['poses_moved']}
    if not summary['p3d_car']['poses_moved'] or any(
            summary[mode]['poses_moved'] for mode in summary
            if mode != 'p3d_car'):
        raise AssertionError('--perturb_poses moved the wrong poses')
    carla = results['carla']['out']
    state = carla['state']
    evaluator = carla['evaluator']
    logged = {(s['tag'], s['step']): s['value'] for s in map(
        json.loads, open(os.path.join(carla['log_dir'], 'scalars.jsonl')))}
    end = FLAG_RESUME['carla'] + FLAG_ITERS['carla'] - 1
    recon = {tag: v for (tag, step), v in logged.items()
             if step == end and tag.startswith('reconstruction/')}
    for tag in ('reconstruction/psnr_front', 'reconstruction/ssim_front',
                'reconstruction/lpips_front', 'reconstruction/fid_frontview',
                'reconstruction/fid_randomview'):
        if not np.isfinite(recon.get(tag, np.nan)):
            raise AssertionError(f'carla evaluation: {tag} {recon.get(tag)}')
    if not state.ppl_running_avg > 0 or state.disc2 is None:
        raise AssertionError('carla: no path length or no second D')
    summary['carla'].update(reconstruction=recon,
                            ppl_running_avg=state.ppl_running_avg,
                            eval_seconds=evaluator.times)
    args = port_config.parse_args(['--dataset', 'carla', '--data_path',
                                   paths['carla']])
    split = loaders.load_dataset(args)[1]
    batch = results['carla']['batch']
    summary['carla']['step_checks'] = gan_step_check(
        'carla flag', state, results['carla']['cfg'], split,
        [b for b in FLAG_BATCHES if b <= batch],
        {triplane_cuda.KERNEL: 4, triplane_cuda.GRAD_PLANES_KERNEL: 4},
        {triplane_cuda.KERNEL: 4})
    summary['carla']['ppl_cost'] = ppl_cost(
        state, results['carla']['cfg'], split, results['carla']['batch'])
    del carla, state, evaluator
    results.clear()
    torch.cuda.empty_cache()
    summary['nofine_inversion_step'] = nofine_step_check(gen, lpips)
    for name in (triplane_cuda.KERNEL, triplane_cuda.GRAD_PLANES_KERNEL,
                 triplane_cuda.GRAD_KERNEL, triplane_cuda.FUSED_KERNEL):
        rows[name]['flag_modes_launches'] = {
            mode: [(k, launched.get(name, 0)) for k, launched in
                   summary[mode]['launches']]
            for mode in FLAG_MODES}
        rows[name]['flag_modes_launches']['nofine_inversion_step'] = \
            summary['nofine_inversion_step']['launches'].get(name, 0)
    emit('flag_modes', started, **summary)


def train_normals_check(gen: Generator, evaluator) -> dict:
    """The evaluation's first batch rendered with normals and semantics
    through the kernels (B1 4, B2 2) and through the plain versions."""
    cfg = evaluator.cfg
    split = evaluator.train_eval_split
    idx = split.eval_indices[:evaluator.eval_bs]
    z = evaluator._tensor(evaluator.z_fid[:len(idx)])
    cams = [evaluator._field(split, idx, name) for name in
            ('tform_cam2world', 'focal_length', 'center', 'bbox')]
    with torch.no_grad():
        state = gen.synthesize(gen.map(z))

        def run(sampler):
            return render(gen.field(state, sampler), cfg.resolution,
                          cfg.resolution, cams[0], cams[1], cfg.scene_range,
                          cfg.white_background, cfg.depth_samples_per_ray,
                          center=cams[2], bbox=cams[3],
                          compute_normals=True, compute_semantics=True)

        reset_counts()
        k_out = run(triplane_cuda.sample_triplane)
        launched = counts()
        p_out = run(triplane.plain_sampler)
    expect_launches('evaluation render with normals', launched,
                    **{triplane_cuda.KERNEL: 4, triplane_cuda.GRAD_KERNEL: 2})
    err = {k: float((getattr(k_out, k).float() - getattr(p_out, k).float())
                    .abs().max()) for k in ('rgb', 'mask', 'semantics')}
    solid = (k_out.mask > 0.5) & (p_out.mask > 0.5)
    err['normals_where_mask_above_half'] = float(
        (k_out.normals - p_out.normals).abs()[solid].max()) if bool(
        solid.any()) else None
    if (max(err['rgb'], err['mask'], err['semantics']) > RENDER_ATOL or
            err['normals_where_mask_above_half'] is None or
            err['normals_where_mask_above_half'] > NORMAL_ATOL):
        raise AssertionError(f'the evaluation render with the kernels '
                             f'differs from the plain render: {err}')
    return {'launches': launched, 'max_abs_err': err,
            'pixels_mask_above_half': int(solid.sum()),
            'atol': RENDER_ATOL, 'normal_atol': NORMAL_ATOL}


def report_files_round_trip(report) -> dict:
    """The unconsolidated report through a report checkpoint in a
    temporary directory: every list back in order, with its index and
    key."""
    key = torch.Generator().manual_seed(27).get_state()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'report_checkpoint.npz')
        pipeline.save_report_checkpoint(path, report, 1, key)
        back = pipeline.make_report(list(report))
        idx, back_key = pipeline.load_report_checkpoint(path, back)
        size = os.path.getsize(path)
    same = idx == 1 and np.array_equal(back_key, key.numpy()) and all(
        len(back[step][k]) == len(v) and all(
            np.array_equal(a, b) for a, b in zip(back[step][k], v))
        for step, entry in report.items() for k, v in entry.items())
    if not same:
        raise AssertionError('the report checkpoint did not give back the '
                             'report')
    return {'checkpoint_bytes': size}


def report_save_round_trip(report, report_text: str) -> dict:
    """The consolidated report through `save_report`'s files in a
    temporary directory: every array and the text back as they were."""
    with tempfile.TemporaryDirectory() as tmp:
        pipeline.save_report(report, report_text, tmp, header='chip_smoke')
        data = np.load(os.path.join(tmp, 'report.npz'))
        same = set(data.files) == {f'{step}/{k}' for step, entry in
                                   report.items() for k in entry} and all(
            np.array_equal(data[f'{step}/{k}'], np.asarray(v))
            for step, entry in report.items() for k, v in entry.items())
        with open(os.path.join(tmp, 'report.txt')) as f:
            same = same and f.read() == 'chip_smoke\n' + report_text
    if not same:
        raise AssertionError('save_report did not give back the report')
    return {'report_arrays': len(data.files)}


def several_cards_batches(cfg: gan.GANConfig, dev: torch.device) -> dict:
    """The global batches of the (b) check from a numpy seed: the G step's
    latents and cameras, the D step's real images (4 channels, with their
    2x copy) and cameras and its fakes' latents and cameras."""
    rng = np.random.default_rng(17)
    b = cfg.batch_size

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def views(latent):
        cam, focal = p3d_cameras(rng, b, dev)
        out = {'pose': cam, 'focal': focal}
        if latent:
            out['z'] = tensor(rng.standard_normal((b, cfg.latent_dim)))
        return out

    hi = tensor(rng.uniform(-1, 1, (b, 2 * RES, 2 * RES, 4)))
    real = dict(views(False), image_highres=hi,
                image=hi.reshape(b, RES, 2, RES, 2, 4).mean((2, 4)))
    return {'g': views(True), 'real': real, 'fake': views(True)}


def _several_variant(name: str):
    """Applies a wrong variant of the several-cards layer (see the
    constants); returns its undo."""
    if name == 'global':
        return lambda: None
    if name == 'per_replica_mbstd':
        original = stylegan.minibatch_std

        def per_replica(x, group_size, num_channels=1):
            layout = mesh.batch_layout
            mesh.batch_layout = lambda: (1, 0)
            try:
                return original(x, group_size, num_channels)
            finally:
                mesh.batch_layout = layout
        stylegan.minibatch_std = per_replica

        def undo():
            stylegan.minibatch_std = original
        return undo
    originals = (mesh.rand, mesh.randn)
    mesh.rand = lambda shape, generator, **kw: torch.rand(
        tuple(shape), generator=generator, **kw)
    mesh.randn = lambda shape, generator, **kw: torch.randn(
        tuple(shape), generator=generator, **kw)

    def undo():
        mesh.rand, mesh.randn = originals
    return undo


def several_cards_steps(variant: str, timed_pairs: int) -> dict:
    """A G step and a D step of `variant` at SEVERAL_BATCH (this rank's
    rows of it on several ranks) from a fresh float32 state of TRAIN_CFG
    at SEVERAL_ITERATION; what the check compares: the metrics, the
    gradients of G's last synthesis layer and D's first layer and the
    norms as `_adam_step` gets them (averaged over ranks), D's
    minibatch-stddev channel on the real batch, ADA's transforms, the
    latents. Then `timed_pairs` more pairs for their ms. Launches,
    CUDA-event ms and peak memory beside them."""
    dev = torch.device('cuda', torch.cuda.current_device())
    cfg = dataclasses.replace(TRAIN_CFG, batch_size=SEVERAL_BATCH)
    undo = _several_variant(variant)
    seen = {'grads': [], 'mbstd': [], 'tforms': []}
    originals = (gan._adam_step, stylegan.minibatch_std,
                 augment.sample_transform)
    layers = {}

    def adam_step(opt, params, grads, base_lr, cfg_):
        index = layers['g' if opt is state.opt_g else 'd']
        seen['grads'].append((float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads
             if g is not None]))), grads[index].float().cpu()))
        return originals[0](opt, params, grads, base_lr, cfg_)

    def minibatch_std(x, group_size, num_channels=1):
        y = originals[1](x, group_size, num_channels)
        seen['mbstd'].append(y[:, -1, 0, 0].detach().float().cpu())
        return y

    def sample_transform(*args, **kwargs):
        t = originals[2](*args, **kwargs)
        seen['tforms'].append(torch.cat((t.rot[:, None], t.scale[:, None],
                                         t.translation), 1).cpu())
        return t

    try:
        state = gan.init_train_state(cfg, dtype=torch.float32, device=dev,
                                     seed=0)
        state.iteration = SEVERAL_ITERATION
        state.augment_p = TRAIN_AUGMENT_P
        for opt in (state.opt_g, state.opt_d):  # past the lr warmup
            opt.param_groups[0]['count'] = SEVERAL_ITERATION // 2
        last = getattr(state.gen.synthesis_network,
                       f'b{cfg.plane_resolution}').torgb.weight
        layers['g'] = [p is last for p in state.gen.parameters()].index(True)
        layers['d'] = 0
        batches = {k: mesh.shard_batch(v) for k, v in
                   several_cards_batches(cfg, dev).items()}
        gan._adam_step = adam_step
        stylegan.minibatch_std = minibatch_std
        augment.sample_transform = sample_transform
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = {'metrics': {}, 'launches': {}, 'ms': {'g': [], 'd': []},
               'z': batches['g']['z'].cpu(),
               'fake_z': batches['fake']['z'].cpu()}
        for k in range(1 + timed_pairs):
            for kind in ('g', 'd'):
                timer = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                reset_counts()
                mbstd_before = len(seen['mbstd'])
                timer[0].record()
                if kind == 'g':
                    metrics = gan.g_step(state, batches['g'], cfg)
                else:
                    metrics = gan.d_step(state, batches['real'],
                                         batches['fake'], cfg)
                timer[1].record()
                timer[1].synchronize()
                launched = counts()
                expect_launches(f'several cards {variant} {kind}', launched,
                                **SEVERAL_LAUNCHES[kind])
                out['ms'][kind].append(timer[0].elapsed_time(timer[1]))
                if k == 0:
                    out['metrics'][kind] = {n: float(v)
                                            for n, v in metrics.items()}
                    out['launches'][kind] = launched
                    if kind == 'd':
                        out['mbstd'] = seen['mbstd'][mbstd_before]
                    out[f'grads_{kind}'] = seen['grads'][-1]
            if k == 0:
                out['tforms'] = list(seen['tforms'])
        out['peak_gb'] = torch.cuda.max_memory_allocated() / 1e9
        out['augment_p'] = state.augment_p
        return out
    finally:
        (gan._adam_step, stylegan.minibatch_std,
         augment.sample_transform) = originals
        undo()


def several_cards_rank(argv) -> None:
    """One rank of the (b) check: `--several-cards-rank RANK WORLD PORT
    OUT`. Joins a gloo group at 127.0.0.1:PORT on the one card (the
    device passed explicitly), runs every variant of
    `several_cards_steps` and times an all-reduce of G's gradients; saves
    what it saw to OUT/rank<RANK>.pt."""
    rank, world, port, out_dir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.cuda.set_device(0)
    # As device_phase sets them for the one-process reference.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    distributed.maybe_initialize(
        coordinator_address=f'tcp://127.0.0.1:{port}', num_processes=world,
        process_id=rank, backend='gloo', timeout_s=SEVERAL_TIMEOUT_S)
    init_s = time.perf_counter() - t
    t = time.perf_counter()
    mesh.all_mean_scalar(torch.ones((), device='cuda'))
    torch.cuda.synchronize()
    first_collective_s = time.perf_counter() - t
    out = {'rank': rank, 'init_s': init_s,
           'first_collective_s': first_collective_s,
           'device': str(torch.device('cuda', torch.cuda.current_device()))}
    for variant in SEVERAL_VARIANTS:
        out[variant] = several_cards_steps(
            variant, SEVERAL_TIMED_PAIRS if variant == 'global' else 0)
        torch.cuda.empty_cache()
    # A gloo all-reduce of G's gradients (32.2M float32 entries in one
    # bucket, through the host) on this card.
    params = list(gan.make_models(TRAIN_CFG, torch.bfloat16, 'cuda')[0]
                  .parameters())
    grads = [torch.ones_like(p) for p in params]
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mesh.all_mean(grads)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    out['all_mean_g'] = {'entries': sum(g.numel() for g in grads),
                         'ms': times[1:], 'first_ms': times[0]}
    torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
    distributed.barrier()
    torch.distributed.destroy_process_group()


def _rays_variant(variant: str):
    """Applies a wrong variant of the split render (see the several-cards
    constants, (d)); returns the undo."""
    originals = (mesh._gather_axis, mesh.RaySplit.image_rows)
    if variant == 'reversed':
        def gather_axis(x, dim, n, group, world):
            if world == 1:
                return x.narrow(dim, 0, n)
            parts = [torch.empty_like(x) for _ in range(world)]
            torch.distributed.all_gather(parts, x.contiguous(), group=group)
            return torch.cat(parts[::-1], dim=dim).narrow(dim, 0, n)
        mesh._gather_axis = gather_axis
    elif variant == 'first_strip':
        mesh.RaySplit.image_rows = lambda self, h, device=None: mesh._share(
            h, self.mesh.axis('rays')[0], 0, device)
    else:
        raise ValueError(variant)

    def undo():
        mesh._gather_axis, mesh.RaySplit.image_rows = originals
    return undo


def _render_gaps(outs: list, wholes: list) -> dict:
    """Each split export render's largest difference from the whole one,
    over the whole one's largest entry, by map."""
    names = ('recon', 'novel')
    return {names[i]: {k: float((o[k].float() - w[k].float()).abs().max() /
                                w[k].float().abs().max().clamp_min(1e-30))
                       for k in w}
            for i, (o, w) in enumerate(zip(outs, wholes))}


def rays_demo_rank(argv) -> None:
    """One rank of the (d) check: `--rays-demo-rank RANK WORLD PORT OUT
    ARGV`. Joins a gloo group at 127.0.0.1:PORT on the one card (the
    device passed explicitly) and runs the demo CLI with the argv of the
    JSON file ARGV in OUT/rank<RANK>, counting launches around the steps,
    the evaluations and the export and keeping each split export render
    and the rank's own parameters before the broadcast. Then, in this
    process alone: the export's views rendered whole from the same
    parameters, twice (the card's run-to-run floor), and split and whole
    on the plain sampler (`plain_bf16_rounded`); split under each wrong
    variant; the strip `export_demo` writes in one process from the same
    parameters and from the rank's own. Saves what it saw to
    OUT/rank<RANK>.pt."""
    rank, world, port, out_dir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    with open(argv[4]) as f:
        cli_argv = json.load(f)
    torch.cuda.set_device(0)
    t = time.perf_counter()
    distributed.maybe_initialize(
        coordinator_address=f'tcp://127.0.0.1:{port}', num_processes=world,
        process_id=rank, backend='gloo', timeout_s=SEVERAL_TIMEOUT_S)
    init_s = time.perf_counter() - t
    work = os.path.join(out_dir, f'rank{rank}')
    os.makedirs(work)
    os.chdir(work)
    calls, renders, seen = [], [], {}
    originals = (inv.run_inversion, pipeline.evaluate_checkpoint,
                 cli_inversion.export_demo, inv.render_from_params,
                 mesh.broadcast)

    def recorded(gen, params, *rest, **kwargs):
        out = originals[3](gen, params, *rest, **kwargs)
        if kwargs.get('split') is not None:
            renders.append((gen, params.copy(False), rest, kwargs, out[0]))
        return out

    def export(*args, **kwargs):
        seen['export'] = (args, kwargs)
        return originals[2](*args, **kwargs)

    def broadcast(tensors):
        seen['own'] = [t.detach().clone() for t in tensors]
        return originals[4](tensors)

    inv.run_inversion = counted_calls(calls, 'steps', originals[0])
    pipeline.evaluate_checkpoint = counted_calls(calls, 'evaluation',
                                                 originals[1])
    cli_inversion.export_demo = counted_calls(calls, 'export', export)
    inv.render_from_params = recorded
    mesh.broadcast = broadcast
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    try:
        out = cli_run.main(cli_argv, device=torch.device('cuda', 0))
    finally:
        (inv.run_inversion, pipeline.evaluate_checkpoint,
         cli_inversion.export_demo, inv.render_from_params,
         mesh.broadcast) = originals
    wall_s = time.perf_counter() - t
    total = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def maps(o):
        return {k: getattr(o, k) for k in RAYS_MAPS
                if getattr(o, k) is not None}

    def again(**change):
        return [maps(inv.render_from_params(
            gen, params, *rest, **dict(kwargs, **change))[0])
            for gen, params, rest, kwargs, _ in renders]

    with torch.no_grad():
        wholes = again(split=None)
        floors = [_render_gaps(again(split=None), wholes)
                  for _ in range(RAYS_FLOOR_RENDERS)]
        gaps = {'split': _render_gaps([maps(r[4]) for r in renders], wholes),
                'floor': {view: {k: max(f[view][k] for f in floors)
                                 for k in m}
                          for view, m in floors[0].items()},
                'plain': _render_gaps(again(sampler=plain_bf16_rounded),
                                      again(sampler=plain_bf16_rounded,
                                            split=None))}
        for variant in RAYS_VARIANTS:
            undo = _rays_variant(variant)
            try:
                gaps[variant] = _render_gaps(again(), wholes)
            finally:
                undo()
    # Where the normals part: the share of pixels off by more than the
    # render limit, and the largest gap where the mask is above 0.5.
    split_normals = maps(renders[0][4])['normals']
    off = (split_normals - wholes[0]['normals']).abs().amax(-1)
    inside = wholes[0]['mask'] > 0.5
    normals_off = {'share': float((off > RAYS_RENDER_RTOL).float().mean()),
                   'inside_max': float(off[inside].max())
                   if bool(inside.any()) else 0.0}

    args, kwargs = seen['export']
    own = inv.InversionParams(**dict(zip(
        [n for n, _ in args[3].named()], seen['own'])))

    def strip_of(params, sub):
        os.makedirs(sub)
        os.chdir(sub)
        try:
            path = originals[2](*args[:3], params, *args[4:],
                                **dict(kwargs, write=True, mesh=None))
            return image_io.read_png(path)
        finally:
            os.chdir(work)

    path = os.path.join(work, out['demo_path'])
    result = {
        'rank': rank, 'init_s': init_s, 'wall_s': wall_s,
        'demo_path': out['demo_path'], 'demo_s': out['demo_s'],
        'peak_gb': peak_gb, 'calls': calls, 'total': total,
        'renders': len(renders),
        'params_parted': out['params_parted'], 'gaps': gaps,
        'normals_off': normals_off,
        'shape': list(renders[0][4].rgb.shape) if renders else None,
        'outputs': sorted(os.listdir('outputs'))
        if os.path.isdir('outputs') else [],
        'strip': image_io.read_png(path) if os.path.exists(path) else None,
        'same_strip': strip_of(args[3], 'same'),
        'own_strip': strip_of(own, 'own')}
    torch.save(result, os.path.join(out_dir, f'rank{rank}.pt'))
    distributed.barrier()
    torch.distributed.destroy_process_group()


def rays_demo_part(assets: dict, demo: dict, base: str) -> dict:
    """(d) of the several-cards constants: the ranks started, waited for
    and checked. Returns the readings, with the faults under 'faults'."""
    out_dir = os.path.join(base, 'rays')
    os.makedirs(out_dir)
    argv_path = os.path.join(out_dir, 'argv.json')
    with open(argv_path, 'w') as f:
        json.dump(['--dataset', 'p3d_car', '--inv_manual_input_path',
                   demo['photos']['rgba'], '--resume_from',
                   demo['gan_path'], '--coord_resume_from',
                   assets['encoder'], '--root_path', assets['root'],
                   '--data_path', assets['data'], '--mesh_shape',
                   RAYS_MESH], f)
    repo = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--rays-demo-rank',
         str(r), str(SEVERAL_RANKS), str(port), out_dir, argv_path],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(SEVERAL_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(
                SEVERAL_TIMEOUT_S - (time.perf_counter() - t), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks_s = time.perf_counter() - t
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f'rays demo rank {r} failed '
                                 f'({p.returncode}):\n{log[-6000:]}')
    got = [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                      weights_only=False) for r in range(SEVERAL_RANKS)]
    faults = []
    want = {'steps': CLI_STEP_LAUNCHES, 'evaluation': DEMO_EVAL_LAUNCHES,
            'export': DEMO_EXPORT_LAUNCHES}
    for g in got:
        kinds = [c[0] for c in g['calls']]
        if kinds != ['evaluation', 'steps', 'evaluation', 'export']:
            faults.append(f'rays demo rank {g["rank"]} calls {kinds}')
        for what, _, launched in g['calls']:
            try:
                expect_launches(f'rays demo rank {g["rank"]} {what}',
                                launched, **want[what])
            except AssertionError as e:
                faults.append(str(e))
        per_call = {n: sum(c[2][n] for c in g['calls']) for n in g['total']}
        if per_call != g['total'] or not all(
                g['total'][n] for n in RAYS_KERNELS):
            faults.append(f'rays demo rank {g["rank"]} launches '
                          f'{g["total"]}, per call {per_call}')
        if g['renders'] != 2 or g['shape'] != [1, RES, RES, 3]:
            faults.append(f'rays demo rank {g["rank"]}: {g["renders"]} '
                          f'split renders of {g["shape"]}')
        def fails(gaps):
            return [(view, k) for view, m in gaps.items()
                    for k, v in m.items() if not v <= RAYS_LIMITS[k]]
        if fails(g['gaps']['split']):
            faults.append(f'rays demo rank {g["rank"]}: the split export '
                          f'parts from the whole one: {g["gaps"]["split"]}'
                          f', limits {RAYS_LIMITS}')
        for variant in RAYS_VARIANTS:
            if not fails(g['gaps'][variant]):
                faults.append(f'the render check passes the wrong variant '
                              f'{variant}: {g["gaps"][variant]}')

    def levels(a, b):
        """(share of pixels within RAYS_STRIP_LEVELS, largest level)."""
        if a is None or b is None or a.shape != b.shape:
            return None, None
        d = np.abs(a.astype(np.int64) - b.astype(np.int64)).max(-1)
        return float((d <= RAYS_STRIP_LEVELS).mean()), int(d.max())

    strips = {
        # The split demo's strip against the one-process export of the
        # same parameters: the split alone.
        'same_params': levels(got[0]['strip'], got[0]['same_strip']),
        # Against the demo phase's one-process run: the split and the
        # card's run-to-run inversion.
        'demo_phase': levels(got[0]['strip'], demo['strips']['rgba']),
        # Two inversions of the photo on the card (the ranks' own before
        # the broadcast), each exported in one process: the floor.
        'floor': levels(got[0]['own_strip'], got[1]['own_strip'])}
    share, top = strips['same_params']
    if share is None or share < RAYS_STRIP_SHARE:
        faults.append(f'rays demo strip: {share} of the pixels within '
                      f'{RAYS_STRIP_LEVELS} levels of the one-process '
                      f'export of the same parameters (largest {top})')
    if got[0]['outputs'] != [os.path.basename(got[0]['demo_path'])] or \
            any(g['outputs'] for g in got[1:]):
        faults.append(f'rays demo writes: {[g["outputs"] for g in got]}')
    return {
        'mesh': RAYS_MESH, 'ranks_s': ranks_s, 'strips': strips,
        'ranks': [{k: g[k] for k in ('rank', 'init_s', 'wall_s', 'demo_s',
                                     'peak_gb', 'params_parted', 'gaps',
                                     'normals_off', 'outputs', 'total')} |
                  {'launches': {c[0] + ('_0' if i == 0 else ''): {
                      n: v for n, v in c[2].items() if v}
                      for i, c in enumerate(g['calls'])},
                   'ms_by_call': [(c[0], c[1]) for c in g['calls']]}
                  for g in got],
        'limits': {'render': RAYS_LIMITS, 'levels': RAYS_STRIP_LEVELS,
                   'share': RAYS_STRIP_SHARE},
        'faults': faults}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _several_errors(got: dict, ref: dict) -> dict:
    """(b)'s readings of a two-rank run (the ranks' results) against one
    process's."""
    def rel(a, b):
        return float((a - b).norm() / b.norm())

    errs = {}
    for kind in ('g', 'd'):
        m, r = got[0]['metrics'][kind], ref['metrics'][kind]
        errs[f'{kind}_loss_rel_err'] = max(
            abs(m[k] - r[k]) / max(abs(r[k]), 1e-30)
            for k in r if k.startswith('loss_'))
        errs[f'{kind}_grad_norm_rel_err'] = (
            abs(got[0][f'grads_{kind}'][0] - ref[f'grads_{kind}'][0]) /
            ref[f'grads_{kind}'][0])
        errs[f'{kind}_layer_grad_rel_err'] = rel(got[0][f'grads_{kind}'][1],
                                                 ref[f'grads_{kind}'][1])
    mbstd = torch.cat([g['mbstd'] for g in got])
    errs['mbstd_rel_err'] = float((mbstd - ref['mbstd']).abs().max() /
                                  ref['mbstd'].abs().max())
    tforms = [torch.cat([g['tforms'][i] for g in got])
              for i in range(len(ref['tforms']))]
    errs['tform_abs_err'] = max(float((a - b).abs().max())
                                for a, b in zip(tforms, ref['tforms']))
    return errs


def _several_fails(errs: dict) -> list:
    limits = {'loss_rel_err': STEP_LOSS_RTOL,
              'grad_norm_rel_err': STEP_GRAD_RTOL,
              'layer_grad_rel_err': STEP_GRAD_RTOL,
              'mbstd_rel_err': STEP_GRAD_RTOL,
              'tform_abs_err': SEVERAL_DRAW_ATOL}
    return [k for k, v in errs.items()
            if not v <= next(lim for s, lim in limits.items()
                             if k.endswith(s))]


def _checkpoint_tensors(tree, prefix=''):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    out = {}
    for k, v in items:
        out.update(_checkpoint_tensors(v, f'{prefix}/{k}'))
    return out


def _latest_gaps(a: dict, b: dict, lr: float,
                 moments_limit: Optional[float]) -> dict:
    """How far checkpoint `a`'s tensors part from `b`'s: the model's by the
    largest entry's difference (held to SEVERAL_CLI_RTOL of the tensor's
    largest entry plus twice `lr`), Adam's moments by the relative norm
    (held to `moments_limit`; None: not held)."""
    if a.keys() != b.keys():
        raise AssertionError('the latest checkpoints differ in form')
    worst = {'model': 0.0, 'moments': 0.0}
    exact, parted = 0, []
    for key, ref in b.items():
        if not ref.is_floating_point():
            if not torch.equal(a[key], ref):
                parted.append((key, 'differs'))
            continue
        diff = a[key].double() - ref.double()
        exact += not bool(diff.any())
        if '/state/' in key:
            err = float(diff.norm() / max(float(ref.double().norm()),
                                          1e-30))
            worst['moments'] = max(worst['moments'], err)
            if moments_limit is not None and err > moments_limit:
                parted.append((key, err))
        else:
            err = float(diff.abs().max())
            scale = float(ref.double().abs().max())
            worst['model'] = max(worst['model'], err / max(scale, 1e-30))
            if err > SEVERAL_CLI_RTOL * scale + 2 * lr:
                parted.append((key, err, scale))
    return {'worst': worst, 'tensors': len(b), 'exact': exact,
            'parted': parted, 'moments_limit': moments_limit}


def several_cards_phase(assets: dict, demo: dict) -> None:
    """(a), (b), (c) and (d) of the several-cards constants; (d) on the
    demo phase's photo, checkpoint and strip (`demo`)."""
    started = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(os.path.dirname(assets['root']), 'several')
    train_root = os.path.join(os.path.dirname(assets['root']), 'train_out')
    ckpt_root = os.path.join(train_root, 'gan_checkpoints')
    resume = os.path.join(ckpt_root, os.listdir(ckpt_root)[0],
                          'checkpoint_latest.pth')
    start_iteration = checkpoint.load(resume)['iteration']
    argv = ['--dataset', 'p3d_car', '--data_path', assets['data'],
            '--resume_from', resume, '--mesh_shape', 'data:1',
            '--iterations', str(start_iteration + SEVERAL_CLI_STEPS)]
    roots = {}
    for kind in ('launched', 'plain', 'repeat'):
        roots[kind] = os.path.join(base, kind)
        os.makedirs(roots[kind])
        os.symlink(os.path.join(assets['root'], 'weights'),
                   os.path.join(roots[kind], 'weights'))

    # (a) One rank under the launcher, NCCL.
    torch.cuda.empty_cache()
    t = time.perf_counter()
    launched = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', '1', '-m', 'nerf_from_image_tpu_torch.cli.run',
         *argv, '--root_path', roots['launched']], cwd=repo,
        capture_output=True, text=True, timeout=SEVERAL_TIMEOUT_S)
    launched_s = time.perf_counter() - t
    if launched.returncode != 0:
        raise AssertionError(f'the launched CLI failed '
                             f'({launched.returncode}):\n'
                             f'{launched.stdout[-4000:]}'
                             f'{launched.stderr[-4000:]}')
    init_line = [line for line in launched.stdout.splitlines()
                 if line.startswith('torch.distributed initialized')]
    if not init_line or 'backend nccl' not in init_line[0]:
        raise AssertionError(f'the launched CLI joined no NCCL group: '
                             f'{launched.stdout[-2000:]}')
    # The same resume in this process, without a launcher.
    calls = []
    originals = (gan.g_step, gan.d_step)

    def counted(kind, fn):
        def wrapper(*args, **kwargs):
            timer = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
            reset_counts()
            timer[0].record()
            out = fn(*args, **kwargs)
            timer[1].record()
            timer[1].synchronize()
            calls.append({'kind': kind, 'launches': counts(),
                          'ms': timer[0].elapsed_time(timer[1])})
            return out
        return wrapper

    gan.g_step = counted('g', originals[0])
    gan.d_step = counted('d', originals[1])
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        cli_run.main(argv + ['--root_path', roots['plain']])
    finally:
        gan.g_step, gan.d_step = originals
    plain_s = time.perf_counter() - t
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if [c['kind'] for c in calls] != ['g', 'd']:
        raise AssertionError(f'the plain resume ran {calls}')
    for c in calls:
        expect_launches(f'several cards plain {c["kind"]}', c['launches'],
                        **SEVERAL_LAUNCHES[c['kind']])
    # The same resume again: the card's run-to-run floor.
    cli_run.main(argv + ['--root_path', roots['repeat']])
    latest = {}
    for kind in roots:
        name = os.listdir(os.path.join(roots[kind], 'gan_checkpoints'))[0]
        latest[kind] = checkpoint.load(os.path.join(
            roots[kind], 'gan_checkpoints', name, 'checkpoint_latest.pth'))
    want = start_iteration + SEVERAL_CLI_STEPS
    if any(v['iteration'] != want for v in latest.values()):
        raise AssertionError(f'latest iterations '
                             f'{[v["iteration"] for v in latest.values()]}')
    # The lr of the steps' last Adam updates (the warmup's, by the count).
    lr = max(latest['plain'][k]['param_groups'][0]['lr']
             for k in ('optimizer_g', 'optimizer_d'))
    latest = {k: _checkpoint_tensors(v) for k, v in latest.items()}
    floor = _latest_gaps(latest['repeat'], latest['plain'], lr, None)
    gaps = _latest_gaps(latest['launched'], latest['plain'], lr,
                        max(STEP_GRAD_RTOL, SEVERAL_FLOOR_FACTOR *
                            floor['worst']['moments']))
    part_a = {'argv': [os.path.basename(x) for x in argv],
              'launched_s': launched_s, 'plain_s': plain_s,
              'init_line': init_line[0], 'lr': lr,
              'launched_vs_plain': gaps, 'repeat_vs_plain': floor,
              'model_rtol': SEVERAL_CLI_RTOL,
              'plain_steps': calls, 'plain_peak_gb': plain_peak_gb,
              'launched_stdout_tail': launched.stdout[-600:]}
    gc.collect()
    torch.cuda.empty_cache()

    # (b) One process at the global batch, then the ranks on this card.
    ref = several_cards_steps('global', 0)
    torch.cuda.empty_cache()
    out_dir = os.path.join(base, 'ranks')
    os.makedirs(out_dir)
    port = _free_port()
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--several-cards-rank',
         str(r), str(SEVERAL_RANKS), str(port), out_dir], cwd=repo,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(SEVERAL_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(
                SEVERAL_TIMEOUT_S - (time.perf_counter() - t), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks_s = time.perf_counter() - t
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f'several cards rank {r} failed '
                                 f'({p.returncode}):\n{log[-6000:]}')
    got = [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                      weights_only=False) for r in range(SEVERAL_RANKS)]
    del latest
    checks = {}
    for variant in SEVERAL_VARIANTS:
        errs = _several_errors([g[variant] for g in got], ref)
        checks[variant] = {'errors': errs, 'fails': _several_fails(errs)}
    per = SEVERAL_BATCH // SEVERAL_RANKS
    z = torch.cat([g['global']['z'] for g in got])
    fake_z = torch.cat([g['global']['fake_z'] for g in got])
    faults = []
    if gaps['parted']:
        faults.append(f'the launched and plain latest part: '
                      f'{gaps["parted"][:5]}')
    if checks['global']['fails']:
        faults.append(f'two ranks part from one: {checks["global"]}')
    for variant in SEVERAL_VARIANTS[1:]:
        if not checks[variant]['fails']:
            faults.append(f'the check passes the wrong variant {variant}: '
                          f'{checks[variant]}')
    if not (torch.equal(z, ref['z']) and torch.equal(fake_z, ref['fake_z'])):
        faults.append('the ranks did not take their rows of the global '
                      'latents')
    if torch.equal(got[0]['global']['z'], got[1]['global']['z']):
        faults.append('the ranks rendered the same latents')
    if any(g['global']['metrics'] != got[0]['global']['metrics']
           for g in got):
        faults.append('the ranks logged different metrics')
    ranks = [{
        'rank': g['rank'], 'device': g['device'],
        'fake_rows': [g['rank'] * per, (g['rank'] + 1) * per],
        'init_s': g['init_s'], 'first_collective_s':
            g['first_collective_s'],
        'launches': {k: {n: v for n, v in g['global']['launches'][k].items()
                         if v} for k in ('g', 'd')},
        'g_ms': g['global']['ms']['g'], 'd_ms': g['global']['ms']['d'],
        'peak_gb': g['global']['peak_gb'],
        'all_mean_g': g['all_mean_g']} for g in got]
    for r in ranks:
        print(json.dumps({'several_cards_rank': r}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    part_d = rays_demo_part(assets, demo, base)
    faults += part_d.pop('faults')
    emit('several_cards', started, cli_nccl_world_1=part_a,
         one_process={'metrics': ref['metrics'], 'g_ms': ref['ms']['g'],
                      'd_ms': ref['ms']['d'], 'peak_gb': ref['peak_gb'],
                      'augment_p': ref['augment_p']},
         two_ranks_s=ranks_s, ranks=ranks,
         latents_differ=not torch.equal(got[0]['global']['z'],
                                        got[1]['global']['z']),
         checks=checks,
         limits={'loss': STEP_LOSS_RTOL, 'grad': STEP_GRAD_RTOL,
                 'mbstd': STEP_GRAD_RTOL, 'tform': SEVERAL_DRAW_ATOL},
         rays_demo=part_d, faults=faults)
    if faults:
        raise AssertionError('several cards: ' + '; '.join(faults))


def main() -> None:
    started = time.perf_counter()
    device = device_phase()
    reader_phase()
    build_phase()
    rows = {}
    for r in [kernel_phase(), triplane_grad_phase(),
              triplane_grad_planes_phase(), *warp_phase()]:
        rows[r['name']] = r
    render_args = slice_phase(rows)
    rows[triplane_cuda.FUSED_KERNEL] = fused_kernel_phase(*render_args[:2])
    r512_phase(*render_args[1:], rows)
    inv_gen, lpips = inversion_models()
    inversion_step = inversion_phase(rows, inv_gen, lpips)
    pipeline_phase(rows, inv_gen, lpips)
    float32_phase(lpips)
    with tempfile.TemporaryDirectory() as tmp:
        assets = cli_assets(tmp)
        cli_phase(assets)
        torch.cuda.empty_cache()
        train_cli_phase(assets, rows)
        torch.cuda.empty_cache()
        demo = demo_phase(assets)
        torch.cuda.empty_cache()
        several_cards_phase(assets, demo)
        torch.cuda.empty_cache()
        dataset_dirs = datasets_phase(assets, lpips)
        torch.cuda.empty_cache()
        families_phase(assets, lpips)
        torch.cuda.empty_cache()
        flag_modes_phase(assets, dataset_dirs, rows, inv_gen, lpips)
    torch.cuda.empty_cache()
    train_steps = train_phase(rows)
    torch.cuda.empty_cache()
    pretrained, pretrain_step = pretrain_phase(rows)
    torch.cuda.empty_cache()
    distill_step = distill_phase(rows, pretrained.gen_ema)
    torch.cuda.empty_cache()
    profile_phase(*render_args, inversion_step, train_steps,
                  (pretrain_step, distill_step))
    emit('done', started)
    print(json.dumps({'kernels': list(rows.values())}), flush=True)
    print(json.dumps({'ok': True, 'device': device}), flush=True)


if __name__ == '__main__':
    if sys.argv[1:2] == ['--several-cards-rank']:
        several_cards_rank(sys.argv[2:])
    elif sys.argv[1:2] == ['--rays-demo-rank']:
        rays_demo_rank(sys.argv[2:])
    else:
        main()
