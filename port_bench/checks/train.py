"""Whether the training steps are right: the program's first three steps
(G, D, G) against the plain reference's, in float32, from the same
seeded weights, loop seeds and state generator.

The numbers, each the worst over what it covers:

- loss_gap: each step's losses (G: adversarial, eikonal, total
  variation, entropy; D: real, fake, R1), |program - reference| /
  max(|reference|, 1e-3).
- grad_gap: the first gradient as each optimizer got it (G's after step
  1, D's after step 2, from the Adam state, whose first moment is the
  clipped gradient with b1 = 0), by leaf: the gap between the program's
  norm and the reference's, over the reference's norm or the median
  leaf's, whichever is larger.
- change_gap: how far the three steps moved G, its EMA and D (D by its
  one step), by leaf, measured alike.

Leaves whose reference gradient is under a thousandth of the median
leaf's (a bias that softmax or a norm makes constant, whose Adam steps
are round-off) are left out of grad_gap and change_gap, by that rule and
not by name. A leaf the program leaves unmoved reads 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import weights as weights_lib
from port_bench.checks import REFERENCE_ROWS
from port_bench.common import reference_generator
from port_bench.reference import discriminator as ref_disc
from port_bench.reference import gan as ref_gan
from port_bench.reference import triplane as ref_triplane

LOSS_TAGS = {'loss_g': 'loss/g', 'loss_eikonal': 'loss/eikonal',
             'loss_tv': 'loss/tv', 'loss_entropy': 'loss/entropy',
             'loss_d_real': 'loss/d_real', 'loss_d_fake': 'loss/d_fake',
             'loss_r1': 'loss/r1'}
LOSS_FLOOR = 1e-3
QUIET_LEAF = 1e-3
FP8_MAX = 448.0


def reference_state(s, device) -> ref_gan.State:
    cfg = s.cfg
    gen = reference_generator(cfg, device)
    gen.plane_sampler = ref_triplane.plain_sampler
    ema = reference_generator(cfg, device).requires_grad_(False)
    disc = ref_disc.Discriminator(
        resolution=cfg.resolution, nc=4 if cfg.supervise_alpha else 3,
        camera_flipped=cfg.camera_flipped, channel_base=cfg.channel_base,
        channel_max=cfg.channel_max, device=device)
    g_state = s.state_dict('generator', device)
    weights_lib.load(gen, g_state)
    weights_lib.load(ema, g_state)
    weights_lib.load(disc, s.state_dict('discriminator', device))
    count = s.optimizer_count
    return ref_gan.State(
        gen=gen, gen_ema=ema, disc=disc,
        opt_g=ref_gan.optimizer(gen, cfg.lr_g, count),
        opt_d=ref_gan.optimizer(disc, cfg.lr_d, count),
        iteration=s.start_iteration, augment_p=s.augment_p)


def _fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale (its largest value
    onto the format's), with an identity gradient."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


@contextlib.contextmanager
def fp8_products():
    """Convolutions and linear layers on fp8-rounded inputs and weights:
    the reference computed a precision below the configuration's bf16."""
    saved = {name: getattr(F, name) for name in
             ('conv2d', 'conv_transpose2d', 'linear')}

    def wrap(fn):
        def quantized(x, w, *args, **kwargs):
            return fn(_fake_fp8(x), _fake_fp8(w), *args, **kwargs)
        return quantized
    try:
        for name, fn in saved.items():
            setattr(F, name, wrap(fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(F, name, fn)


def follow(s, device, block: int, precision=contextlib.nullcontext,
           half_batch: bool = False) -> dict:
    """The reference's first three steps; in `precision`'s context (the
    control), or with the second half of each batch left out and the
    mean taken over the rest (a planted fault). Returns what `warm_up`
    returns for the program."""
    st = reference_state(s, device)
    cfg = s.cfg
    if half_batch:
        cfg = _half(cfg)
    rng = torch.Generator(device=device).manual_seed(s.rng_seed)
    hires = cfg.is_highres and cfg.augment_p_max > 0
    first_loop = ref_gan.LoopDraws(s.split, s.cfg.batch_size, cfg.latent_dim,
                                   s.loop_seed(0), device)
    second_loop = ref_gan.LoopDraws(s.split, s.cfg.batch_size,
                                    cfg.latent_dim, s.loop_seed(1), device)
    g_start = {n: p.detach().clone() for n, p in st.gen.named_parameters()}
    d_start = {n: p.detach().clone() for n, p in st.disc.named_parameters()}
    losses = []
    with precision():
        batch = first_loop.g_batch()
        draws = ref_gan.g_draws(rng, s.cfg, st.augment_p)
        losses.append(ref_gan.g_step(st, _rows(batch, cfg), _rows(draws, cfg),
                                     cfg, block))
        out = {'grad_g': _first(st.opt_g, st.gen)}
        real, fake = first_loop.d_batches(hires)
        draws = ref_gan.d_draws(rng, s.cfg, st.augment_p)
        losses.append(ref_gan.d_step(st, _rows(real, cfg), _rows(fake, cfg),
                                     _rows(draws, cfg), cfg, block))
        out['grad_d'] = _first(st.opt_d, st.disc)
        out['change_d'] = _changes(st.disc, d_start)
        batch = second_loop.g_batch()
        draws = ref_gan.g_draws(rng, s.cfg, st.augment_p)
        losses.append(ref_gan.g_step(st, _rows(batch, cfg), _rows(draws, cfg),
                                     cfg, block))
    out['change_g'] = _changes(st.gen, g_start)
    out['change_ema'] = _changes(st.gen_ema, g_start)
    out['names_g'] = [n for n, _ in sorted(st.gen.named_parameters())]
    out['names_d'] = [n for n, _ in sorted(st.disc.named_parameters())]
    out['losses'] = [{LOSS_TAGS[k]: float(v) for k, v in m.items()}
                     for m in losses]
    return out


def _half(cfg):
    return dataclasses.replace(cfg, batch_size=cfg.batch_size // 2)


def _rows(d, cfg):
    """A batch or a step's draws cut to the configuration's batch (the
    planted half-batch fault's first half); the whole otherwise."""
    b = cfg.batch_size
    out = {}
    for k, v in d.items():
        if k == 'pdf_u':
            out[k] = v[:b * cfg.resolution ** 2]
        elif k.endswith('tform'):
            out[k] = type(v)(rot=v.rot[:b], scale=v.scale[:b],
                             translation=v.translation[:b])
        else:
            out[k] = v[:b]
    return out


def _first(opt, module) -> List[float]:
    return [float(torch.linalg.vector_norm(opt.state[p]['exp_avg'].double()))
            if p in opt.state else math.nan
            for _, p in sorted(module.named_parameters())]


@torch.no_grad()
def _changes(module, start) -> List[float]:
    return [float(torch.linalg.vector_norm((p - start[n]).double()))
            for n, p in sorted(module.named_parameters())]


def leaf_gaps(cand: Sequence[float], ref: Sequence[float],
              ref_grad: Sequence[float]) -> np.ndarray:
    """Each leaf's |cand - ref| / max(ref, the median leaf's ref); NaN for
    the leaves left out, whose reference gradient is under a thousandth
    of the median leaf's."""
    ref, cand, ref_grad = (np.asarray(a, dtype=np.float64)
                           for a in (ref, cand, ref_grad))
    grad_med = np.nanmedian(ref_grad)
    keep = np.isfinite(ref_grad) & (ref_grad >= QUIET_LEAF * grad_med)
    med = np.median(ref[keep])
    gaps = np.abs(np.nan_to_num(cand, nan=0.0) - ref) / np.maximum(ref, med)
    return np.where(keep, gaps, np.nan)


def leaf_gap(cand, ref, ref_grad) -> float:
    return float(np.nanmax(leaf_gaps(cand, ref, ref_grad)))


def worst(cand: dict, ref: dict) -> str:
    """The worst loss and the worst leaves, for the run's standard
    error."""
    losses = sorted(((abs(c[t] - v) / max(abs(v), LOSS_FLOOR), f'step {i} {t} '
                      f'{c[t]:.6g} against {v:.6g}')
                     for i, (c, r) in enumerate(zip(cand['losses'],
                                                    ref['losses']))
                     for t, v in r.items()), reverse=True)[:2]
    out = [f'loss {g:.4g} ({what})' for g, what in losses]
    for key, grad, names in (('grad_g', 'grad_g', 'names_g'),
                             ('grad_d', 'grad_d', 'names_d'),
                             ('change_g', 'grad_g', 'names_g'),
                             ('change_ema', 'grad_g', 'names_g'),
                             ('change_d', 'grad_d', 'names_d')):
        gaps = leaf_gaps(cand[key], ref[key], ref[grad])
        i = int(np.nanargmax(gaps))
        out.append(f'{key} {gaps[i]:.4g} at {ref[names][i]} '
                   f'(median leaf {np.nanmedian(gaps):.4g})')
    return '; '.join(out)


def compare(cand: dict, ref: dict) -> Dict[str, float]:
    loss = 0.0
    for c, r in zip(cand['losses'], ref['losses']):
        for tag, value in r.items():
            loss = max(loss, abs(c[tag] - value) / max(abs(value),
                                                       LOSS_FLOOR))
    grad = max(leaf_gap(cand['grad_g'], ref['grad_g'], ref['grad_g']),
               leaf_gap(cand['grad_d'], ref['grad_d'], ref['grad_d']))
    change = max(
        leaf_gap(cand['change_g'], ref['change_g'], ref['grad_g']),
        leaf_gap(cand['change_ema'], ref['change_ema'], ref['grad_g']),
        leaf_gap(cand['change_d'], ref['change_d'], ref['grad_d']))
    return {'loss_gap': loss, 'grad_gap': grad, 'change_gap': change}


def check(s, first: dict, spec: dict, device) -> Tuple[Dict, bool]:
    """Frees the program's state, follows the first three steps in the
    reference and compares. Returns ({name: {'value', 'limit'}},
    correct)."""
    s.free_program()
    ref = follow(s, device, REFERENCE_ROWS)
    numbers = compare(first, ref)
    print('train check:', worst(first, ref), file=sys.stderr, flush=True)
    limits = spec['limits']
    checks = {k: {'value': v, 'limit': limits[k]} for k, v in numbers.items()}
    correct = all(np.isfinite(c['value']) and c['value'] <= c['limit']
                  for c in checks.values())
    return checks, correct
