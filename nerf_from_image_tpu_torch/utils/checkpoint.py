"""Checkpoints in the reference's own `.pth` layout.

GAN checkpoint (reference run.py:1474-1516; the JAX package reads this
layout in `cli/run.py:convert_reference_checkpoint`): `model`,
`model_ema`, `discriminator` (None in the recon modes) and, in dual-D mode
with an encoder, `discriminator2` (state dicts in the reference's keys,
which are the port's module names), `optimizer_g`, `optimizer_d` (torch
Adam state dicts; one `optimizer_d` over D's parameters and then D2's, as
the reference builds it and the JAX package reads it), `iteration`,
`augment_p`, `ppl_running_avg`, `best_fid`
and `random_state` (the state's torch generator and, when given, the
training loop's host state: its numpy RandomState, its batch sampler's
permutation and position, and its latent generator). A reference checkpoint restores through the
same loader, so `--resume_from` takes one loader for its three forms
(`resolve_gan_checkpoint`): `name` (that run's latest), `name+iter` and a
literal `.pth` path.

Encoder checkpoint: the reference encoder file (a state dict under
`state_dict`, which the JAX package's `scripts/convert_weights.py --kind
encoder` reads) with the optimizer, the iteration, the host RandomState
and the batch sampler's state beside it, so that a resumed distillation
draws the same pose batches.

Files are written to a temporary name and moved into place.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from nerf_from_image_tpu_torch.utils import convert


def save(obj: Dict[str, Any], path: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f'{path}.tmp{os.getpid()}'
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load(path: str) -> Dict[str, Any]:
    """A checkpoint dict, every tensor on the CPU."""
    with open(path, 'rb') as f:
        return torch.load(f, map_location='cpu', weights_only=False)


class CheckpointManager:
    """`<directory>/checkpoint_<label>.pth`, for the labels latest, best,
    an iteration, enc_latest and enc_<iteration>."""

    def __init__(self, directory: str):
        self.directory = directory

    def path(self, label: str) -> str:
        return os.path.join(self.directory, f'checkpoint_{label}.pth')

    def exists(self, label: str = 'latest') -> bool:
        return os.path.exists(self.path(label))

    def save(self, obj: Dict[str, Any], label: str = 'latest') -> None:
        save(obj, self.path(label))

    def load(self, label: str = 'latest') -> Dict[str, Any]:
        return load(self.path(label))


def resolve_gan_checkpoint(root_path: str, resume_from: str) -> str:
    """The file of a --resume_from: a literal `.pth` path, `name+iter`
    (`gan_checkpoints/name/checkpoint_<iter>.pth`) or `name`
    (`gan_checkpoints/name/checkpoint_latest.pth`), all under
    `root_path`. Raises FileNotFoundError when it does not exist."""
    if resume_from.endswith('.pth'):
        path = resume_from
    else:
        name, _, label = resume_from.partition('+')
        path = CheckpointManager(os.path.join(
            root_path, 'gan_checkpoints', name)).path(label or 'latest')
    if not os.path.exists(path):
        raise FileNotFoundError(f'checkpoint {resume_from} does not exist '
                                f'({path})')
    return path


def _random_state(generator: torch.Generator,
                  rng_np: Optional[np.random.RandomState],
                  sampler=None,
                  latent_rng: Optional[torch.Generator] = None) -> dict:
    out = {'torch_generator': generator.get_state(),
           'torch_generator_device': generator.device.type}
    if rng_np is not None:
        out['numpy'] = rng_np.get_state()
    if sampler is not None:
        ss = sampler.get_state()
        out['sampler'] = {'perm': ss['perm'], 'pos': ss['pos']}
    if latent_rng is not None:
        out['latent_generator'] = latent_rng.get_state()
        out['latent_generator_device'] = latent_rng.device.type
    return out


def _set_generator(generator: torch.Generator, saved: dict,
                   key: str) -> None:
    """A generator saved on another device type keeps its state (CPU and
    CUDA states differ in form)."""
    if (saved.get(key) is not None and
            saved.get(f'{key}_device') == generator.device.type):
        generator.set_state(saved[key])


def _restore_random_state(saved: Optional[dict], generator: torch.Generator,
                          rng_np: Optional[np.random.RandomState]) -> None:
    """Restores the torch generator and the RandomState that
    `_random_state` saved."""
    if not saved:
        return
    _set_generator(generator, saved, 'torch_generator')
    if rng_np is not None and saved.get('numpy') is not None:
        rng_np.set_state(saved['numpy'])


def restore_loop_state(saved: Optional[dict],
                       rng_np: np.random.RandomState, sampler,
                       latent_rng: torch.Generator) -> None:
    """Restores a training loop's host state from a checkpoint's
    `random_state`; the pieces it lacks (a reference checkpoint has no
    sampler) keep their fresh values."""
    if not saved:
        return
    if saved.get('numpy') is not None:
        rng_np.set_state(saved['numpy'])
    if saved.get('sampler') is not None:
        sampler.set_state(saved['sampler'])
    _set_generator(latent_rng, saved, 'latent_generator')


def _joint_optimizer_state(opts) -> Optional[Dict[str, Any]]:
    """One Adam state dict over the parameters of `opts` (None skipped)
    back to back: the reference's `optimizer_d` over D and D2."""
    opts = [o for o in opts if o is not None]
    if not opts:
        return None
    state, params = {}, []
    for opt in opts:
        sd = opt.state_dict()
        offset = len(params)
        state.update({offset + i: v for i, v in sd['state'].items()})
        params += [offset + i for i in sd['param_groups'][0]['params']]
    group = dict(opts[0].state_dict()['param_groups'][0], params=params)
    return {'state': state, 'param_groups': [group]}


def _split_optimizer_state(saved: Dict[str, Any], opts) -> None:
    """Loads a joint `optimizer_d` (see `_joint_optimizer_state`) into the
    optimizers `opts` (None skipped), each taking its run of indices."""
    opts = [o for o in opts if o is not None]
    offset = 0
    for opt in opts:
        n = len(opt.param_groups[0]['params'])
        group = dict(saved['param_groups'][0], params=list(range(n)))
        state = {}
        for i in range(n):
            entry = saved['state'].get(offset + i,
                                       saved['state'].get(str(offset + i)))
            if entry is not None:
                state[i] = entry
        _load_optimizer(opt, {'state': state, 'param_groups': [group]})
        offset += n


def gan_checkpoint(state, best_fid: Optional[float] = None,
                   rng_np: Optional[np.random.RandomState] = None,
                   sampler=None,
                   latent_rng: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
    """A `train.gan.GANTrainState` in the reference's checkpoint layout,
    with the training loop's host state where given."""
    return {
        'model': state.gen.state_dict(),
        'model_ema': state.gen_ema.state_dict(),
        'discriminator': (None if state.disc is None else
                          state.disc.state_dict()),
        'discriminator2': (None if state.disc2 is None else
                           state.disc2.state_dict()),
        'optimizer_g': state.opt_g.state_dict(),
        'optimizer_d': _joint_optimizer_state((state.opt_d, state.opt_d2)),
        'iteration': state.iteration,
        'augment_p': state.augment_p,
        'ppl_running_avg': (None if state.ppl_running_avg < 0 else
                            state.ppl_running_avg),
        'best_fid': best_fid,
        'random_state': _random_state(state.rng, rng_np, sampler,
                                      latent_rng),
    }


def _load_optimizer(opt: torch.optim.Optimizer, saved: dict) -> None:
    opt.load_state_dict(saved)
    group = opt.param_groups[0]
    if 'count' not in group:
        # A reference optimizer: the warmup count is its step count.
        steps = [s['step'] for s in opt.state.values() if 'step' in s]
        group['count'] = int(steps[0]) if steps else 0


def restore_gan_checkpoint(ckpt: Dict[str, Any], state,
                           rng_np: Optional[np.random.RandomState] = None
                           ) -> Dict[str, Any]:
    """Loads a checkpoint dict (`load` of a port or reference `.pth`) into
    a `GANTrainState` in place: the EMA generator always; G, D, D2 and
    the optimizers where present (`optimizer_d` over D's parameters, then
    D2's); the iteration, ADA p, PPL average and the
    random states. Returns the host state: {'best_fid'} when the
    checkpoint holds one."""
    convert.load_reference_state_dict(state.gen_ema, ckpt['model_ema'])
    if ckpt.get('model') is not None:
        convert.load_reference_state_dict(state.gen, ckpt['model'])
        if ckpt.get('optimizer_g') is not None:
            _load_optimizer(state.opt_g, ckpt['optimizer_g'])
    loaded = []
    for key, module, opt in (('discriminator', state.disc, state.opt_d),
                             ('discriminator2', state.disc2,
                              state.opt_d2)):
        if ckpt.get(key) is not None:
            convert.load_reference_state_dict(module, ckpt[key])
            loaded.append(opt)
    if loaded and ckpt.get('optimizer_d') is not None:
        _split_optimizer_state(ckpt['optimizer_d'], loaded)
    state.iteration = int(ckpt.get('iteration', 0))
    state.augment_p = float(ckpt.get('augment_p') or 0.0)
    ppl = ckpt.get('ppl_running_avg')
    state.ppl_running_avg = -1.0 if ppl is None else float(ppl)
    _restore_random_state(ckpt.get('random_state'), state.rng, rng_np)
    host = {}
    if ckpt.get('best_fid') is not None:
        host['best_fid'] = float(ckpt['best_fid'])
    return host


def encoder_checkpoint(state, rng_np: np.random.RandomState,
                       sampler=None) -> Dict[str, Any]:
    """A `train.encoder.EncoderTrainState` with the host RandomState and
    the batch sampler's (permutation, position)."""
    out = {'state_dict': state.encoder.state_dict(),
           'optimizer': state.opt.state_dict(),
           'iteration': state.iteration,
           'random_state': _random_state(state.rng, rng_np)}
    if sampler is not None:
        ss = sampler.get_state()
        out['sampler'] = {'perm': ss['perm'], 'pos': ss['pos']}
    return out


def restore_encoder_checkpoint(ckpt: Dict[str, Any], state,
                               rng_np: Optional[np.random.RandomState] = None,
                               sampler=None) -> None:
    """Loads an `encoder_checkpoint` into the state in place, with the
    RandomState and the sampler where given."""
    state.encoder.load_state_dict(ckpt['state_dict'])
    if ckpt.get('optimizer') is not None:
        state.opt.load_state_dict(ckpt['optimizer'])
    state.iteration = int(ckpt.get('iteration', 0))
    _restore_random_state(ckpt.get('random_state'), state.rng, rng_np)
    if sampler is not None and ckpt.get('sampler') is not None:
        sampler.set_state(ckpt['sampler'])


def encoder_state_dict(ckpt: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The encoder weights of an encoder checkpoint or of the reference's
    encoder file (a bare state dict or one under `state_dict`, keys
    optionally 'module.'-prefixed)."""
    sd = ckpt.get('state_dict', ckpt)
    if sd and all(k.startswith('module.') for k in sd):
        sd = {k[len('module.'):]: v for k, v in sd.items()}
    return {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
            else v for k, v in sd.items()}
