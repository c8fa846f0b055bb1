#!/usr/bin/env python3
"""How far replays of the reference's SDF pretraining drift from each
other, as a yardstick for the slow replays
(`tests/test_torch_port_pretrain.py::
test_tape_full_trajectory_matches_reference` and the JAX package's
`tests/test_pretrain_trajectory.py::
test_pretrain_full_trajectory_matches_reference`, both held to 2e-3 of
the reference's prints after step 0).

Replays `tests/golden/trajectory_pretrain.npz` (injected z and strata)
on the CPU four times, each in its own process: the JAX package's
`pretrain_sdf` and the port's, each from the reference's initial weights
and from the same weights times (1 + 1.2e-7), about one float32 ulp.
Every run keeps its (dist, eik) at every step. Prints, at each of the
reference's 100-step prints, each run's relative distance from the
reference's pair; then, for each 100-step window, the largest relative
distance of the port from JAX and of each package's perturbed run from
its exact one; and the first step at which each of those pairs parts by
more than 1e-5. The arrays go to `build/probes/pretrain_drift.npz`.

A term that differs between the packages parts the port from JAX from
the first steps on; float32 rounding parts them as the one-ulp
perturbation parts each package from itself.

Needs JAX and the JAX package beside the port (the CPU machine of the
tests, not the card's). The four runs at 2 threads each take about
an hour on 8 CPU cores.

    python3 probes/pretrain_drift.py [--steps 1000]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / 'tests' / 'golden' / 'trajectory_pretrain.npz'
OUT = REPO / 'build' / 'probes' / 'pretrain_drift.npz'
ULP = 1.2e-7
THREADS = 2
PARTED = 1e-5
RUNS = (('jax', 1.0), ('jax', 1.0 + ULP), ('torch', 1.0),
        ('torch', 1.0 + ULP))


def _regen(entry):
    r = np.random.RandomState(entry['seed'])
    shape = tuple(entry['shape'])
    vals = (r.random_sample(shape) if entry['kind'] == 'rand'
            else r.standard_normal(shape))
    return vals.astype(np.float32)


def _tape(n: int):
    """(reference config, initial G weights, z (n, B, L), strata (n, ...),
    the reference's {step: (dist, eik)})."""
    d = np.load(GOLDEN)
    cfg_ref = json.loads(str(d['config_json']))
    tape = json.loads(str(d['tape_json']))
    g_sd = {k[len('init_g/'):]: d[k] for k in d.files
            if k.startswith('init_g/')}
    zs, strata, prints = [], [], {}
    for e in tape:
        if e['site'] == 'run.py:pretrain_sdf' and e['kind'] == 'randn':
            if len(zs) < n:
                zs.append(_regen(e))
        elif (e['site'] == 'ops.py:sample_volume_stratified' and
              len(strata) < len(zs)):
            strata.append(_regen(e))
        elif e.get('kind') == 'print' and e.get('label') == 'dist':
            prints[100 * len(prints)] = tuple(e['values'][:2])
    return cfg_ref, g_sd, np.stack(zs[:n]), np.stack(strata[:n]), prints


def _replay_jax(scale: float, n: int):
    os.environ['JAX_PLATFORMS'] = 'cpu'
    os.environ['XLA_FLAGS'] = (
        f'--xla_cpu_multi_thread_eigen=true '
        f'intra_op_parallelism_threads={THREADS}')
    import jax
    import jax.numpy as jnp
    from nerf_from_image_tpu.train import gan as gan_lib
    from nerf_from_image_tpu.train import pretrain as pretrain_lib
    from nerf_from_image_tpu.utils import torch_convert as tc
    cfg_ref, g_sd, zs, strata, _ = _tape(n)
    # The fields pretraining reads, as tests/test_pretrain_trajectory.py
    # sets them.
    cfg = gan_lib.GANConfig(
        resolution=cfg_ref['resolution'], latent_dim=cfg_ref['latent_dim'],
        depth_samples_per_ray=64, fine_sampling=True,
        scene_range=cfg_ref['scene_range'],
        white_background=cfg_ref['white_background'], camera_flipped=False,
        supervise_alpha=False, conditional_pose=True, use_sdf=True,
        attention_values=10, eikonal=cfg_ref['eikonal'],
        lr_g=cfg_ref['lr_g'], lr_d=cfg_ref['lr_d'],
        batch_size=cfg_ref['batch_size'], use_pallas=False,
        plane_resolution=256, channel_base=cfg_ref['channel_base'],
        channel_max=cfg_ref['channel_max'])
    params_g = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a) * jnp.float32(scale),
        tc.convert_generator(g_sd, attention_values=10, use_viewdir=False,
                             use_sdf=True))
    opt_g, opt_d = gan_lib.make_optimizers(cfg)
    state = gan_lib.GANTrainState(
        params_g=params_g, params_d={}, ema_params_g=params_g,
        opt_g=opt_g.init(params_g), opt_d=opt_d.init({}),
        iteration=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
        augment_p=jnp.zeros(()), ppl_running_avg=jnp.asarray(-1.0))
    _, (dist, eik) = pretrain_lib.pretrain_sdf(
        state, cfg, None, eikonal_weight=cfg.eikonal, lr=cfg.lr_g,
        n_steps=n, injected={'z': jnp.asarray(zs),
                             'strata': jnp.asarray(strata)},
        return_losses=True)
    return np.asarray(dist, np.float64), np.asarray(eik, np.float64)


def _replay_torch(scale: float, n: int):
    import torch
    from nerf_from_image_tpu_torch.train import gan, pretrain
    from nerf_from_image_tpu_torch.utils import convert
    torch.set_num_threads(THREADS)
    cfg_ref, g_sd, zs, strata, _ = _tape(n)
    cfg = gan.GANConfig(
        resolution=cfg_ref['resolution'], latent_dim=cfg_ref['latent_dim'],
        scene_range=cfg_ref['scene_range'],
        white_background=cfg_ref['white_background'], attention_values=10,
        eikonal=cfg_ref['eikonal'], lr_g=cfg_ref['lr_g'],
        batch_size=cfg_ref['batch_size'], plane_resolution=256,
        channel_base=cfg_ref['channel_base'],
        channel_max=cfg_ref['channel_max'])
    state = gan.init_train_state(cfg, device='cpu', seed=0)
    convert.load_reference_state_dict(state.gen, g_sd)
    with torch.no_grad():
        for p in state.gen.parameters():
            p.mul_(scale)
    _, (dist, eik) = pretrain.pretrain_sdf(
        state, cfg, cfg.eikonal, cfg.lr_g, n_steps=n,
        injected={'z': torch.tensor(zs), 'strata': torch.tensor(strata)},
        return_losses=True)
    return dist.double().numpy(), eik.double().numpy()


def replay(run) -> np.ndarray:
    """(n, 2) per-step (dist, eik) of one run: (package, scale, steps)."""
    sys.path.insert(0, str(REPO))
    package, scale, n = run
    dist, eik = (_replay_jax if package == 'jax' else _replay_torch)(
        scale, n)
    return np.stack([dist, eik], axis=1)


def _rel(a: np.ndarray, ref: np.ndarray) -> np.ndarray:
    return np.abs(a - ref) / np.abs(ref)


def _first_parted(err: np.ndarray):
    hits = np.nonzero(err.max(axis=1) > PARTED)[0]
    return int(hits[0]) if len(hits) else None


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=1000)
    n = parser.parse_args().steps
    ctx = multiprocessing.get_context('spawn')
    with concurrent.futures.ProcessPoolExecutor(len(RUNS),
                                                mp_context=ctx) as pool:
        jax0, jax1, torch0, torch1 = pool.map(
            replay, [(p, s, n) for p, s in RUNS])
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez(OUT, jax=jax0, jax_ulp=jax1, torch=torch0, torch_ulp=torch1)
    pairs = {'torch_vs_jax': _rel(torch0, jax0),
             'jax_ulp_vs_jax': _rel(jax1, jax0),
             'torch_ulp_vs_torch': _rel(torch1, torch0)}
    _, _, _, _, prints = _tape(n)
    for step, ref in sorted(prints.items()):
        if step >= n:
            break
        ref = np.asarray(ref)
        print(json.dumps({'step': step, **{
            f'{name}_vs_ref': _rel(run[step], ref).tolist()
            for name, run in (('jax', jax0), ('jax_ulp', jax1),
                              ('torch', torch0), ('torch_ulp', torch1))}}))
    for lo in range(0, n, 100):
        print(json.dumps({'steps': [lo, min(lo + 100, n) - 1], **{
            name: err[lo:lo + 100].max(axis=0).tolist()
            for name, err in pairs.items()}}))
    print(json.dumps({'first_step_parted_by_1e-5': {
        name: _first_parted(err) for name, err in pairs.items()}}))


if __name__ == '__main__':
    main()
