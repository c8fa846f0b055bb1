"""SDF pretraining in the port against the JAX package and the reference
tape.

A small generator (latent 32, 64^2 planes, narrow channels, four
attention values) from one seeded JAX init feeds both packages through
`from_jax_params`; the stratified draws and latents come from numpy and
are injected into both. JAX runs its XLA decode (`use_pallas=False`), the
port the gather sampler, both in float32 on the CPU. The reference tape
`tests/golden/trajectory_pretrain.npz` is replayed through the port with
no JAX call, as `tests/test_pretrain_trajectory.py` replays it through
the JAX package. Tolerances are stated per check.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.train import gan as jax_gan
from nerf_from_image_tpu.train import pretrain as jax_pretrain
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.train import pretrain
from nerf_from_image_tpu_torch.utils import convert

GOLDEN = (pathlib.Path(__file__).parent / 'golden' /
          'trajectory_pretrain.npz')
BATCH, LATENT, STEPS = 2, 32, 3
CFG = dict(latent_dim=LATENT, scene_range=1.4, attention_values=4,
           plane_resolution=64, channel_base=1024, channel_max=64,
           batch_size=BATCH)
LR, EIKONAL = 0.0025, 0.1
N = pretrain.NSTRATA - 1


def _rel(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.fixture(scope='module')
def case():
    """A seeded JAX init, the port's GAN state holding the same weights,
    and per-step numpy draws."""
    jcfg = jax_gan.GANConfig(use_pallas=False, **CFG)
    jgen, _ = jax_gan.make_models(jcfg)
    variables = jax.jit(jgen.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((BATCH, LATENT)))
    variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    cfg = gan.GANConfig(**CFG)
    state = gan.init_train_state(cfg, device='cpu', seed=0)
    sd = convert.from_jax_params(variables)
    convert.load_reference_state_dict(state.gen, sd)
    convert.load_reference_state_dict(state.gen_ema, sd)
    rng = np.random.default_rng(3)
    injected = {'z': rng.standard_normal((STEPS, BATCH, LATENT)),
                'strata': rng.random((STEPS, BATCH, N, N, N, 3))}
    injected = {k: v.astype(np.float32) for k, v in injected.items()}
    return dict(jcfg=jcfg, jgen=jgen, variables=variables, cfg=cfg,
                state=state, injected=injected, init_sd=sd)


def test_distance_and_eikonal_losses_match_jax(case):
    """`sdf_losses(('sdf_distance_loss', 'sdf_eikonal_loss'), 32)` on the
    same planes and strata, within 1e-5; the distance loss alone gives
    the same value as beside the eikonal loss, whose decode it reuses."""
    gen, jgen, variables = case['state'].gen, case['jgen'], case['variables']
    z = case['injected']['z'][0]
    strata = case['injected']['strata'][0]
    ref = jax.jit(lambda z, s: jgen.apply(
        variables, jgen.apply(variables, jgen.apply(
            variables, z, method=JaxGenerator.map)[:, :14],
            method=JaxGenerator.synthesize_planes),
        {'strata': s}, pretrain.REQUESTS, 32,
        method=JaxGenerator.sdf_losses))(jnp.asarray(z), jnp.asarray(strata))
    planes = pretrain.sdf_planes(gen, torch.tensor(z))
    out = gen.sdf_losses(planes, {'strata': torch.tensor(strata)},
                         pretrain.REQUESTS, 32)
    for key in pretrain.REQUESTS:
        assert out[key].shape == (BATCH,)
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), rtol=1e-5,
                                   atol=1e-5)
    alone = gen.sdf_losses(planes, {'strata': torch.tensor(strata)},
                           ('sdf_distance_loss',), 32)
    torch.testing.assert_close(alone['sdf_distance_loss'],
                               out['sdf_distance_loss'], rtol=0, atol=0)


@pytest.fixture(scope='module')
def pretrained(case):
    jstate = jax_gan.GANTrainState(
        params_g=jax.tree_util.tree_map(jnp.asarray, case['variables']),
        params_d={}, ema_params_g=None, opt_g=None, opt_d=None,
        iteration=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
        augment_p=jnp.zeros(()), ppl_running_avg=jnp.asarray(-1.0))
    jstate, (jdist, jeik) = jax_pretrain.pretrain_sdf(
        jstate, case['jcfg'], None, eikonal_weight=EIKONAL, lr=LR,
        n_steps=STEPS,
        injected={k: jnp.asarray(v) for k, v in case['injected'].items()},
        return_losses=True)
    state = case['state']
    state, (dist, eik) = pretrain.pretrain_sdf(
        state, case['cfg'], EIKONAL, LR, n_steps=STEPS,
        injected={k: torch.tensor(v) for k, v in case['injected'].items()},
        return_losses=True)
    return dict(state=state, dist=dist, eik=eik,
                jparams=convert.from_jax_params(
                    jax.device_get(jstate.params_g)),
                jema=convert.from_jax_params(
                    jax.device_get(jstate.ema_params_g)),
                jdist=np.asarray(jdist), jeik=np.asarray(jeik))


@pytest.mark.parametrize('which', ['dist', 'eik'])
def test_pretrain_losses_match_jax(pretrained, which):
    """The per-step distance and eikonal losses of three steps, within
    1e-4 relative."""
    got = pretrained[which].numpy()
    ref = pretrained['j' + which]
    assert got.shape == ref.shape == (STEPS,)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


@pytest.mark.parametrize('which', ['gen', 'gen_ema'])
def test_pretrained_parameters_match_jax(case, pretrained, which):
    """Every parameter after three Adam steps, and the EMA copied from
    them, within 1e-3 of each tensor's largest entry: both sides sum in
    float32 in another order, and Adam moves an entry by about lr per
    step whatever its gradient's size. The decoder and the synthesis
    moved; the palette mapper, which no loss reads, did not."""
    port = getattr(pretrained['state'], which).state_dict()
    ref = pretrained['jparams' if which == 'gen' else 'jema']
    for key, value in ref.items():
        got = port[key].numpy()
        assert _rel(got, value) < 1e-3, (key, _rel(got, value))
    init = case['init_sd']
    for key in ('decoder.net.0.weight', 'mapping_network.backbone.fc0.weight',
                'synthesis_network.b64.torgb.weight'):
        assert not np.array_equal(port[key].numpy(), init[key]), key
    np.testing.assert_array_equal(port['texture_mapper.fc1.weight'].numpy(),
                                  init['texture_mapper.fc1.weight'])


def test_ema_is_a_copy_of_the_parameters(pretrained):
    """EMA <- params by value: equal, in their own storage, and a later
    change to G leaves the EMA where it was."""
    state = pretrained['state']
    pairs = list(zip(state.gen.parameters(), state.gen_ema.parameters()))
    for p, e in pairs:
        assert torch.equal(p, e)
        assert p.data_ptr() != e.data_ptr()
    p, e = pairs[0]
    before = e.detach().clone()
    with torch.no_grad():
        p.add_(1.0)
        try:
            assert torch.equal(e, before)
        finally:
            p.sub_(1.0)


def test_pretrain_draws_from_an_explicit_generator(case):
    """Without injected draws, z and the strata come from the generator
    passed in: two runs from the same state and seed agree bit for bit,
    and the losses are finite."""
    import copy
    losses = []
    for _ in range(2):
        state = copy.deepcopy(case['state'])
        _, (dist, eik) = pretrain.pretrain_sdf(
            state, case['cfg'], EIKONAL, LR, n_steps=1, return_losses=True,
            generator=torch.Generator().manual_seed(5))
        losses.append((dist, eik))
    assert torch.isfinite(losses[0][0]).all()
    assert torch.equal(losses[0][0], losses[1][0])
    assert torch.equal(losses[0][1], losses[1][1])


# --- the reference tape, replayed with no JAX -------------------------------

def _regen(entry):
    """A substituted draw, regenerated from its recorded seed."""
    r = np.random.RandomState(entry['seed'])
    shape = tuple(entry['shape'])
    vals = (r.random_sample(shape) if entry['kind'] == 'rand'
            else r.standard_normal(shape))
    return torch.tensor(vals.astype(np.float32))


def _tape_injected(tape, n_steps):
    """The first `n_steps` steps' draws: z (run.py:pretrain_sdf), then its
    strata (ops.py:sample_volume_stratified); no perturbation, as the
    pretraining requests none."""
    zs, strata = [], []
    for e in tape:
        if e['site'] == 'run.py:pretrain_sdf' and e['kind'] == 'randn':
            if len(zs) < n_steps:
                zs.append(_regen(e))
        elif (e['site'] == 'ops.py:sample_volume_stratified' and
              len(strata) < len(zs)):
            strata.append(_regen(e))
        if len(zs) >= n_steps and len(strata) >= n_steps:
            break
    assert len(zs) == len(strata) == n_steps
    return {'z': torch.stack(zs), 'strata': torch.stack(strata)}


def _print_pairs(tape):
    """{step: (dist, eik)} of the reference's prints, every 100 steps."""
    out, step = {}, 0
    for e in tape:
        if e.get('kind') == 'print' and e.get('label') == 'dist':
            out[step * 100] = tuple(e['values'][:2])
            step += 1
    return out


def _tape_state():
    d = np.load(GOLDEN)
    cfg_ref = json.loads(str(d['config_json']))
    tape = json.loads(str(d['tape_json']))
    cfg = gan.GANConfig(
        resolution=cfg_ref['resolution'], latent_dim=cfg_ref['latent_dim'],
        scene_range=cfg_ref['scene_range'],
        white_background=cfg_ref['white_background'], attention_values=10,
        eikonal=cfg_ref['eikonal'], lr_g=cfg_ref['lr_g'],
        batch_size=cfg_ref['batch_size'], plane_resolution=256,
        channel_base=cfg_ref['channel_base'],
        channel_max=cfg_ref['channel_max'])
    state = gan.init_train_state(cfg, device='cpu', seed=0)
    g_sd = {k[len('init_g/'):]: d[k] for k in d.files
            if k.startswith('init_g/')}
    convert.load_reference_state_dict(state.gen, g_sd)
    convert.load_reference_state_dict(state.gen_ema, g_sd)
    return cfg, state, tape


@pytest.mark.skipif(not GOLDEN.exists(), reason='pretrain tape missing')
def test_tape_step_0_matches_reference():
    """The reference's step-0 print pair (dist, eik), from the first
    step's injected z and strata, within rtol 1e-4 as
    `tests/test_pretrain_trajectory.py` holds the JAX package."""
    cfg, state, tape = _tape_state()
    prints = _print_pairs(tape)
    _, (dist, eik) = pretrain.pretrain_sdf(
        state, cfg, cfg.eikonal, cfg.lr_g, n_steps=1,
        injected=_tape_injected(tape, 1), return_losses=True)
    np.testing.assert_allclose(float(dist[0]), prints[0][0], rtol=1e-4)
    np.testing.assert_allclose(float(eik[0]), prints[0][1], rtol=1e-4)


@pytest.mark.slow
@pytest.mark.skipif(not GOLDEN.exists(), reason='pretrain tape missing')
def test_tape_full_trajectory_matches_reference():
    """All 1000 steps: every 100-step print pair, rtol 1e-4 at step 0 and
    the JAX package's replay band after (2e-3), and the EMA equal to the
    parameters at the end. Every pair's relative error is reported."""
    cfg, state, tape = _tape_state()
    prints = _print_pairs(tape)
    n = pretrain.PRETRAIN_STEPS
    state, (dist, eik) = pretrain.pretrain_sdf(
        state, cfg, cfg.eikonal, cfg.lr_g, n_steps=n,
        injected=_tape_injected(tape, n), return_losses=True)
    assert len(prints) == 10
    errors = {}
    for step, (dref, eref) in sorted(prints.items()):
        errors[step] = (abs(float(dist[step]) - dref) / abs(dref),
                        abs(float(eik[step]) - eref) / abs(eref))
    print('relative errors (dist, eik) by step:', errors)
    for step, (d_err, e_err) in errors.items():
        rtol = 1e-4 if step == 0 else 2e-3
        assert d_err <= rtol and e_err <= rtol, (step, errors)
    for p, e in zip(state.gen.parameters(), state.gen_ema.parameters()):
        assert torch.equal(p, e)
