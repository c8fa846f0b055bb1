"""The port's checkpoints (`utils/checkpoint.py`) and published-weight
loaders (`utils/weights.py`).

- A GAN train state round-trips through the reference's `.pth` layout:
  weights, the EMA, D, both Adam states (moments, steps and the warmup
  count), iteration, ADA p, best FID and the random states, exactly.
- The three --resume_from forms reach the same file and state.
- A reference-format `.pth` restored by the port gives the generator that
  the JAX package's `cli/run.convert_reference_checkpoint` builds from
  it: the same weights (exactly, through `from_jax_params`), the same EMA
  render on the port (1e-5), and JAX's own map and synthesis of those
  weights within the render test's float32 tolerances (1e-4, 2e-4).
- An encoder checkpoint restores the weights, the Adam state, the
  iteration, the torch generator, the host RandomState and the batch
  sampler's state, so the next draws are those of an uninterrupted run.
- The MiT-B5 graft, the LPIPS and Inception loaders and their fallbacks.

A tiny generator (latent 16, 32^2 planes, channel_base 1024, four
attention values) and a tiny SegFormer keep it quick, on the CPU.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.cli import run as jax_run
from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.train import gan as jax_gan
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.render.renderer import render
from nerf_from_image_tpu_torch.train import encoder as enc_lib
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import checkpoint
from nerf_from_image_tpu_torch.utils import convert
from nerf_from_image_tpu_torch.utils import weights
from nerf_from_image_tpu_torch.utils.io import EndlessSampler

CFG = gan.GANConfig(resolution=16, latent_dim=16, depth_samples_per_ray=4,
                    attention_values=4, plane_resolution=32,
                    channel_base=1024, channel_max=64)
TINY = dict(depths=(1, 1, 1, 1), embed_dims=(8, 8, 16, 16),
            num_heads=(1, 1, 2, 2), sr_ratios=(2, 1, 1, 1), head_width=16)
EMA_RENDER_TOL = 1e-5


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's directory, removed after it: its checkpoints are large."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _trained_state(seed=0):
    """A state whose optimizers hold moments from two steps on random
    gradients, with the scalars away from their initial values."""
    state = gan.init_train_state(CFG, device='cpu', seed=seed)
    rng = torch.Generator().manual_seed(seed + 7)
    for module, opt in ((state.gen, state.opt_g), (state.disc, state.opt_d)):
        for _ in range(2):
            for p in module.parameters():
                p.grad = torch.randn(p.shape, generator=rng)
            opt.step()
            opt.param_groups[0]['count'] += 1
    with torch.no_grad():
        for p in state.gen_ema.parameters():
            p.add_(0.01)
    torch.randn(5, generator=state.rng)
    state.iteration, state.augment_p, state.ppl_running_avg = 12, 0.25, -1.0
    return state


def _assert_states_equal(a, b):
    for ma, mb in ((a.gen, b.gen), (a.gen_ema, b.gen_ema),
                   (a.disc, b.disc)):
        sa, sb = ma.state_dict(), mb.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for oa, ob in ((a.opt_g, b.opt_g), (a.opt_d, b.opt_d)):
        assert oa.param_groups[0]['count'] == ob.param_groups[0]['count']
        assert oa.param_groups[0]['lr'] == ob.param_groups[0]['lr']
        sa, sb = oa.state_dict()['state'], ob.state_dict()['state']
        assert sa.keys() == sb.keys()
        for k in sa:
            for name in ('step', 'exp_avg', 'exp_avg_sq'):
                assert torch.equal(sa[k][name], sb[k][name]), (k, name)
    assert (a.iteration, a.augment_p, a.ppl_running_avg) == (
        b.iteration, b.augment_p, b.ppl_running_avg)
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


def test_gan_checkpoint_round_trip(tmp_path):
    state = _trained_state()
    rng_np = np.random.RandomState(3)
    rng_np.rand(4)
    path = str(tmp_path / 'checkpoint_latest.pth')
    checkpoint.save(checkpoint.gan_checkpoint(state, best_fid=31.5,
                                              rng_np=rng_np), path)
    fresh = gan.init_train_state(CFG, device='cpu', seed=1)
    fresh_np = np.random.RandomState(0)
    host = checkpoint.restore_gan_checkpoint(checkpoint.load(path), fresh,
                                             fresh_np)
    assert host == {'best_fid': 31.5}
    _assert_states_equal(fresh, state)
    np.testing.assert_array_equal(fresh_np.rand(3), rng_np.rand(3))
    # The next Adam step continues both trajectories alike.
    for s in (state, fresh):
        for p in s.gen.parameters():
            p.grad = torch.ones_like(p)
        s.opt_g.step()
    _assert_states_equal(fresh, state)


def test_resume_forms_reach_the_same_state(tmp_path):
    state = _trained_state()
    ckpt = checkpoint.gan_checkpoint(state, best_fid=9.0)
    manager = checkpoint.CheckpointManager(
        str(tmp_path / 'gan_checkpoints' / 'run_a'))
    manager.save(ckpt, 'latest')
    manager.save(ckpt, '12')
    literal = str(tmp_path / 'elsewhere.pth')
    checkpoint.save(ckpt, literal)
    paths = [checkpoint.resolve_gan_checkpoint(str(tmp_path), form)
             for form in ('run_a', 'run_a+12', literal)]
    assert paths == [manager.path('latest'), manager.path('12'), literal]
    for path in paths:
        fresh = gan.init_train_state(CFG, device='cpu', seed=2)
        assert checkpoint.restore_gan_checkpoint(
            checkpoint.load(path), fresh) == {'best_fid': 9.0}
        _assert_states_equal(fresh, state)
    for missing in ('run_b', 'run_a+13', str(tmp_path / 'none.pth')):
        with pytest.raises(FileNotFoundError):
            checkpoint.resolve_gan_checkpoint(str(tmp_path), missing)


def test_reference_optimizer_gets_its_warmup_count(tmp_path):
    """A reference optimizer state dict has no warmup 'count': it is
    taken from Adam's step count."""
    state = _trained_state()
    ckpt = checkpoint.gan_checkpoint(state)
    for key in ('optimizer_g', 'optimizer_d'):
        del ckpt[key]['param_groups'][0]['count']
    fresh = gan.init_train_state(CFG, device='cpu', seed=1)
    checkpoint.restore_gan_checkpoint(ckpt, fresh)
    assert fresh.opt_g.param_groups[0]['count'] == 2
    assert fresh.opt_d.param_groups[0]['count'] == 2


class _Args:
    attention_values = CFG.attention_values
    use_viewdir = False
    use_sdf = True


def test_reference_pth_gives_jax_converted_ema(tmp_path):
    state = _trained_state()
    path = str(tmp_path / 'reference.pth')
    checkpoint.save(checkpoint.gan_checkpoint(state, best_fid=4.0), path)
    ckpt = checkpoint.load(path)

    port = gan.init_train_state(CFG, device='cpu', seed=5)
    checkpoint.restore_gan_checkpoint(ckpt, port)

    jcfg = jax_gan.GANConfig(
        resolution=CFG.resolution, latent_dim=CFG.latent_dim,
        depth_samples_per_ray=4, attention_values=CFG.attention_values,
        plane_resolution=CFG.plane_resolution,
        channel_base=CFG.channel_base, channel_max=CFG.channel_max,
        use_pallas=False, batch_size=4)
    jstate = jax.jit(lambda k: jax_gan.init_train_state(k, jcfg))(
        jax.random.PRNGKey(0))
    jstate, host = jax_run.convert_reference_checkpoint(ckpt, _Args, jstate)
    assert host == {'best_fid': 4.0}
    assert int(jstate.iteration) == 12

    variables = jax.tree_util.tree_map(np.asarray,
                                       jax.device_get(jstate.ema_params_g))
    from_jax = gan.make_models(CFG, device='cpu')[0]
    convert.load_reference_state_dict(from_jax,
                                      convert.from_jax_params(variables))
    own = port.gen_ema.state_dict()
    for key, value in from_jax.state_dict().items():
        if not key.endswith(('noise_strength', 'noise_const')):
            assert torch.equal(value, own[key]), key

    z = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, CFG.latent_dim)).astype(np.float32))
    cam = torch.eye(4).repeat(2, 1, 1)
    cam[:, 2, 3] = 2.0
    cam[1, 0, 3] = 0.15
    focal = torch.full((2,), 1.2)

    def ema_render(g):
        with torch.no_grad():
            st = g.synthesize(g.map(z))
            return render(g.field(st), 16, 16,
                          cam, focal, CFG.scene_range, True, 4)

    a, b = ema_render(port.gen_ema), ema_render(from_jax)
    for key in ('rgb', 'mask', 'depth'):
        np.testing.assert_allclose(getattr(a, key).numpy(),
                                   getattr(b, key).numpy(),
                                   rtol=EMA_RENDER_TOL, atol=EMA_RENDER_TOL)

    jgen = JaxGenerator(latent_dim=CFG.latent_dim, scene_range=0.55,
                        attention_values=CFG.attention_values,
                        img_resolution=CFG.plane_resolution,
                        channel_base=CFG.channel_base,
                        channel_max=CFG.channel_max)
    ws = jgen.apply(variables, jnp.asarray(z.numpy()),
                    method=JaxGenerator.map)
    planes = jgen.apply(variables, ws, method=JaxGenerator.synthesize).planes
    with torch.no_grad():
        pws = port.gen_ema.map(z)
        pplanes = port.gen_ema.synthesize(pws).planes
    np.testing.assert_allclose(pws.numpy(), np.asarray(ws), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pplanes.numpy(), np.asarray(planes),
                               rtol=2e-4, atol=2e-4)


def _tiny_generator():
    gen = gan.make_models(CFG, device='cpu', seed=4)[0]
    with torch.no_grad():
        gen.decoder.net[2].bias[0] -= 1.5  # a surface inside the box
    return gen.requires_grad_(False)


def _encoder_run(state, gen, sampler, rng_np, steps, poses):
    cfg = enc_lib.EncoderConfig(resolution=32, latent_dim=16,
                                depth_samples_per_ray=4)
    losses = []
    for _ in range(steps):
        idx = sampler(2)
        batch = {'pose': poses[idx], 'focal': torch.full((2,), 1.2)}
        losses.append(enc_lib.train_step(state, batch, gen, cfg))
        rng_np.rand()  # the host RandomState moves on between steps too
    return losses


def test_encoder_checkpoint_resume_restores_sampler_and_rng(tmp_path):
    gen = _tiny_generator()
    poses = torch.eye(4).repeat(5, 1, 1)
    poses[:, 2, 3] = 2.0
    poses[:, 0, 3] = torch.linspace(-0.2, 0.2, 5)

    def fresh():
        encoder = BootstrapEncoder(512, device='cpu', **TINY)
        encoder.load_state_dict({k: torch.from_numpy(v) for k, v in
                                 convert.random_encoder_state_dict(
                                     1, **TINY).items()})
        rng_np = np.random.RandomState(1234)
        return (enc_lib.init_train_state(encoder, seed=99),
                EndlessSampler(5, rng_np), rng_np)

    state, sampler, rng_np = fresh()
    straight = _encoder_run(state, gen, sampler, rng_np, 4, poses)

    state, sampler, rng_np = fresh()
    _encoder_run(state, gen, sampler, rng_np, 3, poses)
    manager = checkpoint.CheckpointManager(str(tmp_path))
    manager.save(checkpoint.encoder_checkpoint(state, rng_np, sampler),
                 'enc_latest')
    state, sampler, rng_np = fresh()
    checkpoint.restore_encoder_checkpoint(manager.load('enc_latest'), state,
                                          rng_np, sampler)
    assert state.iteration == 3
    resumed = _encoder_run(state, gen, sampler, rng_np, 1, poses)
    for key, value in straight[3].items():
        assert torch.equal(resumed[0][key], value), key
    # The reference encoder file's form, as the JAX converter reads it.
    sd = checkpoint.encoder_state_dict(
        {'state_dict': {f'module.{k}': v for k, v in
                        state.encoder.state_dict().items()}})
    assert sd.keys() == state.encoder.state_dict().keys()


def test_mit_graft_and_weight_loaders(tmp_path, capsys):
    encoder = BootstrapEncoder(16, separate_backbones=True, device='cpu',
                               **TINY)
    backbone = {k[len('backbone.'):]: v for k, v in
                convert.random_encoder_state_dict(3, 16, **TINY).items()
                if k.startswith('backbone.') and 'linear_' not in k}
    backbone['head.weight'] = np.zeros((10, 16), np.float32)
    wdir = tmp_path / 'weights'
    wdir.mkdir()
    torch.save({'state_dict': {k: torch.from_numpy(v) for k, v in
                               backbone.items()}},
               str(wdir / weights.MIT_FILE))
    decode_before = encoder.backbone.linear_fuse.weight.clone()
    assert weights.load_mit_backbone(encoder, str(tmp_path))
    for name in ('backbone', 'backbone_latent'):
        own = getattr(encoder, name).state_dict()
        for key, value in backbone.items():
            if key != 'head.weight':
                np.testing.assert_array_equal(own[key].numpy(), value)
    assert torch.equal(encoder.backbone.linear_fuse.weight, decode_before)
    with pytest.raises(ValueError, match='do not fit'):
        weights.graft_mit_backbone(encoder, {'norm1.weight': np.zeros(3)})
    with pytest.raises(ValueError, match='matched no'):
        weights.graft_mit_backbone(encoder, {'head.weight': np.zeros(3)})

    assert not weights.load_mit_backbone(encoder, str(tmp_path / 'none'))
    assert weights.load_inception(str(tmp_path), 'cpu') is None
    lpips = weights.load_lpips(str(tmp_path), 'cpu')
    assert 'FID reporting disabled' in capsys.readouterr().out

    vgg, lin = convert.random_lpips_state_dicts(2)
    for name, sd in zip(weights.LPIPS_FILES, (vgg, lin)):
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   str(wdir / name))
    torch.save({k: torch.from_numpy(v) for k, v in
                convert.random_inception_state_dict(1).items()},
               str(wdir / weights.INCEPTION_FILE))
    lpips = weights.load_lpips(str(tmp_path), 'cpu')
    np.testing.assert_array_equal(lpips.state_dict()['features.0.weight'],
                                  vgg['features.0.weight'])
    inception = weights.load_inception(str(tmp_path), 'cpu')
    assert inception is not None and not inception.training
