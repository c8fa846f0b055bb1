"""The port's StyleGAN2 and generator modules against the JAX package and
the reference's own outputs.

One reference-format state dict feeds both packages: the port loads it
with `load_state_dict`, the JAX package through `utils/torch_convert.py`.
The `weight_golden.npz` anchors are reference modules' state dicts and
outputs; the port loads those keys unchanged. Everything runs in float32
on the CPU. Tolerance 1e-4 (2e-4 for the synthesis network, whose eight
stacked convolutions accumulate more float32 sum-order drift).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.models import generator as jax_gen
from nerf_from_image_tpu.models import stylegan as jax_sg
from nerf_from_image_tpu.utils import torch_convert as tc
from nerf_from_image_tpu_torch.models import generator
from nerf_from_image_tpu_torch.models import stylegan
from nerf_from_image_tpu_torch.utils import convert

GOLDEN = pathlib.Path(__file__).parent / 'golden'


def _close(port, ref, tol=1e-4):
    if isinstance(port, torch.Tensor):
        port = port.detach()
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _seeded(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope='module')
def wg():
    return np.load(GOLDEN / 'weight_golden.npz')


def _golden_sd(wg, tag):
    pre = f'{tag}.sd.'
    return {k[len(pre):]: torch.tensor(wg[k]) for k in wg.files
            if k.startswith(pre)}


@pytest.mark.parametrize('up,demodulate', [(False, True), (True, True),
                                           (False, False)])
def test_conv_modulated2d(up, demodulate):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 8, 8)).astype(np.float32)
    w = rng.standard_normal((5, 6, 3, 3)).astype(np.float32)
    styles = rng.standard_normal((2, 6)).astype(np.float32)
    port = stylegan.conv_modulated2d(torch.tensor(x), torch.tensor(w),
                                     torch.tensor(styles), up=up, padding=1,
                                     demodulate=demodulate)
    ref = jax_sg.conv_modulated2d(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(styles), up=up, padding=1,
                                  demodulate=demodulate)
    _close(port, ref)


def test_conv_modulated2d_golden():
    g = np.load(GOLDEN / 'core_golden.npz')
    args = [torch.tensor(g[k]) for k in ('mc_x', 'mc_w', 'mc_styles')]
    _close(stylegan.conv_modulated2d(*args, padding=1), g['mc_plain'], 2e-4)
    _close(stylegan.conv_modulated2d(*args, up=True, padding=1), g['mc_up'],
           2e-4)
    _close(stylegan.conv_modulated2d(*args, padding=1, demodulate=False),
           g['mc_nodemod'], 2e-4)


def test_mapping_network_matches_jax():
    port = stylegan.MappingNetwork(32, 64, num_ws=5, num_layers=2,
                                   generator=_seeded(1))
    z = np.random.default_rng(1).standard_normal((3, 32)).astype(np.float32)
    ref = jax_sg.MappingNetwork(z_dim=32, c_dim=0, w_dim=64, num_ws=5,
                                num_layers=2, lr_multiplier=0.01,
                                normalize_c=False).apply(
        {'params': tc.convert_mapping(_sd(port))}, jnp.asarray(z), None)
    _close(port(torch.tensor(z)), ref)


def test_synthesis_network_matches_jax():
    kwargs = dict(w_dim=32, img_resolution=16, img_channels=12,
                  channel_base=256, channel_max=32)
    port = stylegan.SynthesisNetwork(generator=_seeded(2), **kwargs)
    ws = np.random.default_rng(2).standard_normal((2, 6, 32))
    ws = ws.astype(np.float32)
    mod = jax_sg.SynthesisNetwork(**kwargs)
    ref = jax.jit(lambda w: mod.apply(
        {'params': tc.convert_synthesis(_sd(port))}, w))(jnp.asarray(ws))
    _close(port(torch.tensor(ws)), ref, 2e-4)


def test_attention_mapper_and_decoder_match_jax():
    rng = np.random.default_rng(3)
    mapper = generator.AttentionMapper(4, cond_dim=32, hidden_size=48,
                                       generator=_seeded(3))
    c = rng.standard_normal((3, 32)).astype(np.float32)
    ref = jax_gen.AttentionMapper(4, hidden_size=48).apply(
        {'params': tc.convert_attention_mapper(_sd(mapper))},
        jnp.asarray(c))
    _close(mapper(torch.tensor(c)), ref)

    decoder = generator.TriplanarDecoder(32, 4, generator=_seeded(4))
    sd = _sd(decoder)
    feats = rng.standard_normal((2, 7, 32)).astype(np.float32)
    ref = jax_gen.TriplanarDecoder(32, 4).apply(
        {'params': {'fc0': tc._eq_linear(sd, 'net.0'),
                    'fc1': tc._eq_linear(sd, 'net.2')}},
        jnp.asarray(feats), method=jax_gen.TriplanarDecoder.mlp)
    port = decoder.mlp(torch.tensor(feats))
    for key in ('features', 'density_or_distance'):
        _close(port[key], ref[key])


@pytest.mark.parametrize('tag', ['mapping', 'synthesis', 'decoder',
                                 'attention_mapper'])
def test_reference_golden(wg, tag):
    """The reference modules' own state dicts load unchanged (strict) and
    reproduce the reference's outputs."""
    module, tol = {
        'mapping': (stylegan.MappingNetwork(64, 64, num_ws=3, num_layers=2),
                    1e-4),
        'synthesis': (stylegan.SynthesisNetwork(
            64, 32, 24, channel_base=1024, channel_max=128), 2e-4),
        'decoder': (generator.TriplanarDecoder(32, 10), 1e-4),
        'attention_mapper': (generator.AttentionMapper(6, cond_dim=64),
                             1e-4),
    }[tag]
    module.load_state_dict(_golden_sd(wg, tag), strict=True)
    x = torch.tensor(wg[f'{tag}.in0'])
    with torch.no_grad():
        out = module.net(x) if tag == 'decoder' else module(x)
    _close(out, wg[f'{tag}.out0'], tol)


def test_generator_loads_reference_checkpoint_keys():
    """A real reference Generator state dict (the GAN tape's init_g:
    latent 64, 256^2, channel_base 2048, channel_max 64) loads strict."""
    tape = np.load(GOLDEN / 'trajectory_gan.npz')
    sd = {k[len('init_g/'):]: torch.tensor(tape[k]) for k in tape.files
          if k.startswith('init_g/')}
    port = generator.Generator(latent_dim=64, scene_range=0.55,
                               attention_values=10, img_resolution=256,
                               channel_base=2048, channel_max=64,
                               device='cpu')
    port.load_state_dict(sd, strict=True)
    assert torch.equal(port.beta, sd['beta'])


def test_from_jax_params_round_trip():
    """reference sd -> torch_convert.convert_generator -> from_jax_params
    gives back the same sd, key for key and value for value."""
    port = generator.Generator(latent_dim=16, scene_range=0.55,
                               attention_values=4, img_resolution=16,
                               channel_base=128, channel_max=16,
                               device='cpu', seed=5)
    with torch.no_grad():
        for i, p in enumerate(port.parameters()):
            p.add_(0.01 * i)  # distinct values everywhere
    sd = _sd(port)
    back = convert.from_jax_params(tc.convert_generator(sd,
                                                        attention_values=4))
    assert sorted(back) == sorted(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    other = generator.Generator(latent_dim=16, scene_range=0.55,
                                attention_values=4, img_resolution=16,
                                channel_base=128, channel_max=16,
                                device='cpu', seed=6)
    convert.load_reference_state_dict(other, back)
    for key, value in other.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), sd[key], err_msg=key)


def test_load_reference_state_dict_rejects_mismatch():
    port = generator.Generator(latent_dim=16, scene_range=0.55,
                               attention_values=4, img_resolution=16,
                               channel_base=128, channel_max=16,
                               device='cpu')
    sd = _sd(port)
    del sd['decoder.net.0.weight']
    with pytest.raises(KeyError, match='decoder.net.0.weight'):
        convert.load_reference_state_dict(port, sd)
