"""The port's discriminator against the JAX package and the reference.

`Discriminator` (3 and 4 channels, flipped and plain camera) against the
JAX `Discriminator` on the same weights and inputs, made from a numpy
seed, in float32 on the CPU; `minibatch_std` and
`matrix_to_conditioning_vector` against theirs; the discriminator leg of
`utils/convert.py` against the JAX package's `convert_discriminator`; and
the backbone against the reference's own output in
`tests/golden/weight_golden.npz`.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.core import pose as jax_pose
from nerf_from_image_tpu.models import stylegan as jax_stylegan
from nerf_from_image_tpu.models.discriminator import (
    Discriminator as JaxDiscriminator)
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu_torch.core import pose
from nerf_from_image_tpu_torch.models import stylegan
from nerf_from_image_tpu_torch.models.discriminator import Discriminator
from nerf_from_image_tpu_torch.utils import convert

GOLDEN = pathlib.Path(__file__).parent / 'golden' / 'weight_golden.npz'
D_KWARGS = dict(resolution=32, channel_base=512, channel_max=64)


def _poses(rng, b):
    """Random cameras looking at the origin from distance 2-3."""
    mats = []
    for _ in range(b):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        rot = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
        m = np.eye(4)
        m[:3, :3] = rot
        m[:3, 3] = rot[:, 2] * rng.uniform(2.0, 3.0)
        mats.append(m)
    return np.stack(mats).astype(np.float32)


@pytest.mark.parametrize('nc,flipped', [(3, False), (4, True), (3, True)])
def test_discriminator_matches_jax(nc, flipped):
    """Logits of both packages on one random reference-format state dict
    (the JAX side through its `convert_discriminator`) and the same
    inputs: 1e-5 in float32 (the same convolutions and products, summed
    in another order)."""
    sd = convert.random_discriminator_state_dict(
        nc + 10 * flipped, 32, nc, channel_base=512, channel_max=64)
    jd = JaxDiscriminator(nc=nc, camera_flipped=flipped, **D_KWARGS)
    variables = torch_convert.convert_discriminator(sd)
    port = Discriminator(nc=nc, camera_flipped=flipped, device='cpu',
                         **D_KWARGS)
    convert.load_reference_state_dict(port, sd)
    rng = np.random.default_rng(nc)
    img = rng.uniform(-1, 1, (8, nc, 32, 32)).astype(np.float32)
    poses = _poses(rng, 8)
    focal = rng.uniform(1.0, 2.0, 8).astype(np.float32)
    ref = jax.jit(jd.apply)(variables, jnp.asarray(img), jnp.asarray(poses),
                            None, jnp.asarray(focal))
    with torch.no_grad():
        out = port(torch.tensor(img), torch.tensor(poses), None,
                   torch.tensor(focal))
    assert out.shape == (8, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('group', [2, 4])
def test_minibatch_std_matches_jax(group):
    """Float32, 1e-6: the same means and square roots."""
    x = np.random.default_rng(group).standard_normal(
        (8, 6, 4, 4)).astype(np.float32)
    ref = jax_stylegan.minibatch_std(jnp.asarray(x), group)
    out = stylegan.minibatch_std(torch.tensor(x), group)
    assert out.shape == (8, 7, 4, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('flipped,with_focal', [(False, True), (True, True),
                                                (True, False)])
def test_conditioning_vector_matches_jax(flipped, with_focal):
    """The 13-D pose vector: 1e-5 in float32."""
    rng = np.random.default_rng(5)
    poses = _poses(rng, 6)
    focal = rng.uniform(1.0, 2.0, 6).astype(np.float32) if with_focal \
        else None
    ref = jax_pose.matrix_to_conditioning_vector(
        jnp.asarray(poses), None if focal is None else jnp.asarray(focal),
        flipped)
    out = pose.matrix_to_conditioning_vector(
        torch.tensor(poses), None if focal is None else torch.tensor(focal),
        flipped)
    assert out.shape == (6, 13)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_convert_round_trips_through_convert_discriminator():
    """A random reference-format state dict loads strictly into the port;
    `convert_discriminator` turns it into JAX variables, and
    `from_jax_discriminator` gives back the same dict, exactly."""
    sd = convert.random_discriminator_state_dict(3, 32, 4, channel_base=512,
                                                 channel_max=64)
    port = Discriminator(nc=4, camera_flipped=True, device='cpu', **D_KWARGS)
    port.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                         strict=True)
    back = convert.from_jax_discriminator(
        torch_convert.convert_discriminator(sd))
    assert sorted(back) == sorted(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    assert np.abs(sd['backbone.mapping.fc0.weight']).mean() > 10.0


def test_backbone_matches_the_reference_golden():
    """The backbone on the reference's weights and inputs against the
    reference's own output: 2e-4, the JAX package's bound for the same
    golden (`tests/test_weight_parity.py`)."""
    wg = np.load(GOLDEN)
    pre = 'disc_backbone.sd.'
    sd = {k[len(pre):]: torch.tensor(wg[k]) for k in wg.files
          if k.startswith(pre)}
    backbone = stylegan.DiscriminatorBackbone(
        c_dim=13, img_resolution=32, img_channels=3, channel_base=1024,
        channel_max=128)
    backbone.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = backbone(torch.tensor(wg['disc_backbone.in0']),
                       torch.tensor(wg['disc_backbone.in1']))
    np.testing.assert_allclose(out.numpy(), wg['disc_backbone.out0'],
                               rtol=2e-4, atol=2e-4)


def test_conditional_mapping_matches_the_reference_golden():
    """`MappingNetwork` with a latent and a conditioning vector (the
    discriminator's mapping has only the latter) on the reference's
    weights and inputs: 1e-4, the JAX package's bound for this golden."""
    wg = np.load(GOLDEN)
    pre = 'mapping_cond.sd.'
    mapping = stylegan.MappingNetwork(64, 64, None, num_layers=2,
                                      lr_multiplier=0.01, c_dim=32)
    mapping.load_state_dict({k[len(pre):]: torch.tensor(wg[k])
                             for k in wg.files if k.startswith(pre)},
                            strict=True)
    with torch.no_grad():
        out = mapping(torch.tensor(wg['mapping_cond.in0']),
                      torch.tensor(wg['mapping_cond.in1']))
    np.testing.assert_allclose(out.numpy(), wg['mapping_cond.out0'],
                               rtol=1e-4, atol=1e-4)


def test_discriminator_needs_cuda_unless_asked_and_refuses_unported_modes():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            Discriminator(nc=3, camera_flipped=False, **D_KWARGS)
    # The conditionings are ported: what the port still refuses is a
    # channel count the reference never builds.
    disc = Discriminator(nc=3, camera_flipped=False, use_encoder=True,
                         device='cpu', **D_KWARGS)
    assert list(disc.state_dict())[0].startswith('emb.')
    with pytest.raises(ValueError, match='nc must be 3 or 4'):
        Discriminator(nc=5, camera_flipped=False, device='cpu', **D_KWARGS)
