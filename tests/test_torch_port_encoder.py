"""The port's SegFormer and bootstrap encoder against the reference
goldens and the JAX package.

`SegBlock` and `SegOverlapPatchEmbed` are held against the reference
modules' recorded outputs in `tests/golden/weight_golden.npz`, at
`tests/test_weight_parity.py`'s tolerances (1e-4; 5e-4 for the 7x7
stride-4 patch convolution, whose float32 sums drift to ~2e-4). A tiny
`BootstrapEncoder`, with one backbone and with separate backbones, is
held against the JAX package's on one reference-format state dict
(`random_encoder_state_dict`), loaded with `load_state_dict` here and
converted by `convert_bootstrap_encoder` there.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.models.encoder import \
    BootstrapEncoder as JaxBootstrapEncoder
from nerf_from_image_tpu.utils import torch_convert as tc
from nerf_from_image_tpu_torch.models import segformer
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.utils import convert

GOLDEN = pathlib.Path(__file__).parent / 'golden' / 'weight_golden.npz'
TINY = dict(depths=(1, 1, 2, 1), embed_dims=(8, 16, 16, 32),
            num_heads=(1, 2, 2, 4), sr_ratios=(4, 2, 2, 1), head_width=16)


@pytest.fixture(scope='module')
def wg():
    return np.load(GOLDEN)


def _sd(wg, tag):
    pre = f'{tag}.sd.'
    return {k[len(pre):]: torch.tensor(wg[k]) for k in wg.files
            if k.startswith(pre)}


def _close(a, b, tol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float32), b, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize('tag,sr', [('seg_block', 2), ('seg_block_sr1', 1)])
def test_seg_block_matches_reference_golden(wg, tag, sr):
    block = segformer.SegBlock(32, 2, 4, sr_ratio=sr).eval()
    block.load_state_dict(_sd(wg, tag), strict=True)
    with torch.no_grad():
        out = block(torch.tensor(wg[f'{tag}.in0']), 8, 8)
    _close(out.numpy(), wg[f'{tag}.out0'])


def test_seg_patch_embed_matches_reference_golden(wg):
    embed = segformer.SegOverlapPatchEmbed(7, 4, 3, 32)
    embed.load_state_dict(_sd(wg, 'seg_patch_embed'), strict=True)
    with torch.no_grad():
        tokens, h, w = embed(torch.tensor(wg['seg_patch_embed.in0']))
    assert (h, w) == (8, 8)
    _close(tokens.numpy(), wg['seg_patch_embed.out0'], 5e-4)


def test_drop_path_is_identity_in_eval_only():
    x = torch.ones((64, 3, 5))
    assert torch.equal(segformer.drop_path(x, 0.5, False), x)
    kept = segformer.drop_path(x, 0.5, True)
    per_sample = kept[:, 0, 0]
    assert set(per_sample.tolist()) == {0.0, 2.0}
    assert torch.equal(kept, per_sample[:, None, None].expand_as(x))


@pytest.mark.parametrize('separate', [False, True],
                         ids=['joint', 'separate'])
def test_bootstrap_encoder_matches_jax(separate):
    """coords, mask and w of a tiny encoder (32^2 images) against the
    JAX package's, both in float32: the same convolutions, matmuls and
    LayerNorms summed in another order. Tolerance 1e-4 of each output's
    largest value."""
    sd = convert.random_encoder_state_dict(0, separate_backbones=separate,
                                           **TINY)
    port = BootstrapEncoder(512, separate_backbones=separate, device='cpu',
                            **TINY).eval()
    port.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                         strict=True)
    jenc = JaxBootstrapEncoder(latent_dim=512, separate_backbones=separate,
                               **TINY)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    tc.convert_bootstrap_encoder(sd))
    x = np.random.default_rng(1).uniform(-1, 1, (2, 3, 32, 32)).astype(
        np.float32)
    ref = jax.jit(lambda p, x: jenc.apply(p, x, deterministic=True))(
        params, jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.tensor(x))
    for name, got, want in zip(('coords', 'mask', 'w'), out, ref):
        want = np.asarray(want)
        assert got.shape == want.shape, name
        gap = np.abs(got.numpy() - want).max()
        assert gap <= 1e-4 * np.abs(want).max(), (name, gap)


def test_random_state_dict_is_what_the_encoder_holds():
    """The drawn dict has exactly the module's keys and shapes (the
    reference's names), for MiT-B5's layout as well."""
    sd = convert.random_encoder_state_dict(0, **TINY)
    port = BootstrapEncoder(512, device='meta', **TINY)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in sd.items()}
    full = BootstrapEncoder(512, device='meta').state_dict()
    assert sum(v.numel() for v in full.values()) > 80_000_000
    assert 'backbone.block3.39.mlp.dwconv.dwconv.weight' in full
    assert 'backbone_latent.patch_embed1.proj.weight' not in full
