"""The flag-only modes' model parts against the JAX package.

- `ResidualEncoder` with instance norm (G's `emb`) and without (D's), on
  JAX's initial weights carried into the port by `from_jax_params`: the
  embedding of 32^2 images within 1e-5 (relative to the largest entry),
  and the raise below 16^2 in both.
- The discriminator's two conditionings (the image through `emb`, the
  class through `label_embedding`, which wins over the image): logits
  within 1e-5 on JAX's weights via `from_jax_discriminator`.
- The generator's class and image mappings: ws of `map(z,
  embed_class(labels))` and `map(z, embed_image(images))` within 1e-5, on
  the port's weights carried into JAX (`convert_generator` for `emb`, the
  class table by hand: JAX's converter has no `class_embedding`).
- `attention_values` 0: 14 ws, 3 decoded channels through the wide
  sigmoid, no palette; a render (64 + 64 samples at 8^2) within 1e-4 of
  JAX's, and the fused view declines as JAX's gate does.
- `compute_path_length` with injected plane and palette noise: (B,)
  within 1e-4 relative, with and without a palette.
- `perturb_poses`: the same indices as JAX on 40 random poses.
- The non-fine render (128 stratified samples, composited in order)
  within 1e-4 of JAX's `fine_sampling=False` render.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.core import pose as jax_pose
from nerf_from_image_tpu.models import discriminator as jax_disc_lib
from nerf_from_image_tpu.models import generator as jax_gen_lib
from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.render import render as jax_render
from nerf_from_image_tpu.train import gan as jax_gan
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.models.discriminator import Discriminator
from nerf_from_image_tpu_torch.models.generator import (Generator,
                                                        ResidualEncoder)
from nerf_from_image_tpu_torch.render.renderer import render
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import convert

TOL = 1e-5
RENDER_TOL = 1e-4
PPL_RTOL = 1e-4
CONFIG = dict(latent_dim=32, scene_range=1.5, img_resolution=32,
              channel_base=1024, channel_max=64)
D_CONFIG = dict(resolution=32, channel_base=512, channel_max=64)
BATCH, RES, SAMPLES, CLASSES = 2, 8, 64, 5


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30)


def _images(seed, b=BATCH, hw=32):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (b, 3, hw, hw)).astype(np.float32)


@pytest.mark.parametrize('instance_norm', [True, False])
def test_residual_encoder_matches_jax(instance_norm):
    img = _images(0)
    module = jax_gen_lib.ResidualEncoder(use_instance_norm=instance_norm)
    variables = module.init(jax.random.PRNGKey(3), jnp.asarray(img))
    # Move the norms' affine parameters off their (1, 0) start.
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), v.shape)
        if 'norm' in str(path) else v, variables['params'])
    ref = module.apply({'params': params}, jnp.asarray(img))
    sd = convert.from_jax_params({'params': {'emb': jax.device_get(
        params)}})
    port = ResidualEncoder(use_instance_norm=instance_norm)
    port.load_state_dict({k[len('emb.'):]: torch.tensor(v)
                          for k, v in sd.items()}, strict=True)
    assert (f'emb.norm3.weight' in sd) == instance_norm
    assert ('emb.conv3.bias' in sd) != instance_norm
    with torch.no_grad():
        got = port(torch.tensor(img)).numpy()
    assert got.shape == (BATCH, 512)
    assert _rel(got, ref) < TOL
    with pytest.raises(ValueError, match='>= 16'):
        port(torch.zeros((1, 3, 8, 32)))
    with pytest.raises(ValueError, match='>= 16'):
        module.apply({'params': params}, jnp.zeros((1, 3, 8, 32)))


def _camera(b=BATCH, dist=4.0):
    cam = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    cam[:, 2, 3] = dist
    cam[1 % b, 0, 3] = 0.3
    return cam, np.full((b,), 1.2, np.float32)


@pytest.mark.parametrize('mode', ['encoder', 'class', 'class_and_encoder'])
def test_discriminator_conditioning_matches_jax(mode):
    use_encoder = mode != 'class'
    num_classes = CLASSES if 'class' in mode else None
    jdisc = jax_disc_lib.Discriminator(nc=3, camera_flipped=False,
                                       use_encoder=use_encoder,
                                       num_classes=num_classes, **D_CONFIG)
    # Batch 4: the minibatch-std group.
    x = _images(1, 4)
    cam, focal = _camera(4)
    cond = (np.array([1, 4, 0, 2], np.int32) if num_classes else
            _images(2, 4))
    variables = jdisc.init(jax.random.PRNGKey(5), jnp.asarray(x),
                           jnp.asarray(cam), jnp.asarray(cond),
                           jnp.asarray(focal))
    ref = jdisc.apply(variables, jnp.asarray(x), jnp.asarray(cam),
                      jnp.asarray(cond), jnp.asarray(focal))
    port = Discriminator(nc=3, camera_flipped=False, use_encoder=use_encoder,
                         num_classes=num_classes, device='cpu', **D_CONFIG)
    convert.load_reference_state_dict(port, convert.from_jax_discriminator(
        jax.device_get(variables)))
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(cam),
                   torch.tensor(cond), torch.tensor(focal)).numpy()
    assert got.shape == (4, 1)
    assert _rel(got, ref) < TOL


def _jax_variables(port, attention_values=10):
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    variables = torch_convert.convert_generator(
        sd, attention_values=attention_values, plane_resolution=32)
    if port.num_classes:
        # JAX's converter leaves the class table out (ROADMAP C).
        variables['params']['class_embedding'] = {
            'embedding': sd['class_embedding.weight']}
    return jax.tree_util.tree_map(jnp.asarray, variables)


@pytest.mark.parametrize('mode', ['class', 'encoder'])
def test_conditional_mapping_matches_jax(mode):
    kwargs = ({'num_classes': CLASSES} if mode == 'class' else
              {'use_encoder': True})
    port = Generator(device='cpu', seed=2, **CONFIG, **kwargs)
    with torch.no_grad():
        for name, p in port.named_parameters():
            if '.norm' in name and name.startswith('emb.'):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator()
                                         .manual_seed(len(name))))
    jgen = JaxGenerator(**CONFIG, use_encoder=mode == 'encoder',
                        num_classes=kwargs.get('num_classes'))
    variables = _jax_variables(port)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((BATCH, 32)).astype(np.float32)
    cond = (np.array([0, 3], np.int32) if mode == 'class' else _images(4))
    method = (JaxGenerator.embed_class if mode == 'class' else
              JaxGenerator.embed_image)

    def jax_ws(z, cond):
        c = jgen.apply(variables, cond, method=method)
        return c, jgen.apply(variables, z, c, method=JaxGenerator.map)

    ref_c, ref_ws = jax.jit(jax_ws)(jnp.asarray(z), jnp.asarray(cond))
    with torch.no_grad():
        embed = (port.embed_class if mode == 'class' else port.embed_image)
        c = embed(torch.tensor(cond))
        ws = port.map(torch.tensor(z), c).numpy()
    assert ws.shape == (BATCH, 15, 512)
    assert _rel(c.numpy(), ref_c) < TOL
    assert _rel(ws, ref_ws) < TOL
    with pytest.raises(ValueError, match='conditioning'):
        port.map(torch.tensor(z))
    # JAX's conditional mapping fails without c as well.
    with pytest.raises(AttributeError):
        jgen.apply(variables, jnp.asarray(z), method=JaxGenerator.map)


@pytest.fixture(scope='module')
def no_palette():
    port = Generator(device='cpu', seed=6, attention_values=0, **CONFIG)
    with torch.no_grad():
        port.decoder.net[2].bias[0] -= 1.5
    jgen = JaxGenerator(attention_values=0, **CONFIG)
    ws = np.random.default_rng(7).standard_normal(
        (BATCH, 14, 512)).astype(np.float32)
    return port, jgen, _jax_variables(port, 0), ws


def test_no_palette_generator_layout(no_palette):
    port = no_palette[0]
    assert port.num_ws == 14
    assert not hasattr(port, 'texture_mapper')
    assert port.decoder.net[2].weight.shape[0] == 4
    assert not port.fused_view().fuses
    with torch.no_grad():
        state = port.synthesize(torch.tensor(no_palette[3]))
    assert state.attention_values is None and state.fused_tail is None
    with pytest.raises(ValueError, match='no semantics'):
        port.sample(state, torch.zeros((BATCH, 4, 3)), ('semantics',))


@pytest.mark.parametrize('fine', [True, False], ids=['fine', 'nofine'])
def test_no_palette_render_matches_jax(no_palette, fine):
    port, jgen, variables, ws = no_palette
    cam, focal = _camera()
    samples = SAMPLES if fine else 2 * SAMPLES
    with torch.no_grad():
        state = port.synthesize(torch.tensor(ws))
        out = render(port.field(state), RES, RES, torch.tensor(cam),
                     torch.tensor(focal), 1.4, True, samples,
                     fine_sampling=fine)

    @jax.jit
    def jax_stage(ws, cam, focal):
        st = jgen.apply(variables, ws, method=JaxGenerator.synthesize)

        def sample_fn(pts, reqs):
            return jgen.apply(variables, st, pts, reqs,
                              method=JaxGenerator.sample)
        return jax_render(sample_fn, RES, RES, cam, focal, None, None, 1.4,
                          True, samples, rng=None, fine_sampling=fine)

    ref = jax_stage(jnp.asarray(ws), jnp.asarray(cam), jnp.asarray(focal))
    assert float(ref.mask.max()) > 0.3
    for key in ('rgb', 'mask', 'depth'):
        np.testing.assert_allclose(getattr(out, key).numpy(),
                                   np.asarray(getattr(ref, key)),
                                   rtol=RENDER_TOL, atol=RENDER_TOL,
                                   err_msg=key)


@pytest.mark.parametrize('attention_values', [10, 0])
def test_path_length_matches_jax(attention_values):
    port = Generator(device='cpu', seed=8, attention_values=attention_values,
                     **CONFIG)
    jgen = JaxGenerator(attention_values=attention_values, **CONFIG)
    variables = _jax_variables(port, attention_values)
    rng = np.random.default_rng(9)
    num_ws = port.num_ws
    ws = rng.standard_normal((BATCH, num_ws, 512)).astype(np.float32)
    noise = {'ppl_planes': rng.standard_normal(
        (BATCH, 96, 32, 32)).astype(np.float32),
        'ppl_attn': rng.standard_normal(
            (BATCH, attention_values, 3)).astype(np.float32)}
    ref = jax_gan.compute_path_length(
        jgen, variables, jnp.asarray(ws), jax.random.PRNGKey(0), None,
        {k: jnp.asarray(v) for k, v in noise.items()})
    ws_t = torch.tensor(ws).requires_grad_()
    got = gan.compute_path_length(
        port, ws_t, torch.Generator(), None,
        {k: torch.tensor(v) for k, v in noise.items()})
    assert got.shape == (BATCH,)
    assert _rel(got.detach().numpy(), ref) < PPL_RTOL
    # The graph reaches the synthesis weights (the double backward).
    w = port.synthesis_network.b4.conv1.weight
    g, = torch.autograd.grad(got.sum(), w)
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_perturb_poses_matches_jax():
    rng = np.random.default_rng(10)
    q = rng.standard_normal((40, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cam, focal = pose_lib.pose_to_matrix(
        torch.full((40,), 0.7), torch.tensor(rng.uniform(
            -0.1, 0.1, (40, 2)).astype(np.float32)), torch.ones(40),
        torch.tensor(q), False)
    cam, focal = cam.numpy(), focal.numpy()
    bbox = rng.uniform(0, 1, (40, 2, 2)).astype(np.float32)
    got = pose_lib.perturb_poses(cam, 20.0, focal, None, bbox)
    ref = jax_pose.perturb_poses(cam, 20.0, focal, None, bbox)
    assert got[2] is None and ref[2] is None
    for a, b in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        np.testing.assert_array_equal(a, np.asarray(b))
    # The poses moved (not every pose onto itself).
    assert not np.array_equal(got[0], cam)
