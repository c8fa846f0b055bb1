"""The evaluator's encoder and class modes against the JAX package's.

A small generator (latent 32, 32^2 planes, 32^2 renders of 8 + 8
samples, four attention values) with the image encoder, or with a class
table of 3, evaluates a train-eval split of 6 images (two views an
object, so the permuted view has a target too) and, in encoder mode, a
test split of 4, in batches of 4 (a padded straggler), in both packages:
the same EMA weights, the same random InceptionV3 (its first 64
activations), the same random LPIPS weights. Every `reconstruction/*`
scalar (psnr, ssim, lpips, iou of the front and random views, the test
split's, the two FIDs) and the returned FID within 1e-3 relative, every
logged image within 1e-3 (the normal maps within 1e-2); the class mode's
FID and images the same way; and the training images'
`img/inference_ref`.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.data import loaders as jax_loaders
from nerf_from_image_tpu.models.inception import \
    InceptionV3FID as JaxInceptionV3FID
from nerf_from_image_tpu.models.lpips import LPIPS as JaxLPIPS
from nerf_from_image_tpu.train import eval as jax_eval
from nerf_from_image_tpu.train import gan as jax_gan
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.data import loaders
from nerf_from_image_tpu_torch.models.inception import InceptionV3FID
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.train import eval as port_eval
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import convert

TOL = 1e-3  # scalars (relative) and images (absolute)
# The normal maps are composited gradients of the SDF to the points: one
# pixel of the class mode's 12,288 parts by 3.3e-3 on the CPU.
NORMALS_TOL = 1e-2
WIDTH = 64  # Inception activations kept
CFG = dict(resolution=32, latent_dim=32, depth_samples_per_ray=8,
           scene_range=1.4, white_background=False, camera_flipped=True,
           attention_values=4, plane_resolution=32, channel_base=512,
           channel_max=64)
N_EVAL, N_TEST, BS, ITER, CLASSES = 6, 4, 4, 3, 3
FIELD_RANGE = 1.6
DATASET_CONFIG = dict(scene_range=1.4, white_background=False,
                      has_mask=True, has_bbox=False, is_highres=False,
                      views_per_object=2, views_per_object_test=2,
                      camera_projection_model='perspective',
                      camera_flipped=True)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _split(seed, n, classes=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 4)) * 0.2 + [1.0, 0.0, 0.0, 0.0]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cam, focal = pose_lib.pose_to_matrix(
        torch.full((n,), float(np.log(2.0))),
        torch.tensor(rng.uniform(-0.05, 0.05, (n, 2)), dtype=torch.float32),
        torch.ones(n), torch.tensor(q, dtype=torch.float32), True)
    out = dict(images=rng.uniform(-1, 1, (n, 32, 32, 4)).astype(np.float32),
               tform_cam2world=cam.numpy(), focal_length=focal.numpy())
    if classes:
        out['classes'] = rng.integers(0, CLASSES, n)
        out['num_classes'] = CLASSES
    return out


class Writer:
    def __init__(self):
        self.scalars = {}
        self.images = {}

    def add_scalar(self, tag, value, step):
        self.scalars[tag, int(step)] = float(value)

    def add_images(self, tag, images, step):
        self.images[tag, int(step)] = np.asarray(images, np.float32)


@pytest.fixture(scope='module')
def models():
    inc_sd = convert.random_inception_state_dict(0)
    port_inc = InceptionV3FID(device='cpu')
    convert.load_inception_state_dict(port_inc, inc_sd)
    jvars = jax.tree_util.tree_map(jnp.asarray,
                                   torch_convert.convert_inception(inc_sd))
    jax_inc = jax.jit(functools.partial(JaxInceptionV3FID().apply, jvars))
    vgg_sd, lin_sd = convert.random_lpips_state_dicts(0)
    port_lpips = LPIPS(device='cpu')
    convert.load_lpips_state_dicts(port_lpips, vgg_sd, lin_sd)
    lvars = jax.tree_util.tree_map(
        jnp.asarray, torch_convert.convert_lpips(vgg_sd, lin_sd))
    jax_lpips = jax.jit(lambda a, b: JaxLPIPS().apply(lvars, a, b,
                                                      normalize=True))
    return dict(port_inc=lambda im: port_inc(im)[:, :WIDTH],
                jax_inc=lambda im: jax_inc(im)[:, :WIDTH],
                port_lpips=port_lpips, jax_lpips=jax_lpips)


def _run(mode, models):
    flags = ({'use_encoder': True} if mode == 'encoder' else
             {'use_class': True, 'num_classes': CLASSES})
    cfg = gan.GANConfig(**CFG, **flags)
    state = gan.init_train_state(cfg, device='cpu', seed=2)
    with torch.no_grad():
        for g in (state.gen, state.gen_ema):
            g.decoder.net[2].bias[0] -= 1.0
        state.gen_ema.decoder.net[2].bias[0] -= 0.2  # EMA != G
    state.gen.scene_range = state.gen_ema.scene_range = FIELD_RANGE
    jcfg = jax_gan.GANConfig(use_pallas=False, fine_sampling=True, **CFG,
                             **flags)
    jgen = jax_gan.make_models(jcfg)[0].clone(scene_range=FIELD_RANGE)

    def conv(module):
        sd = {k: v.numpy() for k, v in module.state_dict().items()}
        out = torch_convert.convert_generator(
            sd, attention_values=CFG['attention_values'],
            plane_resolution=CFG['plane_resolution'])
        if 'class_embedding.weight' in sd:
            out['params']['class_embedding'] = {
                'embedding': sd['class_embedding.weight']}
        return jax.tree_util.tree_map(jnp.asarray, out)

    jstate = types.SimpleNamespace(params_g=conv(state.gen),
                                   ema_params_g=conv(state.gen_ema))
    classes = mode == 'class'
    arrays = dict(train=_split(0, 6, classes),
                  train_eval=_split(1, N_EVAL, classes),
                  test=_split(2, N_TEST) if mode == 'encoder' else None)

    def splits(lib):
        return [None if a is None else lib.DatasetSplit(**a)
                for a in (arrays['train'], arrays['train_eval'],
                          arrays['test'])]

    encoder = mode == 'encoder'
    port = port_eval.GANEvaluator(
        cfg, DATASET_CONFIG, 'p3d_car', *splits(loaders),
        inception=models['port_inc'],
        lpips=models['port_lpips'] if encoder else None,
        eval_batch_size=BS, device='cpu', **{
            k: v for k, v in flags.items() if k != 'num_classes'})
    ref = jax_eval.GANEvaluator(
        jcfg, DATASET_CONFIG, 'p3d_car', *splits(jax_loaders),
        inception_apply=models['jax_inc'],
        lpips_apply=models['jax_lpips'] if encoder else None,
        eval_batch_size=BS, **{k: v for k, v in flags.items()
                               if k != 'num_classes'})
    writers = Writer(), Writer()
    fids = (port.evaluate(state, ITER, writers[0]),
            ref.evaluate(jstate, ITER, jgen, writers[1]))
    port.log_training_images(state, ITER, writers[0],
                             np.random.RandomState(4321))
    ref.log_training_images(jstate, ITER, jgen, writers[1],
                            np.random.RandomState(4321))
    return port, ref, fids, writers


@pytest.fixture(scope='module')
def encoder_eval(models):
    return _run('encoder', models)


@pytest.fixture(scope='module')
def class_eval(models):
    return _run('class', models)


def _rel(a, ref):
    return abs(a - ref) / max(abs(ref), 1e-30)


def test_encoder_mode_scalars_match_jax(encoder_eval):
    port, ref, ((fid, best), (jfid, jbest)), (pw, jw) = encoder_eval
    assert set(pw.scalars) == set(jw.scalars)
    tags = {tag for tag, _ in pw.scalars}
    for name in ('psnr', 'ssim', 'lpips', 'iou'):
        for suffix in ('_front', '_random', '_test_front', '_test_random'):
            assert f'reconstruction/{name}{suffix}' in tags, (name, suffix)
    assert {'reconstruction/fid_frontview',
            'reconstruction/fid_randomview'} <= tags
    for key, value in jw.scalars.items():
        assert _rel(pw.scalars[key], value) < TOL, (key, pw.scalars[key],
                                                    value)
    assert best and jbest and _rel(fid, jfid) < TOL
    assert fid == pw.scalars['reconstruction/fid_randomview', ITER]
    np.testing.assert_array_equal(port.test_split.eval_indices_perm,
                                  ref.test_split.eval_indices_perm)
    np.testing.assert_array_equal(port.z_fid_test, ref.z_fid_test)


@pytest.mark.parametrize('mode', ['encoder', 'class'])
def test_images_match_jax(mode, encoder_eval, class_eval):
    _, _, _, (pw, jw) = encoder_eval if mode == 'encoder' else class_eval
    assert set(pw.images) == set(jw.images)
    if mode == 'encoder':
        for tag in ('img_eval_recon_front/ref_untrunc',
                    'img_eval_recon_random/static_untrunc_test',
                    'img/inference_ref'):
            assert (tag, ITER) in pw.images, tag
    for key, value in jw.images.items():
        tol = NORMALS_TOL if 'normals' in key[0] else TOL
        np.testing.assert_allclose(pw.images[key], value, rtol=tol,
                                   atol=tol, err_msg=str(key))


def test_class_mode_fid_matches_jax(class_eval):
    _, _, ((fid, best), (jfid, jbest)), (pw, jw) = class_eval
    assert set(pw.scalars) == set(jw.scalars) == {
        ('generation/fid_untrunc', ITER)}
    assert best and jbest and _rel(fid, jfid) < TOL
