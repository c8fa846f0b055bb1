"""The hybrid inversion of a batch, outside the refinement steps: the
port's rays with bbox and center, image metrics, bootstrap, PnP,
`init_inversion_params`, `evaluate_checkpoint` and `consolidate_report`
against the JAX package and the reference goldens.

A small generator (latent 32, 64^2 planes, four attention values), a
tiny SegFormer encoder and a random-weight VGG LPIPS feed both packages
from one reference-format state dict each, in float32 on the CPU. The
geometry is p3d_car's (render box 1.4, black background, flipped
perspective camera; the field's box is 1.5, as in
`test_torch_port_inversion.py`, so no sample lies on the field's face).
The port's checkpoint renders decode through the fused sample + decoder
tail (its plain version here, B5a on the card); JAX's run its XLA decode
(`use_pallas=False`), the same function without the fused call's bf16
roundings of the features, hidden units and palette probabilities.
Tolerances are stated per check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.core import rays as jax_rays
from nerf_from_image_tpu.invert import optimizer as jax_inv
from nerf_from_image_tpu.invert import pipeline as jax_pipe
from nerf_from_image_tpu.metrics import image as jax_metrics
from nerf_from_image_tpu.models.encoder import \
    BootstrapEncoder as JaxBootstrapEncoder
from nerf_from_image_tpu.models.generator import Generator as JaxGenerator
from nerf_from_image_tpu.models.lpips import LPIPS as JaxLPIPS
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.core import rays
from nerf_from_image_tpu_torch.invert import optimizer as inv
from nerf_from_image_tpu_torch.invert import pipeline as pipe
from nerf_from_image_tpu_torch.invert import pnp
from nerf_from_image_tpu_torch.metrics import image as metrics
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.ops import triplane_cuda
from nerf_from_image_tpu_torch.render.renderer import render
from nerf_from_image_tpu_torch.utils import convert

CONFIG = dict(latent_dim=32, scene_range=1.5, attention_values=4,
              img_resolution=64, channel_base=1024, channel_max=64)
TINY = dict(depths=(1, 1, 1, 1), embed_dims=(8, 8, 16, 16),
            num_heads=(1, 1, 2, 2), sr_ratios=(2, 1, 1, 1), head_width=16)
BATCH, RES, SAMPLES = 2, 16, 4
CFG = dict(resolution=RES, depth_samples_per_ray=SAMPLES, scene_range=1.4,
           white_background=False, camera_flipped=True)
GAIN = 5.0


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _rel(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30)


def _cameras(rng, b):
    """Flipped perspective cameras of the p3d_car form: focal 1.5, s 1,
    a small t2, random azimuth, slightly tilted. Returns (cam2world,
    focal) as tensors."""
    theta = rng.uniform(-np.pi, np.pi, b)
    quat = np.stack((np.cos(theta / 2), np.zeros(b), np.sin(theta / 2),
                     np.zeros(b)), axis=-1)
    quat = quat + rng.standard_normal((b, 4)) * 0.05
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    return pose_lib.pose_to_matrix(_t(np.full(b, np.log(2.0))),
                                   _t(rng.uniform(-0.05, 0.05, (b, 2))),
                                   _t(np.ones(b)), _t(quat), True)


@pytest.mark.parametrize('which', ['center', 'bbox', 'both'])
def test_ray_bundle_bbox_center_matches_jax(which):
    """Against JAX's `get_ray_bundle` (float32; 1e-5)."""
    rng = np.random.default_rng(0)
    cam, focal = _cameras(rng, 3)
    center = rng.uniform(0.3, 0.7, (3, 2)).astype(np.float32)
    bbox = np.stack((rng.uniform(-1.0, -0.7, (3, 2)),
                     rng.uniform(1.4, 2.0, (3, 2))), axis=1).astype(
        np.float32)
    c = center if which in ('center', 'both') else None
    b = bbox if which in ('bbox', 'both') else None
    o, d = rays.get_ray_bundle(8, 9, focal, cam, None if b is None else _t(b),
                               None if c is None else _t(c))
    ro, rd = jax_rays.get_ray_bundle(
        8, 9, jnp.asarray(focal.numpy()), jnp.asarray(cam.numpy()),
        None if b is None else jnp.asarray(b),
        None if c is None else jnp.asarray(c))
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-5)


def test_ray_bundle_bbox_center_golden(golden):
    """Against the reference's recorded rays (`core_golden.npz`, 1e-5 as
    `tests/test_core_rays.py`)."""
    o, d = rays.get_ray_bundle(8, 9, _t(golden['focal']),
                               _t(golden['pose_persp']), _t(golden['bbox']),
                               _t(golden['center']))
    np.testing.assert_allclose(o.numpy(), golden['persp_bbox_o'], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(d.numpy(), golden['persp_bbox_d'], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('reduction', ['mean', 'none'])
def test_image_metrics_match_jax(reduction):
    """psnr, ssim and iou against JAX's on the same images (float32;
    1e-5 relative: the box filter sums in another order)."""
    rng = np.random.default_rng(1)
    a = rng.uniform(-0.1, 1.1, (3, 3, 20, 24)).astype(np.float32)
    b = np.clip(a + rng.standard_normal(a.shape).astype(np.float32) * 0.1,
                0, 1)
    ma, mb = rng.uniform(size=(2, 3, 20, 24)).astype(np.float32)
    for fn, jfn, args in ((metrics.psnr, jax_metrics.psnr, (a, b)),
                          (metrics.ssim, jax_metrics.ssim, (a, b)),
                          (metrics.iou, jax_metrics.iou, (ma, mb))):
        got = fn(*(_t(x) for x in args), reduction=reduction)
        ref = jfn(*(jnp.asarray(x) for x in args), reduction=reduction)
        assert got.shape == np.asarray(ref).shape
        assert _rel(got.numpy(), ref) < 1e-5, fn.__name__
    same = metrics.psnr(_t(b), _t(b), reduction='none')
    assert torch.all(same == 60.0)


def test_average_w_is_the_mean_of_mapped_draws():
    port = Generator(device='cpu', **CONFIG)
    with torch.no_grad():
        avg = port.average_w(torch.Generator().manual_seed(3), 64)
        z = torch.randn((64, CONFIG['latent_dim']),
                        generator=torch.Generator().manual_seed(3))
        ref = port.map(z).mean(dim=0, keepdim=True)
    assert avg.shape == (1, port.num_ws, 512)
    torch.testing.assert_close(avg, ref)


@pytest.fixture(scope='module')
def case():
    port = Generator(device='cpu', **CONFIG)
    with torch.no_grad():
        # Put the surface inside the box (a fresh decoder's SDF is > 0).
        port.decoder.net[2].bias[0] -= 1.5
    variables = jax.tree_util.tree_map(
        jnp.asarray, torch_convert.convert_generator(
            {k: v.numpy() for k, v in port.state_dict().items()},
            attention_values=CONFIG['attention_values'],
            plane_resolution=CONFIG['img_resolution']))
    jgen = JaxGenerator(**CONFIG)

    vgg_sd, lin_sd = convert.random_lpips_state_dicts(1)
    lpips = LPIPS(device='cpu')
    convert.load_lpips_state_dicts(lpips, vgg_sd, lin_sd)

    enc_sd = convert.random_encoder_state_dict(2, **TINY)
    # Lift the mask logit so that most pixels pass PnP's 0.9 cut.
    enc_sd['post.4.bias'][3] += 4.0
    encoder = BootstrapEncoder(512, device='cpu', **TINY).eval()
    encoder.load_state_dict({k: torch.tensor(v) for k, v in enc_sd.items()},
                            strict=True)
    jenc = JaxBootstrapEncoder(latent_dim=512, **TINY)
    enc_params = jax.tree_util.tree_map(
        jnp.asarray, torch_convert.convert_bootstrap_encoder(enc_sd))

    # Targets: a second latent from known cameras (the front view, its
    # mask as the fourth channel) and from other cameras with a bbox crop
    # (the novel views).
    rng = np.random.default_rng(4)
    cfg = inv.InversionConfig(**CFG)
    with torch.no_grad():
        ws, ws_other = (port.map(_t(rng.standard_normal((BATCH, 32))))
                        for _ in range(2))
        gt_cam, gt_focal = _cameras(rng, BATCH)
        state = port.synthesize(ws)

        def field(pts, reqs):
            return port.sample(state, pts, reqs)

        front = render(field, RES, RES, gt_cam, gt_focal, 1.4, False, SAMPLES)
        perm_cam, perm_focal = _cameras(rng, BATCH)
        perm_bbox = _t(np.stack((rng.uniform(-1.0, -0.8, (BATCH, 2)),
                                 rng.uniform(1.6, 1.9, (BATCH, 2))), axis=1))
        novel = render(field, RES, RES, perm_cam, perm_focal, 1.4, False,
                       SAMPLES, bbox=perm_bbox)
    assert float(front.mask.max()) > 0.3  # the target sees the surface
    target = torch.cat((front.rgb, front.mask[..., None]), dim=-1)
    return dict(port=port, variables=variables, jgen=jgen, lpips=lpips,
                lpips_vars=jax.tree_util.tree_map(
                    jnp.asarray, torch_convert.convert_lpips(vgg_sd, lin_sd)),
                encoder=encoder, jenc=jenc, enc_params=enc_params, cfg=cfg,
                jcfg=jax_inv.InversionConfig(**CFG), ws=ws,
                ws_other=ws_other, target=target,
                gt_cam=gt_cam, perm=(perm_cam, perm_focal, None, perm_bbox),
                novel=novel.rgb, focal_guesses=pnp.get_focal_guesses(
                    np.linspace(1.3, 1.8, 20)))


@pytest.fixture(scope='module')
def bootstrapped(case):
    z_avg = torch.zeros((1, 15, 512))
    port = pipe.bootstrap_batch(case['encoder'], case['target'],
                                case['focal_guesses'], z_avg, GAIN)
    apply = jax.jit(lambda p, x: case['jenc'].apply(p, x,
                                                    deterministic=True))
    ref = jax_pipe.bootstrap_batch(
        case['jenc'], case['enc_params'], case['target'].numpy(),
        case['focal_guesses'], jnp.zeros((1, 15, 512)), GAIN, False, apply)
    return port, ref


def test_bootstrap_matches_jax(bootstrapped):
    """The encoder's coords, mask and latent (1e-4 of the largest value:
    float32 sums in another order) and the PnP poses and focals on them
    (1e-3: the solver's iterations amplify those input differences)."""
    port, ref = bootstrapped
    coords, mask, z_init, cam2world, focal, errors = port
    assert (mask > 0.9).mean() > 0.5  # PnP has points to work with
    assert _rel(coords, ref[0]) < 1e-4
    assert _rel(mask, ref[1]) < 1e-4
    assert tuple(z_init.shape) == (BATCH, 15, 512)
    assert _rel(z_init.numpy(), ref[2]) < 1e-4
    np.testing.assert_allclose(cam2world, ref[3], atol=1e-3)
    np.testing.assert_array_equal(focal, ref[4])
    assert np.all(errors < pnp.DUMMY_ERROR)  # no dummy pose: a real solve


def test_bootstrap_takes_the_dummy_pose_on_an_empty_mask(case):
    """An encoder whose mask never passes the cut gives every image the
    dummy pose, as JAX's PnP does (tests/test_pnp.py)."""
    coords, mask, w = pipe.bootstrap_dispatch(case['encoder'],
                                              case['target'])
    out = pipe.bootstrap_finish((coords, mask * 0.0, w),
                                case['focal_guesses'],
                                torch.zeros((1, 15, 512)), GAIN)
    assert np.all(out[5] == pnp.DUMMY_ERROR)
    assert tuple(out[2].shape) == (BATCH, 15, 512)


def test_init_inversion_params_matches_jax(bootstrapped):
    """The refinement's start from the bootstrap (1e-5 of each
    parameter's largest value)."""
    port, ref = bootstrapped
    params = pipe.init_inversion_params(port[2], port[3], port[4], True)
    jparams = jax_pipe.init_inversion_params(ref[2], ref[3], ref[4], True)
    for name, t in params.named():
        assert _rel(t.numpy(), getattr(jparams, name)) < 1e-3, name


def test_evaluate_checkpoint_and_report_match_jax(case, bootstrapped,
                                                   monkeypatch):
    """Two checkpoints, as the CLI records at steps 0 and 30: the
    bootstrap's parameters, and parameters near the target's (a view
    that sees the surface, from a latent between the target's and
    another). Each appends ws, z0, R, s, t2 and the front
    (psnr, ssim, lpips, iou, rot_error) and novel-view (psnr, ssim,
    lpips) metrics; `consolidate_report` averages them. Every entry
    against JAX's `evaluate_checkpoint` and `consolidate_report` on the
    same parameters: the parameters exactly, rot_error 1e-4, the image
    metrics 2e-2 relative (the fused call's bf16 roundings move the
    render by ~1e-2 of its range), and the checkpoint renders go through
    the fused call only (four passes per checkpoint)."""
    cfg, jcfg = case['cfg'], case['jcfg']
    params0 = pipe.init_inversion_params(bootstrapped[0][2],
                                         bootstrapped[0][3],
                                         bootstrapped[0][4], True)
    quat_cam = pose_lib.matrix_to_pose(case['gt_cam'], torch.full(
        (BATCH,), 1.5), True)
    params30 = inv.InversionParams(
        z=(0.7 * case['ws'] + 0.3 * case['ws_other']) / GAIN,
        R=quat_cam[3] + 0.1, s=quat_cam[2] * 1.05,
        t2=quat_cam[1] + 0.05, z0=quat_cam[0] + 0.1)

    calls = []
    fused = triplane_cuda.sample_triplane_fused

    def counted(*args):
        calls.append(args[1].shape)
        return fused(*args)

    monkeypatch.setattr(triplane_cuda, 'sample_triplane_fused', counted)
    ctx = pipe.EvalContext(gen=case['port'], lpips=case['lpips'],
                           has_mask=True)
    jctx = jax_pipe.EvalContext(
        gen=case['jgen'], gen_vars=case['variables'], lpips=JaxLPIPS(),
        lpips_vars=case['lpips_vars'], inception_apply=None,
        camera_flipped=True, has_mask=True, scene_range=1.4,
        attention_values=4)
    report = pipe.make_report([0, 30])
    jreport = jax_pipe.make_report([0, 30])
    perm = case['perm']
    jperm = (jnp.asarray(perm[0].numpy()), jnp.asarray(perm[1].numpy()),
             None, jnp.asarray(perm[3].numpy()))
    for step, params in ((0, params0), (30, params30)):
        before = len(calls)
        pipe.evaluate_checkpoint(ctx, cfg, params, report[step],
                                 case['target'], None, None, case['gt_cam'],
                                 perm_cameras=perm,
                                 target_img_random=case['novel'])
        assert len(calls) - before == 4
        jax_pipe.evaluate_checkpoint(
            jctx, jcfg, jax_inv.InversionParams(**{
                n: jnp.asarray(t.numpy()) for n, t in params.named()}),
            jreport[step], case['target'].numpy(), None, None,
            jnp.asarray(case['gt_cam'].numpy()), perm_cameras=jperm,
            target_img_random=case['novel'].numpy())

    out, text = pipe.consolidate_report(report)
    ref, ref_text = jax_pipe.consolidate_report(jreport)
    assert [line.split()[::2] for line in text.splitlines()] == \
        [line.split()[::2] for line in ref_text.splitlines()]
    for step in (0, 30):
        assert set(out[step]) == set(ref[step])
        for key in ('ws', 'z0', 'R', 's', 't2'):
            np.testing.assert_array_equal(out[step][key], ref[step][key])
        assert _rel(out[step]['rot_error'], ref[step]['rot_error']) < 1e-4
        for key in ('psnr', 'ssim', 'lpips', 'iou', 'psnr_random',
                    'ssim_random', 'lpips_random'):
            assert out[step][key].shape == (BATCH,), key
            assert _rel(out[step][key], ref[step][key]) < 2e-2, (
                step, key, out[step][key], ref[step][key])
            assert abs(out[step][f'{key}_avg'] -
                       ref[step][f'{key}_avg']) <= 2e-2 * abs(
                           ref[step][f'{key}_avg'])
    assert out[30]['iou_avg'] > 0.1  # the near view overlaps the target
