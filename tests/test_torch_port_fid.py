"""FID and the inversion report's files in the port against the JAX
package: the Inception network, the Fréchet distance, the report's FID
entries, the real images' statistics, the report checkpoint and the
report files.

One pytorch-fid-format random state dict (`random_inception_state_dict`)
feeds the port's `InceptionV3FID` through `load_inception_state_dict` and
JAX's through `convert_inception`; activations, images and reports come
from numpy seeds. Everything runs in float32 on the CPU. Tolerances are
stated per check.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_from_image_tpu.invert import pipeline as jax_pipe
from nerf_from_image_tpu.metrics import fid as jax_fid
from nerf_from_image_tpu.models.inception import \
    InceptionV3FID as JaxInceptionV3FID
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu_torch.core import pose as pose_lib
from nerf_from_image_tpu_torch.invert import optimizer as inv
from nerf_from_image_tpu_torch.invert import pipeline as pipe
from nerf_from_image_tpu_torch.metrics import fid
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.models.inception import InceptionV3FID
from nerf_from_image_tpu_torch.models.inception import resize_bilinear
from nerf_from_image_tpu_torch.models.lpips import LPIPS
from nerf_from_image_tpu_torch.render.renderer import render
from nerf_from_image_tpu_torch.utils import convert

BATCH, SIZE = 2, 128
# Activation width of the report tests: the consolidation reads any
# width, and scipy's matrix square root of a 2048^2 product of singular
# covariances takes a minute on a CPU.
WIDTH = 16


def _rel(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.fixture(scope='module')
def nets():
    sd = convert.random_inception_state_dict(0)
    port = InceptionV3FID(device='cpu')
    convert.load_inception_state_dict(port, sd)
    jnet = JaxInceptionV3FID()
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       torch_convert.convert_inception(sd))
    apply = jax.jit(functools.partial(jnet.apply, variables))
    return port, apply


def test_resize_matches_jax_image_resize():
    """128^2 -> 299^2 and 200 x 240 -> 299^2 bilinear, within 1e-6 of
    `jax.image.resize` (half-pixel centres, edges clamped, no antialias
    when resizing up); 299^2 stays as it is."""
    rng = np.random.default_rng(1)
    for shape in ((2, 3, 128, 128), (1, 3, 200, 240), (1, 3, 299, 299)):
        x = rng.random(shape).astype(np.float32)
        ref = jax.image.resize(jnp.asarray(x).transpose(0, 2, 3, 1),
                               (shape[0], 299, 299, 3), method='bilinear')
        got = resize_bilinear(torch.tensor(x), 299).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_inception_matches_jax(nets):
    """Pool3 activations of a batch of 2 at 128^2 (resized to 299^2)
    within 1e-4 of the largest activation: the same float32 convolutions
    summed in another order. The state dict's keys load strictly, with
    pytorch-fid's extra keys ignored."""
    port, apply = nets
    x = np.random.default_rng(2).random((BATCH, 3, SIZE, SIZE)).astype(
        np.float32)
    with torch.no_grad():
        got = port(torch.tensor(x)).numpy()
    ref = np.asarray(apply(jnp.asarray(x)))
    assert got.shape == ref.shape == (BATCH, 2048)
    assert np.abs(ref).max() > 1.0
    assert _rel(got, ref) < 1e-4
    sd = convert.random_inception_state_dict(0)
    sd['fc.weight'] = np.zeros((1008, 2048), np.float32)
    sd['Mixed_5b.branch1x1.bn.num_batches_tracked'] = np.zeros((), np.int64)
    convert.load_inception_state_dict(InceptionV3FID(device='cpu'), sd)
    del sd['Mixed_5b.branch1x1.bn.running_var']
    with pytest.raises(RuntimeError, match='running_var'):
        convert.load_inception_state_dict(InceptionV3FID(device='cpu'), sd)


def test_frechet_distance_matches_jax():
    """Statistics and distance of random activations: the same numpy and
    scipy calls, equal to 1e-12 relative."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((40, 16))
    b = rng.standard_normal((30, 16)) * 1.3 + 0.2
    for got, ref in zip(fid.calculate_stats(a), jax_fid.calculate_stats(a)):
        np.testing.assert_array_equal(got, ref)
    got = fid.calculate_frechet_distance(*fid.calculate_stats(a),
                                         *fid.calculate_stats(b))
    ref = jax_fid.calculate_frechet_distance(*jax_fid.calculate_stats(a),
                                             *jax_fid.calculate_stats(b))
    assert got > 0
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def _filled_reports(seed):
    """The same two-step report for both packages: two batches of scalars
    and WIDTH-wide activations (port arrays, JAX arrays)."""
    rng = np.random.default_rng(seed)
    port, ref = pipe.make_report([0, 30]), jax_pipe.make_report([0, 30])
    assert set(port[0]) == set(ref[0])
    for step in (0, 30):
        for _ in range(2):
            for key in port[step]:
                if key.startswith('inception'):
                    value = rng.standard_normal((12, WIDTH)).astype(np.float32)
                elif key in ('psnr', 'psnr_random', 'lpips', 'lpips_random',
                             'ssim', 'ssim_random', 'iou', 'rot_error'):
                    value = rng.random(12).astype(np.float32)
                else:
                    value = rng.standard_normal((12, 3)).astype(np.float32)
                port[step][key].append(value)
                ref[step][key].append(value.copy())
    return port, ref


@pytest.mark.parametrize('with_test', [False, True],
                         ids=['train_stats', 'train_and_test_stats'])
def test_consolidate_report_with_fid_matches_jax(with_test):
    """`consolidate_report` with FID statistics: the same keys, values
    and text as JAX's (fid_front, fid_random and their _test forms), the
    activations dropped; without statistics, no FID and no activations."""
    rng = np.random.default_rng(4)
    train = fid.calculate_stats(rng.standard_normal((50, WIDTH)))
    test = fid.calculate_stats(rng.standard_normal((50, WIDTH)) + 0.1)
    port, ref = _filled_reports(5)
    test_stats = test if with_test else None
    out, text = pipe.consolidate_report(port, train, test_stats)
    jout, jtext = jax_pipe.consolidate_report(ref, train, test_stats)
    assert text == jtext
    for step in (0, 30):
        assert set(out[step]) == set(jout[step])
        assert 'inception_activations_front' not in out[step]
        for key in ('fid_front', 'fid_random') + (
                ('fid_front_test', 'fid_random_test') if with_test else ()):
            assert np.isfinite(out[step][key])
            np.testing.assert_allclose(out[step][key], jout[step][key],
                                       rtol=1e-12)
    port, _ = _filled_reports(5)
    out, text = pipe.consolidate_report(port)
    assert 'fid' not in text
    assert not any(k.startswith(('fid', 'inception')) for k in out[0])


def test_real_fid_stats_with_a_ragged_last_batch(nets, tmp_path):
    """Three images in batches of 2: the last batch padded with its last
    image and the padding dropped, so the statistics are exactly those
    of the three activations; equal to JAX's `compute_real_fid_stats` on
    the same network within 1e-4 of the largest entry. With a cache path,
    the first call writes the statistics and the second reads them
    back."""
    port, apply = nets
    images = np.random.default_rng(6).uniform(
        -1, 1, (3, SIZE, SIZE, 4)).astype(np.float32)
    cache = str(tmp_path / 'stats' / 'real.npz')
    mu, sigma = pipe.compute_real_fid_stats(images, port, batch_size=2,
                                            cache_path=cache)
    x01 = torch.tensor(np.ascontiguousarray(
        images[..., :3].transpose(0, 3, 1, 2))) / 2 + 0.5
    with torch.no_grad():
        acts = [port(x01[:2]).numpy(), port(x01[[2, 2]]).numpy()[:1]]
    ref_mu, ref_sigma = fid.calculate_stats(np.concatenate(acts))
    np.testing.assert_array_equal(mu, ref_mu)
    np.testing.assert_array_equal(sigma, ref_sigma)
    jmu, jsigma = jax_pipe.compute_real_fid_stats(images, apply,
                                                  batch_size=2)
    assert _rel(mu, jmu) < 1e-4 and _rel(sigma, jsigma) < 1e-4
    cached = pipe.compute_real_fid_stats(images[:1], port, batch_size=2,
                                         cache_path=cache)
    np.testing.assert_array_equal(cached[0], mu)
    np.testing.assert_array_equal(cached[1], sigma)
    assert pipe.compute_real_fid_stats(images, None) is None


def test_report_checkpoint_and_files_round_trip(tmp_path):
    """A report checkpoint written mid-run reads back into a fresh report
    as the same lists in the same order, with its index and key, in the
    port and in JAX's `load_report_checkpoint` alike; no file gives (0,
    None). `save_report` writes the same report.npz arrays and
    report.txt as JAX's."""
    port, _ = _filled_reports(7)
    path = str(tmp_path / 'ckpt' / 'report_ckpt.npz')
    assert pipe.load_report_checkpoint(path, pipe.make_report([0, 30])) == (
        0, None)
    key = torch.Generator().manual_seed(3).get_state()
    pipe.save_report_checkpoint(path, port, 3, key)
    for load, make in ((pipe.load_report_checkpoint, pipe.make_report),
                       (jax_pipe.load_report_checkpoint,
                        jax_pipe.make_report)):
        back = make([0, 30])
        idx, got_key = load(path, back)
        assert idx == 3
        np.testing.assert_array_equal(got_key, key.numpy())
        for step in (0, 30):
            assert set(back[step]) == set(port[step])
            for k, values in port[step].items():
                assert len(back[step][k]) == len(values) == 2
                for a, b in zip(back[step][k], values):
                    np.testing.assert_array_equal(a, b)

    stats = fid.calculate_stats(np.random.default_rng(8).standard_normal(
        (30, WIDTH)))
    report, text = pipe.consolidate_report(port, stats)
    pipe.save_report(report, text, str(tmp_path / 'port'), header='hdr')
    jax_pipe.save_report(report, text, str(tmp_path / 'jax'), header='hdr')
    got = np.load(tmp_path / 'port' / 'report.npz')
    ref = np.load(tmp_path / 'jax' / 'report.npz')
    assert set(got.files) == set(ref.files) and '30/fid_front' in got.files
    for name in ref.files:
        np.testing.assert_array_equal(got[name], ref[name])
    assert ((tmp_path / 'port' / 'report.txt').read_text() ==
            (tmp_path / 'jax' / 'report.txt').read_text())


def test_evaluate_checkpoint_records_inception_activations(nets):
    """With an Inception network in the context, a checkpoint records the
    activations of the clipped front and novel-view renders, (B, 2048)
    each, equal to the network on those renders; without one, none."""
    port_net, _ = nets
    gen = Generator(device='cpu', latent_dim=32, scene_range=1.5,
                    attention_values=4, img_resolution=64,
                    channel_base=1024, channel_max=64)
    lpips = LPIPS(device='cpu')
    convert.load_lpips_state_dicts(lpips, *convert.random_lpips_state_dicts(1))
    cfg = inv.InversionConfig(resolution=16, depth_samples_per_ray=4,
                              scene_range=1.4, white_background=False,
                              camera_flipped=True)
    cam = torch.eye(4).repeat(BATCH, 1, 1)
    cam[:, 2, 3] = 3.0
    cam[:, :3, 1:] *= -1.0
    z0, t2, s, quat = pose_lib.matrix_to_pose(cam, torch.full((BATCH,), 1.5),
                                              True)
    with torch.no_grad():
        ws = gen.map(torch.zeros((BATCH, 32)))
    params = inv.InversionParams(z=ws / cfg.lr_gain_z, R=quat, s=s, t2=t2,
                                 z0=z0)
    target = torch.zeros((BATCH, 16, 16, 4))
    perm = (cam, torch.full((BATCH,), 1.5), None, None)
    acts = {}
    for inception in (None, port_net):
        ctx = pipe.EvalContext(gen=gen, lpips=lpips, has_mask=True,
                               inception=inception)
        entry = pipe.make_report([0])[0]
        pipe.evaluate_checkpoint(ctx, cfg, params, entry, target, None, None,
                                 cam, perm_cameras=perm,
                                 target_img_random=target[..., :3])
        acts[inception is None] = entry
    assert acts[True]['inception_activations_front'] == []
    front = acts[False]['inception_activations_front']
    novel = acts[False]['inception_activations_random']
    assert len(front) == len(novel) == 1
    assert front[0].shape == novel[0].shape == (BATCH, 2048)
    fused = gen.fused_view()
    with torch.no_grad():
        out, _, _ = inv.render_from_params(fused, params, cfg)
        state = fused.synthesize(ws)
        out_r = render(fused.field(state), 16,
                       16, cam, perm[1], 1.4, False, 4)
        want = port_net(pipe._to01(out.rgb)).numpy()
        want_r = port_net(pipe._to01(out_r.rgb)).numpy()
    np.testing.assert_allclose(front[0], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(novel[0], want_r, rtol=1e-5, atol=1e-5)
