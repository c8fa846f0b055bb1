"""The demo against the JAX package.

`cli/demo.py`'s functions against JAX's on the same inputs: GrabCut's
mask exactly, the largest instance of the requested class, the order of
the mask sources (mask file, `segment_fn`, alpha, GrabCut, the full
frame) and the URL branch through a stubbed `urlopen`.

Then the demo through both CLIs (`--inv_manual_input_path`, which implies
--inv_export_demo_sample and --run_inversion) on an RGBA image made from
a p3d_car fixture's test image, with the same reference-format GAN
checkpoint, encoder and LPIPS weights as `test_torch_port_cli_
inversion.py` (the full-width generator at 32^2 rays and planes, four
attention values, float32): in the gate encoder only (the exported
parameters are the bootstrap's, within 1e-4, and the strips as below);
`slow` and `parity` (JAX compiles its refinement scan for minutes), with
two refinement steps with the l1 loss (no random crops, so both sides
take the same steps) of the latent alone: in p3d_car's geometry every ray's first coarse sample lies on the
field's box face, where the camera's gradient is not reproducible even
within JAX (ROADMAP C; with the pose optimized, s parts by 7.4e-4 after
the two steps). The camera within 1e-4, the latent within 1e-4 but where
Adam's normalized steps follow the sign of a gradient at float32 noise
(see the test), the strips of the same shape [input | coords | recon |
normals | novel view], each panel's mean absolute difference in [0, 1]
under 1e-2 (the largest difference is in the assertion's message).
"""

import io
import os
import shutil
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from nerf_from_image_tpu.cli import demo as jax_demo
from nerf_from_image_tpu.cli import inversion as jax_cli_inv
from nerf_from_image_tpu.cli import run as jax_cli
from nerf_from_image_tpu.utils import torch_convert
from nerf_from_image_tpu.utils.weights import save_npz_variables
from nerf_from_image_tpu_torch.cli import demo
from nerf_from_image_tpu_torch.cli import inversion as cli_inv
from nerf_from_image_tpu_torch.cli import run as cli_run
from nerf_from_image_tpu_torch.data import fixtures
from nerf_from_image_tpu_torch.data import image_io
from nerf_from_image_tpu_torch.train import gan
from nerf_from_image_tpu_torch.utils import checkpoint
from nerf_from_image_tpu_torch.utils import convert

PARAM_ATOL = 1e-4
PANEL_MAD = 1e-2
STEPS = 2
LR = 2e-3  # the refinement's Adam rate
Z_STEP_ATOL = 2 * STEPS * LR
Z_SHARE = 0.9
KNOBS = ['--dataset', 'p3d_car', '--resolution', '32', '--latent_dim',
         '512', '--attention_values', '4', '--plane_resolution', '32',
         '--depth_samples_per_ray', '4', '--compute_dtype', 'float32',
         '--mesh_shape', 'data:1']
ENCODER_ONLY = ['--inv_encoder_only']
WITH_STEPS = ['--inv_loss', 'l1', '--inv_no_optimize_pose', '--inv_steps',
              str(STEPS)]


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Beside other test processes, torch's default of one thread a core
    spins on shared cores; these small tensors run as fast on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _subject_image(h=96, w=96, y0=24, y1=72, x0=30, x1=66):
    """Dark background, bright textured centered rectangle."""
    rng = np.random.RandomState(0)
    img = 0.05 + 0.02 * rng.rand(h, w, 3)
    img[y0:y1, x0:x1] = 0.7 + 0.25 * rng.rand(y1 - y0, x1 - x0, 3)
    return img.astype(np.float64)


def _save(path, arr):
    Image.fromarray(arr).save(path)
    return str(path)


def test_grabcut_matches_jax_exactly():
    img = _subject_image()
    got = demo.grabcut_foreground(img)
    ref = jax_demo.grabcut_foreground(img)
    assert got is not None and got.mean() > 0.1
    np.testing.assert_array_equal(got, ref)
    for flat in (np.full((64, 64, 3), 0.5), np.full((8, 8, 3), 0.5)):
        assert demo.grabcut_foreground(flat) is None
        assert jax_demo.grabcut_foreground(flat) is None


def test_select_largest_of_class_matches_jax():
    masks = np.zeros((3, 8, 8), bool)
    masks[0, :, :] = True       # huge, another class
    masks[1, 0:2, 0:2] = True   # small, the class
    masks[2, 0:4, 0:4] = True   # larger, the class
    classes = np.array([5, 2, 2])
    got = demo.select_largest_of_class(classes, masks, 2)
    np.testing.assert_array_equal(
        got, jax_demo.select_largest_of_class(classes, masks, 2))
    np.testing.assert_array_equal(got > 0.5, masks[2])
    for mod in (demo, jax_demo):
        with pytest.raises(RuntimeError, match='COCO class 9'):
            mod.select_largest_of_class(classes, masks, 9)


def _both(*args, **kwargs):
    got = demo.load_manual_image(*args, **kwargs)
    ref = jax_demo.load_manual_image(*args, **kwargs)
    assert got.keys() == ref.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    return got


def test_mask_sources_in_jax_order(tmp_path):
    """A mask file outranks `segment_fn`, which outranks the alpha
    channel, which outranks GrabCut, which outranks the full frame."""
    rgba = np.zeros((40, 40, 4), np.uint8)
    rgba[..., :3] = 128
    rgba[10:30, 5:25, 3] = 255
    img = _save(tmp_path / 'rgba.png', rgba)
    m = np.zeros((40, 40), np.uint8)
    m[3:7, 8:14] = 255
    mask = _save(tmp_path / 'mask.png', m)

    def seg(im, cls):
        out = np.zeros(im.shape[:2])
        out[2:6, 3:9] = 1.0
        return out

    def no_seg(im, cls):
        return None

    np.testing.assert_allclose(
        _both(img, 2, segment_fn=seg, mask_path=mask)['bbox'],
        [8, 3, 13, 6])
    np.testing.assert_allclose(_both(img, 2, segment_fn=seg)['bbox'],
                               [3, 2, 8, 5])
    alpha = _both(img, 2, segment_fn=no_seg)
    np.testing.assert_allclose(alpha['bbox'], [5, 10, 24, 29])
    rgb = _save(tmp_path / 'rgb.png',
                (np.clip(_subject_image(), 0, 1) * 255).astype(np.uint8))
    grab = _both(rgb, 2, segment_fn=no_seg)
    x0, y0, x1, y1 = grab['bbox']
    assert 20 <= x0 <= 36 and 60 <= x1 <= 72
    flat = _save(tmp_path / 'flat.png', np.full((40, 40, 3), 90, np.uint8))
    full = _both(flat, 2, segment_fn=no_seg)
    assert full['mask'].min() == 1.0
    np.testing.assert_allclose(full['bbox'], [0, 0, 39, 39])
    bad = _save(tmp_path / 'bad.png', m[:20])
    for mod in (demo, jax_demo):
        with pytest.raises(ValueError, match='mask shape'):
            mod.load_manual_image(img, 2, mask_path=bad)


def test_url_branch_matches_jax(monkeypatch):
    img = (np.clip(_subject_image(), 0, 1) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format='PNG')
    payload = buf.getvalue()

    class FakeResponse(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    seen = []

    def fake_urlopen(url, timeout=None):
        seen.append(url)
        return FakeResponse(payload)

    def seg(im, cls):
        out = np.zeros(im.shape[:2])
        out[2:6, 3:9] = 1.0
        return out

    monkeypatch.setattr(urllib.request, 'urlopen', fake_urlopen)
    out = _both('https://example.com/bird.png', 14, segment_fn=seg)
    np.testing.assert_allclose(out['bbox'], [3, 2, 8, 5])
    assert seen == ['https://example.com/bird.png'] * 2

    def offline(url, timeout=None):
        raise OSError('no network')

    monkeypatch.setattr(urllib.request, 'urlopen', offline)
    for mod in (demo, jax_demo):
        with pytest.raises(RuntimeError, match='pass a local path'):
            mod.load_manual_image('http://example.com/x.jpg', 2)


# ---- The demo through both CLIs ----------------------------------------

@pytest.fixture(scope='module')
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp('demo')
    data = str(root / 'data')
    fixtures.write_p3d_car(data, n_train=8, n_test=4, size=(48, 40),
                           seed=4)
    # The user's photo: a test image with its mask as the alpha channel.
    rgba = np.zeros((48, 40, 4), np.uint8)
    rgba[..., :3] = image_io.read_png(os.path.join(
        data, fixtures.IMAGES_DIR, 'car_pascal', 'test_0000.png'))
    rgba[8:40, 6:34, 3] = 255
    _save(root / 'photo.png', rgba)
    cfg = gan.GANConfig(resolution=32, latent_dim=512, attention_values=4,
                        plane_resolution=32)
    state = gan.init_train_state(cfg, device='cpu', seed=3)
    with torch.no_grad():
        state.gen.decoder.net[2].bias[0] -= 1.5
        state.gen_ema.load_state_dict(state.gen.state_dict())
    checkpoint.save(checkpoint.gan_checkpoint(state), str(root / 'gan.pth'))
    enc_sd = convert.random_encoder_state_dict(2)
    enc_sd['post.4.bias'][3] += 8.0  # masks past PnP's 0.9 cut
    torch.save({k: torch.from_numpy(v) for k, v in enc_sd.items()},
               str(root / 'enc.pth'))
    save_npz_variables(torch_convert.convert_bootstrap_encoder(enc_sd),
                       str(root / 'enc.npz'))
    vgg, lin = convert.random_lpips_state_dicts(1)
    os.makedirs(root / 'port' / 'weights')
    for name, sd in (('vgg16.pth', vgg), ('lpips_lins.pth', lin)):
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   str(root / 'port' / 'weights' / name))
    save_npz_variables(torch_convert.convert_lpips(vgg, lin),
                       str(root / 'jax' / 'weights' / 'lpips.npz'))
    yield root
    # The module's runs write checkpoints of hundreds of MB here.
    shutil.rmtree(root, ignore_errors=True)


def _demos(assets, extra, tag):
    """Runs the demo through both CLIs in `assets` (JAX joins a relative
    --resume_from to its report directory), each strip moved to its
    side's directory; returns each side's final parameters and strip."""
    common = KNOBS + extra + ['--resume_from', 'gan.pth',
                      '--data_path', str(assets / 'data'),
                      '--inv_manual_input_path', str(assets / 'photo.png')]
    seen = {}

    def spy(side, original):
        def export(args, ctx_or_gen, inv_cfg, params, *rest, **kwargs):
            seen[side] = {n: np.asarray(
                v.detach().cpu().numpy() if torch.is_tensor(v) else v)
                for n, v in (params.named() if side == 'port' else
                             vars(params).items()) if v is not None}
            return original(args, ctx_or_gen, inv_cfg, params, *rest,
                            **kwargs)
        return export

    cwd = os.getcwd()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(cli_inv, 'export_demo',
                      spy('port', cli_inv.export_demo))
        patch.setattr(jax_cli_inv, 'export_demo',
                      spy('jax', jax_cli_inv.export_demo))
        try:
            os.chdir(assets)
            out = cli_run.main(common + ['--root_path', 'port',
                                         '--coord_resume_from', 'enc.pth'],
                               device='cpu')
            shutil.move('outputs', os.path.join('port', f'outputs_{tag}'))
            jax_cli.main(common + ['--root_path', 'jax', '--coord_resume_from',
                                   'enc.npz', '--use_pallas', '0'])
            shutil.move('outputs', os.path.join('jax', f'outputs_{tag}'))
        finally:
            os.chdir(cwd)
    steps = STEPS if extra is WITH_STEPS else 0
    name = f'demo_manual_p3d_car_{steps}it.png'
    assert out['demo_path'] == os.path.join('outputs', name)
    assert [b['images'] for b in out['batches']] == [1]
    strips = {side: image_io.read_png(str(assets / side / f'outputs_{tag}' /
                                          name))
              for side in ('port', 'jax')}
    return seen, strips


@pytest.fixture(scope='module')
def demos(assets):
    return _demos(assets, ENCODER_ONLY, 'encoder')


@pytest.fixture(scope='module')
def demos_with_steps(assets):
    return _demos(assets, WITH_STEPS, 'steps')


def test_demo_parameters_match_jax(demos):
    """Encoder only: the exported parameters (the bootstrap's) within
    PARAM_ATOL."""
    seen, _ = demos
    port, ref = seen['port'], seen['jax']
    assert sorted(port) == sorted(ref) == ['R', 's', 't2', 'z', 'z0']
    for key in port:
        assert port[key].shape == ref[key].shape, key
        np.testing.assert_allclose(port[key], ref[key], rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)


@pytest.mark.slow
@pytest.mark.parity
def test_demo_with_steps_parameters_match_jax(demos_with_steps):
    """Two l1 steps with the pose frozen: the camera within PARAM_ATOL;
    the latent's entries within it but for those whose gradient sits at
    float32 noise, which Adam's normalized steps move by up to its rate a
    step either way (ROADMAP C: 4.8e-3 on 8% of z's entries): those
    within Z_STEP_ATOL, and at least Z_SHARE of the entries within
    PARAM_ATOL."""
    seen, _ = demos_with_steps
    port, ref = seen['port'], seen['jax']
    assert sorted(port) == sorted(ref) == ['R', 's', 't2', 'z', 'z0']
    for key in port:
        assert port[key].shape == ref[key].shape, key
        if key != 'z':
            np.testing.assert_allclose(port[key], ref[key], rtol=0,
                                       atol=PARAM_ATOL, err_msg=key)
    gap = np.abs(port['z'] - ref['z'])
    assert gap.max() <= Z_STEP_ATOL, gap.max()
    assert (gap <= PARAM_ATOL).mean() >= Z_SHARE, (gap <= PARAM_ATOL).mean()


@pytest.mark.parametrize('steps', [
    False, pytest.param(True, marks=[pytest.mark.slow, pytest.mark.parity])],
    ids=['encoder_only', 'with_steps'])
def test_demo_strip_matches_jax(request, steps):
    _, strips = request.getfixturevalue(
        'demos_with_steps' if steps else 'demos')
    port, ref = strips['port'], strips['jax']
    assert port.shape == ref.shape == (32, 5 * 32, 3)
    diff = np.abs(port.astype(np.float64) - ref.astype(np.float64)) / 255
    for i, name in enumerate(('input', 'coords', 'recon', 'normals',
                              'novel')):
        panel = diff[:, 32 * i:32 * (i + 1)]
        assert panel.mean() < PANEL_MAD, (name, panel.mean(), panel.max())
