"""The port's data layer against the JAX package's: the RLE codec, image
reading (both read through cv2, and through PIL without it), cv2's
INTER_AREA resize, and `load_dataset` on fixtures of p3d_car (train and
the car_val.mat test split, PNG and JPEG), SRN ShapeNet, CARLA and an
ImageNet fixture holding a CMYK JPEG, split by split; the demo's photo
as a CMYK JPEG.

Tolerances: the codec and image reads are exact; a resize is within 1e-6
of cv2's; every array of every split within 1e-6.
"""

import os

import cv2
import numpy as np
import pytest

from nerf_from_image_tpu.data import datasets as jax_datasets
from nerf_from_image_tpu.data import loaders as jax_loaders
from nerf_from_image_tpu.data import rle as jax_rle
from nerf_from_image_tpu import config as jax_config
from nerf_from_image_tpu_torch import config
from nerf_from_image_tpu_torch.data import fixtures
from nerf_from_image_tpu_torch.data import image_io
from nerf_from_image_tpu_torch.data import loaders
from nerf_from_image_tpu_torch.data import rle
from test_rle import _coco_compress

RESIZE_ATOL = 1e-6
JPEG_LOSS = 0.02  # mean absolute error of a quality-95 JPEG
SPLIT_ATOL = 1e-6


@pytest.mark.parametrize('shape', [(17, 23), (64, 48), (1, 9), (31, 1)])
def test_rle_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    mask = (rng.random(shape) > 0.55).astype(np.uint8)
    enc = rle.encode(mask)
    assert enc == jax_rle.encode(mask)
    np.testing.assert_array_equal(rle.decode(enc), mask)
    compressed = {'size': enc['size'],
                  'counts': _coco_compress(enc['counts'])}
    np.testing.assert_array_equal(rle.decode(compressed),
                                  jax_rle.decode(compressed))
    np.testing.assert_array_equal(rle.decode(compressed), mask)
    with pytest.raises(ValueError):
        rle.decode({'size': list(shape), 'counts': b''})


def _bgr(img):
    """RGB(A) -> the channel order cv2 writes and reads."""
    if img.ndim == 2 or img.shape[-1] == 1:
        return img.reshape(img.shape[:2])
    return img[..., [2, 1, 0, 3][:img.shape[-1]]]


def _images(rng, h, w, c):
    """A noise image and a smooth one (libpng picks other row filters)."""
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (np.sin(xx / 5.0 + yy / 7.0)[..., None] * 0.5 + 0.5 +
              np.zeros(c)) * np.linspace(0.3, 1.0, c)
    return [(rng.random((h, w, c)) * 255).astype(np.uint8),
            (smooth * 255).astype(np.uint8)]


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_png_reads_match_cv2(tmp_path, channels):
    """Files written by cv2 (libpng's adaptive row filters) read back by
    the port equal JAX's cv2 read, exactly."""
    rng = np.random.default_rng(channels)
    for i, img in enumerate(_images(rng, 41, 57, channels)):
        path = str(tmp_path / f'im{i}.png')
        cv2.imwrite(path, _bgr(img))
        got = image_io.imread(path)
        ref = jax_datasets.imread(path)
        assert got.dtype == ref.dtype == np.float64
        np.testing.assert_array_equal(got, ref)


def _filtered_png(img, kinds):
    """An 8-bit PNG of `img` (H, W, C) whose row y is filtered with
    kinds[y % len(kinds)]: a plain encoder, written from the PNG
    specification, independent of the reader."""
    import struct
    import zlib
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for y in range(h):
        kind = kinds[y % len(kinds)]
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate((np.zeros(c, np.int64), cur[:-c]))
        upleft = np.concatenate((np.zeros(c, np.int64), prev[:-c]))
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(kind)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(k, body):
        return (struct.pack('>I', len(body)) + k + body +
                struct.pack('>I', zlib.crc32(k + body) & 0xFFFFFFFF))
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (image_io.PNG_SIGNATURE +
            chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(bytes(out))) + chunk(b'IEND', b''))


@pytest.mark.parametrize('channels', [1, 2, 3, 4])
def test_png_every_row_filter(tmp_path, channels):
    """Rows filtered with each of the five PNG filters in turn (cv2 writes
    filter 1 only, PIL 1 and 2) read back exactly."""
    rng = np.random.default_rng(10 + channels)
    for img in _images(rng, 23, 19, channels):
        path = tmp_path / 'f.png'
        path.write_bytes(_filtered_png(img, [0, 1, 2, 3, 4, 4, 3]))
        want = img[..., 0] if channels == 1 else img
        if channels == 2:  # gray + alpha reads as RGBA
            want = np.concatenate((np.repeat(img[..., :1], 3, axis=2),
                                   img[..., 1:]), axis=2)
        np.testing.assert_array_equal(image_io.read_png(str(path)), want)


def test_png_palette_and_gray_alpha_and_round_trip(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(5)
    pal = Image.fromarray((rng.random((20, 30, 3)) * 255).astype(
        np.uint8)).convert('P', palette=Image.ADAPTIVE, colors=200)
    pal.save(tmp_path / 'p.png')
    np.testing.assert_array_equal(image_io.read_png(str(tmp_path / 'p.png')),
                                  np.asarray(pal.convert('RGB')))
    la = Image.fromarray((rng.random((20, 30, 2)) * 255).astype(np.uint8),
                         'LA')
    la.save(tmp_path / 'la.png')
    np.testing.assert_array_equal(image_io.read_png(str(tmp_path / 'la.png')),
                                  np.asarray(la.convert('RGBA')))
    for c in (1, 3, 4):
        img = _images(rng, 13, 9, c)[0]
        img = img[..., 0] if c == 1 else img
        image_io.write_png(str(tmp_path / f'w{c}.png'), img)
        np.testing.assert_array_equal(
            image_io.read_png(str(tmp_path / f'w{c}.png')), img)
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / f'w{c}.png'), cv2.IMREAD_UNCHANGED),
            _bgr(img))


def test_jpeg_reads_through_pil_or_raises(tmp_path, monkeypatch):
    """As the JAX package reads: cv2 first, PIL without cv2, and
    FileNotFoundError for a file cv2 cannot read."""
    from PIL import Image
    img = (np.random.default_rng(6).random((16, 24, 3)) * 255).astype(
        np.uint8)
    path = str(tmp_path / 'a.jpg')
    Image.fromarray(img).save(path, quality=90)
    got = image_io.imread(path)
    np.testing.assert_array_equal(got, jax_datasets.imread(path))
    np.testing.assert_array_equal(
        got, cv2.imread(path)[..., ::-1].astype(np.float64) / 255.0)
    (tmp_path / 'b.gif').write_bytes(b'GIF89a')
    for module in (image_io, jax_datasets):
        with pytest.raises(FileNotFoundError, match='b.gif'):
            module.imread(str(tmp_path / 'b.gif'))
    monkeypatch.setattr(image_io, 'cv2', None)
    monkeypatch.setattr(jax_datasets, 'cv2', None)
    got = image_io.imread(path)
    np.testing.assert_array_equal(got, jax_datasets.imread(path))
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(path)).astype(np.float64) / 255.0)


def _write_cmyk_jpeg(path, rgb):
    from PIL import Image
    Image.fromarray(rgb).convert('CMYK').save(path, quality=95)


def _write_png16(path, rgb):
    cv2.imwrite(path, _bgr(rgb.astype(np.uint16) * 256 + 3))


def _write_bmp(path, rgb):
    cv2.imwrite(path, _bgr(rgb))


def _write_gray_jpeg(path, rgb):
    from PIL import Image
    Image.fromarray(rgb[..., 1]).save(path, quality=90)


@pytest.mark.parametrize('kind,write,shape', [
    ('cmyk.jpg', _write_cmyk_jpeg, (20, 30, 3)),
    ('rgb16.png', _write_png16, (20, 30, 3)),
    ('rgb.bmp', _write_bmp, (20, 30, 3)),
    ('gray.jpg', _write_gray_jpeg, (20, 30)),
], ids=['cmyk_jpeg', 'png_16bit', 'bmp', 'gray_jpeg'])
def test_reads_match_jax_exactly(tmp_path, kind, write, shape):
    """Files the JAX package reads through cv2, read by the port equal,
    exactly: a CMYK JPEG comes back RGB (ImageNet holds such files), a
    16-bit PNG in uint16 levels / 255, as the reference's skimage read."""
    rng = np.random.default_rng(len(kind))
    rgb = (rng.random((20, 30, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / kind)
    write(path, rgb)
    got, ref = image_io.imread(path), jax_datasets.imread(path)
    assert got.dtype == ref.dtype == np.float64
    assert got.shape == ref.shape == shape
    np.testing.assert_array_equal(got, ref)
    if kind == 'rgb16.png':
        assert got.max() > 1.0


@pytest.mark.parametrize('shape', [(16, 24, 3), (17, 23, 3), (101, 77, 3),
                                   (375, 500, 3), (33, 45)])
@pytest.mark.parametrize('quality,subsampling,progressive', [
    (50, 2, False),  # 4:2:0, PIL's default and PASCAL3D+'s
    (75, 2, True),
    (90, 1, False),  # 4:2:2
    (95, 0, False),  # 4:4:4
    (100, 0, False),
])
def test_jpeg_reads_match_cv2(tmp_path, shape, quality, subsampling,
                              progressive):
    """The port's JPEG read (PIL's decoder) equals the JAX package's
    (cv2's), exactly: RGB at odd and even sizes, a gray image,
    baseline and progressive files, each chroma subsampling."""
    from PIL import Image
    rng = np.random.default_rng(shape[0] * quality)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.sin(xx / 6.0 + yy / 9.0)[..., None] * 0.4 + 0.5
    img = np.clip(smooth * np.linspace(0.5, 1.0, 3) +
                  rng.normal(0, 0.1, (h, w, 3)), 0, 1)
    img = (img[..., 0] if len(shape) == 2 else img) * 255
    path = str(tmp_path / 'a.jpg')
    Image.fromarray(img.astype(np.uint8)).save(
        path, quality=quality, subsampling=subsampling,
        progressive=progressive, optimize=progressive)
    got, ref = image_io.imread(path), jax_datasets.imread(path)
    assert got.shape == ref.shape == shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('channels', [1, 3, 4])
@pytest.mark.parametrize('src,dst', [
    ((64, 64), (32, 32)),  # integer shrink
    ((96, 60), (32, 20)),  # integer shrink, another factor per axis
    ((70, 53), (32, 32)),  # fractional shrink
    ((33, 33), (32, 32)),  # barely shrinking
    ((16, 16), (32, 32)),  # integer enlarge
    ((24, 13), (64, 64)),  # fractional enlarge
    ((31, 30), (32, 32)),  # barely enlarging
    ((40, 20), (32, 32)),  # shrink one axis, enlarge the other
    ((5, 7), (5, 7)),  # same size
])
def test_resize_area_matches_cv2(src, dst, channels):
    rng = np.random.default_rng(src[0] * 100 + dst[1] + channels)
    img = rng.random(src + (channels,))
    got = image_io.resize_area(img, dst)
    ref = jax_datasets.resize_area(img, dst)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=RESIZE_ATOL)
    got2 = image_io.resize_area(img[..., 0], dst)
    np.testing.assert_allclose(got2, cv2.resize(
        img[..., 0], dst[::-1], interpolation=cv2.INTER_AREA),
        rtol=0, atol=RESIZE_ATOL)


def _write_srn(root, stage, n_objects=2, n_views=3, src_res=48):
    rng = np.random.default_rng(len(stage))
    for o in range(n_objects):
        d = os.path.join(root, 'shapenet', f'cars_{stage}', f'obj_{o}')
        os.makedirs(os.path.join(d, 'pose'))
        with open(os.path.join(d, 'intrinsics.txt'), 'w') as f:
            f.write(f'{src_res * 1.1:.1f} {src_res / 2:.1f} {src_res / 2:.1f}'
                    ' 0.0\nskew\nheight width\n')
        for v in range(n_views):
            image_io.write_png(os.path.join(d, 'rgb', f'{v:06d}.png'),
                               (rng.random((src_res, src_res, 4)) *
                                255).astype(np.uint8))
            pose = np.eye(4)
            pose[:3, 3] = [0.05 * v, 0.1 * o, 2.0 + 0.1 * v]
            np.savetxt(os.path.join(d, 'pose', f'{v:06d}.txt'),
                       pose.reshape(1, 16))


def _assert_splits_equal(got, ref):
    assert (got is None) == (ref is None)
    if got is None:
        return
    for field in ('images', 'images_highres', 'tform_cam2world',
                  'focal_length', 'bbox', 'center', 'classes',
                  'num_classes'):
        a, b = getattr(got, field), getattr(ref, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert np.shape(a) == np.shape(b), field
            np.testing.assert_allclose(a, b, rtol=0, atol=SPLIT_ATOL,
                                       err_msg=field)


@pytest.mark.parametrize('dataset,extra', [
    ('p3d_car', ['--run_inversion']),
    ('p3d_car', []),
    ('shapenet_cars', ['--run_inversion']),
    ('carla', []),
])
def test_load_dataset_matches_jax(tmp_path, dataset, extra):
    """Train (at 2x with the highres copy under p3d's and carla's ADA),
    train-eval and test splits: 32^2 crops of 40 x 48 p3d images enlarge,
    the 64^2 uncropped train images and the SRN/CARLA views shrink or
    enlarge."""
    data = str(tmp_path)
    if dataset == 'p3d_car':
        fixtures.write_p3d_car(data, n_train=5, n_test=4, size=(40, 48))
    elif dataset == 'carla':
        fixtures.write_carla(data, 3)
    else:
        _write_srn(data, 'train')
        _write_srn(data, 'test', n_objects=1)
    argv = ['--dataset', dataset, '--data_path', data, '--resolution',
            '32'] + extra
    args, jargs = config.parse_args(argv), jax_config.parse_args(argv)
    got = loaders.load_dataset(args)
    ref = jax_loaders.load_dataset(jargs)
    assert got[0] == ref[0]
    for g, r in zip(got[1:], ref[1:]):
        _assert_splits_equal(g, r)
    if dataset == 'p3d_car' and extra:
        assert len(got[3].images) == 4
        assert got[3].images.shape[1:] == (32, 32, 4)


@pytest.mark.parametrize('extra', [['--run_inversion'], []])
def test_load_dataset_jpeg_matches_jax(tmp_path, extra):
    """A p3d_car fixture of JPEG files, as PASCAL3D+ ships its images:
    the port reads them through PIL, JAX through cv2; every array of
    every split within 1e-6."""
    data = str(tmp_path)
    fixtures.write_p3d_car(data, n_train=5, n_test=4, size=(40, 48),
                           ext='jpg')
    argv = ['--dataset', 'p3d_car', '--data_path', data, '--resolution',
            '32'] + extra
    got = loaders.load_dataset(config.parse_args(argv))
    ref = jax_loaders.load_dataset(jax_config.parse_args(argv))
    assert got[0] == ref[0]
    for g, r in zip(got[1:], ref[1:]):
        _assert_splits_equal(g, r)
    assert len((got[3] if extra else got[1]).images) == (4 if extra else 10)


@pytest.mark.parametrize('extra', [['--run_inversion'], []])
def test_load_dataset_cmyk_jpeg_matches_jax(tmp_path, extra):
    """An ImageNet fixture whose first image is a CMYK JPEG, as ImageNet's
    train set holds some: the port reads it as RGB, as JAX's cv2 does;
    every array of every split within 1e-6."""
    import glob
    from PIL import Image
    data = str(tmp_path)
    fixtures.write_imagenet(data, 'imagenet_car', 3, (48, 40), seed=7)
    first = sorted(glob.glob(os.path.join(
        data, 'imagenet', 'imagenet_car', 'images', '**', '*.jpg'),
        recursive=True))[0]
    _write_cmyk_jpeg(first, np.asarray(Image.open(first)))
    assert Image.open(first).mode == 'CMYK'
    argv = ['--dataset', 'imagenet_car', '--data_path', data,
            '--resolution', '32'] + extra
    got = loaders.load_dataset(config.parse_args(argv))
    ref = jax_loaders.load_dataset(jax_config.parse_args(argv))
    assert got[0] == ref[0]
    for g, r in zip(got[1:], ref[1:]):
        _assert_splits_equal(g, r)


def test_demo_reads_a_cmyk_photo_as_rgb(tmp_path, capsys):
    """The demo's photo as a CMYK JPEG: three channels within JPEG loss
    of the RGB photo, its mask not taken from a fourth channel; image,
    mask and bbox equal the JAX package's."""
    from nerf_from_image_tpu.cli import demo as jax_demo
    from nerf_from_image_tpu_torch.cli import demo
    data = str(tmp_path / 'data')
    fixtures.write_p3d_car(data, n_train=2, n_test=2, size=(48, 40))
    rgb = image_io.read_png(os.path.join(data, fixtures.IMAGES_DIR,
                                         'car_pascal', 'test_0000.png'))
    path = str(tmp_path / 'photo.jpg')
    _write_cmyk_jpeg(path, rgb)
    got = demo.load_manual_image(path, 3)
    assert 'alpha' not in capsys.readouterr().out
    ref = jax_demo.load_manual_image(path, 3)
    assert got['image'].shape == rgb.shape
    assert np.abs(got['image'] - rgb / 255.0).mean() < JPEG_LOSS
    for key in ('image', 'mask', 'bbox'):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


@pytest.mark.parametrize('blocked', [('cv2',), ('cv2', 'PIL')],
                         ids=['pil', 'neither'])
def test_cli_path_runs_without_cv2_pil_or_jax(tmp_path, monkeypatch,
                                              blocked):
    """The CLI's modules import with cv2, JAX and the JAX package blocked
    (the card's machine has no JAX). A CARLA fixture then loads through
    PIL, equal to the JAX package's own loader without cv2; a p3d_car
    fixture raises TypeError in both, as PIL's box resize takes no
    (H, W, 1) mask. With PIL blocked too, the read raises ImportError, as
    the JAX package's does."""
    import subprocess
    import sys
    out = str(tmp_path / 'splits.npz')
    argvs = {name: ['--dataset', name, '--resolution', '32', '--data_path',
                    str(tmp_path / name)] for name in ('carla', 'p3d_car')}
    fixtures.write_carla(str(tmp_path / 'carla'), 3)
    fixtures.write_p3d_car(str(tmp_path / 'p3d_car'), 3, 2, (40, 48))
    code = (
        "import sys\n"
        f"for name in {blocked + ('jax', 'flax', 'nerf_from_image_tpu')!r}:\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from nerf_from_image_tpu_torch.cli import run, inversion\n"
        "from nerf_from_image_tpu_torch import config\n"
        "from nerf_from_image_tpu_torch.data import loaders\n"
        f"for name, argv in {argvs!r}.items():\n"
        "    try:\n"
        "        splits = loaders.load_dataset(config.parse_args(argv))[1:]\n"
        "    except (ImportError, TypeError) as e:\n"
        "        print(name, type(e).__name__)\n"
        "        continue\n"
        "    print(name, 'loaded')\n"
        f"    np.savez({out!r}, *[s.images for s in splits if s])\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    monkeypatch.setattr(jax_datasets, 'cv2', None)
    if 'PIL' in blocked:
        assert proc.stdout.split() == ['carla', 'ModuleNotFoundError',
                                       'p3d_car', 'ModuleNotFoundError']
        monkeypatch.setitem(__import__('sys').modules, 'PIL', None)
        for argv in argvs.values():
            with pytest.raises(ImportError):
                jax_loaders.load_dataset(jax_config.parse_args(argv))
        return
    assert proc.stdout.split() == ['carla', 'loaded', 'p3d_car',
                                   'TypeError']
    with pytest.raises(TypeError):
        jax_loaders.load_dataset(jax_config.parse_args(argvs['p3d_car']))
    ref = [s.images for s in jax_loaders.load_dataset(
        jax_config.parse_args(argvs['carla']))[1:] if s]
    got = np.load(out)
    assert len(got.files) == len(ref) > 0
    for i, b in enumerate(ref):
        assert got[f'arr_{i}'].shape == b.shape
        np.testing.assert_allclose(got[f'arr_{i}'], b, rtol=0,
                                   atol=SPLIT_ATOL)
