"""The port stands alone: no JAX, no flax, nothing of the JAX package.

The machine with the card has no JAX, so one such import anywhere in the
port or in `chip_smoke.py` ends a run there at import time. These tests
import every port module with those packages blocked (`cli/demo.py`
among them, also with cv2 and detectron2 blocked), scan the sources, and
check that entry points never drop to the CPU on their own.
"""

import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from nerf_from_image_tpu_torch import device as device_lib
from nerf_from_image_tpu_torch.models.encoder import BootstrapEncoder
from nerf_from_image_tpu_torch.models.generator import Generator
from nerf_from_image_tpu_torch.models.inception import InceptionV3FID
from nerf_from_image_tpu_torch.models.lpips import LPIPS

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / 'nerf_from_image_tpu_torch'
PORT_SOURCES = sorted(PORT.rglob('*.py')) + [
    REPO / 'chip_smoke.py', REPO / 'chip_ab.py',
    REPO / 'probes' / 'backward_designs.py']


def _module_names():
    names = []
    for path in sorted(PORT.rglob('*.py')):
        rel = path.relative_to(REPO).with_suffix('')
        parts = rel.parts[:-1] if rel.name == '__init__' else rel.parts
        names.append('.'.join(parts))
    return names


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'nerf_from_image_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for name in {_module_names() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


def test_the_parallel_package_is_covered():
    """Several cards (`parallel/`) are held like every module of the
    port: imported with JAX blocked and read for imports below."""
    names = _module_names()
    for module in ('mesh', 'distributed'):
        assert f'nerf_from_image_tpu_torch.parallel.{module}' in names
        assert PORT / 'parallel' / f'{module}.py' in PORT_SOURCES


@pytest.mark.parametrize('path', PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_reference_in_sources(path):
    text = path.read_text()
    assert not re.search(r'^\s*(import|from)\s+(jax|flax)\b', text,
                         re.MULTILINE)
    imports = re.findall(r'^\s*(?:import|from)\s+(\S+)', text, re.MULTILINE)
    assert not [m for m in imports
                if re.match(r'nerf_from_image_tpu(?!_torch)', m)]
    assert 'torch.utils.cpp_extension' not in text
    assert 'torch.compile' not in text


@pytest.mark.parametrize('where', ['repo', 'alone'])
def test_chip_smoke_fails_without_cuda(where, tmp_path):
    """Without a card, or copied alone into an empty directory, the smoke
    script exits non-zero and prints no result line."""
    cwd = REPO
    if where == 'alone':
        shutil.copy(REPO / 'chip_smoke.py', tmp_path)
        cwd = tmp_path
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip('checks the behaviour without a CUDA device')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        device_lib.resolve_device()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        device_lib.resolve_device('cuda')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Generator(latent_dim=8, scene_range=0.55, img_resolution=8,
                  channel_base=32, channel_max=8)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        LPIPS()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        BootstrapEncoder(512, depths=(1, 1, 1, 1), embed_dims=(8, 8, 8, 8),
                         num_heads=(1, 1, 1, 1), head_width=8)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        InceptionV3FID()
    assert device_lib.resolve_device('cpu') == torch.device('cpu')


def test_demo_runs_without_cv2_or_detectron2(tmp_path):
    """`cli/demo.py` imports cv2 and detectron2 only where it needs them:
    with both blocked, a user's RGBA image still loads through PIL, as
    the JAX package reads without cv2 (its alpha is the mask), and
    GrabCut and Mask R-CNN step aside (None)."""
    from nerf_from_image_tpu_torch.data import image_io
    rgba = np.zeros((40, 40, 4), np.uint8)
    rgba[..., :3] = 128
    rgba[10:30, 5:25, 3] = 255
    image_io.write_png(str(tmp_path / 'a.png'), rgba)
    code = (
        "import sys\n"
        "for name in ('cv2', 'detectron2', 'jax', 'flax',\n"
        "             'nerf_from_image_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from nerf_from_image_tpu_torch.cli import demo\n"
        "out = demo.load_manual_image(sys.argv[1], 3)\n"
        "assert out['bbox'].tolist() == [5, 10, 24, 29], out['bbox']\n"
        "assert demo.grabcut_foreground(np.ones((64, 64, 3))) is None\n"
        "assert demo.detectron2_segment(np.ones((64, 64, 3)), 3) is None\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, '-c', code,
                           str(tmp_path / 'a.png')], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith('ok')
