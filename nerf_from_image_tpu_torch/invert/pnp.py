"""Host-side PnP pose estimation over the repository's native solver
(port copy of `nerf_from_image_tpu/invert/pnp.py`).

For each image, the foreground pixels' predicted canonical coordinates
and their pixel grid positions go to the C++ EPnP/SQPnP + LM solver in
`native/pnp.cc`, over a sweep of focal proposals (percentiles of the
training focals); an image with fewer than four foreground pixels or no
pose of positive depth takes the dummy pose (error 10, focal 1). It runs
on the host with numpy, as in the JAX package.

The solver is built from `native/pnp.cc` with the host C++ compiler
(`-O3 -fPIC -shared -std=c++17`, the flags of `native/Makefile`) into
`build/native/libnfi_pnp-<hash>.so` at the root of the checkout (listed
in .gitignore) at its first use, and loaded with ctypes. The name carries
a hash of the source and the flags, so an edited source is never served
by a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
SOURCE = REPO / 'native' / 'pnp.cc'
BUILD_DIR = REPO / 'build' / 'native'
CXX_FLAGS = ('-O3', '-fPIC', '-shared', '-std=c++17')
# The error the solver reports for the dummy pose.
DUMMY_ERROR = 10.0

_library = None


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes() +
                            ' '.join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'libnfi_pnp-{digest[:12]}.so'


def _compiler() -> str:
    for name in (os.environ.get('CXX'), 'g++', 'c++'):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError('no C++ compiler found (set CXX or PATH)')


def load_library() -> ctypes.CDLL:
    """The loaded solver, built first if its library is missing.

    Raises RuntimeError with the compiler's output when the build fails.
    """
    global _library
    if _library is not None:
        return _library
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f'.tmp{os.getpid()}.so')
        proc = subprocess.run([_compiler(), *CXX_FLAGS, '-o', str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'PnP build failed ({proc.returncode}):\n'
                               f'{proc.stdout}{proc.stderr}')
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.nfi_solve_pnp_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # coords
        ctypes.POINTER(ctypes.c_uint8),  # masks
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # bs, h, w
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,  # focals, n_focals
        ctypes.c_int,  # refine
        ctypes.POINTER(ctypes.c_double),  # out_world2cam
        ctypes.POINTER(ctypes.c_double),  # out_focal
        ctypes.POINTER(ctypes.c_double),  # out_err
    ]
    lib.nfi_solve_pnp_batch.restype = None
    _library = lib
    return lib


def compute_pose_pnp(coords: np.ndarray, masks: np.ndarray,
                     focal_proposals: Sequence[float], refine: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """coords: (B, H, W, 3); masks: (B, H, W) bool.

    Returns (world2cam (B, 4, 4), focal (B,), errors (B,)), float64;
    world2cam includes the reference's diag(1, -1, -1) flip.
    """
    lib = load_library()
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    masks = np.ascontiguousarray(np.asarray(masks).astype(np.uint8))
    focals = np.ascontiguousarray(np.asarray(focal_proposals,
                                             dtype=np.float64))
    bs, h, w, _ = coords.shape
    if masks.shape != (bs, h, w):
        raise ValueError(f'masks must be {(bs, h, w)}, got {masks.shape}')
    out_mat = np.zeros((bs, 16), dtype=np.float64)
    out_focal = np.zeros((bs,), dtype=np.float64)
    out_err = np.zeros((bs,), dtype=np.float64)

    def ptr(a, kind=ctypes.c_double):
        return a.ctypes.data_as(ctypes.POINTER(kind))

    lib.nfi_solve_pnp_batch(ptr(coords), ptr(masks, ctypes.c_uint8), bs, h,
                            w, ptr(focals), len(focals), int(refine),
                            ptr(out_mat), ptr(out_focal), ptr(out_err))
    return out_mat.reshape(bs, 4, 4), out_focal, out_err


def get_focal_guesses(focal_length) -> Optional[np.ndarray]:
    """Focal proposals: the distinct 1st, 10th, ..., 90th and 99th
    percentiles of the training focals; None for an orthographic
    dataset."""
    if focal_length is None:
        return None
    guesses = np.percentile(np.sort(np.asarray(focal_length)),
                            [1, 10, 20, 30, 40, 50, 60, 70, 80, 90, 99])
    return np.unique(guesses)


def _invert_space_np(mat: np.ndarray) -> np.ndarray:
    out = np.zeros_like(mat)
    scale = mat[:, 3:4, 3:4]
    out[:, :3, :3] = np.swapaxes(mat[:, :3, :3], -2, -1) / scale
    out[:, 3, 3] = 1.0
    out[:, :3, 3] = -np.sum(mat[:, :3, :3] / scale * mat[:, :3, None, 3],
                            axis=-2)
    return out


def estimate_poses_batch(target_coords: np.ndarray, target_mask: np.ndarray,
                         focal_guesses: Optional[np.ndarray]
                         ) -> Tuple[np.ndarray, Optional[np.ndarray],
                                    np.ndarray]:
    """The bootstrap's pose estimate from the encoder's outputs.

    target_coords: (B, H, W, 3); target_mask: (B, H, W) in [0, 1], cut at
    0.9. With `focal_guesses` None (orthographic camera) the solver runs
    at focal 100 and the pose is converted back to the orthographic model.
    Returns (cam2world (B, 4, 4) float32, focal (B,) float32 or None,
    errors (B,)).
    """
    mask = np.asarray(target_mask) > 0.9
    is_ortho = focal_guesses is None
    if is_ortho:
        focal_guesses = np.asarray([100.0])

    world2cam, focal, errors = compute_pose_pnp(
        np.asarray(target_coords), mask, focal_guesses)

    if is_ortho:
        s = 2.0 * focal_guesses[0] / -world2cam[:, 2, 3]
        t2 = world2cam[:, :2, 3] * s[..., None]
        world2cam = world2cam.copy()
        world2cam[:, :2, 3] = t2
        world2cam[:, 2, 3] = -10.0

    cam2world = _invert_space_np(world2cam)
    if is_ortho:
        cam2world = cam2world / s[:, None, None]
        return cam2world.astype(np.float32), None, errors
    return cam2world.astype(np.float32), focal.astype(np.float32), errors
