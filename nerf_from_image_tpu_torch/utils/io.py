"""The .npz files of the inversion report (a copy of the local-path part
of `save_npz` and `load_npz` in `nerf_from_image_tpu/utils/io.py`, which
the port may not import).

The JAX package's versions also take gs:// paths; these take local paths
only, so the report's other file calls are Python's own.
"""

from __future__ import annotations

import os

import numpy as np


def save_npz(path: str, compressed: bool = False, **arrays) -> None:
    """np.savez (or savez_compressed) into `path`, its parent made first."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, 'wb') as f:
        (np.savez_compressed if compressed else np.savez)(f, **arrays)


def load_npz(path: str) -> dict:
    """Every array of an .npz file, loaded."""
    with open(path, 'rb') as f:
        return dict(np.load(f))
