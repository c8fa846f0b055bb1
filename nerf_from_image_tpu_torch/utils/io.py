"""Host-side IO helpers (copies of the local-path part of
`nerf_from_image_tpu/utils/io.py`, which the port may not import): the
.npz files of the inversion report, the endless batch sampler and the
semantic colour palette.

The JAX package's file functions also take gs:// paths; these take local
paths only, so the port's other file calls are Python's own.
"""

from __future__ import annotations

import colorsys
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


class EndlessSampler:
    """Shuffled endless index stream (reference lib/utils.py:163-192).

    Deterministic given the numpy RandomState; its state is (permutation,
    position), read by `get_state` and restored by `set_state`.
    """

    def __init__(self, dataset_size: int, rng: np.random.RandomState):
        self.dataset_size = dataset_size
        self.rng = rng
        self._perm = rng.permutation(dataset_size)
        self._pos = 0

    def __call__(self, batch_size: int) -> np.ndarray:
        out = []
        while len(out) < batch_size:
            if self._pos >= self.dataset_size:
                self._perm = self.rng.permutation(self.dataset_size)
                self._pos = 0
            take = min(batch_size - len(out), self.dataset_size - self._pos)
            out.extend(self._perm[self._pos:self._pos + take].tolist())
            self._pos += take
        return np.asarray(out)

    def get_state(self):
        return {'perm': self._perm.copy(), 'pos': self._pos,
                'rng': self.rng.get_state()}

    def set_state(self, state):
        """Restores the permutation and position, and the RandomState when
        the state holds one."""
        self._perm = np.asarray(state['perm'])
        self._pos = int(state['pos'])
        if 'rng' in state:
            self.rng.set_state(state['rng'])


def get_color_palette(n: int) -> np.ndarray:
    """n distinct colours in [-1, 1], (n, 3) float32: the GAN evaluation's
    palette for the semantics images."""
    colors = [colorsys.hsv_to_rgb(i / n, 0.65, 0.9) for i in range(n)]
    return np.asarray(colors, dtype=np.float32) * 2.0 - 1.0
