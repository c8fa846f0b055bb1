"""FID statistics and the Fréchet distance, on the host in numpy/scipy
(a copy of `nerf_from_image_tpu/metrics/fid.py`, which the port may not
import, less `sqrtm`'s `disp` argument and its fallback for a missing
scipy).

The activations come from `models/inception.InceptionV3FID`; the
statistics and the matrix square root stay on the host, as in the JAX
package and the reference.
"""

from __future__ import annotations

import numpy as np
from scipy import linalg


def calculate_stats(act: np.ndarray):
    mu = np.mean(act, axis=0)
    sigma = np.cov(act, rowvar=False)
    return mu, sigma


def _sqrtm(mat: np.ndarray) -> np.ndarray:
    # The JAX package passes disp=False, which newer scipy no longer takes;
    # the default returns the same root (and may warn).
    return linalg.sqrtm(mat)


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6):
    mu1 = np.atleast_1d(mu1)
    mu2 = np.atleast_1d(mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape
    assert sigma1.shape == sigma2.shape

    diff = mu1 - mu2
    covmean = _sqrtm(sigma1.dot(sigma2))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f'Imaginary component {m}')
        covmean = covmean.real

    return (diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) -
            2 * np.trace(covmean))
