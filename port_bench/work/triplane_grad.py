"""Kernel B2, the triplane sampler's backward to the planes and the
coordinates: least bytes and FLOPs of one call from its shapes, and the
kernel names (the tile accumulation, the partial sums and the shared
binning of `triplane_bins.cuh`) whose device time is its time.

One call reads the bf16 planes (for the coordinates' gradient), the
float32 coordinates and the bf16 gradient of the features once, and
writes the planes' float32 gradient and the coordinates' once; a tap
costs a multiply-add a channel for the planes and one for the
coordinates.
"""

KERNELS = ('grad_tiles_kernel', 'sum_partials_kernel', 'histogram_kernel',
           'scan_kernel', 'scatter_kernel')
CHANNELS = 32


def call(batch: int, points: int, resolution: int,
         channels: int = CHANNELS) -> dict:
    """{'bytes', 'flops'} of one call; `points` per image."""
    n = batch * points
    plane = batch * 3 * resolution * resolution * channels
    return {'bytes': plane * 2 + n * 3 * 4 + n * channels * 2 + plane * 4 +
            n * 3 * 4,
            'flops': n * 3 * 4 * channels * 4}
