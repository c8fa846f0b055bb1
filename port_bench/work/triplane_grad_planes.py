"""Kernel B4, the triplane sampler's backward to the planes alone (the
coordinates are data): least bytes and FLOPs of one call from its
shapes, and the kernel names (the tile accumulation and the shared
binning of `triplane_bins.cuh`) whose device time is its time.

One call reads the float32 coordinates and the bf16 gradient of the
features once and writes the planes' float32 gradient once; a tap costs
a multiply-add a channel.
"""

KERNELS = ('grad_planes_tiles_kernel', 'histogram_kernel', 'scan_kernel',
           'scatter_kernel')
CHANNELS = 32


def call(batch: int, points: int, resolution: int,
         channels: int = CHANNELS) -> dict:
    """{'bytes', 'flops'} of one call; `points` per image."""
    n = batch * points
    return {'bytes': (n * 3 * 4 + n * channels * 2 +
                      batch * 3 * resolution * resolution * channels * 4),
            'flops': n * 3 * 4 * channels * 2}
