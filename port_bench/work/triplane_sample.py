"""Kernel B1, the triplane sampler's forward: least bytes and FLOPs of
one call from its shapes, and the kernel names whose device time is its
time.

One call samples N points of each of B images from its three planes
(R x R, C channels, bf16) and writes C bf16 features a point. Each plane
byte is read once, each coordinate (3 float32) once, each feature
written once; four taps a plane, a multiply-add a channel a tap.
"""

KERNELS = ('triplane_sample_kernel',)
CHANNELS = 32


def call(batch: int, points: int, resolution: int,
         channels: int = CHANNELS) -> dict:
    """{'bytes', 'flops'} of one call; `points` per image."""
    n = batch * points
    return {'bytes': (batch * 3 * resolution * resolution * channels * 2 +
                      n * 3 * 4 + n * channels * 2),
            'flops': n * 3 * 4 * channels * 2}
