"""B2's share of its roofline (`roofline.py`)."""

from port_bench.metrics import roofline


def read(ctx: dict):
    return roofline.share(ctx, 'triplane_grad')
