"""The traced window's arithmetic, on a timeline written by hand: the
device's busy union, the idle gaps by the host's span, the breakdown,
and the per-layer readers that take their numbers from it."""

import pytest

from port_bench import trace as trace_lib
from port_bench.metrics import idle_share, mfu, roofline
from port_bench.work import triplane_sample


def timeline() -> trace_lib.Tracer:
    t = trace_lib.Tracer(True)
    t.window_span = (0.0, 10.0)
    # Two overlapping kernels, one apart, one past the window's end.
    t.ops = [('triplane_sample_kernel(bf16)', 1.0, 3.0),
             ('gemm', 2.0, 4.0), ('gemm', 6.0, 7.0), ('gemm', 9.5, 11.0)]
    t.spans = [('refine', 0.0, 5.0), ('pnp_wait', 4.0, 8.0)]
    return t


def test_busy_union_and_idle_gaps():
    t = timeline()
    assert t.busy_intervals() == [(1.0, 4.0), (6.0, 7.0), (9.5, 10.0)]
    assert t.busy_s() == pytest.approx(4.5)
    gaps = t.idle_gaps()
    # [0, 1] in refine; [4, 6] and [7, 9.5] in pnp_wait (innermost).
    assert gaps == pytest.approx({'refine': 1.0, 'pnp_wait': 2.0,
                                  'host': 2.5})
    assert idle_share.read({'tracer': t}) == pytest.approx(55.0)


def test_breakdown_orders_and_caps():
    b = timeline().breakdown(top=2)
    assert b['device_ops'][0] == ['gemm', 3.5]
    assert len(b['device_ops']) == 2 and len(b['idle_gaps']) == 2


def test_roofline_reads_its_kernels_and_is_silent_without_them():
    t = timeline()
    shape = (8, 1000, 64)
    ctx = {'tracer': t, 'work': {'kernels': {
        'triplane_sample': {'count': 3, 'shape': shape}}}}
    one = triplane_sample.call(*shape)
    least = 3 * max(one['bytes'] / 3.35e12, one['flops'] / 67e12)
    assert roofline.share(ctx, 'triplane_sample') == pytest.approx(
        100 * least / 2.0)
    t.ops = [op for op in t.ops if not op[0].startswith('triplane')]
    assert roofline.share(ctx, 'triplane_sample') is None


def test_mfu_counts_completed_units_over_the_window():
    cfg = {'batch': 2, 'resolution': 32, 'plane_resolution': 16,
           'channel_base': 256, 'channel_max': 32, 'samples_per_ray': 8,
           'crops': 15, 'steps': 3}
    ctx = {'tracer': timeline(), 'work': {
        'model': 'stylegan_triplane', 'unit': 'inversion_batch',
        'precision': 'float32', 'units': 4, 'shapes': cfg}}
    from port_bench.work import stylegan_triplane
    flops = sum(stylegan_triplane.inversion_batch(cfg).values())
    assert mfu.read(ctx) == pytest.approx(100 * 4 * flops / 67e12 / 10.0)
