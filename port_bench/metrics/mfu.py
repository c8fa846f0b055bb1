"""The whole step's share of the card's peak, in percent: the model
FLOPs of the work the traced window completed (`port_bench/work/`,
counted from the cell's shapes), each part at the published dense peak
of the precision the configuration runs it in, over the window's time.
"""

import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]


def read(ctx: dict):
    w = ctx['work']
    tracer = ctx['tracer']
    if not w['units'] or not tracer.window_s:
        return None
    spec = importlib.util.spec_from_file_location(
        f'port_bench_work_{w["model"]}', BENCH / 'work' / f'{w["model"]}.py')
    model = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(model)
    with open(BENCH / 'work' / 'peaks.json') as f:
        peak = json.load(f)['flops_per_s'][w['precision']]
    flops = sum(getattr(model, w['unit'])(w['shapes']).values())
    return 100.0 * w['units'] * flops / peak / tracer.window_s
