"""A kernel's share of its roofline over the traced window, in percent.

The least time of the window's calls of the kernel (from
`port_bench/work/<kernel>.py`: each call's bytes over the card's memory
rate or its FLOPs over the float32 rate, whichever is larger), over the
device time of the kernels that its work file names. The calls and
their shapes are the driver's count of the work the window completed.
None when the kernel did not run in the window.
"""

import json
import pathlib
import re

BENCH = pathlib.Path(__file__).resolve().parents[1]


def kernel_seconds(tracer, names) -> float:
    pattern = re.compile(r'\b(' + '|'.join(map(re.escape, names)) + r')\b')
    return sum(s for op, s in tracer.op_seconds().items()
               if pattern.search(op))


def share(ctx: dict, kernel: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f'port_bench_work_{kernel}', BENCH / 'work' / f'{kernel}.py')
    work = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(work)
    calls = ctx['work']['kernels'].get(kernel)
    seconds = kernel_seconds(ctx['tracer'], work.KERNELS)
    if not calls or not seconds:
        return None
    with open(BENCH / 'work' / 'peaks.json') as f:
        peaks = json.load(f)
    one = work.call(*calls['shape'])
    least = calls['count'] * max(one['bytes'] / peaks['hbm_bytes_per_s'],
                                 one['flops'] / peaks['flops_per_s']['float32'])
    return 100.0 * least / seconds
