"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is an entry of `BENCHMARK.json`'s
`workloads`; everything it names is found by name under `port_bench/`:
the configuration (`configs/<config>.json`), the traffic mix
(`traffic/<traffic>.json`, which names its driver,
`drivers/<driver>.py`), the correctness limits (`limits/<cell>.json`)
and, in a traced run, each per-layer metric's reader
(`metrics/<metric name up to its first dot>.py`). A new cell, mix,
configuration or metric is new files and new entries; no file here
changes.

The driver sets the program up from the seed, warms up every shape,
measures for `--seconds` (ending with the unit of work in progress), and
checks the window's results against the plain reference once the window
has closed. The last line of standard output is one JSON object:
correct, attempted, failed, the metrics (end-to-end with --trace 0,
per-layer with --trace 1), the device, with --trace 1 the breakdown,
and last the numbers compared with their limits, which also end
standard error. Without a card, with fewer cards than the cell asks
for, or when JAX or the JAX package is loaded in this process once the
window has closed, the run exits non-zero and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# Whole top-level module names that no run may load.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'nerf_from_image_tpu')


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """Imports a harness file by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        'port_bench_' + path.stem.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def resolve(cell_name: str, bench: dict = None) -> dict:
    """The cell's entry with its configuration, traffic, driver and limits
    loaded: {'cell', 'config', 'traffic', 'limits', 'driver_path'}."""
    bench = bench or load_json(ROOT / 'BENCHMARK.json')
    cells = {c['name']: c for c in bench['workloads']}
    if cell_name not in cells:
        raise KeyError(f'no workload {cell_name!r} in BENCHMARK.json')
    cell = cells[cell_name]
    config = load_json(BENCH / 'configs' / f'{cell["config"]}.json')
    traffic = load_json(BENCH / 'traffic' / f'{cell["traffic"]}.json')
    return {'cell': cell, 'config': config, 'traffic': traffic,
            'limits': load_json(BENCH / 'limits' / f'{cell_name}.json'),
            'driver_path': BENCH / 'drivers' / f'{traffic["driver"]}.py'}


def metrics_of(bench: dict, cell_name: str, kind: str) -> list:
    """The metrics of `kind` ('end_to_end' or 'per_layer') this cell
    reports: those that list it, and those without a list."""
    return [m for m in bench[kind]
            if cell_name in m.get('workloads', [cell_name])]


def forbidden_modules() -> list:
    return sorted({name.split('.')[0] for name in list(sys.modules)} &
                  set(FORBIDDEN))


def fail(message: str) -> int:
    print(message, file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench = load_json(ROOT / 'BENCHMARK.json')
    spec = resolve(args.workload, bench)
    driver = load_module(spec['driver_path'])  # imports the program
    print(f'set-up imports {time.perf_counter() - T_PROCESS:.3f} s',
          file=sys.stderr, flush=True)
    import torch
    chips = spec['cell']['chips']
    if not torch.cuda.is_available():
        return fail('no CUDA device: the benchmark measures the card only')
    if torch.cuda.device_count() < chips:
        return fail(f'{args.workload} needs {chips} cards, this host has '
                    f'{torch.cuda.device_count()}')

    outcome = driver.run(spec, args, T_PROCESS, torch.device('cuda', 0))

    found = forbidden_modules()
    if found:
        return fail(f'the run loaded {found}: the port and the benchmark '
                    'must not import JAX or the JAX package')

    kind = 'per_layer' if args.trace else 'end_to_end'
    metrics = {}
    for m in metrics_of(bench, args.workload, kind):
        if kind == 'end_to_end':
            value = outcome['end_to_end'].get(m['name'])
        else:
            reader = load_module(
                BENCH / 'metrics' / f'{m["name"].split(".")[0]}.py')
            value = reader.read(outcome['context'])
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}

    result = {'correct': outcome['correct'],
              'attempted': outcome['attempted'],
              'failed': outcome['failed'],
              'metrics': metrics,
              'device': outcome['device']}
    if args.trace:
        result['breakdown'] = outcome['context']['tracer'].breakdown()
    result['checks'] = outcome['checks']
    for name, c in outcome['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(f'correct {outcome["correct"]}', file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    os.chdir(ROOT)
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
