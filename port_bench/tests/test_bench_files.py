"""BENCHMARK.json and the files its cells name: they parse, resolve, and
keep to the benchmark's naming rules."""

import json
import pathlib
import re

import pytest

from port_bench import run as run_lib

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [c['name'] for c in BENCH['workloads']]


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= BENCH['run_seconds'] <= 51
    assert BENCH['paths'] == ['port_bench']
    for word in BENCH['command']:
        assert not word.startswith('/') and '..' not in word


@pytest.mark.parametrize('path', sorted(
    (ROOT / 'port_bench').glob('*/*.json')), ids=lambda p: p.name)
def test_json_files_parse(path):
    assert isinstance(json.loads(path.read_text()), dict)


@pytest.mark.parametrize('cell', CELLS)
def test_cell_resolves(cell):
    spec = run_lib.resolve(cell, BENCH)
    assert spec['driver_path'].exists()
    assert spec['config']['name'] == spec['cell']['config']
    assert spec['limits']


def test_every_config_is_used_and_has_its_file():
    used = {c['config'] for c in BENCH['workloads']}
    for c in BENCH['configs']:
        assert c['name'] in used
        assert (ROOT / c['file']).exists()
        assert c['file'].startswith('port_bench/')
        assert json.loads((ROOT / c['file']).read_text())['reduced'] == \
            c['reduced']


def test_names_units_and_sources():
    names = []
    for kind in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for entry in BENCH[kind]:
            assert NAME.match(entry['name']), entry['name']
            names.append((kind, entry['name']))
            if 'unit' in entry:
                assert UNIT.match(entry['unit']), entry['unit']
                assert entry['better'] in ('lower', 'higher')
    assert len(set(names)) == len(names)
    metric_names = [m['name'] for m in BENCH['end_to_end'] +
                    BENCH['per_layer']]
    assert len(set(metric_names)) == len(metric_names)
    for m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert 'setup_s' in {m['name'] for m in BENCH['end_to_end']}


def test_per_layer_metrics_have_readers_and_move_a_reported_metric():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    for m in BENCH['per_layer']:
        reader = ROOT / 'port_bench' / 'metrics' / \
            f'{m["name"].split(".")[0]}.py'
        assert reader.exists(), reader
        assert m['moves'] in e2e
        moved_in = e2e[m['moves']].get('workloads', CELLS)
        assert set(m.get('workloads', CELLS)) <= set(moved_in)
        if 'roofline' in m['name'] or 'mfu' in m['name']:
            assert m['unit'] == '%'


@pytest.mark.parametrize('cell', CELLS)
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = run_lib.metrics_of(BENCH, cell, 'end_to_end')
    assert 'setup_s' in {m['name'] for m in e2e} and len(e2e) >= 2
    assert run_lib.metrics_of(BENCH, cell, 'per_layer')
