"""The command's refusals: without a card it exits non-zero and prints no
metric; in a directory that holds only BENCHMARK.json and the
benchmark's files it does the same."""

import json
import pathlib
import shutil
import subprocess

ROOT = pathlib.Path(__file__).resolve().parents[2]


def run_cell(cwd: pathlib.Path):
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cell = bench['workloads'][0]['name']
    return subprocess.run(
        [*bench['command'], '--workload', cell, '--seed', '2147483700',
         '--seconds', '1', '--trace', '0'],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result():
    out = run_cell(ROOT)
    assert out.returncode != 0
    assert 'no CUDA device' in out.stderr
    assert not out.stdout.strip()


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'port_bench', tmp_path / 'port_bench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = run_cell(tmp_path)
    assert out.returncode != 0
    assert 'nerf_from_image_tpu_torch' in out.stderr
    assert not out.stdout.strip()
