"""What the benchmark loads: never JAX, flax or the JAX package (whole
top-level names: the port's own name begins with the JAX package's), and
the reference nothing of the program."""

import ast
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / 'port_bench'
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'nerf_from_image_tpu'}


def imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            roots.add(node.module.split('.')[0])
    return roots


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob('*.py'):
        assert not imported_roots(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / 'reference').glob('*.py'):
        assert 'nerf_from_image_tpu_torch' not in imported_roots(path), path


def test_loading_every_module_loads_no_jax():
    """Every harness module imported in a fresh process, the program's
    with them: none of the forbidden names is in sys.modules after."""
    code = (
        'import importlib, pathlib, sys, json\n'
        'root = pathlib.Path(sys.argv[1])\n'
        'for p in sorted((root / "port_bench").rglob("*.py")):\n'
        '    if "tests" in p.parts:\n'
        '        continue\n'
        '    name = ".".join(p.relative_to(root).with_suffix("").parts)\n'
        '    if "." in p.stem:\n'
        '        continue\n'
        '    importlib.import_module(name)\n'
        'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))\n')
    out = subprocess.run([sys.executable, '-c', code, str(ROOT)], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, 'USE_FLAX': '0'})
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert 'nerf_from_image_tpu_torch' in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_without_the_program():
    code = ('import sys, importlib, pathlib\n'
            'for p in sorted(pathlib.Path("port_bench/reference")'
            '.glob("*.py")):\n'
            '    importlib.import_module("port_bench.reference." + p.stem)\n'
            'assert not [m for m in sys.modules '
            'if m.split(".")[0] == "nerf_from_image_tpu_torch"]\n')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True)
