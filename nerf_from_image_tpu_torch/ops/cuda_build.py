"""Builds the port's CUDA sources with nvcc and loads them through ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/cuda/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and the flags, so an edited
source is never served by a stale build. Libraries go to `build/cuda/` at
the root of the checkout (listed in .gitignore). Nothing is built when the
package is imported: a wrapper builds its library at its first CUDA call,
and `build()` builds several at once, one nvcc process per source, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Sequence

CSRC_DIR = pathlib.Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / 'build' / 'cuda'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_libraries: Dict[str, ctypes.CDLL] = {}
# Wall seconds of each nvcc run and its compiler output (ptxas register
# and spill report), by source name, for the builds made in this process.
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = pathlib.Path(cuda_home) / 'bin' / 'nvcc'
    if candidate.exists():
        return str(candidate)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME or PATH)')
    return found


def library_path(name: str) -> pathlib.Path:
    source = CSRC_DIR / f'{name}.cu'
    digest = hashlib.sha256(source.read_bytes() +
                            ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}-{digest[:12]}.so'


def build(names: Sequence[str]) -> Dict[str, pathlib.Path]:
    """Compiles every named source whose library is missing, in parallel.

    Raises RuntimeError with nvcc's output when a compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    nvcc = _nvcc()
    running = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f'.tmp{os.getpid()}.so')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC_DIR / f'{name}.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, time.perf_counter())
    failures = []
    for name, (proc, tmp, start) in running.items():
        output, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - start
        build_log[name] = output
        if proc.returncode != 0:
            failures.append(f'{name}: nvcc exited {proc.returncode}\n{output}')
            continue
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError('CUDA build failed:\n' + '\n'.join(failures))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _libraries:
        path = build([name])[name]
        _libraries[name] = ctypes.CDLL(str(path))
    return _libraries[name]
