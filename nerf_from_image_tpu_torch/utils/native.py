"""Builds the repository's host C++ sources (`native/*.cc`) for ctypes.

Each source is compiled with the host C++ compiler and the flags of
`native/Makefile` into `build/native/<stem>-<hash>.so` at the root of the
checkout (listed in .gitignore) at its first use. The name carries a hash
of the source and the flags, so an edited source is never served by a
stale build. `make` in `native/` is never run: the `.so` files there are
not part of a checkout.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess

REPO = pathlib.Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO / 'native'
BUILD_DIR = REPO / 'build' / 'native'
CXX_FLAGS = ('-O3', '-fPIC', '-shared', '-std=c++17')


def library_path(source: pathlib.Path, stem: str) -> pathlib.Path:
    digest = hashlib.sha256(source.read_bytes() +
                            ' '.join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'{stem}-{digest[:12]}.so'


def _compiler() -> str:
    for name in (os.environ.get('CXX'), 'g++', 'c++'):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError('no C++ compiler found (set CXX or PATH)')


def build(source: pathlib.Path, stem: str) -> pathlib.Path:
    """The path of `source`'s library, compiled first if it is missing.

    Raises RuntimeError with the compiler's output when the build fails.
    """
    path = library_path(source, stem)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f'.tmp{os.getpid()}.so')
        proc = subprocess.run([_compiler(), *CXX_FLAGS, '-o', str(tmp),
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'build of {source.name} failed '
                               f'({proc.returncode}):\n'
                               f'{proc.stdout}{proc.stderr}')
        os.replace(tmp, path)
    return path
