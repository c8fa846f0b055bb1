"""COCO RLE mask codec over `native/rle.cc` (a copy of
`nerf_from_image_tpu/data/rle.py`, which the port may not import).

Decodes both compressed (LEB128-style string) and raw-counts RLE into
row-major uint8 masks, and encodes masks back to raw counts; runs are in
column-major (Fortran) order, per the COCO spec. The codec is built by
`utils/native.py` into `build/native/librle-<hash>.so` at its first use.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np

from nerf_from_image_tpu_torch.utils import native

SOURCE = native.NATIVE_DIR / 'rle.cc'

_library = None


def load_library() -> ctypes.CDLL:
    global _library
    if _library is not None:
        return _library
    lib = ctypes.CDLL(str(native.build(SOURCE, 'librle')))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.nfi_rle_decode_mask.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                        ctypes.c_int, u8p]
    lib.nfi_rle_decode_mask.restype = ctypes.c_int
    lib.nfi_rle_counts_to_mask.argtypes = [i64p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, u8p]
    lib.nfi_rle_counts_to_mask.restype = None
    lib.nfi_rle_encode_mask.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                        i64p, ctypes.c_int]
    lib.nfi_rle_encode_mask.restype = ctypes.c_int
    _library = lib
    return lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(ctypes.POINTER(kind))


def decode(rle: Dict) -> np.ndarray:
    """Decodes a COCO RLE dict {'size': [h, w], 'counts': str|list}."""
    lib = load_library()
    h, w = rle['size']
    out = np.zeros((h, w), dtype=np.uint8)
    counts = rle['counts']
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            counts = counts.encode('ascii')
        if lib.nfi_rle_decode_mask(counts, h, w, _ptr(out, ctypes.c_uint8)):
            raise ValueError('Invalid compressed RLE string')
    else:
        arr = np.ascontiguousarray(np.asarray(counts, dtype=np.int64))
        lib.nfi_rle_counts_to_mask(_ptr(arr, ctypes.c_int64), len(arr), h,
                                   w, _ptr(out, ctypes.c_uint8))
    return out


def encode(mask: np.ndarray) -> Dict:
    """Encodes a binary mask to raw-counts RLE."""
    lib = load_library()
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = mask.shape
    counts = np.zeros(h * w + 2, dtype=np.int64)
    n = lib.nfi_rle_encode_mask(_ptr(mask, ctypes.c_uint8), h, w,
                                _ptr(counts, ctypes.c_int64), len(counts))
    if n < 0:
        raise ValueError('RLE encode overflow')
    return {'size': [h, w], 'counts': counts[:n].tolist()}
