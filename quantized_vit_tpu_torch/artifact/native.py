"""The C++ artifact packer (``_native/pack.cc``, OpenMP, bound with
:mod:`ctypes`), with the numpy path beside it
(``quantized_vit_tpu/artifact/native.py``): int4 packing and unpacking
along K, and the per-column weight-level quantization.

The library is built with g++ at first use into ``build/native/<hash>/``
at the repository root (listed in ``.gitignore``), keyed on a hash of the
source, so an edited source rebuilds and the source directory stays
untouched. Without g++ every function takes its numpy path, as the JAX
package's does. Host code only: no device is involved.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..utils._gxx import load_library

_SRC = Path(__file__).resolve().parent / "_native" / "pack.cc"
_SO = "libqvtpack.so"


def _bind(lib: ctypes.CDLL) -> None:
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.qvt_pack_int4.argtypes = [i8p, i64, i64, i8p]
    lib.qvt_unpack_int4.argtypes = [i8p, i64, i64, i8p]
    lib.qvt_quantize_levels.argtypes = [f32p, f32p, i64, i64, ctypes.c_int,
                                        ctypes.c_int, i8p]
    for fn in (lib.qvt_pack_int4, lib.qvt_unpack_int4,
               lib.qvt_quantize_levels):
        fn.restype = None


def _load():
    return load_library(_SRC, _SO, _bind)


def native_available() -> bool:
    return _load() is not None


def _pack_int4_np(levels: np.ndarray) -> np.ndarray:
    k = levels.shape[0]
    lo = levels[: k // 2]
    hi = levels[k // 2:]
    return ((lo & 0xF) | ((hi & 0xF) << 4)).astype(np.int8)


def _unpack_int4_np(packed: np.ndarray) -> np.ndarray:
    lo = (packed << 4).astype(np.int8) >> 4
    hi = packed >> 4
    return np.concatenate([lo, hi], axis=0).astype(np.int8)


def _quantize_levels_np(w: np.ndarray, scale: np.ndarray, lo: int,
                        hi: int) -> np.ndarray:
    q = np.rint(w / scale[None, :])
    return np.clip(q, lo, hi).astype(np.int8)


def pack_int4_host(levels: np.ndarray) -> np.ndarray:
    """[K, N] int8 levels in [-8, 7] -> [K/2, N] packed (row i with row
    i + K/2), as ``quant.pack_int4``."""
    levels = np.ascontiguousarray(levels, np.int8)
    k, n = levels.shape
    if k % 2:
        raise ValueError(f"K={k} must be even")
    lib = _load()
    if lib is None:
        return _pack_int4_np(levels)
    out = np.empty((k // 2, n), np.int8)
    lib.qvt_pack_int4(levels, k, n, out)
    return out


def unpack_int4_host(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_int4_host`."""
    packed = np.ascontiguousarray(packed, np.int8)
    kh, n = packed.shape
    lib = _load()
    if lib is None:
        return _unpack_int4_np(packed)
    out = np.empty((2 * kh, n), np.int8)
    lib.qvt_unpack_int4(packed, kh, n, out)
    return out


def quantize_levels_host(w: np.ndarray, scale: np.ndarray, lo: int,
                         hi: int) -> np.ndarray:
    """``clip(round(w / scale[col]), lo, hi)`` as int8, the export's hot
    loop. The numpy path rounds half to even, the native one half away
    from zero, as the JAX package's two paths do: they differ only at an
    exact tie."""
    w = np.ascontiguousarray(w, np.float32)
    k, n = w.shape
    scale = np.ascontiguousarray(np.broadcast_to(scale, (n,)), np.float32)
    lib = _load()
    if lib is None:
        return _quantize_levels_np(w, scale, lo, hi)
    out = np.empty((k, n), np.int8)
    lib.qvt_quantize_levels(w, scale, k, n, int(lo), int(hi), out)
    return out
