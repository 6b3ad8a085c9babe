"""Build a C++ source with g++ at first use and load it with :mod:`ctypes`.

The library goes into ``build/native/<hash>/`` at the repository root
(listed in ``.gitignore``), keyed on a hash of the source, so an edited
source rebuilds and the source directory stays untouched. A failed build
or load is remembered, and the caller takes its numpy path from then on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
_lock = threading.Lock()
# (source, library name) -> the bound library, or None after a failure
_libs: Dict[Tuple[Path, str], Optional[ctypes.CDLL]] = {}


def so_path(src: Path, so_name: str) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / digest / so_name


def _build(src: Path, so: Path) -> bool:
    # a per-pid temporary name, then a rename (atomic on POSIX): another
    # process racing the build never loads a half-written library
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    for cmd in (
        ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", str(src), "-o", tmp],
        ["g++", "-O3", "-shared", "-fPIC", str(src), "-o", tmp],
    ):
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
            return True
        except (subprocess.SubprocessError, FileNotFoundError, OSError):
            continue
    return False


def load_library(src: Path, so_name: str,
                 bind: Callable[[ctypes.CDLL], None]
                 ) -> Optional[ctypes.CDLL]:
    """The library built from ``src``, with ``bind`` (which sets its
    functions' argtypes and restypes) applied once; None if g++ or the
    load failed."""
    key = (src, so_name)
    with _lock:
        if key in _libs:
            return _libs[key]
        so = so_path(src, so_name)
        lib = None
        if so.exists() or _build(src, so):
            try:
                lib = ctypes.CDLL(str(so))
                bind(lib)
            except OSError:
                lib = None
        _libs[key] = lib
        return lib
