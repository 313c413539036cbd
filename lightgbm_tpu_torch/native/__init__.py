"""The native text parser (``parser.cpp``), loaded with ctypes.

The library has a plain C interface (``ltpu_scan``, ``ltpu_dims_csv``,
``ltpu_parse_csv``, ``ltpu_dims_libsvm``, ``ltpu_parse_libsvm``,
``ltpu_atof``), so it is compiled with
``g++ -O3 -shared -fPIC -std=c++17 -pthread`` at first use, with no
Python headers, into ``build/native/`` at the repository root
(git-ignored), named by a hash of the source: an edited source is
rebuilt, an unchanged one reused.  The same environment switches as the
JAX package's loader mean the same thing here:

- ``LIGHTGBM_TPU_NO_NATIVE`` (any value): do not build or load the
  library; the readers parse with pandas' C engine instead;
- ``LIGHTGBM_TPU_NATIVE_CACHE=<dir>``: build into ``<dir>`` instead.

``get_lib()`` returns the loaded library, or None when it is switched
off or no compiler is available; callers keep a fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ..obs.trace import note_compile

SRC = Path(__file__).resolve().parent / "parser.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build(src: Path, out: str) -> bool:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", str(src), "-o", out]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        note_compile("build")
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def library_path() -> Optional[str]:
    """Where the library for the current source is (or would be) built;
    None when the source cannot be read."""
    try:
        digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    except OSError:
        return None
    cache_dir = os.environ.get("LIGHTGBM_TPU_NATIVE_CACHE") or str(BUILD_DIR)
    return os.path.join(cache_dir, f"parser_{digest}.so")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32 = ctypes.c_int64, ctypes.c_int
    pd = ctypes.POINTER(ctypes.c_double)
    vp, cp, ch = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char
    for name, args, res in (
            ("ltpu_scan", [cp, i64], vp),
            ("ltpu_scan_free", [vp], None),
            ("ltpu_dims_csv", [vp, cp, ch, i32, ctypes.POINTER(i64), ctypes.POINTER(i32)], i32),
            ("ltpu_parse_csv", [vp, cp, ch, i32, pd, i64, i32, i32], i32),
            ("ltpu_dims_libsvm", [vp, cp, ctypes.POINTER(i64), ctypes.POINTER(i32)], i32),
            ("ltpu_parse_libsvm", [vp, cp, pd, pd, i64, i32, i32], i32),
            ("ltpu_atof", [cp], ctypes.c_double)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("LIGHTGBM_TPU_NO_NATIVE"):
            return None
        so = library_path()
        if so is None:
            return None
        if not os.path.exists(so):
            try:
                os.makedirs(os.path.dirname(so), exist_ok=True)
            except OSError:
                return None
            tmp = so + f".tmp{os.getpid()}"
            if not _build(SRC, tmp):
                return None
            os.replace(tmp, so)
        try:
            _LIB = _bind(ctypes.CDLL(so))
        except OSError:
            return None
        return _LIB


def atof(s: str) -> float:
    """The reference's Atof (common.h:163-261) of one token; Python's
    ``float`` when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return float(s)
    return lib.ltpu_atof(s.encode())
