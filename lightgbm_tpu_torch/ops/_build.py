"""Build and bind the port's CUDA kernels (``lightgbm_tpu_torch/csrc``).

The sources have a plain C interface, so they are compiled with ``nvcc``
straight into one shared library and loaded with ``ctypes`` — no
PyTorch headers, which keeps a cold build to seconds.  Each ``.cu`` file
compiles to an object in its own ``nvcc`` process (all started
together), then one link step makes the library.

The build happens at first use, into ``build/torch_kernels/<hash>/`` at
the repository root (git-ignored), where ``<hash>`` covers the sources
and the flags, so an edited source is rebuilt and an unchanged one is
reused.  A missing ``nvcc`` or a failed build raises; nothing falls back
to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false"]

_LOCK = threading.Lock()
_LIB = None

# (name, argtypes) of every C entry point; every pointer and the stream
# are c_void_p so ctypes never truncates them to 32 bits
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "lgbt_update_root_hist": [_P, _L, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _F, _F, _F, _I, _I, _I, _P, _P],
    "lgbt_partition_hist": [_P, _P, _L, _I, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I,
                            _I, _I, _I, _I, _P, _P],
    "lgbt_score_add": [_P, _L, _I, _P, _I, _P],
}


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin): the CUDA "
        "kernels of lightgbm_tpu_torch cannot be built")


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "liblgbt_kernels.so"


def build() -> Path:
    """Compile every source in parallel and link the shared library;
    returns its path.  A library already built from identical sources is
    reused."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out.parent))
    try:
        procs = []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs, errors = [], []
        for src, obj, proc in procs:
            log, _ = proc.communicate()
            (tmp / (src.stem + ".log")).write_text(log)
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
            objs.append(str(obj))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        so = tmp / out.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(so), *objs]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout)
        for log in tmp.glob("*.log"):
            os.replace(log, out.parent / log.name)
        os.replace(so, out)  # atomic: a concurrent build sees all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def lib():
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
        return _LIB


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError_t {rc}")
