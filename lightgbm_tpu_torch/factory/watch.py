"""Data-directory watcher — PyTorch counterpart of
lightgbm_tpu/factory/watch.py, the same fingerprints (a run id is built
from them, so both packages must give the same ones).

Poll-based (no inotify; works on network mounts).  A file's fingerprint
is its size, mtime and a CRC32 over its first and last 64 KiB: cheap to
rescan every poll, and an append moves both the size and the tail CRC,
so an appended chunk retrains like a new file.  A change counts only
once every watched file's mtime is ``debounce_s`` old, so a writer
mid-append never triggers a retrain on a half-written chunk.
"""

from __future__ import annotations

import os
import time
import zlib
from typing import Dict, List, Tuple

_FP_CHUNK = 65536
DATA_SUFFIXES: Tuple[str, ...] = (".csv", ".tsv", ".txt", ".data")


def fingerprint(path: str) -> Dict:
    st = os.stat(path)
    with open(path, "rb") as f:
        crc = zlib.crc32(f.read(_FP_CHUNK))
        if st.st_size > 2 * _FP_CHUNK:
            f.seek(-_FP_CHUNK, os.SEEK_END)
            crc = zlib.crc32(f.read(_FP_CHUNK), crc)
    return {"size": int(st.st_size), "mtime_ns": int(st.st_mtime_ns), "crc32": crc & 0xFFFFFFFF}


def scan(data_dir: str, suffixes: Tuple[str, ...] = DATA_SUFFIXES) -> Dict[str, Dict]:
    """{filename: fingerprint} of every data chunk in ``data_dir``, by name
    (chunk order is lexical order); hidden files and other suffixes are
    ignored."""
    out: Dict[str, Dict] = {}
    try:
        names = sorted(os.listdir(data_dir))
    except OSError:
        return out
    for name in names:
        if name.startswith(".") or (suffixes and not name.endswith(suffixes)):
            continue
        path = os.path.join(data_dir, name)
        try:
            if os.path.isfile(path):
                out[name] = fingerprint(path)
        except OSError:
            continue  # vanished mid-scan; the next poll sees the truth
    return out


def changed(prev: Dict[str, Dict], cur: Dict[str, Dict]) -> List[str]:
    """Names that are new or whose content moved (size or CRC; an mtime
    alone is no change: a touch must not retrain)."""
    out = []
    for name, fp in cur.items():
        old = prev.get(name)
        if old is None or old["size"] != fp["size"] or old["crc32"] != fp["crc32"]:
            out.append(name)
    return out


def stable(cur: Dict[str, Dict], debounce_s: float) -> bool:
    """True once every watched file's mtime is ``debounce_s`` old."""
    now = time.time()
    return all(now - fp["mtime_ns"] / 1e9 >= debounce_s for fp in cur.values())


def combined_fingerprint(cur: Dict[str, Dict]) -> str:
    """Order-stable fingerprint of the whole data set, the content half of
    a run id: unchanged data maps to the same run."""
    crc = 0
    for name in sorted(cur):
        fp = cur[name]
        crc = zlib.crc32(f"{name}:{fp['size']}:{fp['crc32']}".encode(), crc)
    return f"{crc & 0xFFFFFFFF:08x}"
