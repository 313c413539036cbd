"""Binary dataset cache, format v2: random access + integrity — the
PyTorch port's copy of lightgbm_tpu/data/cache.py (host code, no torch),
so a cache written by either package loads in the other.

Format v1 was a ``np.savez_compressed`` archive, which has no random
access.  Format v2 keeps the same npz member layout (``io/dataset.py``
owns the payload schema) but

  - stores members UNCOMPRESSED (``np.savez``), so the ``binned``
    matrix's bytes sit contiguous in the file and a row-range is one
    ``seek`` + ``read`` (or an ``np.memmap`` view);
  - adds a ``__cache_meta__`` JSON header: format version, the SOURCE
    file's identity (path/size/mtime) so a regenerated source refuses a
    stale cache instead of silently training old data, and the dataset
    fingerprint (``rows x cols : crc32``);
  - adds ``chunk_crc``: one CRC32 per ``CRC_ROWS``-row block of the
    binned matrix, so a reader of row ranges verifies every block it
    reads (bit-rot surfaces as a clear error at the offending rows, not
    as a silently-wrong model).

``CRC_ROWS`` is the JAX package's histogram ``ROW_BLOCK`` (4096 rows,
lightgbm_tpu/ops/histogram.py), copied here, since the block CRCs are
part of the format both packages share.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, Optional

import numpy as np

from ..utils.log import Log

CACHE_FORMAT_VERSION = 2
CRC_ROWS = 4096  # the JAX package's ROW_BLOCK

_META_KEY = "__cache_meta__"


# ----------------------------------------------------------------------
# header build / verify (io/dataset.py save_binary / load_binary hooks)
# ----------------------------------------------------------------------
def source_identity(source_path: Optional[str]) -> Dict:
    """Identity of the text file a cache was built from.  Size + mtime
    (ns) is the staleness test: editing or regenerating the source
    changes at least one of them."""
    if not source_path:
        return {}
    try:
        st = os.stat(source_path)
    except OSError:
        return {}
    return {
        "source_path": os.path.abspath(source_path),
        "source_size": int(st.st_size),
        "source_mtime_ns": int(st.st_mtime_ns),
    }


def chunk_crcs(binned: np.ndarray, crc_rows: int = CRC_ROWS) -> np.ndarray:
    """Per-block CRC32s of the row-major binned matrix."""
    n = binned.shape[0]
    out = np.empty((max(-(-n // crc_rows), 1),), np.uint32)
    if n == 0:
        out[0] = 0
        return out
    for b in range(out.shape[0]):
        blk = np.ascontiguousarray(binned[b * crc_rows: (b + 1) * crc_rows])
        out[b] = zlib.crc32(blk.tobytes()) & 0xFFFFFFFF
    return out


def build_cache_meta(binned: np.ndarray, label: Optional[np.ndarray],
                     source_path: Optional[str] = None) -> Dict:
    """The ``__cache_meta__`` JSON dict for ``save_binary``."""
    crc = zlib.crc32(np.ascontiguousarray(binned).tobytes())
    if label is not None:
        crc = zlib.crc32(np.ascontiguousarray(
            np.asarray(label)).tobytes(), crc)
    meta = {
        "format_version": CACHE_FORMAT_VERSION,
        "crc_rows": CRC_ROWS,
        "num_data": int(binned.shape[0]),
        "num_features": int(binned.shape[1]),
        "bin_dtype": str(binned.dtype),
        "data_fingerprint":
            f"{binned.shape[0]}x{binned.shape[1]}:{crc & 0xFFFFFFFF:08x}",
    }
    meta.update(source_identity(source_path))
    return meta


def read_cache_meta(npz) -> Optional[Dict]:
    """The parsed ``__cache_meta__`` header, or None on a v1 cache."""
    if _META_KEY not in getattr(npz, "files", ()):
        return None
    try:
        return json.loads(str(npz[_META_KEY]))
    except (ValueError, TypeError):
        return None


def stale_reason(meta: Dict) -> Optional[str]:
    """Why this cache must be refused, or None when it is trustworthy.
    A cache whose recorded source still exists but has changed size or
    mtime was built from different bytes — training it would silently
    use old data."""
    src = meta.get("source_path")
    if not src or not os.path.exists(src):
        return None  # source gone/moved: nothing to compare against
    st = os.stat(src)
    if int(st.st_size) != int(meta.get("source_size", -1)):
        return (f"source {src} size changed "
                f"({meta.get('source_size')} -> {st.st_size} bytes)")
    if int(st.st_mtime_ns) != int(meta.get("source_mtime_ns", -1)):
        return f"source {src} was modified after the cache was written"
    return None


# ----------------------------------------------------------------------
# random access into the stored matrix
# ----------------------------------------------------------------------
class CacheReader:
    """Checksummed random access to the ``binned`` member of a v2 cache.

    Locates the member's raw bytes inside the (uncompressed) zip
    container once, then serves row ranges by seek+read — or the whole
    matrix as a read-only ``np.memmap`` — without inflating anything.
    ``read_rows`` verifies the per-block CRCs of every fully-covered
    block, which is every block when the caller's chunk grid is
    ``crc_rows``-aligned.
    """

    def __init__(self, path: str):
        import zipfile

        self.path = path
        with zipfile.ZipFile(path) as zf:
            names = zf.namelist()
            if "binned.npy" not in names or f"{_META_KEY}.npy" not in names:
                raise ValueError(
                    f"{path} is not a format-v{CACHE_FORMAT_VERSION} "
                    "binary dataset cache (missing header); regenerate "
                    "it with task=ingest")
            info = zf.getinfo("binned.npy")
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(
                    f"{path} stores the bin matrix compressed — no random "
                    "access; regenerate the cache with task=ingest")
            with zf.open(f"{_META_KEY}.npy") as f:
                self.meta = json.loads(str(np.lib.format.read_array(f)))
            with zf.open("chunk_crc.npy") as f:
                self.crcs = np.lib.format.read_array(f)
            # raw offset of the member's bytes: local header is
            # 30 bytes + name + extra (the extra field can differ from
            # the central directory's copy, so parse the local one)
            with open(path, "rb") as f:
                f.seek(info.header_offset)
                hdr = f.read(30)
                if hdr[:4] != b"PK\x03\x04":
                    raise ValueError(f"{path}: corrupt zip local header")
                name_len, extra_len = struct.unpack("<HH", hdr[26:30])
                member_start = info.header_offset + 30 + name_len + extra_len
                # then the npy header in front of the raw array bytes
                f.seek(member_start)
                version = np.lib.format.read_magic(f)
                if version == (1, 0):
                    shape, fortran, dtype = \
                        np.lib.format.read_array_header_1_0(f)
                elif version == (2, 0):
                    shape, fortran, dtype = \
                        np.lib.format.read_array_header_2_0(f)
                else:
                    raise ValueError(
                        f"{path}: unsupported npy header version {version}")
                if fortran:
                    raise ValueError(f"{path}: Fortran-order bin matrix")
                self.data_offset = f.tell()
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.num_rows, self.num_cols = self.shape
        self.row_bytes = self.num_cols * self.dtype.itemsize
        self.crc_rows = int(self.meta.get("crc_rows", CRC_ROWS))
        self._f = open(path, "rb")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def memmap(self) -> np.ndarray:
        """Read-only memmap of the whole matrix (host pages stay
        demand-loaded; nothing is materialized)."""
        return np.memmap(self.path, dtype=self.dtype, mode="r",
                         offset=self.data_offset, shape=self.shape)

    def read_rows(self, start: int, stop: int,
                  verify: bool = True) -> np.ndarray:
        """Rows [start, stop) as a fresh C-order array, CRC-verified."""
        if not (0 <= start <= stop <= self.num_rows):
            raise IndexError(f"row range [{start}, {stop}) outside "
                             f"[0, {self.num_rows})")
        self._f.seek(self.data_offset + start * self.row_bytes)
        raw = self._f.read((stop - start) * self.row_bytes)
        if len(raw) != (stop - start) * self.row_bytes:
            raise IOError(f"{self.path}: short read at rows "
                          f"[{start}, {stop}) — truncated cache?")
        arr = np.frombuffer(raw, dtype=self.dtype).reshape(
            stop - start, self.num_cols)
        if verify:
            self._verify_blocks(arr, start, stop)
        return arr

    def _verify_blocks(self, arr: np.ndarray, start: int, stop: int) -> None:
        cr = self.crc_rows
        b0 = -(-start // cr)  # first block fully inside [start, stop)
        while b0 * cr < stop:
            lo = b0 * cr
            hi = min(lo + cr, self.num_rows)
            if hi > stop:  # partially covered: next read verifies it
                break
            blk = arr[lo - start: hi - start]
            crc = zlib.crc32(np.ascontiguousarray(blk).tobytes()) & 0xFFFFFFFF
            if b0 < len(self.crcs) and crc != int(self.crcs[b0]):
                raise IOError(
                    f"{self.path}: CRC mismatch on rows [{lo}, {hi}) "
                    f"(block {b0}): cache is corrupt — regenerate it "
                    "with task=ingest")
            b0 += 1

    def verify_all(self) -> None:
        """Stream every block through the CRC check (bounded memory)."""
        for start in range(0, max(self.num_rows, 1), self.crc_rows):
            stop = min(start + self.crc_rows, self.num_rows)
            if stop > start:
                self.read_rows(start, stop, verify=True)


def open_cache_reader(path: str) -> Optional[CacheReader]:
    """A :class:`CacheReader` for ``path``, or None (with a log line)
    when the cache predates random access."""
    try:
        return CacheReader(path)
    except (ValueError, OSError) as e:
        Log.warning("No random access into cache %s: %s", path, e)
        return None
