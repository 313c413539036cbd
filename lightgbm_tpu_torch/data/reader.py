"""Chunked text readers — PyTorch-port copy of lightgbm_tpu/data/reader.py
(host code, no torch), the counterpart of the reference's TextReader /
PipelineReader (include/LightGBM/utils/text_reader.h,
pipeline_reader.h): stream a CSV/TSV/LibSVM file as bounded-size row
chunks so no caller ever needs the whole raw float matrix in memory.

One parsing code path: the legacy single-shot ``io/parser.load_text_file``
and the two-pass streaming ingest (data/ingest.py) both parse through
these readers, so dense and streaming loads cannot drift in dtype or
missing-value semantics.  Per-chunk parsing backend: the native
multithreaded parser (native/parser.cpp, reference-exact Atof) when a
compiler is available, else pandas' C engine — the SAME backend choice
for every chunk of a file, whatever the chunk size.

Chunking is by NON-BLANK lines (the native scanner and the reference's
TextReader both index non-blank lines), so chunk boundaries never change
parsed values: a file read as one chunk and as two hundred chunks yields
bit-identical rows.

The native parser and pandas' C engine can differ by an ulp on some
tokens (the reference's Atof is not correctly rounded), so the first
block each backend parses in a process is logged, and
``parser_blocks()`` counts the blocks each has parsed.  Skipped bad rows
are logged and counted on the reader (``bad_rows``).
"""

from __future__ import annotations

import collections
import io
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..utils.log import Log

# default per-chunk raw-matrix budget when chunk_rows is not forced
DEFAULT_CHUNK_BYTES = 32 << 20  # 32 MiB of float64 cells per chunk
MIN_CHUNK_ROWS = 1024
MAX_CHUNK_ROWS = 1 << 21

# blocks parsed by each backend in this process ("native", "pandas",
# "python"); the first of each kind is logged
_PARSED: collections.Counter = collections.Counter()


def _note_parser(kind: str) -> None:
    if not _PARSED[kind]:
        what = {"native": "the native parser (the reference's Atof)",
                "pandas": "pandas' C engine (within an ulp of the reference's Atof)",
                "python": "the Python LibSVM parser (float(), within an ulp of the "
                          "reference's Atof)"}[kind]
        Log.info("Parsing text data with %s", what)
    _PARSED[kind] += 1


def parser_blocks() -> dict:
    """{backend: blocks parsed in this process}."""
    return dict(_PARSED)

# tokens the salvage parser treats as NaN (pandas C-engine default NA
# set, lowercased; the fast paths keep their own identical semantics)
_NA_TOKENS = frozenset({
    "", "#n/a", "#n/a n/a", "#na", "-1.#ind", "-1.#qnan", "-nan",
    "1.#ind", "1.#qnan", "<na>", "n/a", "na", "null", "nan", "none",
})


def _parse_value_token(tok: str) -> Optional[float]:
    """One field -> float (NaN for the NA set), or None if malformed."""
    t = tok.strip()
    if t.lower() in _NA_TOKENS:
        return float("nan")
    try:
        return float(t)
    except ValueError:
        return None


def _report_bad_rows(reader, bad: List[Tuple[int, str]]) -> None:
    """Apply ``reader.bad_row_policy`` to the triaged rows: 'error'
    fails loudly naming the file and 1-based data-row number; 'skip'
    counts them on the reader (``bad_rows``) and warns once per block."""
    if not bad:
        return
    lineno, reason = bad[0]
    if reader.bad_row_policy != "skip":
        Log.fatal(
            "%s: malformed data row %d (%s)%s — set bad_row_policy=skip "
            "to drop such rows",
            reader.path, lineno, reason,
            f" and {len(bad) - 1} more" if len(bad) > 1 else "",
        )
    reader.bad_rows += len(bad)
    Log.warning(
        "%s: skipped %d malformed data row(s); first: row %d (%s)",
        reader.path, len(bad), lineno, reason,
    )


def auto_chunk_rows(ncols: int, chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> int:
    rows = chunk_bytes // max(8 * max(ncols, 1), 1)
    return int(min(max(rows, MIN_CHUNK_ROWS), MAX_CHUNK_ROWS))


def iter_line_blocks(path: str, chunk_lines: int,
                     skip_lines: int = 0) -> Iterator[Tuple[int, bytes, int]]:
    """Yield ``(start_line, block_bytes, num_lines)`` where lines are
    counted over NON-BLANK lines only and ``start_line`` is the index of
    the block's first non-blank line after ``skip_lines`` were dropped.
    Memory is bounded by one block."""
    buf: List[bytes] = []
    start = 0
    n_in_buf = 0
    skipped = 0
    with open(path, "rb") as f:
        for raw in f:
            if not raw.strip():
                continue
            if skipped < skip_lines:
                skipped += 1
                continue
            buf.append(raw)
            n_in_buf += 1
            if n_in_buf >= chunk_lines:
                yield start, b"".join(buf), n_in_buf
                start += n_in_buf
                buf, n_in_buf = [], 0
    if buf:
        yield start, b"".join(buf), n_in_buf


def count_data_lines(path: str, skip_lines: int = 0) -> int:
    """Cheap pass-0 row count: non-blank lines minus the header."""
    n = 0
    with open(path, "rb") as f:
        for raw in f:
            if raw.strip():
                n += 1
    return max(0, n - skip_lines)


def read_header_names(path: str, sep: Optional[str]) -> List[str]:
    """First non-blank line parsed as column names (quote-aware via
    pandas when the line carries quotes)."""
    with open(path, "rb") as f:
        first = b""
        for raw in f:
            if raw.strip():
                first = raw
                break
    text = first.decode("utf-8", "replace").strip()
    if '"' in text or "'" in text:
        import pandas as pd

        df = pd.read_csv(io.StringIO(text), sep=sep or r"\s+", header=0,
                         engine="python", nrows=0)
        return [str(c) for c in df.columns]
    sp = None if sep in (None, r"\s+") else sep
    return [t.strip() for t in text.split(sp)]


# ----------------------------------------------------------------------
def _native_parse_block(block: bytes, sep: str) -> Optional[np.ndarray]:
    """Parse one dense block with the native parser (reference-exact
    Atof).  Returns None to signal the pandas fallback."""
    from ..native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    import ctypes

    sep_b = b" " if sep == r"\s+" else sep.encode()
    handle = lib.ltpu_scan(block, len(block))
    try:
        nrows = ctypes.c_int64()
        ncols = ctypes.c_int()
        if lib.ltpu_dims_csv(handle, block, sep_b, 0,
                             ctypes.byref(nrows), ctypes.byref(ncols)) != 0:
            return None
        mat = np.empty((nrows.value, ncols.value), dtype=np.float64)
        rc = lib.ltpu_parse_csv(
            handle, block, sep_b, 0,
            mat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            nrows.value, ncols.value, min(os.cpu_count() or 1, 16),
        )
        if rc != 0:
            return None
        _note_parser("native")
        return mat
    finally:
        lib.ltpu_scan_free(handle)


def _pandas_parse_block(block: bytes, sep: str) -> np.ndarray:
    import pandas as pd

    df = pd.read_csv(
        io.BytesIO(block), sep=sep, header=None,
        engine="c" if sep != r"\s+" else "python",
    )
    mat = df.to_numpy(dtype=np.float64)
    _note_parser("pandas")
    return mat


class DenseChunkReader:
    """Chunked reader for CSV/TSV files.  Every chunk is the FULL column
    set (label/weight/group columns included) — column-role slicing is
    the caller's job, exactly like the reference's parser emitting all
    (idx, value) pairs."""

    def __init__(self, path: str, sep: str, has_header: bool,
                 chunk_rows: Optional[int] = None,
                 bad_row_policy: str = "error"):
        self.path = path
        self.sep = sep
        self.has_header = has_header
        self.header_names: Optional[List[str]] = (
            read_header_names(path, sep) if has_header else None
        )
        self._chunk_rows = chunk_rows
        self._num_rows: Optional[int] = None
        self._ncols: Optional[int] = None
        self.bad_row_policy = bad_row_policy
        self.bad_rows = 0  # cumulative skipped rows (policy='skip')

    # -- pass 0 --------------------------------------------------------
    def count_rows(self) -> int:
        if self._num_rows is None:
            self._num_rows = count_data_lines(
                self.path, skip_lines=1 if self.has_header else 0
            )
        return self._num_rows

    @property
    def ncols(self) -> int:
        if self._ncols is None:
            for _, chunk in self.iter_chunks(probe_rows=MIN_CHUNK_ROWS):
                self._ncols = chunk.shape[1]
                break
            if self._ncols is None:
                Log.fatal("Data file %s is empty", self.path)
        return self._ncols

    def chunk_rows(self) -> int:
        if self._chunk_rows:
            return int(self._chunk_rows)
        return auto_chunk_rows(self.ncols)

    # -- chunk iteration ----------------------------------------------
    def parse_block(self, block: bytes, start_row: int = 0) -> np.ndarray:
        """Parse one block.  The fast paths (native parser, pandas C
        engine) are tried first and are byte-for-byte what a clean file
        always gets; only when a block fails to parse — or parses at a
        width inconsistent with the rest of the file — does the per-line
        salvage pass run, applying ``bad_row_policy``: 'error' fails
        loudly naming the file and 1-based data-row number, 'skip' drops
        the malformed rows and counts them (``bad_rows``)."""
        mat: Optional[np.ndarray] = None
        try:
            mat = _native_parse_block(block, self.sep)
            if mat is None:
                mat = _pandas_parse_block(block, self.sep)
        except Exception:
            mat = None
        if mat is not None and self._ncols is not None \
                and mat.shape[1] != self._ncols:
            mat = None  # width flip mid-file: let salvage name the rows
        if mat is None:
            mat = self._salvage_block(block, start_row)
        if self._ncols is None and mat.shape[1] > 0:
            self._ncols = mat.shape[1]
        return mat

    def _salvage_block(self, block: bytes, start_row: int) -> np.ndarray:
        """Per-line triage of a block the fast path rejected.  The
        surviving lines are re-joined and parsed through the SAME fast
        path (native parser / pandas C engine), so their values are
        bit-identical to a file that never had the bad rows; the
        token-level parse is used for validation only (and as a last
        resort if the fast path rejects even the surviving lines)."""
        sep = None if self.sep in (None, r"\s+") else self.sep
        expected = self._ncols
        rows: List[List[float]] = []
        good_lines: List[bytes] = []
        bad: List[Tuple[int, str]] = []  # (1-based data-row number, reason)
        for raw in block.split(b"\n"):
            if not raw.strip():
                continue
            lineno = start_row + len(rows) + len(bad) + 1
            toks = raw.decode("utf-8", "replace").strip().split(sep)
            vals = [_parse_value_token(t) for t in toks]
            if any(v is None for v in vals):
                j = next(k for k, v in enumerate(vals) if v is None)
                bad.append((lineno, f"unparsable value {toks[j]!r} "
                                    f"in field {j + 1}"))
                continue
            if expected is None:
                expected = len(vals)
            if len(vals) != expected:
                bad.append((lineno, f"{len(vals)} fields, expected {expected}"))
                continue
            rows.append(vals)  # type: ignore[arg-type]
            good_lines.append(raw if raw.endswith(b"\n") else raw + b"\n")
        _report_bad_rows(self, bad)
        if not rows:
            return np.empty((0, expected or 0), dtype=np.float64)
        good_block = b"".join(good_lines)
        try:
            mat = _native_parse_block(good_block, self.sep)
            if mat is None:
                mat = _pandas_parse_block(good_block, self.sep)
            if mat.shape == (len(rows), expected):
                return mat
        except Exception:
            pass
        # the fast path rejects even the validated lines (e.g. quoting
        # the naive splitter misread): fall back to the token values
        return np.asarray(rows, dtype=np.float64)

    def iter_chunks(self, probe_rows: Optional[int] = None
                    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield ``(start_row, (rows, ncols) float64 matrix)``.
        ``start_row`` counts EMITTED rows, so with ``bad_row_policy=
        'skip'`` downstream offsets stay dense; on a clean file it is
        identical to the raw non-blank line index."""
        rows = probe_rows or self.chunk_rows()
        skip = 1 if self.has_header else 0
        emitted = 0
        for start, block, _ in iter_line_blocks(self.path, rows, skip):
            mat = self.parse_block(block, start_row=start)
            if mat.shape[0] == 0:
                continue
            yield emitted, mat
            emitted += mat.shape[0]

    def read_all(self) -> Tuple[np.ndarray, Optional[List[str]]]:
        """Single-shot load (legacy io/parser path): one chunk spanning
        the file, so the memory profile matches the old whole-file
        parse."""
        chunks = [c for _, c in self.iter_chunks(probe_rows=MAX_CHUNK_ROWS)]
        if not chunks:
            Log.fatal("Data file %s is empty", self.path)
        mat = chunks[0] if len(chunks) == 1 else np.vstack(chunks)
        return mat, self.header_names


# ----------------------------------------------------------------------
class LibSVMChunkReader:
    """Chunked LibSVM reader.  Chunks are ``(features, labels)``; the
    global feature count is the max seen index + 1, discovered during
    pass 1 (``grow_ncols``) and then frozen for pass 2 via ``set_ncols``."""

    def __init__(self, path: str, chunk_rows: Optional[int] = None,
                 bad_row_policy: str = "error"):
        self.path = path
        self.has_header = False
        self.header_names = None
        self._chunk_rows = chunk_rows
        self._num_rows: Optional[int] = None
        self.ncols_seen = 0  # grows as chunks are parsed
        self.bad_row_policy = bad_row_policy
        self.bad_rows = 0

    def count_rows(self) -> int:
        if self._num_rows is None:
            self._num_rows = count_data_lines(self.path)
        return self._num_rows

    def chunk_rows(self) -> int:
        if self._chunk_rows:
            return int(self._chunk_rows)
        return auto_chunk_rows(32)

    def parse_block(self, block: bytes,
                    start_row: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        mat_lab = self._native_parse(block)
        if mat_lab is None:
            good_block = self._scan_lines(block, start_row)
            if good_block is not block:
                # surviving lines go back through the SAME fast path so
                # their values match a file without the bad rows
                mat_lab = self._native_parse(good_block)
            if mat_lab is None:
                mat_lab = self._python_parse(good_block)
        feats, labels = mat_lab
        self.ncols_seen = max(self.ncols_seen, feats.shape[1])
        return feats, labels

    def _scan_lines(self, block: bytes, start_row: int) -> bytes:
        """Validate each line; apply ``bad_row_policy`` to the broken
        ones.  Returns the block itself when every line is fine, else
        the surviving lines re-joined."""
        good: List[bytes] = []
        bad: List[Tuple[int, str]] = []
        n_seen = 0
        for raw in block.split(b"\n"):
            toks = raw.split()
            if not toks:
                continue
            n_seen += 1
            lineno = start_row + n_seen
            try:
                float(toks[0])
                for t in toks[1:]:
                    i, v = t.split(b":")
                    int(i), float(v)
            except ValueError as e:
                bad.append((lineno, str(e)))
                continue
            good.append(raw if raw.endswith(b"\n") else raw + b"\n")
        if not bad:
            return block
        _report_bad_rows(self, bad)
        return b"".join(good)

    def _native_parse(self, block: bytes):
        from ..native import get_lib

        lib = get_lib()
        if lib is None:
            return None
        import ctypes

        handle = lib.ltpu_scan(block, len(block))
        try:
            nrows = ctypes.c_int64()
            ncols = ctypes.c_int()
            if lib.ltpu_dims_libsvm(handle, block, ctypes.byref(nrows),
                                    ctypes.byref(ncols)) != 0:
                return None
            mat = np.zeros((nrows.value, ncols.value), dtype=np.float64)
            labels = np.empty(nrows.value, dtype=np.float64)
            pd_ = ctypes.POINTER(ctypes.c_double)
            rc = lib.ltpu_parse_libsvm(
                handle, block, mat.ctypes.data_as(pd_),
                labels.ctypes.data_as(pd_),
                nrows.value, ncols.value, min(os.cpu_count() or 1, 16),
            )
            if rc != 0:
                return None
            _note_parser("native")
            return mat, labels.astype(np.float32)
        finally:
            lib.ltpu_scan_free(handle)

    def _python_parse(self, block: bytes) -> Tuple[np.ndarray, np.ndarray]:
        labels: List[float] = []
        rows: List[List[Tuple[int, float]]] = []
        max_idx = -1
        for line in block.split(b"\n"):
            toks = line.split()
            if not toks:
                continue
            labels.append(float(toks[0]))
            row: List[Tuple[int, float]] = []
            for t in toks[1:]:
                i, v = t.split(b":")
                idx = int(i)
                row.append((idx, float(v)))
                max_idx = max(max_idx, idx)
            rows.append(row)
        mat = np.zeros((len(rows), max_idx + 1), dtype=np.float64)
        for r, row in enumerate(rows):
            for idx, v in row:
                mat[r, idx] = v
        _note_parser("python")
        return mat, np.asarray(labels, dtype=np.float32)

    def iter_chunks(self) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """Yield ``(start_row, features, labels)``.  Feature matrices are
        chunk-local width; callers pad to a global width (``ncols_seen``
        after a full pass, or a frozen pass-1 count).  ``start_row``
        counts emitted rows (dense under ``bad_row_policy='skip'``)."""
        emitted = 0
        for start, block, _ in iter_line_blocks(self.path, self.chunk_rows()):
            feats, labels = self.parse_block(block, start_row=start)
            if feats.shape[0] == 0:
                continue
            yield emitted, feats, labels
            emitted += feats.shape[0]

    def read_all(self) -> Tuple[np.ndarray, np.ndarray]:
        feats_list, labels_list = [], []
        for _, feats, labels in self.iter_chunks():
            feats_list.append(feats)
            labels_list.append(labels)
        if not feats_list:
            Log.fatal("Data file %s is empty", self.path)
        width = self.ncols_seen
        padded = [
            np.pad(f, ((0, 0), (0, width - f.shape[1]))) if f.shape[1] < width else f
            for f in feats_list
        ]
        return np.vstack(padded), np.concatenate(labels_list)


def make_reader(path: str, chunk_rows: Optional[int] = None,
                has_header: bool = False, bad_row_policy: str = "error"):
    """Sniff the format (io/parser.sniff_format) and build the matching
    chunked reader."""
    from ..io.parser import sniff_format

    kind, sep = sniff_format(path)
    if kind == "libsvm":
        return LibSVMChunkReader(path, chunk_rows=chunk_rows,
                                 bad_row_policy=bad_row_policy)
    return DenseChunkReader(path, sep, has_header, chunk_rows=chunk_rows,
                            bad_row_policy=bad_row_policy)
