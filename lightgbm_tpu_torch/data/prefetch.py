"""The out-of-core pipe: bounded host-to-device chunk prefetch — PyTorch
counterpart of lightgbm_tpu/data/prefetch.py.

A chunk's life on the card: read from its source (an array, a memmap, or
the binary cache with its CRC check) into one of ``depth`` pinned host
buffers, copied with ``non_blocking=True`` on the prefetcher's own CUDA
stream into the matching device buffer, and consumed by the grower's
chunk launches on the caller's stream.  A producer thread runs ahead of
the consumer, so the read and the copy of chunk i+1 overlap the card's
work on chunk i.

The ring is bounded and event-ordered, never host-synced on the
consumer's side:

- the producer records an event on the copy stream after each copy; the
  consumer's stream waits on that event before its first launch on the
  chunk (``Stream.wait_event``, no host sync);
- when the consumer moves on, it records an event on its stream and
  returns the slot; the copy stream waits on that event before the next
  copy into the slot's device buffer, and the producer waits for the
  slot's previous copy to finish before it overwrites the pinned buffer;
- so at most ``depth`` chunk buffers live on the device, however large
  the dataset.

On the CPU (the tests) the same ring of ``depth`` places hands over host
tensors.

Each chunk comes as a (rows, cols) tensor of the bins' width (uint8, or
int16 holding uint16 bins), its columns padded with zero bins to whole
32-bit words: ``chunk.view(torch.int32)`` is then the mask grower's
packed bin words of those rows, transposed (ops/histogram.py
``pack_bin_words``: feature f in word f // per at bit (f % per) * bits,
little-endian).

Overlap accounting: the producer clocks fetch time (read, staging copy,
the copy's dispatch), the consumer clocks stall time (blocked on an
empty ring); ``overlap_pct = 100 * (1 - stall / fetch)``.  On the card
each copy is also timed between two CUDA events (``copy_s``), read when
its slot comes round again.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import queue
import threading
import time
import warnings
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch


class ChunkPlan:
    """The chunk grid over [0, num_rows): ``bounds[i] = (start, stop)``.

    All chunks are ``chunk_rows`` long except a final partial chunk; the
    trainer rounds ``chunk_rows`` up to a ``ROW_BLOCK`` multiple
    (boosting/ooc.py ``resolve_chunk_rows``)."""

    def __init__(self, num_rows: int, chunk_rows: int):
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        self.num_rows = int(num_rows)
        self.chunk_rows = int(chunk_rows)
        self.bounds: List[Tuple[int, int]] = [
            (s, min(s + chunk_rows, num_rows)) for s in range(0, max(num_rows, 1), chunk_rows)]

    @property
    def num_chunks(self) -> int:
        return len(self.bounds)

    def fingerprint(self) -> str:
        """Schedule identity recorded into checkpoints (the JAX package's
        string, so its checkpoints and the port's check each other)."""
        return f"{self.num_rows}r/{self.chunk_rows}c/{self.num_chunks}"


class ArrayChunkSource:
    """Chunk source over a host-resident (or memmapped) bin matrix."""

    def __init__(self, binned: np.ndarray):
        self.binned = binned
        self.num_rows, self.num_cols = binned.shape
        self.dtype = binned.dtype

    def read(self, start: int, stop: int) -> np.ndarray:
        return np.ascontiguousarray(self.binned[start:stop])

    def describe(self) -> str:
        kind = "memmap" if isinstance(self.binned, np.memmap) else "array"
        return f"{kind}({self.num_rows}x{self.num_cols})"


class CacheChunkSource:
    """Chunk source over a binary cache (data/cache.py ``CacheReader``):
    every read checks the CRC of the blocks it covers."""

    def __init__(self, reader):
        self.reader = reader
        self.num_rows = reader.num_rows
        self.num_cols = reader.num_cols
        self.dtype = reader.dtype

    def read(self, start: int, stop: int) -> np.ndarray:
        return self.reader.read_rows(start, stop, verify=True)

    def describe(self) -> str:
        return f"cache({self.reader.path})"


class PrefetchStats:
    """Accumulated overlap accounting across passes."""

    def __init__(self):
        self.chunks = 0
        self.bytes = 0
        self.fetch_s = 0.0
        self.stall_s = 0.0
        self.copy_s = 0.0  # the card's copies, between CUDA events
        self.passes = 0
        self.peak_inflight = 0

    def overlap_pct(self) -> float:
        if self.fetch_s <= 0.0:
            return 100.0
        return max(0.0, min(100.0, 100.0 * (1.0 - self.stall_s / self.fetch_s)))

    def as_dict(self) -> dict:
        return {
            "chunks": self.chunks,
            "bytes": self.bytes,
            "passes": self.passes,
            "fetch_s": round(self.fetch_s, 6),
            "stall_s": round(self.stall_s, 6),
            "copy_s": round(self.copy_s, 6),
            "overlap_pct": round(self.overlap_pct(), 2),
            "peak_inflight": self.peak_inflight,
        }


def chunk_layout(dtype, num_cols: int) -> Tuple[torch.dtype, int]:
    """(torch dtype, padded columns) of a source's chunks: uint8 bins four
    to a word, uint16 (as int16) two."""
    itemsize = np.dtype(dtype).itemsize
    if itemsize not in (1, 2):
        raise ValueError(f"bins of {np.dtype(dtype)} cannot be streamed (uint8 or uint16)")
    per = 4 // itemsize
    return (torch.uint8 if itemsize == 1 else torch.int16), -(-int(num_cols) // per) * per


# the staging copy into a pinned buffer runs on this many threads (numpy
# releases the GIL): one thread's memcpy, not the card's copy engine, set
# the pace of a pass on the card's host (PERF.md)
STAGING_THREADS = 8
_STAGING_POOL = None  # made at the first staging copy, shared by the process's rings
_STAGING_LOCK = threading.Lock()


def _stage(dst: np.ndarray, src: np.ndarray, threads: int = STAGING_THREADS) -> None:
    """``dst[...] = src`` in row blocks on up to ``threads`` staging
    threads."""
    global _STAGING_POOL
    n = len(src)
    k = max(1, min(threads, STAGING_THREADS, n // 65536))
    if k == 1:
        np.copyto(dst, src)
        return
    with _STAGING_LOCK:
        if _STAGING_POOL is None:
            _STAGING_POOL = concurrent.futures.ThreadPoolExecutor(
                STAGING_THREADS, thread_name_prefix="ooc-stage")
    cuts = [n * i // k for i in range(k + 1)]
    list(_STAGING_POOL.map(lambda i: np.copyto(dst[cuts[i]:cuts[i + 1]], src[cuts[i]:cuts[i + 1]]),
                           range(k)))


class _Slot:
    """One place of the card's ring: a pinned host buffer, its device
    buffer, and the events that order them."""

    def __init__(self, rows: int, cols: int, dtype, device):
        self.host = torch.zeros((rows, cols), dtype=dtype, pin_memory=True)
        self.host_np = self.host.numpy()
        self.dev = torch.empty((rows, cols), dtype=dtype, device=device)
        self.start = torch.cuda.Event(enable_timing=True)
        self.copied = torch.cuda.Event(enable_timing=True)
        self.consumed = torch.cuda.Event()
        self.timed = False  # a copy's events wait to be read


class ChunkPrefetcher:
    """Bounded ring of in-flight host-to-device chunk transfers.

    ``stream()`` yields ``(index, start, stop, chunk)`` in schedule order,
    ``chunk`` a (stop - start, cols) tensor on ``device`` (see the module
    docstring); a chunk is valid until the consumer asks for the next.
    On the card the ring (``depth`` pinned and device buffers, a copy
    stream) is made at the first pass and kept for the next."""

    def __init__(self, source, plan: ChunkPlan, depth: int = 2,
                 stats: Optional[PrefetchStats] = None, device="cpu"):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.source = source
        self.plan = plan
        self.depth = depth
        self.stats = stats if stats is not None else PrefetchStats()
        self.device = torch.device(device)
        self.dtype, self.cols = chunk_layout(source.dtype, source.num_cols)
        self._slots: Optional[List[_Slot]] = None
        self._copy_stream = None

    def stream(self) -> Iterator[Tuple[int, int, int, torch.Tensor]]:
        card = self.device.type == "cuda"
        slots = self._ring() if card else None
        stats = self.stats
        stats.passes += 1
        free: "queue.Queue" = queue.Queue()  # the places of the ring not in use
        for j in range(self.depth):
            free.put(j)
        ready: "queue.Queue" = queue.Queue()
        stop = threading.Event()
        inflight = [0]
        lock = threading.Lock()

        def produce():
            try:
                with torch.cuda.device(self.device) if card else contextlib.nullcontext():
                    for i, (start, end) in enumerate(self.plan.bounds):
                        j = free.get()
                        if stop.is_set():
                            return
                        t0 = time.perf_counter()
                        if card:
                            chunk = self._copy(slots[j], start, end)
                        else:
                            chunk = self._host_tensor(self.source.read(start, end))
                        stats.fetch_s += time.perf_counter() - t0
                        stats.bytes += chunk.numel() * chunk.element_size()
                        with lock:
                            inflight[0] += 1
                            stats.peak_inflight = max(stats.peak_inflight, inflight[0])
                        ready.put((i, start, end, j, chunk))
                ready.put(None)
            except BaseException as e:  # surface in the consumer
                ready.put(e)

        t = threading.Thread(target=produce, name="ooc-prefetch", daemon=True)
        t.start()
        consumer = torch.cuda.current_stream(self.device) if card else None
        held = None
        try:
            while True:
                t0 = time.perf_counter()
                item = ready.get()
                stats.stall_s += time.perf_counter() - t0
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                i, start, end, j, chunk = item
                held = j
                if card:
                    consumer.wait_event(slots[j].copied)
                stats.chunks += 1
                yield i, start, end, chunk
                self._release(j, consumer, lock, inflight, free)
                held = None
        finally:
            if held is not None:
                self._release(held, consumer, lock, inflight, free)
            stop.set()
            for _ in range(self.depth):
                free.put(-1)  # wake a producer waiting for a place
            t.join()

    def _release(self, j, consumer, lock, inflight, free) -> None:
        """The consumer is done with place ``j``: on the card its stream
        records the event the next copy into the place waits on."""
        if consumer is not None:
            self._slots[j].consumed.record(consumer)
        with lock:
            inflight[0] -= 1
        free.put(j)

    def _host_tensor(self, host: np.ndarray) -> torch.Tensor:
        if host.shape[1] != self.cols:
            padded = np.zeros((host.shape[0], self.cols), host.dtype)
            padded[:, :host.shape[1]] = host
            host = padded
        if host.dtype == np.uint16:
            host = host.view(np.int16)
        with warnings.catch_warnings():  # a cache's rows may be read-only
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(np.ascontiguousarray(host))

    def _ring(self) -> List[_Slot]:
        if self._slots is None:
            rows = min(self.plan.chunk_rows, max(self.plan.num_rows, 1))
            self._slots = [_Slot(rows, self.cols, self.dtype, self.device)
                           for _ in range(self.depth)]
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._slots

    def _copy(self, slot: _Slot, start: int, end: int) -> torch.Tensor:
        """Rows [start, end) through ``slot``'s pinned buffer into its device
        buffer, on the copy stream; returns the device rows."""
        slot.copied.synchronize()  # the pinned buffer's last copy is done
        if slot.timed:
            self.stats.copy_s += slot.start.elapsed_time(slot.copied) / 1e3
            slot.timed = False
        c = end - start
        host = self.source.read(start, end)
        if host.dtype == np.uint16:
            host = host.view(np.int16)
        _stage(slot.host_np[:c, :host.shape[1]], host)
        cs = self._copy_stream
        with torch.cuda.stream(cs):
            cs.wait_event(slot.consumed)  # the consumer is done with the device buffer
            slot.start.record(cs)
            slot.dev[:c].copy_(slot.host[:c], non_blocking=True)
            slot.copied.record(cs)
        slot.timed = True
        return slot.dev[:c]
