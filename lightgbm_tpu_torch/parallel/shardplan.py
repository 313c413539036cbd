"""Shard plans and straggler rebalancing — PyTorch counterpart of
lightgbm_tpu/parallel/shardplan.py (pure numpy, the same logic).

A synchronous data-parallel fleet runs at the pace of its slowest rank;
this module moves rows off it.  Three pieces:

- :class:`ShardPlan` — the contiguous global row partition, in rank
  order.  It keeps the pre-partition contract (global row order = the
  ranks' shards concatenated), so a checkpoint taken after any number of
  moves merges into the same canonical layout (ckpt/state.py) and the
  global dataset fingerprint does not change.
- :class:`RebalanceController` — a deterministic policy fed the
  allgathered per-rank compute seconds (and heartbeat ages, so no rows
  move toward a rank that may be dying).  Every rank runs the same
  arithmetic on the same table, so all derive the same plan with no
  extra round.
- :func:`exchange_rows` — applies a plan change by moving row blocks
  between ranks over the byte collectives, with the slice semantics of
  the elastic restore (ckpt/state.py ``reshard_to_local``).

Policy (config keys): a rank is a straggler when its compute-time EWMA
exceeds ``rebalance_threshold`` x the fleet median for
``rebalance_patience`` consecutive iterations; the new plan sizes shards
inversely to the per-row cost, moving at most
``rebalance_max_move_frac`` of the global rows an event.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.log import Log

__all__ = ["ShardPlan", "RebalanceController", "exchange_rows", "snap_to_groups"]


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Contiguous global row partition in rank order."""

    counts: Tuple[int, ...]

    def __post_init__(self):
        if not self.counts or any(int(c) < 0 for c in self.counts):
            raise ValueError(f"bad shard counts {self.counts}")
        object.__setattr__(self, "counts",
                           tuple(int(c) for c in self.counts))

    @property
    def world(self) -> int:
        return len(self.counts)

    @property
    def total(self) -> int:
        return sum(self.counts)

    @property
    def starts(self) -> Tuple[int, ...]:
        out, acc = [], 0
        for c in self.counts:
            out.append(acc)
            acc += c
        return tuple(out)

    def rank_range(self, rank: int) -> Tuple[int, int]:
        """[start, stop) of ``rank``'s rows in global row order."""
        s = self.starts[rank]
        return s, s + self.counts[rank]

    @classmethod
    def from_counts(cls, counts) -> "ShardPlan":
        return cls(tuple(int(c) for c in counts))


class RebalanceController:
    """Deterministic straggler detector + plan proposer.

    Feed :meth:`observe` once per iteration with the identical
    allgathered table on every rank; it returns a new :class:`ShardPlan`
    when the policy fires, else ``None``.  State resets after each
    emitted plan so the next move is based on fresh measurements of the
    new layout."""

    def __init__(self, threshold: float, patience: int,
                 max_move_frac: float, alpha: float = 0.3,
                 stale_s: float = 10.0, min_rows: int = 32,
                 group_bounds: Optional[np.ndarray] = None):
        self.threshold = float(threshold)
        self.patience = int(patience)
        self.max_move_frac = float(max_move_frac)
        self.alpha = float(alpha)
        self.stale_s = float(stale_s)
        self.min_rows = int(min_rows)
        # cumulative global query-group boundaries (0 ... total,
        # ascending).  When set, proposed shard cuts snap to the nearest
        # boundary so no query group is ever split across ranks — the
        # ranking objectives (lambdarank) need whole groups per rank.
        self.group_bounds = (None if group_bounds is None
                             else np.asarray(group_bounds, np.int64))
        self._ewma: Optional[List[float]] = None
        self._hot = 0

    def reset(self) -> None:
        self._ewma = None
        self._hot = 0

    def observe(self, plan: ShardPlan, compute_s: List[float],
                hb_ages: Optional[List[float]] = None
                ) -> Optional[ShardPlan]:
        """One iteration's per-rank compute seconds (+ max heartbeat age
        each rank observes).  Returns the next plan when a persistent
        straggler warrants a move."""
        xs = [max(float(c), 1e-9) for c in compute_s]
        if len(xs) != plan.world:
            raise ValueError(
                f"{len(xs)} timings for a world-{plan.world} plan")
        if self._ewma is None or len(self._ewma) != plan.world:
            self._ewma = list(xs)
        else:
            a = self.alpha
            self._ewma = [a * x + (1.0 - a) * e
                          for x, e in zip(xs, self._ewma)]
        if hb_ages and max(float(h) for h in hb_ages) > self.stale_s:
            # a peer's heartbeat is stale: it may be dying, not merely
            # slow — moving rows toward or away from it now would race
            # the failure detector; hold position
            self._hot = 0
            return None
        med = float(np.median(self._ewma))
        if med <= 0 or max(self._ewma) <= self.threshold * med:
            self._hot = 0
            return None
        self._hot += 1
        if self._hot < self.patience:
            return None
        new_plan = self._propose(plan)
        self.reset()
        if new_plan is None or new_plan.counts == plan.counts:
            return None
        return new_plan

    def _propose(self, plan: ShardPlan) -> Optional[ShardPlan]:
        """Size shards inversely to measured per-row cost, clamped by
        ``max_move_frac`` and a per-shard row floor.  Pure integer
        arithmetic after the float shares, largest-remainder rounding —
        identical on every rank."""
        total = plan.total
        ewma = self._ewma
        # per-row cost of rank r: ewma_r / rows_r; balanced counts are
        # proportional to the inverse cost
        speed = [plan.counts[r] / ewma[r] if plan.counts[r] > 0 else 0.0
                 for r in range(plan.world)]
        ssum = sum(speed)
        if ssum <= 0:
            return None
        shares = [s / ssum * total for s in speed]
        ideal = _largest_remainder(shares, total)
        # clamp the total displaced rows to max_move_frac * total
        move = sum(max(0, c - i) for c, i in zip(plan.counts, ideal))
        budget = int(self.max_move_frac * total)
        if move > budget and move > 0:
            scale = budget / move
            scaled = [c + (i - c) * scale
                      for c, i in zip(plan.counts, ideal)]
            ideal = _largest_remainder(scaled, total)
        if self.group_bounds is not None:
            # query-grouped data: the 32-row floor is replaced by
            # cut-point snapping — the cumulative group boundaries are
            # invariant under row moves, so every rank derives the same
            # snapped cuts from the same ideal counts
            cuts = snap_to_groups(np.cumsum(ideal)[:-1], self.group_bounds)
            if cuts is None:
                return None
            edges = [0] + list(cuts) + [total]
            ideal = [edges[i + 1] - edges[i] for i in range(plan.world)]
        else:
            floor = min(self.min_rows, max(total // (2 * plan.world), 1))
            ideal = _apply_floor(ideal, floor, total)
        return ShardPlan.from_counts(ideal)


def _largest_remainder(shares: List[float], total: int) -> List[int]:
    base = [int(np.floor(s)) for s in shares]
    rem = total - sum(base)
    order = sorted(range(len(shares)),
                   key=lambda r: (base[r] - shares[r], r))
    for k in range(rem):
        base[order[k % len(order)]] += 1
    return base


def snap_to_groups(cum_targets, group_bounds) -> Optional[Tuple[int, ...]]:
    """Snap ideal cumulative cut points to the nearest query-group
    boundary, keeping the cuts strictly increasing and strictly inside
    ``(0, total)``.  Ties break toward the lower boundary; collisions
    push the later cut to the next greater boundary.  Returns ``None``
    when there are fewer interior boundaries than cuts (a rank would
    own zero groups) — the caller holds position instead of moving."""
    gb = np.asarray(group_bounds, np.int64)
    total = int(gb[-1])
    interior = gb[(gb > 0) & (gb < total)]
    cuts: List[int] = []
    prev = 0
    for t in cum_targets:
        cand = interior[interior > prev]
        if cand.size == 0:
            return None
        i = int(np.searchsorted(cand, int(t)))
        if i == 0:
            pick = int(cand[0])
        elif i >= cand.size:
            pick = int(cand[-1])
        else:
            lo, hi = int(cand[i - 1]), int(cand[i])
            pick = lo if int(t) - lo <= hi - int(t) else hi
        cuts.append(pick)
        prev = pick
    return tuple(cuts)


def _apply_floor(counts: List[int], floor: int, total: int) -> List[int]:
    """Raise every shard to ``floor`` rows, taking from the largest."""
    out = list(counts)
    for r in range(len(out)):
        while out[r] < floor:
            donor = int(np.argmax(out))
            if donor == r or out[donor] <= floor:
                break
            give = min(floor - out[r], out[donor] - floor)
            if give <= 0:
                break
            out[donor] -= give
            out[r] += give
    assert sum(out) == total
    return out


# ----------------------------------------------------------------------
# row-block wire: framed raw-numpy bytes (no pickle on the wire)
# ----------------------------------------------------------------------
# Same framing idea as the quantized ``hist_q`` histogram wire: fixed
# struct headers + a CRC32 over each array payload, so a corrupted or
# truncated blob fails loudly instead of deserializing garbage.  The
# payload is the raw C-order buffer — byte-for-byte reproducible, which
# the round-trip test pins.
_RB_MAGIC = b"RB1\x00"
_RB_HDR = struct.Struct("<I")          # span count
_RB_SPAN = struct.Struct("<qqI")       # g0, g1, piece count
_RB_PIECE = struct.Struct("<HHBB")     # name len, dtype len, axis, ndim


def _pack_row_wire(outgoing: Dict[Tuple[int, int], Dict[str, np.ndarray]]
                   ) -> bytes:
    parts = [_RB_MAGIC, _RB_HDR.pack(len(outgoing))]
    for (g0, g1) in sorted(outgoing):
        blocks = outgoing[(g0, g1)]
        parts.append(_RB_SPAN.pack(g0, g1, len(blocks)))
        for name in sorted(blocks):
            arr = np.ascontiguousarray(blocks[name])
            nb = name.encode("utf-8")
            db = arr.dtype.str.encode("ascii")
            payload = arr.tobytes()
            parts.append(_RB_PIECE.pack(len(nb), len(db), 0, arr.ndim))
            parts.append(nb)
            parts.append(db)
            parts.append(struct.pack(f"<{arr.ndim}q", *arr.shape))
            parts.append(struct.pack("<QI", len(payload),
                                     zlib.crc32(payload)))
            parts.append(payload)
    return b"".join(parts)


def _unpack_row_wire(blob: bytes
                     ) -> Dict[Tuple[int, int], Dict[str, np.ndarray]]:
    if blob[:len(_RB_MAGIC)] != _RB_MAGIC:
        raise ValueError("rebalance wire: bad magic")
    off = len(_RB_MAGIC)
    (n_spans,) = _RB_HDR.unpack_from(blob, off)
    off += _RB_HDR.size
    out: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
    for _ in range(n_spans):
        g0, g1, n_pieces = _RB_SPAN.unpack_from(blob, off)
        off += _RB_SPAN.size
        blocks: Dict[str, np.ndarray] = {}
        for _p in range(n_pieces):
            nlen, dlen, _axis, ndim = _RB_PIECE.unpack_from(blob, off)
            off += _RB_PIECE.size
            name = blob[off:off + nlen].decode("utf-8")
            off += nlen
            dtype = np.dtype(blob[off:off + dlen].decode("ascii"))
            off += dlen
            shape = struct.unpack_from(f"<{ndim}q", blob, off)
            off += 8 * ndim
            nbytes, crc = struct.unpack_from("<QI", blob, off)
            off += 12
            payload = blob[off:off + nbytes]
            off += nbytes
            if len(payload) != nbytes or zlib.crc32(payload) != crc:
                raise ValueError(
                    f"rebalance wire: CRC/length mismatch for {name!r} "
                    f"span [{g0},{g1})")
            blocks[name] = np.frombuffer(payload, dtype).reshape(shape)
        out[(g0, g1)] = blocks
    return out


# ----------------------------------------------------------------------
# applying a plan: row-block exchange over the hardened collectives
# ----------------------------------------------------------------------
def _subtract(a: Tuple[int, int], b: Tuple[int, int]
              ) -> List[Tuple[int, int]]:
    """Interval a minus interval b (half-open), as up to two pieces."""
    out = []
    if a[0] < min(a[1], b[0]):
        out.append((a[0], min(a[1], b[0])))
    if max(a[0], b[1]) < a[1]:
        out.append((max(a[0], b[1]), a[1]))
    return out


def exchange_rows(old_plan: ShardPlan, new_plan: ShardPlan, rank: int,
                  row_blocks: Dict[str, Tuple[np.ndarray, int]],
                  comm=None) -> Dict[str, np.ndarray]:
    """Move rows between ranks so every rank ends up owning its
    ``new_plan`` range.  ``row_blocks`` maps name -> (array, row_axis)
    holding the rank's CURRENT rows in global row order.  Returns the
    new local arrays, rows in global order.

    Each rank broadcasts only the row blocks LEAVING it (allgather over
    parallel/collect.py, or ``comm`` when the caller runs on a live
    membership fleet; tagged ``purpose="rebalance"`` in the comms
    ledger); receivers take the pieces intersecting their new range.
    Retained rows never leave the rank.  The wire is framed raw-numpy
    bytes (:func:`_pack_row_wire`), never pickle."""
    if old_plan.total != new_plan.total or old_plan.world != new_plan.world:
        raise ValueError(
            f"plan mismatch: {old_plan.counts} -> {new_plan.counts}")
    old_s, old_e = old_plan.rank_range(rank)
    new_s, new_e = new_plan.rank_range(rank)

    def _take(arr: np.ndarray, axis: int, lo: int, hi: int) -> np.ndarray:
        # lo/hi in LOCAL (old-range) coordinates
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(lo, hi)
        return np.ascontiguousarray(arr[tuple(sl)])

    outgoing = {}
    for (g0, g1) in _subtract((old_s, old_e), (new_s, new_e)):
        outgoing[(g0, g1)] = {
            name: _take(np.asarray(arr), axis, g0 - old_s, g1 - old_s)
            for name, (arr, axis) in row_blocks.items()
        }
    wire = _pack_row_wire(outgoing)
    if comm is not None:
        gathered = comm.allgather(wire, purpose="rebalance")
    else:
        from .collect import allgather_bytes

        gathered = allgather_bytes(wire, purpose="rebalance")

    n_new = new_e - new_s
    out: Dict[str, np.ndarray] = {}
    for name, (arr, axis) in row_blocks.items():
        arr = np.asarray(arr)
        shape = list(arr.shape)
        shape[axis] = n_new
        dst = np.empty(shape, arr.dtype)
        # retained intersection stays local
        lo, hi = max(old_s, new_s), min(old_e, new_e)
        if lo < hi:
            sl = [slice(None)] * dst.ndim
            sl[axis] = slice(lo - new_s, hi - new_s)
            dst[tuple(sl)] = _take(arr, axis, lo - old_s, hi - old_s)
        out[name] = dst
    filled = max(0, min(old_e, new_e) - max(old_s, new_s))
    for blob in gathered:
        for (g0, g1), blocks in _unpack_row_wire(blob).items():
            lo, hi = max(g0, new_s), min(g1, new_e)
            if lo >= hi:
                continue
            for name, piece in blocks.items():
                axis = row_blocks[name][1]
                sl = [slice(None)] * out[name].ndim
                sl[axis] = slice(lo - new_s, hi - new_s)
                psl = [slice(None)] * piece.ndim
                psl[axis] = slice(lo - g0, hi - g0)
                out[name][tuple(sl)] = piece[tuple(psl)]
            filled += hi - lo
    if filled != n_new:
        raise RuntimeError(
            f"rebalance exchange left rows unfilled on rank {rank}: "
            f"{filled}/{n_new}")
    Log.debug("Rebalance exchange on rank %d: [%d,%d) -> [%d,%d)",
              rank, old_s, old_e, new_s, new_e)
    return out
