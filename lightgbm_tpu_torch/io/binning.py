"""Feature binning — counterpart of the reference's BinMapper
(src/io/bin.cpp, include/LightGBM/bin.h).

Behavioral parity targets:
- ``greedy_find_bin``   ↔ GreedyFindBin (bin.cpp:66–135): equal-count greedy
  binning with big-count values pinned to their own bin.
- ``BinMapper.find_bin`` ↔ BinMapper::FindBin (bin.cpp:137–290): zero/missing
  range handling (|v| <= kMissingValueRange treated as the default/zero bin),
  separate greedy binning of the negative and positive ranges, categorical
  count-ordered bin assignment with a 98% coverage cut, trivial-feature
  filtering via NeedFilter (bin.cpp:47-65).
- ``BinMapper.value_to_bin`` ↔ ValueToBin (bin.h:419–441): first upper bound
  >= value; unseen categoricals map to the last bin.

All of this is host-side numpy on the sampled rows — binning happens once at
dataset construction, so there is nothing to accelerate on the TPU; the
output (the binned uint8/uint16 matrix) is what lives in HBM.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..utils.log import Log

# |value| <= this is treated as zero/missing (reference meta.h:22)
MISSING_VALUE_RANGE = 1e-20

NUMERICAL = 0
CATEGORICAL = 1


def greedy_find_bin(
    distinct_values: np.ndarray,
    counts: np.ndarray,
    max_bin: int,
    total_cnt: int,
    min_data_in_bin: int,
) -> List[float]:
    """Equal-count greedy binning over sorted distinct values.

    Returns the list of bin upper bounds; the last is +inf.
    Parity with GreedyFindBin (bin.cpp:66–135).
    """
    num_distinct = len(distinct_values)
    bounds: List[float] = []
    if num_distinct == 0:
        return bounds
    if num_distinct <= max_bin:
        cur_cnt = 0
        for i in range(num_distinct - 1):
            cur_cnt += int(counts[i])
            if cur_cnt >= min_data_in_bin:
                bounds.append((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                cur_cnt = 0
        bounds.append(np.inf)
        return bounds

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin

    # values whose count alone exceeds the mean bin size get a private bin
    is_big = counts >= mean_bin_size
    rest_bin_cnt = max_bin - int(np.sum(is_big))
    rest_sample_cnt = total_cnt - int(np.sum(counts[is_big]))
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)

    upper: List[float] = []
    lower: List[float] = [distinct_values[0]]
    cur_cnt = 0
    for i in range(num_distinct - 1):
        if not is_big[i]:
            rest_sample_cnt -= int(counts[i])
        cur_cnt += int(counts[i])
        need_new = (
            is_big[i]
            or cur_cnt >= mean_bin_size
            or (is_big[i + 1] and cur_cnt >= max(1.0, mean_bin_size * 0.5))
        )
        if need_new:
            upper.append(float(distinct_values[i]))
            lower.append(float(distinct_values[i + 1]))
            if len(upper) >= max_bin - 1:
                break
            cur_cnt = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)

    bounds = [(upper[i] + lower[i + 1]) / 2.0 for i in range(len(upper))]
    bounds.append(np.inf)
    return bounds


def _need_filter(cnt_in_bin: np.ndarray, total_cnt: int, filter_cnt: int, bin_type: int) -> bool:
    """True when no split of this feature can satisfy min_data_in_leaf on
    both sides (NeedFilter, bin.cpp:47–65)."""
    if len(cnt_in_bin) <= 1:
        return True
    if bin_type == NUMERICAL:
        left = np.cumsum(cnt_in_bin[:-1])
        ok = (left >= filter_cnt) & (total_cnt - left >= filter_cnt)
        return not bool(np.any(ok))
    one = cnt_in_bin[:-1]
    ok = (one >= filter_cnt) & (total_cnt - one >= filter_cnt)
    return not bool(np.any(ok))


class BinMapper:
    """Maps one feature's raw values to small integer bins."""

    def __init__(self):
        self.num_bin: int = 1
        self.bin_type: int = NUMERICAL
        self.is_trivial: bool = True
        self.sparse_rate: float = 0.0
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.bin_2_categorical: np.ndarray = np.array([], dtype=np.int64)
        self.categorical_2_bin: Dict[int, int] = {}
        self.default_bin: int = 0
        self.min_val: float = 0.0
        self.max_val: float = 0.0

    # ------------------------------------------------------------------
    def find_bin(
        self,
        sample_values: np.ndarray,
        total_sample_cnt: int,
        max_bin: int,
        min_data_in_bin: int,
        min_split_data: int,
        bin_type: int = NUMERICAL,
    ) -> None:
        """Build the bin mapping from sampled *non-zero* values.

        ``total_sample_cnt`` = len(sample_values) + number of zero entries,
        exactly as the reference passes them (FindBin, bin.cpp:137).
        """
        values = np.asarray(sample_values, dtype=np.float64)
        distinct_arr, counts_arr = np.unique(values, return_counts=True)
        self.find_bin_from_distinct(
            distinct_arr, counts_arr.astype(np.int64), total_sample_cnt,
            max_bin, min_data_in_bin, min_split_data, bin_type,
        )

    def find_bin_from_distinct(
        self,
        distinct_values: np.ndarray,
        counts: np.ndarray,
        total_sample_cnt: int,
        max_bin: int,
        min_data_in_bin: int,
        min_split_data: int,
        bin_type: int = NUMERICAL,
    ) -> None:
        """``find_bin`` over pre-aggregated (distinct non-zero value,
        count) pairs — the entry point for mergeable streaming sketches
        (data/sketch.py): a sketch that is still exact reproduces the
        raw-sample mapper bit-for-bit, a spilled one feeds its summary
        representatives.  ``total_sample_cnt - counts.sum()`` is the
        implied zero/missing count, same contract as ``find_bin``."""
        self.bin_type = bin_type
        self.default_bin = 0
        distinct_arr = np.asarray(distinct_values, dtype=np.float64)
        counts_arr = np.asarray(counts, dtype=np.int64)
        zero_cnt = int(total_sample_cnt - counts_arr.sum())
        insert_at: Optional[int] = None
        if len(distinct_arr) == 0 or (distinct_arr[0] > 0.0 and zero_cnt > 0):
            insert_at = 0
        elif distinct_arr[-1] < 0.0 and zero_cnt > 0:
            insert_at = len(distinct_arr)
        else:
            pos = int(np.searchsorted(distinct_arr, 0.0, side="left"))
            if 0 < pos < len(distinct_arr) and distinct_arr[pos - 1] < 0.0 < distinct_arr[pos]:
                insert_at = pos
        if insert_at is not None:
            distinct_arr = np.insert(distinct_arr, insert_at, 0.0)
            counts_arr = np.insert(counts_arr, insert_at, zero_cnt)
        self.min_val = float(distinct_arr[0]) if len(distinct_arr) else 0.0
        self.max_val = float(distinct_arr[-1]) if len(distinct_arr) else 0.0

        if bin_type == NUMERICAL:
            cnt_in_bin = self._find_bin_numerical(
                distinct_arr, counts_arr, total_sample_cnt, max_bin, min_data_in_bin
            )
        else:
            cnt_in_bin = self._find_bin_categorical(distinct_arr, counts_arr, total_sample_cnt, max_bin)

        self.is_trivial = self.num_bin <= 1 or _need_filter(
            cnt_in_bin, total_sample_cnt, min_split_data, bin_type
        )
        if not self.is_trivial:
            self.default_bin = int(self.value_to_bin(0.0))
        # sparse_rate computed even for trivial features (bin.cpp:289)
        if len(cnt_in_bin) > self.default_bin:
            self.sparse_rate = float(cnt_in_bin[self.default_bin]) / max(total_sample_cnt, 1)

    def _find_bin_numerical(self, distinct, counts, total_cnt, max_bin, min_data_in_bin):
        # partition distinct values into negative / zero-range / positive
        left_mask = distinct <= -MISSING_VALUE_RANGE
        right_mask = distinct > MISSING_VALUE_RANGE
        zero_mask = ~left_mask & ~right_mask
        left_cnt_data = int(np.sum(counts[left_mask]))
        missing_cnt_data = int(np.sum(counts[zero_mask]))
        right_cnt_data = int(np.sum(counts[right_mask]))
        # Intentional divergence from bin.cpp:196-204: there, left_cnt stays
        # 0 when NO value > -kMissingValueRange exists (strictly-negative
        # feature), so the reference emits a single [inf] bin and drops the
        # feature as trivial.  Here such features are binned normally —
        # strictly better behavior, at the cost of bit-parity with reference
        # models on strictly-negative features (documented per ADVICE r1).
        left_cnt = int(np.sum(left_mask))

        bounds: List[float] = []
        if left_cnt > 0:
            denom = max(total_cnt - missing_cnt_data, 1)
            left_max_bin = int(left_cnt_data / denom * (max_bin - 1))
            left_bounds = greedy_find_bin(
                distinct[:left_cnt], counts[:left_cnt], left_max_bin, left_cnt_data, min_data_in_bin
            )
            if left_bounds:
                left_bounds[-1] = -MISSING_VALUE_RANGE
            bounds.extend(left_bounds)

        right_idx = np.nonzero(right_mask)[0]
        if len(right_idx) > 0:
            rs = int(right_idx[0])
            right_max_bin = max_bin - 1 - len(bounds)
            right_bounds = greedy_find_bin(
                distinct[rs:], counts[rs:], right_max_bin, right_cnt_data, min_data_in_bin
            )
            bounds.append(MISSING_VALUE_RANGE)  # the zero/default bin
            bounds.extend(right_bounds)
        else:
            bounds.append(np.inf)

        self.bin_upper_bound = np.asarray(bounds, dtype=np.float64)
        self.num_bin = len(bounds)
        if self.num_bin > max_bin:
            Log.fatal("bin count %d exceeds max_bin %d", self.num_bin, max_bin)
        # histogram of sampled data over the final bins
        bin_of_distinct = np.searchsorted(self.bin_upper_bound, distinct, side="left")
        cnt_in_bin = np.zeros(self.num_bin, dtype=np.int64)
        np.add.at(cnt_in_bin, bin_of_distinct, counts)
        return cnt_in_bin

    def _find_bin_categorical(self, distinct, counts, total_cnt, max_bin):
        # fold to ints, then order by count descending (stable)
        distinct_int = distinct.astype(np.int64)
        uniq, inv = np.unique(distinct_int, return_inverse=True)
        cnt = np.zeros(len(uniq), dtype=np.int64)
        np.add.at(cnt, inv, counts)
        order = np.argsort(-cnt, kind="stable")
        uniq, cnt = uniq[order], cnt[order]

        cut_cnt = int(total_cnt * 0.98)
        max_bin = min(len(uniq), max_bin)
        used_cnt = 0
        num_bin = 0
        while num_bin < len(uniq) and (used_cnt < cut_cnt or num_bin < max_bin):
            used_cnt += int(cnt[num_bin])
            num_bin += 1
        self.num_bin = num_bin
        self.bin_2_categorical = uniq[:num_bin].copy()
        self.categorical_2_bin = {int(v): i for i, v in enumerate(self.bin_2_categorical)}
        # Parity quirk (bin.cpp:269-271): cnt_in_bin is the FULL distinct
        # counts — the unseen-value fold `counts_int.back() += ...` lands in
        # the truncated copy that is immediately discarded — so NeedFilter
        # and sparse_rate see untruncated per-category counts.
        return cnt.copy()

    # ------------------------------------------------------------------
    def value_to_bin(self, value) -> np.ndarray:
        """Vectorized value→bin (ValueToBin, bin.h:419–441)."""
        value = np.asarray(value, dtype=np.float64)
        if self.bin_type == NUMERICAL:
            v = np.where(np.isnan(value), 0.0, value)  # NaN rides the zero bin
            return np.minimum(
                np.searchsorted(self.bin_upper_bound, v, side="left"), self.num_bin - 1
            ).astype(np.int32)
        out = np.full(value.shape, self.num_bin - 1, dtype=np.int32)
        iv = value.astype(np.int64)
        for cat, b in self.categorical_2_bin.items():
            out[iv == cat] = b
        return out

    def bin_to_value(self, b: int) -> float:
        """Representative value of a bin (BinToValue, bin.h:98-104)."""
        if self.bin_type == NUMERICAL:
            return float(self.bin_upper_bound[b])
        return float(self.bin_2_categorical[b])

    # ------------------------------------------------------------------
    def to_string(self) -> str:
        """Feature-info string used in the model file ("min:max" for
        numerical, colon-joined categories otherwise) — matches the
        feature_infos= field the reference writes (dataset.cpp)."""
        if self.is_trivial:
            return "none"
        if self.bin_type == NUMERICAL:
            return f"[{self.min_val}:{self.max_val}]"
        return ":".join(str(int(v)) for v in self.bin_2_categorical)

    def state(self) -> dict:
        return {
            "num_bin": self.num_bin,
            "bin_type": self.bin_type,
            "is_trivial": self.is_trivial,
            "sparse_rate": self.sparse_rate,
            "bin_upper_bound": self.bin_upper_bound,
            "bin_2_categorical": self.bin_2_categorical,
            "default_bin": self.default_bin,
            "min_val": self.min_val,
            "max_val": self.max_val,
        }

    @classmethod
    def from_state(cls, st: dict) -> "BinMapper":
        m = cls()
        m.num_bin = int(st["num_bin"])
        m.bin_type = int(st["bin_type"])
        m.is_trivial = bool(st["is_trivial"])
        m.sparse_rate = float(st["sparse_rate"])
        m.bin_upper_bound = np.asarray(st["bin_upper_bound"], dtype=np.float64)
        m.bin_2_categorical = np.asarray(st["bin_2_categorical"], dtype=np.int64)
        m.categorical_2_bin = {int(v): i for i, v in enumerate(m.bin_2_categorical)}
        m.default_bin = int(st["default_bin"])
        m.min_val = float(st["min_val"])
        m.max_val = float(st["max_val"])
        return m
