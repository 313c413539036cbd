"""Binned dataset — counterpart of lightgbm_tpu/io/dataset.py (the
reference's Dataset/Metadata, src/io/dataset.cpp, metadata.cpp).

The whole dataset is one dense row-major ``(N, F)`` uint8/uint16 matrix
of bin indices, built on the host with numpy exactly as the JAX package
builds it (same sample, same mappers, same bins), with the query groups
of a ranking task, and its row subsets (cv folds) and validation sets.
Not ported yet: the distributed find-bin (raises NotImplementedError)
and the binary dataset cache.

Parity notes:
- trivial-feature filtering and used-feature mapping ↔ Dataset::Construct
  (dataset.cpp:210)
- metadata (labels/weights/query boundaries/init score) ↔ Metadata
  (dataset.h:36–248, metadata.cpp)
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..config import Config
from ..utils.log import Log
from ..utils.random import Random
from .binning import CATEGORICAL, NUMERICAL, BinMapper


class Metadata:
    """Labels, weights, query boundaries, init scores (dataset.h:36–248)."""

    def __init__(self, num_data: int = 0):
        self.num_data = num_data
        self.label: np.ndarray = np.zeros(num_data, dtype=np.float32)
        self.weights: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None
        self.query_weights: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label: Sequence[float]) -> None:
        label = np.asarray(label, dtype=np.float32).ravel()
        if len(label) != self.num_data:
            Log.fatal("Length of label (%d) != num_data (%d)", len(label), self.num_data)
        self.label = label

    def set_weights(self, weights: Optional[Sequence[float]]) -> None:
        if weights is None:
            self.weights = None
            return
        weights = np.asarray(weights, dtype=np.float32).ravel()
        if len(weights) != self.num_data:
            Log.fatal("Length of weights (%d) != num_data (%d)", len(weights), self.num_data)
        self.weights = weights

    def set_query(self, group: Optional[Sequence[int]]) -> None:
        """``group`` is per-query sizes (the python API's convention);
        builds cumulative query boundaries like Metadata::SetQuery."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.asarray(group, dtype=np.int64).ravel()
        if int(group.sum()) != self.num_data:
            Log.fatal("Sum of query counts (%d) != num_data (%d)", int(group.sum()), self.num_data)
        self.query_boundaries = np.concatenate([[0], np.cumsum(group)]).astype(np.int64)

    def set_init_score(self, init_score: Optional[Sequence[float]]) -> None:
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.asarray(init_score, dtype=np.float64).ravel()

    @property
    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None else len(self.query_boundaries) - 1


class BinnedDataset:
    """The device-ready binned training data.

    Attributes
    ----------
    binned : (num_data, num_used_features) np.uint8 or np.uint16
        Bin index of each (row, used-feature).
    bin_mappers : list[BinMapper], one per used feature.
    used_feature_map : original feature index of each used feature.
    num_total_features : raw feature count before trivial filtering.
    """

    def __init__(self):
        self.binned: np.ndarray = np.zeros((0, 0), dtype=np.uint8)
        self.bin_mappers: List[BinMapper] = []
        self.used_feature_map: np.ndarray = np.array([], dtype=np.int32)
        self.num_total_features: int = 0
        self.metadata = Metadata(0)
        self.feature_names: List[str] = []
        self.max_bin: int = 255
        self.label_idx: int = 0
        self.bundle = None  # EFB BundleInfo (io/bundle.py); None = unbundled
        self.bundled: Optional[np.ndarray] = None  # (N, G) uint8 bundle bins
        # raw (unbinned) copy is not kept — predictions on training data run
        # on the binned representation like the reference's score updater.

    # ------------------------------------------------------------------
    @property
    def num_data(self) -> int:
        return self.binned.shape[0]

    @property
    def num_features(self) -> int:
        """Number of used (non-trivial) features."""
        return self.binned.shape[1]

    def num_bin(self, fidx: int) -> int:
        return self.bin_mappers[fidx].num_bin

    @property
    def max_num_bin(self) -> int:
        return max((m.num_bin for m in self.bin_mappers), default=1)

    def real_threshold(self, fidx: int, bin_idx: int) -> float:
        return self.bin_mappers[fidx].bin_to_value(int(bin_idx))

    def inner_to_real_feature(self, fidx: int) -> int:
        return int(self.used_feature_map[fidx])

    # ------------------------------------------------------------------
    @classmethod
    def from_raw(
        cls,
        data: np.ndarray,
        config: Config,
        *,
        label: Optional[Sequence[float]] = None,
        weight: Optional[Sequence[float]] = None,
        group: Optional[Sequence[int]] = None,
        init_score: Optional[Sequence[float]] = None,
        feature_names: Optional[List[str]] = None,
        categorical_features: Optional[Sequence[int]] = None,
        reference: Optional["BinnedDataset"] = None,
    ) -> "BinnedDataset":
        """Construct from a raw dense float matrix.

        Mirrors DatasetLoader::ConstructBinMappersFromTextData +
        ExtractFeaturesFromMemory (dataset_loader.cpp:661, :840): sample rows,
        find bins per feature, then push every row through the mappers.
        With ``reference`` given, reuses its bin mappers (CreateValid /
        LoadFromFileAlignWithOtherDataset path).
        """
        data = np.asarray(data, dtype=np.float64)
        if data.ndim != 2:
            Log.fatal("data must be 2-dimensional")
        n, num_features = data.shape
        ds = cls()
        ds.num_total_features = num_features
        ds.max_bin = config.max_bin
        ds.metadata = Metadata(n)
        if label is not None:
            ds.metadata.set_label(label)
        ds.metadata.set_weights(weight)
        ds.metadata.set_query(group)
        ds.metadata.set_init_score(init_score)
        ds.feature_names = list(feature_names) if feature_names else [
            f"Column_{i}" for i in range(num_features)
        ]

        if reference is not None:
            ds.bin_mappers = reference.bin_mappers
            ds.used_feature_map = reference.used_feature_map
            ds.num_total_features = reference.num_total_features
            ds.feature_names = reference.feature_names
            ds.max_bin = reference.max_bin
        else:
            cat_set = set(int(c) for c in categorical_features) if categorical_features else set()
            if getattr(config, "is_parallel_find_bin", False):
                raise NotImplementedError(
                    "lightgbm_tpu_torch does not support the distributed find-bin yet")
            mappers = _find_bin_mappers(data, config, cat_set)
            used = [i for i, m in enumerate(mappers) if not m.is_trivial]
            if not used:
                Log.fatal("Cannot construct Dataset: all features are trivial (constant)")
            ds.bin_mappers = [mappers[i] for i in used]
            ds.used_feature_map = np.asarray(used, dtype=np.int32)

        ds.binned = _bin_matrix(data, ds.bin_mappers, ds.used_feature_map)
        return ds

    def ensure_bundles(self, config) -> None:
        """Decide EFB bundling lazily, exactly as the JAX package does
        (io/bundle.py find_bundles), and build the (N, G) matrix of bundle
        bins that the partitioned trainer packs in place of ``binned``."""
        if self.bundle is not None or getattr(self, "_bundle_checked", False):
            return
        self._bundle_checked = True
        if not getattr(config, "enable_bundle", True) or self.binned.dtype != np.uint8:
            return
        from .bundle import build_bundled_matrix, find_bundles

        info = find_bundles(self.binned, self.bin_mappers, config)
        if info is not None:
            self.bundle = info
            self.bundled = build_bundled_matrix(self.binned, self.bin_mappers, info)

    def create_valid(self, data, **kwargs) -> "BinnedDataset":
        """Validation dataset aligned with this dataset's bin mappers
        (Dataset::CreateValid, dataset.cpp)."""
        return BinnedDataset.from_raw(data, Config(), reference=self, **kwargs)

    def subset(self, indices) -> "BinnedDataset":
        """Row subset sharing the bin mappers (Dataset::CopySubset): the
        binned rows, label, weights and init score of ``indices``, nothing
        re-binned.  A ranking set keeps its non-empty queries, in order,
        with the rows of each that ``indices`` retains."""
        indices = np.asarray(indices)
        ds = BinnedDataset()
        ds.binned = self.binned[indices]
        ds.bin_mappers = self.bin_mappers
        ds.used_feature_map = self.used_feature_map
        ds.num_total_features = self.num_total_features
        ds.feature_names = self.feature_names
        ds.max_bin = self.max_bin
        md = self.metadata
        ds.metadata = Metadata(len(indices))
        ds.metadata.set_label(md.label[indices])
        if md.weights is not None:
            ds.metadata.set_weights(md.weights[indices])
        if md.query_boundaries is not None:
            qb = md.query_boundaries
            row_query = np.searchsorted(qb, indices, side="right") - 1
            per_query = np.bincount(row_query, minlength=len(qb) - 1)
            ds.metadata.set_query(per_query[per_query > 0])
        if md.init_score is not None:
            ns = len(md.init_score) // max(md.num_data, 1)
            if ns > 1:  # class-major (K, N)
                ds.metadata.set_init_score(md.init_score.reshape(ns, -1)[:, indices].ravel())
            else:
                ds.metadata.set_init_score(md.init_score[indices])
        return ds

    # ------------------------------------------------------------------
    def feature_infos(self) -> List[str]:
        """feature_infos= strings for the model file, indexed by ORIGINAL
        feature id (trivial features report 'none')."""
        infos = ["none"] * self.num_total_features
        for inner, real in enumerate(self.used_feature_map):
            infos[int(real)] = self.bin_mappers[inner].to_string()
        return infos

    # ------------------------------------------------------------------
def _find_bin_mappers(data: np.ndarray, config: Config, categorical: set) -> List[BinMapper]:
    """Sample rows then FindBin per feature (dataset_loader.cpp:661–776)."""
    n = data.shape[0]
    return find_bin_mappers_from_sample(data[bin_sample_indices(n, config)], n, config,
                                        categorical)


def bin_sample_indices(n: int, config: Config) -> np.ndarray:
    """The deterministic bin-construction row sample (DatasetLoader's
    ``random_.Sample(num_data, bin_construct_sample_cnt)``), sorted
    ascending."""
    rng = Random(config.data_random_seed)
    sample_cnt = min(config.bin_construct_sample_cnt, n)
    return rng.sample(n, sample_cnt)


def find_bin_mappers_from_sample(
    sampled: np.ndarray,
    total_rows: int,
    config: Config,
    categorical: set,
) -> List[BinMapper]:
    """FindBin per feature over an already-collected sample matrix.
    ``total_rows`` is the FULL dataset row count — min_data_in_leaf is
    scaled by the sampling fraction, exactly like
    dataset_loader.cpp:491-492 / :709-710 (sampled per-bin counts are
    proportionally smaller than full-data counts)."""
    total = sampled.shape[0]
    filter_cnt = int(config.min_data_in_leaf * total / max(total_rows, 1))
    mappers: List[BinMapper] = []
    for f in range(sampled.shape[1]):
        col = sampled[:, f]
        col = col[~np.isnan(col)]
        nonzero = col[col != 0.0]
        m = BinMapper()
        m.find_bin(
            nonzero,
            total,
            config.max_bin,
            config.min_data_in_bin,
            filter_cnt,
            CATEGORICAL if f in categorical else NUMERICAL,
        )
        mappers.append(m)
    return mappers


def _bin_matrix(data: np.ndarray, mappers: List[BinMapper], used_map: np.ndarray) -> np.ndarray:
    """(N, F) bin matrix: uint8 unless some feature needs more than 256
    bins (the packed-matrix sizing rule)."""
    max_bins = max((m.num_bin for m in mappers), default=2)
    out = np.empty((data.shape[0], len(mappers)), np.uint8 if max_bins <= 256 else np.uint16)
    for inner, real in enumerate(used_map):
        out[:, inner] = mappers[inner].value_to_bin(data[:, int(real)]).astype(out.dtype)
    return out
