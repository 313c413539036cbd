"""Binned dataset — counterpart of lightgbm_tpu/io/dataset.py (the
reference's Dataset/Metadata, src/io/dataset.cpp, metadata.cpp).

The whole dataset is one dense row-major ``(N, F)`` uint8/uint16 matrix
of bin indices, built on the host with numpy exactly as the JAX package
builds it (same sample, same mappers, same bins), with the query groups
of a ranking task, and its row subsets (cv folds) and validation sets.
Over several processes the find-bin is distributed (each process its
feature block, the mappers allgathered: ``_find_bin_mappers_distributed``).

Parity notes:
- trivial-feature filtering and used-feature mapping ↔ Dataset::Construct
  (dataset.cpp:210)
- metadata (labels/weights/query boundaries/init score) ↔ Metadata
  (dataset.h:36–248, metadata.cpp)
- binary cache save/load ↔ SaveBinaryFile/LoadFromBinFile
  (dataset.cpp, dataset_loader.cpp:263): the JAX package's npz, format
  v2 (data/cache.py), with the same magic and members, so a cache
  written by either package loads in the other.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import Config
from ..utils.log import Log
from ..utils.random import Random
from .binning import CATEGORICAL, NUMERICAL, BinMapper

_BINARY_MAGIC = "lightgbm_tpu.dataset.v1"


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
        self.cache_path: Optional[str] = None  # the binary cache this was loaded from
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
            mappers = _find_bin_mappers_distributed(data, config, cat_set)
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
    def save_binary(self, path: str, source_path: Optional[str] = None) -> None:
        """The binary dataset cache (Dataset::SaveBinaryFile), format v2,
        written to exactly ``path``: members stored uncompressed, so the
        bin matrix's bytes are contiguous in the file; the
        ``__cache_meta__`` header records the format version, per-block
        CRCs and, given ``source_path``, the source file's identity, so a
        cache that no longer matches its source is refused."""
        from ..data.cache import build_cache_meta, chunk_crcs

        meta = build_cache_meta(self.binned, self.metadata.label, source_path=source_path)
        payload: Dict[str, np.ndarray] = {
            "magic": np.asarray(_BINARY_MAGIC),
            "__cache_meta__": np.asarray(json.dumps(meta)),
            "chunk_crc": chunk_crcs(self.binned),
            "binned": self.binned,
            "used_feature_map": self.used_feature_map,
            "num_total_features": np.asarray(self.num_total_features),
            "feature_names": np.asarray(self.feature_names),
            "max_bin": np.asarray(self.max_bin),
            "label": self.metadata.label,
            "num_mappers": np.asarray(len(self.bin_mappers)),
        }
        if self.metadata.weights is not None:
            payload["weights"] = self.metadata.weights
        if self.metadata.query_boundaries is not None:
            payload["query_boundaries"] = self.metadata.query_boundaries
        if self.metadata.init_score is not None:
            payload["init_score"] = self.metadata.init_score
        for i, m in enumerate(self.bin_mappers):
            st = m.state()
            payload[f"m{i}_meta"] = np.asarray(
                [st["num_bin"], st["bin_type"], int(st["is_trivial"]), st["default_bin"]],
                dtype=np.int64)
            payload[f"m{i}_fl"] = np.asarray([st["sparse_rate"], st["min_val"], st["max_val"]],
                                             dtype=np.float64)
            payload[f"m{i}_bounds"] = st["bin_upper_bound"]
            payload[f"m{i}_cats"] = st["bin_2_categorical"]
        # a file object: np.savez appends .npz to a bare name
        with open(path, "wb") as f:
            np.savez(f, **payload)

    @staticmethod
    def is_binary_cache(path: str) -> bool:
        """True when ``path`` is a saved binary dataset (zip magic and the
        payload's magic): DatasetLoader checks the binary header before
        parsing text (dataset_loader.cpp LoadFromBinFile)."""
        try:
            with open(path, "rb") as f:
                if f.read(4) != b"PK\x03\x04":
                    return False
            with np.load(path, allow_pickle=False) as z:
                return "magic" in z and str(z["magic"]) == _BINARY_MAGIC
        except Exception:
            return False

    @classmethod
    def load_binary(cls, path: str) -> "BinnedDataset":
        """A cache written by ``save_binary`` (of either package).  A
        format-v1 cache, a newer format and a cache whose source file has
        changed are refused; the bin matrix is a read-only memmap of the
        file where the format allows it."""
        from ..data.cache import (CACHE_FORMAT_VERSION, open_cache_reader, read_cache_meta,
                                  stale_reason)

        with np.load(path, allow_pickle=False) as z:
            if str(z["magic"]) != _BINARY_MAGIC:
                Log.fatal("File %s is not a lightgbm_tpu binary dataset", path)
            meta = read_cache_meta(z)
            if meta is None:
                Log.fatal("Binary dataset %s predates cache format v%d (no version/fingerprint "
                          "header) — regenerate it with task=ingest", path,
                          CACHE_FORMAT_VERSION)
            if int(meta.get("format_version", 0)) > CACHE_FORMAT_VERSION:
                Log.fatal("Binary dataset %s has cache format v%s, newer than this build "
                          "supports (v%d)", path, meta.get("format_version"),
                          CACHE_FORMAT_VERSION)
            stale = stale_reason(meta)
            if stale:
                Log.fatal("Refusing stale binary dataset %s: %s — regenerate the cache with "
                          "task=ingest (or delete it)", path, stale)
            ds = cls()
            reader = open_cache_reader(path)
            if reader is not None:
                ds.binned = reader.memmap()
                ds.cache_path = path
                reader.close()
            else:
                ds.binned = z["binned"]
            ds.used_feature_map = z["used_feature_map"]
            ds.num_total_features = int(z["num_total_features"])
            ds.feature_names = [str(s) for s in z["feature_names"]]
            ds.max_bin = int(z["max_bin"])
            ds.metadata = Metadata(ds.binned.shape[0])
            ds.metadata.set_label(z["label"])
            if "weights" in z:
                ds.metadata.set_weights(z["weights"])
            if "query_boundaries" in z:
                ds.metadata.query_boundaries = z["query_boundaries"].astype(np.int64)
            if "init_score" in z:
                ds.metadata.set_init_score(z["init_score"])
            for i in range(int(z["num_mappers"])):
                mm, fl = z[f"m{i}_meta"], z[f"m{i}_fl"]
                ds.bin_mappers.append(BinMapper.from_state({
                    "num_bin": mm[0], "bin_type": mm[1], "is_trivial": bool(mm[2]),
                    "default_bin": mm[3], "sparse_rate": fl[0], "min_val": fl[1],
                    "max_val": fl[2], "bin_upper_bound": z[f"m{i}_bounds"],
                    "bin_2_categorical": z[f"m{i}_cats"]}))
        return ds


def _find_bin_mappers_distributed(data: np.ndarray, config: Config,
                                  categorical: set) -> List[BinMapper]:
    """The distributed find-bin (dataset_loader.cpp:733-835; JAX
    io/dataset.py:404-446): over several processes each finds the bins of
    its contiguous feature block, ``step = ceil(F / M)`` features from
    ``rank * step``, from its own rows, and the pickled mapper states are
    allgathered, so every process ends with the same list.  One process,
    or a run that is not ``is_parallel_find_bin``, finds them all."""
    if not getattr(config, "is_parallel_find_bin", False):
        return _find_bin_mappers(data, config, categorical)
    from ..parallel import distributed

    if not distributed.ensure_initialized(config):
        return _find_bin_mappers(data, config, categorical)
    import pickle

    from ..parallel.collect import allgather_blob_lists

    nproc, rank = distributed.process_count(), distributed.process_index()
    f_total = data.shape[1]
    step = max(1, -(-f_total // nproc))
    start = min(rank * step, f_total)
    stop = min(start + step, f_total)
    local_cats = {c - start for c in categorical if start <= c < stop}
    local = _find_bin_mappers(data[:, start:stop], config, local_cats) if stop > start else []
    gathered = allgather_blob_lists([pickle.dumps(m.state()) for m in local], list_len=step)
    mappers: List[BinMapper] = []
    for f in range(f_total):
        r, i = divmod(f, step)
        mappers.append(BinMapper.from_state(pickle.loads(gathered[r][i])))
    return mappers


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


def packed_bin_dtype(mappers: List[BinMapper]):
    """uint8 unless some feature needs more than 256 bins (the bin
    matrix's sizing rule, shared with the streamed ingest's pass 2)."""
    max_bins = max((m.num_bin for m in mappers), default=2)
    return np.uint8 if max_bins <= 256 else np.uint16


def bin_rows_into(out: np.ndarray, start: int, data: np.ndarray, mappers: List[BinMapper],
                  used_map: np.ndarray) -> None:
    """Bin raw rows into ``out[start:start + len(data)]`` (the streamed
    ingest's pass-2 write)."""
    stop = start + data.shape[0]
    for inner, real in enumerate(used_map):
        out[start:stop, inner] = mappers[inner].value_to_bin(data[:, int(real)]).astype(out.dtype)


def _bin_matrix(data: np.ndarray, mappers: List[BinMapper], used_map: np.ndarray) -> np.ndarray:
    """(N, F) bin matrix of the raw rows."""
    out = np.empty((data.shape[0], len(mappers)), dtype=packed_bin_dtype(mappers))
    bin_rows_into(out, 0, data, mappers, used_map)
    return out
