"""State carried across from the JAX package.

``booster_from_model_string`` loads model text written by
``lightgbm_tpu`` (the reference-compatible format both packages write)
into a port Booster; ``dataset_from_arrays`` rebuilds a BinnedDataset
from the numpy arrays of a ``lightgbm_tpu`` BinnedDataset, so both
packages can be handed identical state."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .basic import Booster
from .io.binning import BinMapper
from .io.dataset import BinnedDataset, Metadata


def booster_from_model_string(text: str, device=None) -> Booster:
    return Booster(model_str=text, device=device)


def dataset_from_arrays(binned: np.ndarray, mapper_states: Sequence[dict], label,
                        weight=None, init_score=None, used_feature_map=None,
                        num_total_features: Optional[int] = None,
                        feature_names: Optional[List[str]] = None,
                        max_bin: int = 255) -> BinnedDataset:
    """A BinnedDataset over the (N, F) bin matrix ``binned`` whose bin
    mappers are given by ``mapper_states`` (``BinMapper.state()`` dicts:
    bin upper bounds, categories, default bin, ...)."""
    binned = np.asarray(binned)
    n, f = binned.shape
    ds = BinnedDataset()
    ds.binned = binned
    ds.bin_mappers = [BinMapper.from_state(st) for st in mapper_states]
    if len(ds.bin_mappers) != f:
        raise ValueError(f"{len(ds.bin_mappers)} bin mappers for {f} binned columns")
    ds.used_feature_map = (np.arange(f, dtype=np.int32) if used_feature_map is None
                           else np.asarray(used_feature_map, np.int32))
    ds.num_total_features = int(num_total_features or (int(ds.used_feature_map.max()) + 1))
    ds.feature_names = list(feature_names) if feature_names else [
        f"Column_{i}" for i in range(ds.num_total_features)]
    ds.max_bin = max_bin
    ds.metadata = Metadata(n)
    ds.metadata.set_label(label)
    ds.metadata.set_weights(weight)
    ds.metadata.set_init_score(init_score)
    return ds
