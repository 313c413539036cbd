"""Inference serving on one CUDA card — PyTorch counterpart of
lightgbm_tpu/serve/.

1. **Packed artifacts** (``artifact.py``): the stacked tree arrays plus
   objective/class/feature metadata in one versioned ``.npz`` (v1 exact,
   v2 quantized, v3 linear leaves), the JAX package's format.
2. **Bucketed predictors** (``compilecache.py``): requests padded up a
   power-of-two bucket ladder, one CUDA graph per bucket per predictor
   (the walk, the per-class sums and the objective's conversion);
   ``warmup()`` captures the ladder.
3. **Microbatching** (``batcher.py``) and a stdlib-HTTP front end
   (``server.py``, ``python -m lightgbm_tpu_torch serve``): concurrent
   requests coalesce into device batches under ``max_batch_size`` /
   ``max_delay_ms``, with bounded queueing and overload shedding.
4. **Hot swap** (``registry.py``, ``fleet.py``): a versioned on-disk
   model registry with atomic CRC'd publishes, and a version-stamped slot
   that swaps at microbatch boundaries (a same-shape retrain in place,
   with no capture).
5. **The fleet** (``fleet.py``, ``breaker.py``): ``FleetProxy`` in front
   of N replicas (``spawn_replicas``, ``python -m lightgbm_tpu_torch
   fleet``) with health ejection, deadline budgets, hedged predicts,
   latency-outlier circuit breakers and overload shedding.

See docs/SERVING.md for the artifact format and the operational knobs
(the port adds ``device``; its compiles are CUDA graph captures).
"""

from .artifact import PackedPredictor, PredictorArtifact
from .batcher import MicroBatcher, RequestTimeout, ServerOverloaded
from .compilecache import (BucketedQuantizedPredictor, BucketedRawPredictor, bucket_for,
                           bucket_ladder, pad_qtree_arrays, pad_tree_arrays,
                           tree_shape_bucket)
from .breaker import LatencyBreaker
from .fleet import FleetProxy, SwappablePredictor, spawn_replicas
from .registry import ModelRegistry

__all__ = [
    "PredictorArtifact",
    "PackedPredictor",
    "BucketedRawPredictor",
    "BucketedQuantizedPredictor",
    "bucket_for",
    "bucket_ladder",
    "tree_shape_bucket",
    "pad_tree_arrays",
    "pad_qtree_arrays",
    "MicroBatcher",
    "ServerOverloaded",
    "RequestTimeout",
    "ModelRegistry",
    "SwappablePredictor",
    "FleetProxy",
    "spawn_replicas",
    "LatencyBreaker",
]
