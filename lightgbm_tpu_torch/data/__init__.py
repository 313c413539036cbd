"""Data files on the host — the PyTorch port's copy of lightgbm_tpu/data/
(numpy only, no torch, but for the two streaming modules below), the
counterpart of the reference's TextReader/PipelineReader and the
sampling half of DatasetLoader:

  ``reader``  chunked CSV/TSV/LibSVM parsers (native parser per block,
              pandas' C engine as the fallback), the one backend of both
              the in-memory load (io/parser.py) and the streamed ingest
  ``sketch``  mergeable per-feature summaries (distinct-count maps
              spilling to GK quantile sketches, Misra-Gries categorical
              counts)
  ``stats``   pass-1 collection: the deterministic bin-construction
              sample and the sketch bank
  ``ingest``  two-pass construction: Dataset(path) -> bin matrix without
              ever materializing the raw float matrix
  ``cache``   the binary dataset cache, format v2 (the JAX package's):
              an uncompressed npz with a version and source-identity
              header and per-block CRCs

Out-of-core training's streaming seam (boosting/ooc.py), which uses
torch and is imported only by it:

  ``prefetch``     the chunk plan, the array and cache chunk sources and
                   the bounded prefetch ring (pinned buffers, a copy
                   stream and events on the card)
  ``chunksource``  the chunk stream and the fold algebra of the streamed
                   mask grower
"""

from .cache import (CACHE_FORMAT_VERSION, CacheReader, build_cache_meta,  # noqa: F401
                    open_cache_reader, read_cache_meta, stale_reason)
from .ingest import should_stream, stream_dataset  # noqa: F401
from .reader import DenseChunkReader, LibSVMChunkReader, make_reader  # noqa: F401
from .sketch import CategoricalSketch, GKSketch, NumericSketch  # noqa: F401
from .stats import SampleCollector, SketchCollector  # noqa: F401

__all__ = [
    "should_stream", "stream_dataset",
    "DenseChunkReader", "LibSVMChunkReader", "make_reader",
    "GKSketch", "NumericSketch", "CategoricalSketch",
    "SampleCollector", "SketchCollector",
    "CACHE_FORMAT_VERSION", "CacheReader", "build_cache_meta",
    "open_cache_reader", "read_cache_meta", "stale_reason",
]
