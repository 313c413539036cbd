"""Metrics — PyTorch counterpart of lightgbm_tpu/metric/ (factory
src/metric/metric.cpp:10-41).

Each metric evaluates with torch ops on the scores' device, in float64
(the JAX package's host path evaluates in float64 numpy; the reference
reduces into ``double sum_loss``).  One function per metric: the JAX
package's second, device copy (metric/device.py) is not carried over.
The ranking metrics (NDCG, MAP) evaluate query by query on the host in
float64 numpy, as the JAX package's do.
"""

from .binary import AUCMetric, BinaryErrorMetric, BinaryLoglossMetric
from .multiclass import MultiErrorMetric, MultiLoglossMetric
from .rank import MapMetric, NDCGMetric
from .regression import (
    FairMetric,
    HuberMetric,
    L1Metric,
    L2Metric,
    PoissonMetric,
    RMSEMetric,
)

_FACTORY = {
    "l1": L1Metric,
    "mean_absolute_error": L1Metric,
    "mae": L1Metric,
    "regression_l1": L1Metric,
    "l2": L2Metric,
    "mean_squared_error": L2Metric,
    "mse": L2Metric,
    "regression": L2Metric,
    "regression_l2": L2Metric,
    "rmse": RMSEMetric,
    "root_mean_squared_error": RMSEMetric,
    "l2_root": RMSEMetric,
    "huber": HuberMetric,
    "fair": FairMetric,
    "poisson": PoissonMetric,
    "binary_logloss": BinaryLoglossMetric,
    "binary": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "multi_logloss": MultiLoglossMetric,
    "multiclass": MultiLoglossMetric,
    "softmax": MultiLoglossMetric,
    "multiclassova": MultiLoglossMetric,
    "multiclass_ova": MultiLoglossMetric,
    "ova": MultiLoglossMetric,
    "ovr": MultiLoglossMetric,
    "multi_error": MultiErrorMetric,
    "ndcg": NDCGMetric,
    "lambdarank": NDCGMetric,
    "map": MapMetric,
    "mean_average_precision": MapMetric,
}


def create_metric(name: str, config):
    """Metric::CreateMetric (src/metric/metric.cpp:10-41); None for an
    unknown name, like the reference (the caller warns)."""
    cls = _FACTORY.get(name.lower())
    return cls(config) if cls is not None else None


def metric_names_for_objective(objective_name: str):
    """The default metric when none is given: the objective's name through
    the same factory (config.cpp metric defaulting)."""
    return [objective_name]


__all__ = [
    "create_metric",
    "metric_names_for_objective",
    "AUCMetric",
    "BinaryErrorMetric",
    "BinaryLoglossMetric",
    "FairMetric",
    "HuberMetric",
    "L1Metric",
    "L2Metric",
    "MapMetric",
    "MultiErrorMetric",
    "MultiLoglossMetric",
    "NDCGMetric",
    "PoissonMetric",
    "RMSEMetric",
]
