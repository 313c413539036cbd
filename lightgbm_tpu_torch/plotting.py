"""Plotting — the PyTorch port's copy of lightgbm_tpu/plotting.py, the
counterpart of python-package/lightgbm/plotting.py (plot_importance,
plot_metric, plot_tree, create_tree_digraph).  matplotlib and graphviz
are imported when a function needs them, so the package imports
without them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .basic import Booster
from .utils.log import Log


def _check_not_tuple_of_2_elements(obj, obj_name="obj"):
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a tuple of 2 elements.")


def plot_importance(
    booster,
    ax=None,
    height: float = 0.2,
    xlim=None,
    ylim=None,
    title: str = "Feature importance",
    xlabel: str = "Feature importance",
    ylabel: str = "Features",
    importance_type: str = "split",
    max_num_features: Optional[int] = None,
    ignore_zero: bool = True,
    figsize=None,
    grid: bool = True,
    **kwargs,
):
    """Bar chart of feature importances (plotting.py plot_importance)."""
    import matplotlib.pyplot as plt

    if isinstance(booster, Booster):
        importance = booster.feature_importance(importance_type)
        feature_names = booster.feature_name()
    elif hasattr(booster, "booster_"):
        importance = booster.booster_.feature_importance(importance_type)
        feature_names = booster.booster_.feature_name()
    else:
        raise TypeError("booster must be Booster or LGBMModel")

    tuples = sorted(zip(feature_names, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    if not tuples:
        raise ValueError("Cannot plot trees with zero importance")
    labels, values = zip(*tuples)

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y, str(int(x) if importance_type == "split" else round(x, 2)),
                va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
        ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(
    booster_or_evals_result,
    metric: Optional[str] = None,
    dataset_names=None,
    ax=None,
    xlim=None,
    ylim=None,
    title: str = "Metric during training",
    xlabel: str = "Iterations",
    ylabel: str = "auto",
    figsize=None,
    grid: bool = True,
):
    """Plot metric history recorded by record_evaluation
    (plotting.py plot_metric)."""
    import matplotlib.pyplot as plt

    if isinstance(booster_or_evals_result, dict):
        eval_results = booster_or_evals_result
    elif hasattr(booster_or_evals_result, "evals_result_"):
        eval_results = booster_or_evals_result.evals_result_
    else:
        raise TypeError(
            "booster_or_evals_result must be a dict from record_evaluation "
            "or a fitted LGBMModel"
        )
    if not eval_results:
        raise ValueError("eval results are empty")

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)

    names = list(dataset_names) if dataset_names else list(eval_results.keys())
    first = eval_results[names[0]]
    if metric is None:
        metric = next(iter(first.keys()))
    for name in names:
        if metric not in eval_results[name]:
            raise ValueError(f"Metric {metric} not found for dataset {name}")
        results = eval_results[name][metric]
        ax.plot(range(1, len(results) + 1), results, label=name)
    ax.legend(loc="best")
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
        ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    ax.set_ylabel(metric if ylabel == "auto" else ylabel)
    ax.grid(grid)
    return ax


def _tree_of(booster, tree_index: int):
    if hasattr(booster, "booster_"):
        booster = booster.booster_
    if not isinstance(booster, Booster):
        raise TypeError("booster must be Booster or LGBMModel")
    models = booster.boosting.models
    if tree_index >= len(models):
        raise IndexError(f"tree_index {tree_index} out of range ({len(models)} trees)")
    return booster, models[tree_index]


def create_tree_digraph(
    booster,
    tree_index: int = 0,
    show_info=None,
    name=None,
    comment=None,
    **kwargs,
):
    """Graphviz Digraph of one tree (plotting.py create_tree_digraph)."""
    import graphviz

    booster, tree = _tree_of(booster, tree_index)
    feature_names = booster.feature_name()
    show_info = show_info or []
    graph = graphviz.Digraph(name=name, comment=comment, **kwargs)

    def add(idx, parent=None, decision=None):
        if idx >= 0:
            name_ = f"split{idx}"
            feat = tree.split_feature[idx]
            label = (
                f"{feature_names[feat] if feat < len(feature_names) else feat}"
                f" {'==' if tree.decision_type[idx] == 1 else '<='}"
                f" {tree.threshold[idx]:g}"
            )
            if "split_gain" in show_info:
                label += f"\\ngain: {tree.split_gain[idx]:g}"
            if "internal_value" in show_info:
                label += f"\\nvalue: {tree.internal_value[idx]:g}"
            if "internal_count" in show_info:
                label += f"\\ncount: {tree.internal_count[idx]}"
            graph.node(name_, label=label)
            add(tree.left_child[idx], name_, "yes")
            add(tree.right_child[idx], name_, "no")
        else:
            leaf = ~idx
            name_ = f"leaf{leaf}"
            label = f"leaf {leaf}: {tree.leaf_value[leaf]:g}"
            if "leaf_count" in show_info:
                label += f"\\ncount: {tree.leaf_count[leaf]}"
            graph.node(name_, label=label)
        if parent is not None:
            graph.edge(parent, name_, decision)

    add(0 if tree.num_leaves > 1 else -1)
    return graph


def plot_tree(booster, tree_index: int = 0, ax=None, figsize=None,
              show_info=None, **kwargs):
    """Render one tree with matplotlib via the graphviz digraph
    (plotting.py plot_tree)."""
    import matplotlib.image as mpimg
    import matplotlib.pyplot as plt

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize)
    graph = create_tree_digraph(booster, tree_index, show_info=show_info, **kwargs)
    import io

    try:
        s = graph.pipe(format="png")
        img = mpimg.imread(io.BytesIO(s))
        ax.imshow(img)
    except Exception as e:  # graphviz binary missing: text fallback
        Log.warning("graphviz rendering unavailable (%s); text fallback", e)
        booster_, tree = _tree_of(booster, tree_index)
        ax.text(0.5, 0.5, tree.to_string(), ha="center", va="center",
                family="monospace", fontsize=6)
    ax.axis("off")
    return ax
