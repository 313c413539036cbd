"""The port's model front ends (pmml.py, plotting.py, convert_model.py)
against the JAX package's on one model text, loaded into each package:
the PMML strings, the graphviz source of a tree, the bars and labels of
``plot_importance``, the lines of ``plot_metric`` and the C++ of
``model_to_cpp`` must be equal.  matplotlib runs on its Agg backend."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
from lightgbm_tpu import plotting as jplotting  # noqa: E402
from lightgbm_tpu.convert_model import model_to_cpp as jmodel_to_cpp  # noqa: E402
from lightgbm_tpu.pmml import model_to_pmml as jmodel_to_pmml  # noqa: E402

import lightgbm_tpu_torch as lgt  # noqa: E402
from lightgbm_tpu_torch import plotting  # noqa: E402
from lightgbm_tpu_torch.convert_model import model_to_cpp  # noqa: E402
from lightgbm_tpu_torch.pmml import model_to_pmml, pmml_from_model_file  # noqa: E402


@pytest.fixture(scope="module")
def models():
    """(port booster, JAX booster, evals_result) of one model text: binary,
    a categorical feature, a missing value, 5 iterations of 7 leaves."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((800, 5))
    X[:, 2] = rng.integers(0, 4, 800)
    X[rng.random(800) < 0.05, 0] = np.nan
    y = ((X[:, 1] + (X[:, 2] == 1)) > 0.3).astype(np.float32)
    params = dict(objective="binary", num_leaves=7, max_bin=31, min_data_in_leaf=10,
                  metric="auc", verbose=-1)
    ds = lgt.Dataset(X, label=y, categorical_feature=[2],
                     feature_name=["a", "b", "cat", "d", "e"])
    res = {}
    bst = lgt.train(params, ds, 5, valid_sets=[ds.create_valid(X[:300], label=y[:300])],
                    evals_result=res, verbose_eval=False, device="cpu")
    text = bst.model_to_string()
    assert "decision_type=" in text and " 1" in text.split("decision_type=")[1].split("\n")[0]
    return (lgt.Booster(model_str=text, device="cpu"), lgb.Booster(model_str=text), res, text)


def test_pmml_equal(models, tmp_path):
    port, jax, _, text = models
    got = model_to_pmml(port)
    assert got == jmodel_to_pmml(jax)
    assert 'operator="equal"' in got and 'operator="lessOrEqual"' in got
    (tmp_path / "m.txt").write_text(text)
    assert pmml_from_model_file(str(tmp_path / "m.txt"), str(tmp_path / "m.pmml"),
                                device="cpu") == got
    assert (tmp_path / "m.pmml").read_text() == got


def test_convert_model_equal(models):
    port, jax, _, _ = models
    assert model_to_cpp(port.boosting) == jmodel_to_cpp(jax.boosting)
    assert model_to_cpp(port.boosting, num_iteration=2) == jmodel_to_cpp(jax.boosting, 2)


@pytest.mark.parametrize("show_info", [None, ["split_gain", "internal_value",
                                              "internal_count", "leaf_count"]])
@pytest.mark.parametrize("tree_index", [0, 3])
def test_tree_digraph_equal(models, tree_index, show_info):
    port, jax, _, _ = models
    kw = dict(tree_index=tree_index, show_info=show_info, name="t")
    assert plotting.create_tree_digraph(port, **kw).source == \
        jplotting.create_tree_digraph(jax, **kw).source
    with pytest.raises(IndexError):
        plotting.create_tree_digraph(port, tree_index=99)


def _bars(ax):
    return ([p.get_width() for p in ax.patches],
            [t.get_text() for t in ax.get_yticklabels()],
            [t.get_text() for t in ax.texts])


@pytest.mark.parametrize("kw", [{}, {"importance_type": "gain", "max_num_features": 3}])
def test_plot_importance_equal(models, kw):
    port, jax, _, _ = models
    got = _bars(plotting.plot_importance(port, **kw))
    want = _bars(jplotting.plot_importance(jax, **kw))
    plt.close("all")
    assert got == want and len(got[0]) > 0


def test_plot_metric_and_tree(models):
    port, jax, res, _ = models
    ax = plotting.plot_metric(res, metric="auc")
    jax_ax = jplotting.plot_metric(res, metric="auc")
    assert [tuple(ln.get_ydata()) for ln in ax.lines] == \
        [tuple(ln.get_ydata()) for ln in jax_ax.lines]
    assert ax.get_ylabel() == "auc"
    ax = plotting.plot_tree(port, tree_index=1)
    assert not ax.axison
    plt.close("all")
    with pytest.raises(TypeError):
        plotting.plot_importance(object())


def test_import_needs_no_plotting_packages():
    """plotting imports matplotlib and graphviz only inside its functions."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.plotting, "
            "lightgbm_tpu_torch.pmml, lightgbm_tpu_torch.convert_model; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('matplotlib', 'graphviz')]; "
            "assert not bad, bad; print('ok')")
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=str(repo), capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(repo)))
    assert out.returncode == 0, out.stderr
