"""Lambdarank, query groups and the ranking metrics of lightgbm_tpu_torch
against the JAX package's.

Both packages get the same seeded numpy inputs.  Held:

- ``LambdarankNDCG.get_gradients`` against the JAX one within rtol
  1e-5 / atol 1e-6 (the pair terms' exp: XLA's float32 against the
  port's correctly rounded one; the row sums in another order), on
  queries of one document, of equal labels and of many documents, on
  random and on all-tied scores (the first iteration), with and without
  weights; the bucketed computation against one bucket within the same
  tolerance, and the buckets within their budget;
- ``ndcg@k`` and ``map@k`` against the JAX ``eval`` within 1e-9;
- ``Dataset(group=...)`` and ``set_group`` against the JAX Metadata's
  query boundaries, and the fatal check of their sum;
- a 5-iteration lambdarank model on the mask grower against the JAX
  package's: the same split lines (or a first differing split that is a
  near-tie, gains within 1e-3 relative), predictions within rtol 3e-3 /
  atol 3e-4, and the ``evals_result`` of ``ndcg@1,3,5`` within 1e-6;
- each package loads the other's lambdarank model and predicts within
  1e-5 relative.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax._src.core
import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMeta
from lightgbm_tpu.metric import create_metric as jmetric
from lightgbm_tpu.objective import create_objective as jcreate
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata as TMeta
from lightgbm_tpu_torch.metric import create_metric as tmetric
from lightgbm_tpu_torch.objective import create_objective as tcreate
from lightgbm_tpu_torch.objective import rank as trank

ROUNDS = 5


@pytest.fixture(scope="module", autouse=True)
def jax_mask_grower():
    """LIGHTGBM_TPU_PGROW=0 for both packages (ranking runs on the mask
    grower in both anyway), and jax 0.9's ``trace_state_clean`` shim."""
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    old = os.environ.get("LIGHTGBM_TPU_PGROW")
    os.environ["LIGHTGBM_TPU_PGROW"] = "0"
    yield
    if old is None:
        del os.environ["LIGHTGBM_TPU_PGROW"]
    else:
        os.environ["LIGHTGBM_TPU_PGROW"] = old
    if not had:
        del jax.core.trace_state_clean


def _queries(seed=3, n_queries=60):
    """Query sizes (a one-document query, one of equal labels, the rest
    2-39 documents), features, 0-4 labels and per-row weights."""
    rng = np.random.default_rng(seed)
    sizes = np.concatenate([[1, 5, 7], rng.integers(2, 40, n_queries)])
    n = int(sizes.sum())
    X = rng.standard_normal((n, 5)).astype(np.float32)
    label = np.clip(np.round(X[:, 0] + 0.7 * rng.standard_normal(n) + 1), 0, 4)
    label = label.astype(np.float32)
    label[1:6] = 2.0  # the second query: all labels equal
    weight = (rng.random(n) + 0.5).astype(np.float32)
    return sizes, X, label, weight


def _bound(create, Config, Meta, params, sizes, label, weight=None):
    obj = create(Config.from_params(params))
    md = Meta(len(label))
    md.set_label(label)
    md.set_weights(weight)
    md.set_query(sizes)
    obj.init(md, len(label))
    return obj


def _pair(sizes, label, weight=None, **params):
    params = dict(params, objective="lambdarank")
    return (_bound(jcreate, JConfig, JMeta, params, sizes, label, weight),
            _bound(tcreate, TConfig, TMeta, params, sizes, label, weight))


# ----------------------------------------------------------------------
# gradients
# ----------------------------------------------------------------------
@pytest.mark.parametrize("scores", ["random", "tied"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_lambdarank_gradients_match_jax(scores, weighted):
    sizes, _, label, weight = _queries()
    jobj, tobj = _pair(sizes, label, weight if weighted else None, sigmoid=1.5)
    n = len(label)
    score = (np.random.default_rng(9).standard_normal(n).astype(np.float32)
             if scores == "random" else np.zeros(n, np.float32))
    jg, jh = (np.asarray(v) for v in jobj.get_gradients(jnp.asarray(score)))
    tg, th = (v.numpy() for v in tobj.get_gradients(torch.from_numpy(score)))
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-6)
    # a one-document query and a query of equal labels have no pairs
    np.testing.assert_array_equal(tg[:6], 0.0)
    np.testing.assert_array_equal(th[:6], 0.0)
    assert np.abs(tg).max() > 0


def test_buckets_match_one_bucket():
    sizes, _, label, _ = _queries(seed=4, n_queries=120)
    _, tobj = _pair(sizes, label)
    score = torch.from_numpy(np.random.default_rng(2).standard_normal(len(label))
                             .astype(np.float32))
    tobj.pair_budget = 1 << 40
    g1, h1 = tobj.get_gradients(score)
    assert len(tobj._state("cpu")[0]) == 1
    tobj.pair_budget = 3000
    g2, h2 = tobj.get_gradients(score)
    buckets = tobj._state("cpu")[0]
    assert len(buckets) > 10
    for b in buckets:
        q, s = b.valid.shape
        assert q * s * s <= 3000 or q == 1
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h2.numpy(), h1.numpy(), rtol=1e-5, atol=1e-6)


def test_pad_queries_matches_jax():
    from lightgbm_tpu.objective.rank import pad_queries as jpad

    sizes, _, _, _ = _queries()
    qb = np.concatenate([[0], np.cumsum(sizes)])
    jdoc, jvalid, _ = jpad(qb)
    doc, valid = trank.pad_queries(qb[:-1], sizes)
    np.testing.assert_array_equal(doc, jdoc)
    np.testing.assert_array_equal(valid, jvalid)


def test_size_buckets_cover_every_query_once():
    sizes = np.random.default_rng(1).integers(1, 900, 500)
    buckets = trank.size_buckets(sizes, 1 << 20)
    got = np.sort(np.concatenate(buckets))
    np.testing.assert_array_equal(got, np.arange(len(sizes)))
    for b in buckets:
        assert len(b) * int(sizes[b].max()) ** 2 <= 1 << 20 or len(b) == 1


def test_lambdarank_needs_query_information():
    obj = tcreate(TConfig.from_params({"objective": "lambdarank"}))
    md = TMeta(4)
    md.set_label([0, 1, 0, 1])
    with pytest.raises(LightGBMError, match="query information"):
        obj.init(md, 4)


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["ndcg", "map", "lambdarank", "mean_average_precision"])
def test_rank_metrics_match_jax(name):
    sizes, _, label, _ = _queries(seed=5)
    label[6:13] = 0.0  # the third query: no relevant document
    n = len(label)
    params = {"ndcg_eval_at": [1, 3, 5, 10]}
    out = []
    for create, Config, Meta in ((jmetric, JConfig, JMeta), (tmetric, TConfig, TMeta)):
        m = create(name, Config.from_params(params))
        md = Meta(n)
        md.set_label(label)
        md.set_query(sizes)
        m.init(md, n)
        out.append(m)
    score = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    want = out[0].eval(score.astype(np.float64))
    got = out[1].eval(torch.from_numpy(score))
    assert [k for k, _ in got] == [k for k, _ in want]
    assert [k for k, _ in got][0].endswith("@1") and len(got) == 4
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=0, atol=1e-9)
    assert out[1].bigger_is_better


# ----------------------------------------------------------------------
# query groups
# ----------------------------------------------------------------------
def test_dataset_group_matches_jax():
    sizes, X, label, _ = _queries()
    jd = lgb.Dataset(X, label=label, group=sizes).construct()
    td = lgt.Dataset(X, label=label, group=sizes).construct()
    np.testing.assert_array_equal(td.metadata.query_boundaries, jd.metadata.query_boundaries)
    assert td.metadata.num_queries == jd.metadata.num_queries == len(sizes)
    assert td.metadata.query_weights is None
    # set_group before and after construction
    ds = lgt.Dataset(X, label=label).set_group(sizes)
    np.testing.assert_array_equal(ds.get_group(), sizes)
    built = ds.construct()
    np.testing.assert_array_equal(built.metadata.query_boundaries,
                                  jd.metadata.query_boundaries)
    ds.set_group([len(label)])
    np.testing.assert_array_equal(built.metadata.query_boundaries, [0, len(label)])
    with pytest.raises(LightGBMError, match="Sum of query counts"):
        ds.set_group([1, 2])


# ----------------------------------------------------------------------
# models
# ----------------------------------------------------------------------
PARAMS = dict(objective="lambdarank", num_leaves=7, learning_rate=0.1, max_bin=31,
              min_data_in_leaf=5, verbose=-1, metric="ndcg", ndcg_eval_at=[1, 3, 5])


def _model_splits(text):
    """[(tree, split index, feature, threshold, gain), ...] in order."""
    out = []
    for i, blk in enumerate(text.split("Tree=")[1:]):
        kv = dict(line.split("=", 1) for line in blk.splitlines()[1:] if "=" in line)
        if "split_feature" not in kv:
            continue
        for s, (f, t, g) in enumerate(zip(kv["split_feature"].split(),
                                          kv["threshold"].split(),
                                          kv["split_gain"].split())):
            out.append((i, s, int(f), t, float(g)))
    return out


@pytest.fixture(scope="module")
def rank_models():
    sizes, X, label, _ = _queries()
    vsizes, vX, vlabel, _ = _queries(seed=8, n_queries=30)
    out = []
    for mod, kw in ((lgb, {}), (lgt, {"device": "cpu"})):
        tr = mod.Dataset(X, label=label, group=sizes)
        va = mod.Dataset(vX, label=vlabel, group=vsizes, reference=tr)
        er = {}
        b = mod.train(PARAMS, tr, ROUNDS, valid_sets=[va], valid_names=["valid"],
                      evals_result=er, verbose_eval=False, **kw)
        out.append((b, er))
    return X, out


def test_lambdarank_model_matches_jax(rank_models):
    X, ((jb, jer), (tb, ter)) = rank_models
    assert jb.boosting.ptrainer is None and tb.boosting.ptrainer is None
    ja, ta = _model_splits(jb.model_to_string()), _model_splits(tb.model_to_string())
    assert len(ja) == len(ta) and len(ta) > 0
    first = next((k for k, (a, b) in enumerate(zip(ja, ta)) if a[:4] != b[:4]), None)
    if first is not None:
        ga, gb = ja[first][4], ta[first][4]
        assert abs(ga - gb) <= 1e-3 * max(abs(ga), abs(gb)), (first, ja[first], ta[first])
    else:
        np.testing.assert_allclose(tb.predict(X), np.asarray(jb.predict(X)), rtol=3e-3,
                                   atol=3e-4)
    assert "objective=lambdarank" in tb.model_to_string().splitlines()


def test_lambdarank_evals_result_matches_jax(rank_models):
    _, ((_, jer), (_, ter)) = rank_models
    assert list(ter["valid"]) == ["ndcg@1", "ndcg@3", "ndcg@5"] == list(jer["valid"])
    for k in ter["valid"]:
        assert len(ter["valid"][k]) == ROUNDS
        np.testing.assert_allclose(ter["valid"][k], jer["valid"][k], rtol=0, atol=1e-6)


def test_lambdarank_models_load_across_packages(rank_models, tmp_path):
    X, ((jb, _), (tb, _)) = rank_models
    jb.save_model(str(tmp_path / "jax.txt"))
    tb.save_model(str(tmp_path / "port.txt"))
    in_port = lgt.Booster(model_file=str(tmp_path / "jax.txt"), device="cpu")
    in_jax = lgb.Booster(model_file=str(tmp_path / "port.txt"))
    assert in_port.objective.name == "lambdarank"
    np.testing.assert_allclose(in_port.predict(X), np.asarray(jb.predict(X)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(in_jax.predict(X)), tb.predict(X), rtol=1e-5,
                               atol=1e-6)
