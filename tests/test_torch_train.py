"""The port's training slice against the JAX package's fused trainer.

Both packages train on the same seeded numpy data: the JAX package with
LIGHTGBM_TPU_PGROW=force (the partitioned trainer, its Pallas kernels in
interpret mode on the CPU), the port on ``device="cpu"`` (the kernels'
plain PyTorch versions).  Binary logloss and weighted L2, 7 and 31 leaves.

- split features and thresholds in the model text: identical;
- predictions: rtol 3e-3 / atol 3e-4 (tests/test_pgrow.py:441 — the
  interpret-mode histograms are bf16 3-term sums, the port's exact f32);
- the port's level grower on and off: byte-identical model text;
- a JAX-written model loaded into the port predicts within 1e-6 of JAX.

EFB-bundled binary data is held to the same split structure and
predictions.  The features the port does not take yet raise
NotImplementedError, naming themselves; bagging with GOSS, DART with
linear trees and an initial model of another feature count raise the
reference's own errors.  (Multiclass has its own file,
tests/test_torch_multiclass.py; sampling and validation have
tests/test_torch_sampling.py and tests/test_torch_valid.py.)
"""

import os

import numpy as np
import pytest

import jax
import jax._src.core

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.convert import booster_from_model_string

ROUNDS = 4
CASES = [("binary", 7), ("binary", 31), ("l2_weighted", 7), ("l2_weighted", 31)]
IDS = [f"{o}-{L}" for o, L in CASES]


@pytest.fixture(scope="module", autouse=True)
def jax_trace_state_shim():
    """jax 0.9 moved ``trace_state_clean`` out of ``jax.core``, where the
    JAX package's compile watch imports it from; put it back for the
    duration of this module."""
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    yield
    if not had:
        del jax.core.trace_state_clean


def _data(objective):
    if objective == "binary":
        rng = np.random.default_rng(0)
        X = rng.standard_normal((3000, 8)).astype(np.float32)
        w = rng.standard_normal(8)
        y = (rng.random(3000) < 1 / (1 + np.exp(-(X @ w)))).astype(np.float32)
        return X, y, None
    rng = np.random.default_rng(1)
    X = rng.standard_normal((2000, 6)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.1 * rng.standard_normal(2000)).astype(np.float32)
    return X, y, (rng.random(2000) + 0.5).astype(np.float32)


def _params(objective, leaves):
    return dict(objective="binary" if objective == "binary" else "regression",
                num_leaves=leaves, learning_rate=0.2, max_bin=31, min_data_in_leaf=20,
                verbose=-1)


def _with_env(name, value, fn):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        return fn()
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


@pytest.fixture(scope="module")
def trained():
    """{case: (X, jax booster, port booster, port booster, level grower off)},
    each case trained once for the module."""
    cache = {}

    def get(case):
        if case not in cache:
            objective, leaves = case
            X, y, w = _data(objective)
            params = _params(objective, leaves)
            jb = _with_env("LIGHTGBM_TPU_PGROW", "force", lambda: lgb.train(
                params, lgb.Dataset(X, label=y, weight=w), num_boost_round=ROUNDS))
            assert jb.boosting.ptrainer is not None, "the JAX reference left the fused path"
            tb = lgt.train(params, lgt.Dataset(X, label=y, weight=w), ROUNDS, device="cpu")
            tb0 = _with_env("LIGHTGBM_TPU_LEVELGROW", "0", lambda: lgt.train(
                params, lgt.Dataset(X, label=y, weight=w), ROUNDS, device="cpu"))
            cache[case] = (X, jb, tb, tb0)
        return cache[case]

    return get


def _split_lines(text):
    return [line for line in text.splitlines()
            if line.startswith(("Tree=", "num_leaves=", "split_feature=", "threshold=",
                                "decision_type=", "left_child=", "right_child="))]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_structure_matches_jax(trained, case):
    _, jb, tb, _ = trained(case)
    assert _split_lines(tb.model_to_string()) == _split_lines(jb.model_to_string())
    assert tb.num_trees == jb.num_trees


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_model_header_matches_jax(trained, case):
    _, jb, tb, _ = trained(case)
    head = [t.model_to_string().split("Tree=0")[0] for t in (jb, tb)]
    assert head[1] == head[0]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_predictions_match_jax(trained, case):
    X, jb, tb, _ = trained(case)
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=3e-3, atol=3e-4)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_level_grower_on_off_byte_identical(trained, case):
    _, _, tb, tb0 = trained(case)
    assert tb.boosting.ptrainer.params.levelwise
    assert not tb0.boosting.ptrainer.params.levelwise
    assert tb0.model_to_string() == tb.model_to_string()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_jax_model_loads_into_port(trained, case):
    X, jb, _, _ = trained(case)
    loaded = booster_from_model_string(jb.model_to_string(), device="cpu")
    np.testing.assert_allclose(loaded.predict(X), jb.predict(X), rtol=1e-6, atol=1e-6)
    # the text round-trips; feature_infos is written from a training set
    # only, by both packages
    def lines(text):
        return [ln for ln in text.splitlines() if not ln.startswith("feature_infos=")]

    assert lines(loaded.model_to_string()) == lines(jb.model_to_string())


DECLINED = [
    # DART trains (tests/test_torch_dart.py); with linear trees it is declined
    ("boosting=dart", dict(boosting="dart", linear_tree=True), {}),
    ("Cannot use bagging in GOSS", dict(boosting="goss", bagging_fraction=0.5, bagging_freq=1),
     {}),
    # parallel learners train over several processes (tests/test_torch_distributed.py);
    # out-of-core data-parallel training over two ranks (threads here) is refused
    ("tree_learner=data", dict(tree_learner="data", num_machines=2, out_of_core=True),
     dict(ranks=2)),
    # out-of-core training runs (tests/test_torch_ooc.py); with DART forced
    # it is refused
    ("out-of-core training", dict(out_of_core=True, boosting="dart"), {}),
    # checkpoints train (tests/test_torch_ckpt.py); resume="force" with an
    # empty checkpoint directory is refused
    ("checkpoint_dir", {}, dict(checkpoint_dir="checkpoint_dir", checkpoint_resume="force")),
    # continued training runs (tests/test_torch_api.py); an initial model of
    # another feature count is refused
    ("init_model", {}, dict(init_model="narrow")),
]
# the reference's own errors (goss.py:38, config.py's linear_tree checks,
# engine.py's schema guard); the rest are not ported yet
RAISES = {"Cannot use bagging in GOSS": LightGBMError, "boosting=dart": LightGBMError,
          "init_model": LightGBMError, "checkpoint_dir": LightGBMError,
          "out-of-core training": LightGBMError}


@pytest.mark.parametrize("what,params,kwargs", DECLINED, ids=[d[0] for d in DECLINED])
def test_declined_feature_raises(what, params, kwargs):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((500, 4))
    y = rng.integers(0, 3, 500).astype(np.float32)
    if params.get("objective") != "multiclass":
        y = (y > 0).astype(np.float32)
    ds = lgt.Dataset(X, label=y)
    if kwargs.get("init_model") == "narrow":
        kwargs = dict(init_model=lgt.train(dict(objective="binary", verbose=-1),
                                           lgt.Dataset(X[:, :3], label=y), 2, device="cpu"))
    if kwargs.get("ranks"):
        _raises_in_every_rank(kwargs["ranks"], RAISES.get(what, NotImplementedError), what,
                              lambda: lgt.train(dict(dict(objective="binary", verbose=-1),
                                                     **params), lgt.Dataset(X, label=y), 2,
                                                device="cpu"))
        return
    with pytest.raises(RAISES.get(what, NotImplementedError), match=what):
        lgt.train(dict(dict(objective="binary", verbose=-1), **params), ds, 2, device="cpu",
                  **kwargs)


def _raises_in_every_rank(nproc, exc, match, fn):
    """``fn`` on ``nproc`` LocalComm rank threads (parallel/comm.py
    rank_thread) must raise ``exc`` matching ``match`` in every rank."""
    import re
    import threading

    from lightgbm_tpu_torch.parallel import LocalGroup
    from lightgbm_tpu_torch.parallel.comm import rank_thread

    group = LocalGroup(nproc)
    errs = [None] * nproc

    def run(r, comm):
        with rank_thread(comm):
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - checked below
                errs[r] = e
                group.barrier.abort()

    ts = [threading.Thread(target=run, args=(r, c), daemon=True)
          for r, c in enumerate(group.comms())]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    for e in errs:
        assert isinstance(e, exc) and re.search(match, str(e)), repr(e)


def test_efb_bundles_raise():
    """Mutually exclusive sparse columns bundle under EFB.  The first
    slice declined them (hence the name); now the port trains the bundle
    matrix, and its binary model matches the JAX fused trainer's: the
    same split lines and header, predictions within 3e-3 / 3e-4."""
    rng = np.random.default_rng(4)
    cat = rng.integers(0, 12, 2000)
    X = np.zeros((2000, 14))
    X[np.arange(2000), cat] = rng.random(2000) + 1.0
    X[:, 12:] = rng.standard_normal((2000, 2))
    y = ((cat < 6) ^ (X[:, 12] > 0.8)).astype(np.float32)
    params = dict(objective="binary", num_leaves=15, learning_rate=0.2, max_bin=31,
                  min_data_in_leaf=20, verbose=-1)
    jb = _with_env("LIGHTGBM_TPU_PGROW", "force", lambda: lgb.train(
        params, lgb.Dataset(X, label=y), num_boost_round=ROUNDS))
    assert jb.boosting.ptrainer is not None and jb.boosting.ptrainer.bmeta is not None
    tb = lgt.train(params, lgt.Dataset(X, label=y), ROUNDS, device="cpu")
    pt = tb.boosting.ptrainer
    assert pt.bmeta is not None and pt.params.num_cols < X.shape[1]
    jt, tt = jb.model_to_string(), tb.model_to_string()
    assert _split_lines(tt) == _split_lines(jt)
    assert tt.split("Tree=0")[0] == jt.split("Tree=0")[0]
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), rtol=3e-3, atol=3e-4)
