"""Checkpoints of lightgbm_tpu_torch (ckpt/, ``train(checkpoint_*)``).

The port against itself: a run killed after a mid-run checkpoint and
resumed from it writes the model text of the run that never stopped,
byte for byte, for each variant whose state a resume must carry:

- fused L2 and binary with bagging and feature_fraction (the pending
  delta of the fused K = 1 chunk, the iteration-keyed draws);
- fused multiclass, K = 7;
- fused GOSS (keys folded with the iteration), past its warm-up;
- GOSS on the mask grower (the chained key), K = 3;
- bagging on the mask grower (the RandomState and a select kept across
  ``bagging_freq``), killed between two draws;
- DART (the drop stream, the tree weights);
- quantized training, whose rounding is keyed by the restored
  iteration;
- continued training (``init_model``) with bagging;
- the ``output_freq`` loop and early stopping's patience across a kill
  (``best_iteration`` and ``evals_result`` too), and a preemption.

Also the store's retention, corrupt tail and completion marker, and the
refusals (config, data, boosting type, validation sets, and a blob whose
out-of-core chunk schedule is not the run's), and a blob that carries a
``world_size``, which both packages' ``restore`` takes alike.

The port against the JAX package: ``config_fingerprint``,
``data_fingerprint`` and ``pack_trees`` of the same model text are
equal; a TrainState the JAX package's ``capture`` wrote resumes in the
port and the port's resumes in the JAX package (fused trainers, a
sampling-free configuration): the same split lines, predictions within
3e-3.
"""

import json
import os
import zlib

import numpy as np
import pytest
import torch

import jax
import jax._src.core

import lightgbm_tpu as lgb
from lightgbm_tpu.ckpt import state as jstate

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ckpt import (CheckpointManager, CheckpointMismatch, CheckpointStore,
                                     TrainState, capture, restore)
from lightgbm_tpu_torch.ckpt import state as tstate
from lightgbm_tpu_torch.config import Config


@pytest.fixture(scope="module", autouse=True)
def jax_trace_state_shim():
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    yield
    if not had:
        del jax.core.trace_state_clean


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path is many small ops: one intra-op thread keeps it
    fast beside the other test workers (no OpenMP barriers over busy
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=1500, f=6, seed=0, classes=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f))
    z = X[:, 0] - 0.7 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3] + 0.3 * rng.standard_normal(n)
    if classes:
        y = np.digitize(z, np.quantile(z, np.linspace(0, 1, classes + 1)[1:-1]))
    else:
        y = (z > 0).astype(np.float64)
    return X, y.astype(np.float64)


class Kill(Exception):
    pass


def _killer(at):
    """Raises at the first boundary past iteration ``at``, before the
    checkpoint manager (order 40) could save there: the work since the
    last checkpoint is lost, as in a crash."""
    def cb(env):
        if env.model.boosting.iter > at:
            raise Kill()
    cb.order = 35
    return cb


BASE = dict(num_leaves=15, learning_rate=0.2, min_data_in_leaf=10, verbose=-1)
# (params, rounds, checkpoint_freq, killed after iteration, env, data)
VARIANTS = {
    "fused_l2_bagging": (dict(objective="regression", bagging_fraction=0.7, bagging_freq=2,
                              feature_fraction=0.8), 8, 3, 4, {}, {}),
    "fused_binary_bagging": (dict(objective="binary", bagging_fraction=0.7, bagging_freq=3,
                                  feature_fraction=0.8), 8, 3, 4, {}, {}),
    "fused_multiclass_k7": (dict(objective="multiclass", num_class=7, num_leaves=7), 4, 2, 2,
                            {}, dict(classes=7, n=700)),
    "fused_goss": (dict(objective="binary", boosting="goss", learning_rate=0.5, top_rate=0.3,
                        other_rate=0.2), 7, 3, 4, {}, {}),
    "mask_goss_k3": (dict(objective="multiclass", num_class=3, boosting="goss",
                          learning_rate=0.5, num_leaves=7), 6, 3, 4, {}, dict(classes=3)),
    "mask_bagging": (dict(objective="regression", bagging_fraction=0.6, bagging_freq=3,
                          feature_fraction=0.7), 8, 2, 3, {"LIGHTGBM_TPU_PGROW": "0"}, {}),
    "dart": (dict(objective="binary", boosting="dart", drop_rate=0.4, drop_seed=7,
                  skip_drop=0.2), 8, 3, 4, {}, {}),
    "quantized": (dict(objective="binary", use_quantized_grad=True, quantized_grad_bits=4,
                       bagging_fraction=0.8, bagging_freq=1), 7, 3, 4, {}, {}),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_resume_is_byte_identical(name, tmp_path, monkeypatch):
    """Killed past iteration ``at``, its last checkpoint the last multiple
    of ``freq`` up to ``at``, and resumed in the same directory (the lost
    iterations trained again): the uninterrupted run's model text.  The
    quantized case pins that quantization's rounding, keyed by the global
    iteration, needs nothing restored beyond ``iter``."""
    params, rounds, freq, at, env, dkw = VARIANTS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    X, y = _data(**dkw)
    p = dict(BASE, **params)
    full = lgt.train(p, lgt.Dataset(X, label=y), rounds, device="cpu").model_to_string()
    d = str(tmp_path / "ck")
    with pytest.raises(Kill):
        lgt.train(p, lgt.Dataset(X, label=y), rounds, device="cpu", checkpoint_dir=d,
                  checkpoint_freq=freq, callbacks=[_killer(at)])
    assert max(CheckpointStore(d).steps()) == at // freq * freq
    resumed = lgt.train(p, lgt.Dataset(X, label=y), rounds, device="cpu", checkpoint_dir=d,
                        checkpoint_freq=freq)
    assert resumed.model_to_string() == full
    assert CheckpointStore(d).complete_step() == rounds


def test_init_model_resume(tmp_path):
    """Continued training from an initial model, with bagging, killed and
    resumed: the initial trees stay first, the draws keyed by the new
    run's own iterations."""
    X, y = _data()
    p = dict(BASE, objective="binary", bagging_fraction=0.7, bagging_freq=1)
    init = lgt.train(p, lgt.Dataset(X, label=y), 3, device="cpu")
    full = lgt.train(p, lgt.Dataset(X, label=y), 6, device="cpu", init_model=init)
    d = str(tmp_path / "ck")
    with pytest.raises(Kill):
        lgt.train(p, lgt.Dataset(X, label=y), 6, device="cpu", init_model=init,
                  checkpoint_dir=d, checkpoint_freq=2, callbacks=[_killer(2)])
    assert CheckpointStore(d).steps() == [2]
    res = lgt.train(p, lgt.Dataset(X, label=y), 6, device="cpu", init_model=init,
                    checkpoint_dir=d, checkpoint_freq=2)
    assert res.model_to_string() == full.model_to_string()
    assert res.current_iteration() == full.current_iteration() == 9


def test_early_stopping_patience_across_a_kill(tmp_path):
    """Early stopping on a validation set (the per-iteration loop): the
    callback's bests and the evaluation history come back, so the resumed
    run stops where the uninterrupted one stops."""
    X, y = _data(n=2000)
    Xv, yv = _data(n=600, seed=9)
    p = dict(BASE, objective="binary", learning_rate=0.6, num_leaves=31, min_data_in_leaf=2,
             metric="binary_logloss")

    def run(**kw):
        ev = {}
        ds = lgt.Dataset(X, label=y)
        b = lgt.train(p, ds, 40, valid_sets=[lgt.Dataset(Xv, label=yv, reference=ds)],
                      early_stopping_rounds=3, evals_result=ev, verbose_eval=False,
                      device="cpu", **kw)
        return b, ev

    full, ev_full = run()
    assert full.best_iteration < 30  # it stopped early
    d = str(tmp_path / "ck")
    at = full.best_iteration + 1  # in the patience window
    with pytest.raises(Kill):
        run(checkpoint_dir=d, checkpoint_freq=2, callbacks=[_killer(at)])
    assert max(CheckpointStore(d).steps()) == at // 2 * 2
    res, ev_res = run(checkpoint_dir=d, checkpoint_freq=2)
    assert res.best_iteration == full.best_iteration
    assert res.model_to_string() == full.model_to_string()
    assert ev_res == ev_full


def test_output_freq_chunks_and_preemption(tmp_path):
    """The output_freq loop's chunks end on checkpoint steps without
    changing the trees or best_iteration; a preemption flushes a
    checkpoint and returns, and the rerun finishes the same model."""
    X, y = _data()
    Xv, yv = _data(n=500, seed=3)
    p = dict(BASE, objective="binary", output_freq=4, metric="auc", bagging_fraction=0.8,
             bagging_freq=1)

    def run(rounds, **kw):
        ds = lgt.Dataset(X, label=y)
        return lgt.train(p, ds, rounds, valid_sets=[lgt.Dataset(Xv, label=yv, reference=ds)],
                         verbose_eval=False, device="cpu", **kw)

    full = run(10)
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, freq=3)

    def preempt(env):
        if env.model.boosting.iter >= 5:
            mgr.request_preemption()
    preempt.order = 35  # before the manager (40) at the same boundary
    cut = run(10, checkpoint_manager=mgr, callbacks=[preempt])
    assert mgr.preempted and cut.current_iteration() < 10
    assert CheckpointStore(d).complete_step() is None
    res = run(10, checkpoint_dir=d, checkpoint_freq=3)
    assert res.model_to_string() == full.model_to_string()
    assert res.best_iteration == full.best_iteration


def test_store_retention_corrupt_tail_and_completion(tmp_path):
    X, y = _data()
    p = dict(BASE, objective="binary")
    d = str(tmp_path / "ck")
    b = lgt.train(p, lgt.Dataset(X, label=y), 6, device="cpu", checkpoint_dir=d,
                  checkpoint_freq=1, checkpoint_keep=2)
    store = CheckpointStore(d, keep_last=2)
    assert store.steps() == [5, 6]
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == [
        "ckpt_00000005.npz", "ckpt_00000006.npz"]
    assert store.complete_step() == 6
    # a completed run does not resume; "force" does
    again = lgt.Booster(params=dict(p), train_set=lgt.Dataset(X, label=y), device="cpu")
    assert CheckpointManager(d).try_restore(again) is None
    st = CheckpointManager(d).try_restore(again, ignore_complete=True)
    assert st.iteration == 6 and again.model_to_string() == b.model_to_string()
    # a torn tail checkpoint is skipped for the one before it
    with open(store.path_for(6), "r+b") as f:
        f.seek(100)
        f.write(b"\0" * 64)
    step, blob = store.latest_valid()
    assert step == 5 and zlib.crc32(blob) & 0xFFFFFFFF == store.read_manifest()["entries"][
        "ckpt_00000005.npz"]["crc32"]
    # a new save voids the completion marker
    store.save(7, b"x")
    assert store.complete_step() is None and store.steps() == [6, 7]
    with pytest.raises(lgt.LightGBMError, match="No valid checkpoint"):
        CheckpointManager(str(tmp_path / "empty")).try_restore(again, require=True)


def _state(p, X, y, rounds=2):
    b = lgt.train(p, lgt.Dataset(X, label=y), rounds, device="cpu")
    return capture(b)


@pytest.mark.parametrize("what", ["config", "data", "boosting", "valid", "world_size",
                                  "ooc_schedule", "format"])
def test_restore_refusals(what):
    X, y = _data()
    p = dict(BASE, objective="binary")
    st = TrainState.from_bytes(_state(p, X, y).to_bytes())
    q, Xq = dict(p), X
    if what == "config":
        q["lambda_l2"] = 1.0
    elif what == "data":
        Xq = X.copy()
        Xq[0, 0] += 10.0
    elif what == "boosting":
        st.meta["boosting_type"] = "dart"
    elif what == "world_size":
        st.meta["world_size"] = 4
    elif what == "ooc_schedule":
        st.meta["ooc_schedule"] = "grid/4x100"
    elif what == "format":
        st.meta["format_version"] = 2
        with pytest.raises(ValueError, match="format_version"):
            TrainState.from_bytes(st.to_bytes())
        return
    ds = lgt.Dataset(Xq, label=y)
    b = lgt.Booster(params=dict(q), train_set=ds, device="cpu")
    if what == "valid":
        b.add_valid(lgt.Dataset(X[:100], label=y[:100], reference=ds), "v")
    if what == "world_size":
        # a world_size key refuses nothing in the JAX package's restore (the
        # manager slices a canonical container first): both packages restore it
        jb = lgb.Booster(params=dict(q), train_set=lgb.Dataset(Xq, label=y))
        jst = jstate.restore(jb, jstate.TrainState.from_bytes(st.to_bytes()))
        assert restore(b, st).iteration == jst.iteration == 2
        assert len(b.boosting.models) == len(jb.boosting.models)
        np.testing.assert_array_equal(b.boosting.scores.cpu().numpy(),
                                      np.asarray(jb.boosting.scores))
        return
    match = {"config": "different training config", "data": "different dataset",
             "boosting": "boosting type", "valid": "valid sets",
             "ooc_schedule": "chunk schedule"}[what]
    with pytest.raises(CheckpointMismatch, match=match):
        restore(b, st)


def test_pack_trees_round_trip_linear():
    """Linear trees pack and unpack field for field (and their model text
    with them)."""
    X, y = _data()
    b = lgt.train(dict(BASE, objective="regression", linear_tree=True), lgt.Dataset(X, label=y),
                  3, device="cpu")
    models = b.boosting.models
    arrays = tstate.pack_trees(models)
    assert "tree_leaf_coeff" in arrays
    back = tstate.unpack_trees(arrays)
    assert [t.to_string() for t in back] == [t.to_string() for t in models]


# ----------------------------------------------------------------------
# against the JAX package
# ----------------------------------------------------------------------
def _pgrow_force(monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_PGROW", "force")


def test_fingerprints_equal_across_packages():
    X, y = _data()
    params = dict(BASE, objective="binary", bagging_fraction=0.7, bagging_freq=2, max_bin=63)
    assert (tstate.config_fingerprint(Config.from_params(dict(params)))
            == jstate.config_fingerprint(lgb.config.Config.from_params(dict(params))))
    tds = lgt.Dataset(X, label=y, params=params).construct()
    jds = lgb.Dataset(X, label=y, params=params).construct()
    assert tstate.data_fingerprint(tds) == jstate.data_fingerprint(jds)
    assert tstate.data_fingerprint_parts(tds) == jstate.data_fingerprint_parts(jds)
    # the booster's config (after its init) fingerprints alike too
    tb = lgt.Booster(params=dict(params), train_set=lgt.Dataset(X, label=y), device="cpu")
    jb = lgb.Booster(params=dict(params), train_set=lgb.Dataset(X, label=y))
    assert (tstate.config_fingerprint(tb.boosting.config)
            == jstate.config_fingerprint(jb.boosting.config))


def test_pack_trees_equal_across_packages():
    X, y = _data(classes=3)
    b = lgt.train(dict(BASE, objective="multiclass", num_class=3), lgt.Dataset(X, label=y), 3,
                  device="cpu")
    text = b.model_to_string()
    tp = tstate.pack_trees(lgt.Booster(model_str=text, device="cpu").boosting.models)
    jp = jstate.pack_trees(lgb.Booster(model_str=text).boosting.models)
    assert sorted(tp) == sorted(jp)
    for k in tp:
        assert tp[k].dtype == jp[k].dtype and np.array_equal(tp[k], jp[k]), k


def _split_lines(text):
    keys = ("split_feature=", "threshold=", "decision_type=", "left_child=", "right_child=")
    return [ln for ln in text.splitlines() if ln.startswith(keys)]


CROSS = dict(objective="binary", num_leaves=15, learning_rate=0.2, min_data_in_leaf=20,
             max_bin=63, verbose=-1)


def test_jax_checkpoint_resumes_in_port(tmp_path, monkeypatch):
    _pgrow_force(monkeypatch)
    X, y = _data()
    d = str(tmp_path / "ck")
    lgb.train(dict(CROSS), lgb.Dataset(X, label=y), 3, checkpoint_dir=d, checkpoint_freq=3)
    jfull = lgb.train(dict(CROSS), lgb.Dataset(X, label=y), 6)
    res = lgt.train(dict(CROSS), lgt.Dataset(X, label=y), 6, device="cpu", checkpoint_dir=d,
                    checkpoint_freq=3, checkpoint_resume="force")
    assert res.current_iteration() == 6
    assert _split_lines(res.model_to_string()) == _split_lines(jfull.model_to_string())
    np.testing.assert_allclose(res.predict(X), jfull.predict(X), atol=3e-3)


def test_port_checkpoint_resumes_in_jax(tmp_path, monkeypatch):
    _pgrow_force(monkeypatch)
    X, y = _data()
    d = str(tmp_path / "ck")
    lgt.train(dict(CROSS), lgt.Dataset(X, label=y), 3, device="cpu", checkpoint_dir=d,
              checkpoint_freq=3)
    with open(os.path.join(d, "MANIFEST.json")) as f:
        assert json.load(f)["complete_step"] == 3
    tfull = lgt.train(dict(CROSS), lgt.Dataset(X, label=y), 6, device="cpu")
    res = lgb.train(dict(CROSS), lgb.Dataset(X, label=y), 6, checkpoint_dir=d, checkpoint_freq=3,
                    checkpoint_resume="force")
    assert res.current_iteration() == 6
    assert _split_lines(res.model_to_string()) == _split_lines(tfull.model_to_string())
    np.testing.assert_allclose(res.predict(X), tfull.predict(X), atol=3e-3)
