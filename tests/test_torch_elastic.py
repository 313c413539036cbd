"""Live elastic membership end to end on the CPU: fleets of the port's
member worker (``python -m lightgbm_tpu_torch.factory.member_worker``,
``MEMBER_DEVICE=cpu``), each member a process of its own coordinating
through a shared fleet directory, at the JAX package's worker size (600
rows, 10 features, 12 trees).

- a fleet that loses member 1 to SIGTERM (a clean leave), member 2 to
  SIGKILL (an eviction) and gains a joiner finishes with a model
  byte-identical to a fleet of one on the same global rows;
- so does a fleet whose coordinator (member 0) is SIGKILLed, member 1
  re-elected;
- the fleet of one's model against the JAX package trained in this
  process with the same parameters (``Booster`` + ``update()``): float,
  every tree's splits equal (or a near-tie first) and predictions within
  3e-3; quantized binary, the first tree equal, as far as the two agree
  (quantization keys its rounding on each gradient's bits, and XLA's
  float32 ``exp`` is an ulp from the port's on some rows);
- the JAX package's slow churn matrix (a float fleet, rebalancing with a
  leave, two joiners, a fleet shrinking to one), marked slow as there.

At most four member processes run at a time.  The JAX package's own
fleet worker cannot start under jax 0.9 (its compile watch), so no JAX
process is spawned.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

pytestmark = [pytest.mark.membership, pytest.mark.faultinject]


def _spawn(member, fleet_dir, out, extra=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("LIGHTGBM_TPU_", "MEMBER_"))}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MEMBER_DEVICE="cpu",
               LIGHTGBM_TPU_NET_TIMEOUT="8")
    env.update(extra or {})
    return subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch.factory.member_worker", str(member),
         fleet_dir, out], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _run_fleet(fleet_dir, nproc, per_member=None, joiners=0, joiner_env=None, timeout=240):
    """A bootstrap fleet and ``joiners`` mid-run arrivals; waits for every
    process: {key: (rc, output)}."""
    os.makedirs(fleet_dir, exist_ok=True)
    out = os.path.join(fleet_dir, "out")
    procs = {}
    for m in range(nproc):
        procs[m] = _spawn(m, fleet_dir, out,
                          dict({"MEMBER_NPROC": str(nproc)}, **(per_member or {}).get(m, {})))
    for j in range(joiners):
        if j:
            time.sleep(2.0)
        procs[f"join{j}"] = _spawn("join", fleet_dir, out,
                                   dict(joiner_env or {}, MEMBER_NPROC=str(nproc)))
    deadline = time.monotonic() + timeout
    results = {}
    for key, p in procs.items():
        try:
            o, _ = p.communicate(timeout=max(1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            o, _ = p.communicate()
            o = (o or "") + "\n<<killed at the test's time limit>>"
        results[key] = (p.returncode, o or "")
    return out, results


def _meta(out, mid):
    return json.loads(Path(f"{out}.m{mid}.json").read_text())


def _model(out, mid):
    return Path(f"{out}.m{mid}.txt").read_text()


def _dump(results):
    return "\n".join(f"--- member {k} rc={rc} ---\n{o[-2500:]}" for k, (rc, o) in results.items())


def _member_ids(fleet_dir, suffix):
    return sorted(int(f.split(".m")[1].split(".")[0]) for f in os.listdir(fleet_dir)
                  if f.startswith("out.m") and f.endswith(suffix))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One member holding all the global rows.  Quantized training's
    rounding depends only on the tree's index and each value's bits, so
    any static world, and any elastic run that keeps the state exactly,
    trains these bytes."""
    d = str(tmp_path_factory.mktemp("member_ref"))
    out, results = _run_fleet(d, 1)
    assert results[0][0] == 0, _dump(results)
    return _model(out, 0), _meta(out, 0)


def test_fleet_churn_one_run_byte_identity(reference, tmp_path):
    """Three members: member 1 SIGTERMs itself at iteration 2 (the signal
    handler, a clean leave), member 2 is SIGKILLed at iteration 5 (an
    eviction), a joiner arrives mid-run; the two finishers train the
    reference's bytes, and no iteration is lost."""
    ref_model, ref_meta = reference
    per = {0: {"MEMBER_ITER_SLEEP": "0.4"},  # paces the fleet: the joiner lands mid-run
           1: {"MEMBER_SIGTERM_ITER": "2"},
           2: {"MEMBER_KILL_ITER": "5"}}
    out, results = _run_fleet(str(tmp_path), 3, per_member=per, joiners=1)
    assert results[0][0] == 0 and results[1][0] == 0, _dump(results)  # a leave exits 0
    assert results[2][0] == -signal.SIGKILL, _dump(results)
    assert results["join0"][0] == 0, _dump(results)
    assert _meta(out, 1)["left_at_epoch"] >= 1
    assert not os.path.exists(out + ".m1.txt")  # a leaver writes no model
    joiner = max(_member_ids(str(tmp_path), ".json"))
    assert joiner >= 3  # a fresh, monotonic id
    for mid in (0, joiner):
        meta = _meta(out, mid)
        assert meta["trees"] == 12 and meta["iters"] == 12, meta
        assert meta["final_members"] == sorted(meta["final_members"])
        assert 1 not in meta["final_members"] and 2 not in meta["final_members"]
        assert joiner in meta["final_members"]
        assert sum(meta["final_counts"]) == 600
        assert meta["device"] == "cpu"
        assert _model(out, mid) == ref_model, f"member {mid} diverged from the reference"
    survivor = _meta(out, 0)
    assert len(survivor["epochs_seen"]) == 12  # every round trained once
    assert len(survivor["resize_pauses"]) == survivor["final_epoch"] >= 2
    assert ref_meta["final_members"] == [0] and ref_meta["resize_pauses"] == []


def test_fleet_coordinator_sigkill_reelection(reference, tmp_path):
    """Member 0 is the coordinator; SIGKILLed at iteration 4, member 1 is
    re-elected, the epoch moves on, and both survivors train the
    reference's bytes."""
    ref_model, _ = reference
    out, results = _run_fleet(str(tmp_path), 3, per_member={0: {"MEMBER_KILL_ITER": "4"}})
    assert results[0][0] == -signal.SIGKILL, _dump(results)
    for mid in (1, 2):
        assert results[mid][0] == 0, _dump(results)
        meta = _meta(out, mid)
        assert meta["final_members"] == [1, 2] and meta["final_epoch"] >= 1
        assert meta["trees"] == 12
        assert _model(out, mid) == ref_model
    assert not os.path.exists(out + ".m0.txt")


def _trees(text):
    """Each tree's {key: values} of its split and leaf lines."""
    out = []
    for block in text.split("Tree=")[1:]:
        rec = {}
        for ln in block.splitlines():
            key, _, val = ln.partition("=")
            if key in ("split_feature", "threshold", "left_child", "right_child", "split_gain",
                       "leaf_value", "decision_type"):
                rec[key] = val.split()
        out.append(rec)
    return out


def _same_or_near_tie(a, b):
    """One tree's splits equal, or their first difference a near-tie
    (gains within 1e-3 relative): the packages' float histograms differ
    in the sixth digit, so two candidates that close may swap."""
    keys = ("split_feature", "threshold", "left_child", "right_child", "decision_type")
    if all(a.get(k) == b.get(k) for k in keys):
        return True
    n = min(len(a["split_gain"]), len(b["split_gain"]))
    first = next(i for i in range(n) if any(a[k][i] != b[k][i] for k in keys[:2]))
    ga, gb = float(a["split_gain"][first]), float(b["split_gain"][first])
    return abs(ga - gb) <= 1e-3 * max(abs(ga), abs(gb))


def _jax_model(p, X, y, rounds=12):
    """The JAX package's ``Booster`` + ``update()`` in this process (its
    elastic key warns and is ignored: no runtime)."""
    import jax
    import jax._src.core

    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    try:
        import lightgbm_tpu as lgb

        bst = lgb.Booster(params=dict(p), train_set=lgb.Dataset(X, label=y, params=dict(p)))
        while bst.current_iteration() < rounds:
            bst.update()
        return bst.model_to_string(), bst.predict(X)
    finally:
        if not had:
            del jax.core.trace_state_clean


MEMBER_PARAMS = dict(objective="binary", tree_learner="data", pre_partition=True,
                     elastic_membership=True, num_leaves=7, learning_rate=0.2, max_bin=31,
                     min_data_in_leaf=20, boost_from_average=False, seed=7, verbose=-1)


@pytest.mark.parametrize("quantized", [True, False], ids=["quantized", "float"])
def test_fleet_of_one_matches_the_jax_package_in_process(reference, tmp_path, quantized):
    """The fleet of one against the JAX package on the worker's rows and
    parameters, trained in this process.  Float: every tree's splits
    equal (or a near-tie first) and predictions within 3e-3.  Quantized:
    the first tree is the JAX package's, split for split and leaf for
    leaf; from the second on the trees part, because quantization keys
    its rounding on each gradient's bits and the port's float32 ``exp``
    is an ulp from XLA's on some rows (the same divergence as the port's
    serial grower against the JAX package's)."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.factory.member_worker import make_data

    X, y = make_data(600, 10, 5)
    if quantized:
        ours = reference[0]
    else:
        out, results = _run_fleet(str(tmp_path), 1, per_member={0: {"MEMBER_QUANTIZED": "0"}})
        assert results[0][0] == 0, _dump(results)
        ours = _model(out, 0)
    jtext, jpred = _jax_model(dict(MEMBER_PARAMS, quantized_training=quantized), X, y)
    assert ours.split("Tree=0")[0].splitlines()[:8] == jtext.split("Tree=0")[0].splitlines()[:8]
    mine, theirs = _trees(ours), _trees(jtext)
    assert len(mine) == len(theirs) == 12
    if quantized:
        gains = [np.asarray(t[0].pop("split_gain"), np.float64) for t in (mine, theirs)]
        assert mine[0] == theirs[0]
        np.testing.assert_allclose(gains[0], gains[1], rtol=1e-5)  # float32 sums' last digit
        return
    assert all(_same_or_near_tie(a, b) for a, b in zip(mine, theirs))
    np.testing.assert_allclose(lgt.Booster(model_str=ours, device="cpu").predict(X),
                               jpred, atol=3e-3)


@pytest.mark.slow
@pytest.mark.parametrize("scenario", ["float_churn", "rebalance_churn", "double_join",
                                      "shrink_to_one"])
def test_fleet_churn_matrix(scenario, tmp_path):
    per, nproc, joiners, joiner_env, expect = {}, 3, 0, {}, None
    if scenario == "float_churn":
        # float32 gradients: a resize changes the merge order, so the
        # fleet is held to its survival and roster, not to bytes
        per = {0: {"MEMBER_QUANTIZED": "0", "MEMBER_ITER_SLEEP": "0.4"},
               1: {"MEMBER_QUANTIZED": "0", "MEMBER_SIGTERM_ITER": "2"},
               2: {"MEMBER_QUANTIZED": "0", "MEMBER_KILL_ITER": "5"}}
        joiner_env = {"MEMBER_QUANTIZED": "0"}
        joiners = 1
    elif scenario == "rebalance_churn":
        per = {m: {"MEMBER_REBALANCE": "1"} for m in range(3)}
        per[1]["MEMBER_LEAVE_ITER"] = "3"
        expect = [0, 2]
    elif scenario == "double_join":
        nproc, joiners = 2, 2
        per = {0: {"MEMBER_ITER_SLEEP": "0.5"}}
    elif scenario == "shrink_to_one":
        per = {1: {"MEMBER_LEAVE_ITER": "1"}, 2: {"MEMBER_LEAVE_ITER": "3"}}
        expect = [0]
    out, results = _run_fleet(str(tmp_path), nproc, per_member=per, joiners=joiners,
                              joiner_env=joiner_env, timeout=300)
    finishers = _member_ids(str(tmp_path), ".txt")
    assert finishers, _dump(results)
    metas = {mid: _meta(out, mid) for mid in finishers}
    rosters = {tuple(m["final_members"]) for m in metas.values()}
    assert len(rosters) == 1, (rosters, _dump(results))
    for meta in metas.values():
        assert meta["trees"] == 12 and sum(meta["final_counts"]) == 600, _dump(results)
    assert len({_model(out, mid) for mid in finishers}) == 1, _dump(results)
    if expect is not None:
        assert finishers == expect, _dump(results)
    if scenario == "double_join":
        assert len(next(iter(rosters))) == 4, _dump(results)
    if scenario == "shrink_to_one":
        assert next(iter(rosters)) == (0,), _dump(results)
