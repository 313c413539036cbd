"""The port's shard plans and straggler rebalancing (lightgbm_tpu_torch/
parallel/shardplan.py, boosting/gbdt.py ``_init_rebalance`` /
``_maybe_rebalance`` / ``_apply_rebalance``) against the JAX package's
parallel/shardplan.py on the CPU.

- the cases of the JAX package's tests/test_rebalance.py, each run
  through both packages' functions on the same inputs: ``ShardPlan``,
  ``_largest_remainder``, ``_apply_floor``, ``snap_to_groups`` and the
  ``RebalanceController`` policy (patience, a quiet fleet, a transient
  spike, a stale heartbeat, determinism, whole query groups);
- the row wire pinned to the JAX package's bytes, its round trip and its
  refusals;
- ``exchange_rows`` over port ``LocalComm`` rank threads moves the rows
  the JAX function moves over the JAX ``LocalComm``;
- two rank processes (the port's CLI, ``device=cpu``) with
  ``rebalance=true`` and a collective delay on rank 0 move rows off rank
  0, and the quantized model is the one the same ranks train without
  rebalancing; ``report merge`` shows the move;
- ``rebalance=true`` in one process warns and trains the same model.
"""

import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from lightgbm_tpu.parallel import LocalGroup as JLocalGroup
from lightgbm_tpu.parallel import shardplan as jsp

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.parallel import LocalGroup
from lightgbm_tpu_torch.parallel import shardplan as tsp
from lightgbm_tpu_torch.utils.log import Log

REPO = Path(__file__).resolve().parents[1]
JOIN_S = 120


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------------
# ShardPlan and the integer helpers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mod", [tsp, jsp], ids=["port", "jax"])
def test_shard_plan_ranges(mod):
    p = mod.ShardPlan.from_counts([300, 500, 200])
    assert p.world == 3 and p.total == 1000
    assert p.starts == (0, 300, 800)
    assert [p.rank_range(r) for r in range(3)] == [(0, 300), (300, 800), (800, 1000)]


@pytest.mark.parametrize("counts", [(), (100, -1)])
def test_shard_plan_rejects_bad_counts(counts):
    for mod in (tsp, jsp):
        with pytest.raises(ValueError):
            mod.ShardPlan(counts)


@pytest.mark.parametrize("shares,total", [([333.4, 333.3, 333.3], 1000), ([0.5, 0.5], 7),
                                          ([10.9, 0.1], 11), ([2.5, 2.5, 2.5, 2.5], 10)])
def test_largest_remainder_equals_jax(shares, total):
    out = tsp._largest_remainder(shares, total)
    assert out == jsp._largest_remainder(shares, total)
    assert sum(out) == total and all(c >= 0 for c in out)


@pytest.mark.parametrize("counts,floor,total", [([0, 990, 10], 32, 1000),
                                                ([5, 5, 990], 50, 1000), ([600, 600], 32, 1200)])
def test_apply_floor_equals_jax(counts, floor, total):
    out = tsp._apply_floor(counts, floor, total)
    assert out == jsp._apply_floor(counts, floor, total)
    assert sum(out) == total and all(c >= min(floor, total // len(counts)) for c in out)


@pytest.mark.parametrize("targets,gb", [
    ([28], [0, 10, 30, 60, 100]), ([45, 80], [0, 10, 30, 60, 100]),
    ([20], [0, 10, 30, 60, 100]), ([29, 31], [0, 10, 30, 60, 100]),
    ([40, 70], [0, 50, 100])])
def test_snap_to_groups_equals_jax(targets, gb):
    gb = np.array(gb, np.int64)
    assert tsp.snap_to_groups(targets, gb) == jsp.snap_to_groups(targets, gb)


def test_snap_to_groups_cases():
    gb = np.array([0, 10, 30, 60, 100], np.int64)
    assert tsp.snap_to_groups([28], gb) == (30,)
    assert tsp.snap_to_groups([20], gb) == (10,)  # a tie goes to the lower boundary
    assert tsp.snap_to_groups([29, 31], gb) == (30, 60)  # a collision moves on
    assert tsp.snap_to_groups([40, 70], np.array([0, 50, 100], np.int64)) is None


# ----------------------------------------------------------------------
# the controller's policy, step for step against the JAX controller
# ----------------------------------------------------------------------
def _run(mod, kw, counts, steps):
    """Feed both packages' controllers the same table: the plans each
    step returned (counts or None)."""
    if "group_bounds" in kw:
        kw = dict(kw, group_bounds=np.array(kw["group_bounds"], np.int64))
    ctl = mod.RebalanceController(**kw)
    plan = mod.ShardPlan.from_counts(counts)
    out = []
    for compute, ages in steps:
        p = ctl.observe(plan, compute, ages)
        out.append(None if p is None else p.counts)
    return out


CASES = {
    "patience": (dict(threshold=1.5, patience=3, max_move_frac=0.25), [600, 600],
                 [([4.0, 1.0], None)] * 5),
    "quiet": (dict(threshold=1.5, patience=3, max_move_frac=0.25), [512, 512],
              [([1.0, 1.1], None)] * 10),
    "transient": (dict(threshold=1.5, patience=3, max_move_frac=0.25), [512, 512],
                  [([4.0, 1.0], None)] + [([1.0, 1.0], None)] * 8),
    "stale": (dict(threshold=1.5, patience=3, max_move_frac=0.25, stale_s=10.0), [600, 600],
              [([4.0, 1.0], [0.1, 20.0])] * 6),
    "three": (dict(threshold=1.5, patience=3, max_move_frac=0.25), [700, 500, 600],
              [([3.0, 1.0, 1.2], None)] * 6),
    "groups": (dict(threshold=1.2, patience=1, max_move_frac=0.5,
                    group_bounds=[0, 40, 80, 130, 180, 256]), [128, 128],
               [([3.0, 1.0], None)] * 4),
    "floor": (dict(threshold=1.1, patience=1, max_move_frac=1.0), [40, 40, 40],
              [([50.0, 1.0, 1.0], None)] * 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_controller_equals_jax(case):
    kw, counts, steps = CASES[case]
    ours = _run(tsp, kw, counts, steps)
    assert ours == _run(jsp, kw, counts, steps)
    assert ours == _run(tsp, kw, counts, steps)  # deterministic: ranks agree with no round
    fired = [p for p in ours if p is not None]
    if case in ("quiet", "transient", "stale"):
        assert not fired  # no move for a calm fleet, a blip, or a rank that may be dying
    else:
        assert fired and all(sum(p) == sum(counts) for p in fired)
    if case == "patience":
        assert ours[:2] == [None, None] and ours[2] is not None
        assert ours[2][0] < 600 < ours[2][1] and 600 - ours[2][0] <= 300  # max_move_frac
    if case == "groups":
        assert fired[0][0] in (40, 80, 130, 180) and fired[0][0] < fired[0][1]


# ----------------------------------------------------------------------
# the row wire
# ----------------------------------------------------------------------
def _wire_example():
    return {
        (5, 9): {"bins": np.arange(8, dtype=np.int8).reshape(4, 2),
                 "label": np.array([0.0, 1.0, 1.0, 0.0], np.float32)},
        (20, 22): {"bins": np.array([[7, 7]], np.int8).repeat(2, 0),
                   "label": np.array([1.0, 0.5], np.float32)},
    }


# the JAX package's pinned frame of _wire_example() (tests/test_rebalance.py)
_WIRE_PIN = (
    "5242310002000000050000000000000009000000000000000200000004000300"
    "000262696e737c69310400000000000000020000000000000008000000000000"
    "009f68aa8800010203040506070500030000016c6162656c3c66340400000000"
    "0000001000000000000000d876f7c6000000000000803f0000803f0000000014"
    "0000000000000016000000000000000200000004000300000262696e737c6931"
    "02000000000000000200000000000000040000000000000044f2f96807070707"
    "0500030000016c6162656c3c663402000000000000000800000000000000dbc9"
    "85ee0000803f0000003f"
)


def test_row_wire_pins_the_jax_bytes():
    blob = tsp._pack_row_wire(_wire_example())
    assert blob.hex() == _WIRE_PIN
    assert blob == jsp._pack_row_wire(_wire_example())


@pytest.mark.parametrize("unpack", [tsp._unpack_row_wire, jsp._unpack_row_wire],
                         ids=["port", "jax"])
def test_row_wire_roundtrip_across_packages(unpack):
    out = _wire_example()
    back = unpack(tsp._pack_row_wire(out))
    assert set(back) == set(out)
    for span, blocks in out.items():
        for name, arr in blocks.items():
            got = back[span][name]
            assert got.dtype == arr.dtype and got.shape == arr.shape
            assert got.tobytes() == arr.tobytes()


def test_row_wire_rejects_corruption():
    blob = tsp._pack_row_wire(_wire_example())
    with pytest.raises(ValueError, match="bad magic"):
        tsp._unpack_row_wire(b"XX" + blob[2:])
    flipped = bytearray(blob)
    flipped[-1] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        tsp._unpack_row_wire(bytes(flipped))
    with pytest.raises(ValueError, match="CRC|length"):
        tsp._unpack_row_wire(blob[:-1])


# ----------------------------------------------------------------------
# exchange_rows over rank threads, both packages
# ----------------------------------------------------------------------
def _threads(n, work, group):
    out, errs = [None] * n, []

    def run(r):
        try:
            out[r] = work(r)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errs.append(e)
            group.barrier.abort()

    ts = [threading.Thread(target=run, args=(r,), daemon=True) for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(JOIN_S)
        assert not t.is_alive(), "a rank thread did not finish in time"
    if errs:
        raise errs[0]
    return out


@pytest.mark.parametrize("old,new", [([300, 300], [150, 450]), ([100, 200, 300], [250, 250, 100]),
                                     ([200, 200, 200], [200, 200, 200]), ([10, 590], [590, 10])])
def test_exchange_rows_equals_jax(old, new):
    rng = np.random.default_rng(5)
    total = sum(old)
    binned = rng.integers(0, 255, size=(total, 6)).astype(np.uint8)
    label = rng.random(total).astype(np.float32)
    scores = rng.standard_normal((2, total)).astype(np.float32)
    starts = np.concatenate(([0], np.cumsum(old)))

    def blocks(r):
        s, e = starts[r], starts[r + 1]
        return {"binned": (binned[s:e], 0), "label": (label[s:e], 0),
                "scores": (scores[:, s:e], 1)}

    def run(mod, group_cls):
        group = group_cls(len(old))
        comms = group.comms()
        return _threads(len(old), lambda r: mod.exchange_rows(
            mod.ShardPlan.from_counts(old), mod.ShardPlan.from_counts(new), r, blocks(r),
            comm=comms[r]), group)

    ours = run(tsp, LocalGroup)
    theirs = run(jsp, JLocalGroup)
    nstart = np.concatenate(([0], np.cumsum(new)))
    for r in range(len(old)):
        s, e = nstart[r], nstart[r + 1]
        for name in ("binned", "label", "scores"):
            assert ours[r][name].tobytes() == theirs[r][name].tobytes(), (r, name)
        np.testing.assert_array_equal(ours[r]["binned"], binned[s:e])
        np.testing.assert_array_equal(ours[r]["scores"], scores[:, s:e])


def test_exchange_rows_refuses_a_plan_mismatch():
    with pytest.raises(ValueError, match="plan mismatch"):
        tsp.exchange_rows(tsp.ShardPlan((5, 5)), tsp.ShardPlan((4, 4, 2)), 0,
                          {"x": (np.zeros(5), 0)})


# ----------------------------------------------------------------------
# one process: the key warns and changes nothing
# ----------------------------------------------------------------------
def test_rebalance_in_one_process_warns_and_skips(capsys, monkeypatch):
    monkeypatch.setattr(Log, "_level", 1)
    rng = np.random.RandomState(3)
    X = rng.randint(0, 8, size=(400, 5)).astype(np.float32)
    y = (X[:, 0] > 3).astype(np.float32)
    p = dict(objective="binary", num_leaves=7, min_data_in_leaf=20, verbose=0)
    base = lgt.train(dict(p), lgt.Dataset(X, label=y), 3, device="cpu")
    assert base.boosting._rebalance is None
    capsys.readouterr()
    p2 = dict(p, rebalance=True)
    b = lgt.train(dict(p2), lgt.Dataset(X, label=y), 3, device="cpu")
    assert "rebalance=true ignored" in capsys.readouterr().out
    assert b.boosting._rebalance is None and b.num_trees == 3
    assert b.model_to_string().split("parameters:")[0] == \
        base.model_to_string().split("parameters:")[0]


# ----------------------------------------------------------------------
# two rank processes with a slow rank 0
# ----------------------------------------------------------------------
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _shards(d, n=512):
    """Integer-valued rows (the bins of any slice are the same), split in
    two binary caches with the whole data's bins."""
    from lightgbm_tpu_torch.factory.member_worker import make_data

    X, y = make_data(n, 10, 5)
    full = lgt.Dataset(X, label=y, params={"max_bin": 31})
    for r, (lo, hi) in enumerate([(0, n // 2), (n // 2, n)]):
        lgt.Dataset(X[lo:hi], label=y[lo:hi], reference=full).save_binary(str(d / f"s{r}.bin"))


def _ranks(d, tag, extra=(), env_extra=None, rounds=12):
    port = _free_port()
    procs = []
    for r in range(2):
        env = {k: v for k, v in os.environ.items() if not k.startswith("LIGHTGBM_TPU_")}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   LIGHTGBM_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   LIGHTGBM_TPU_NUM_PROCESSES="2", LIGHTGBM_TPU_PROCESS_ID=str(r),
                   LIGHTGBM_TPU_TRACE=str(d / f"{tag}.trace{r}.jsonl"))
        env.update((env_extra or {}).get(r, {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "lightgbm_tpu_torch", "task=train", f"data={d / f's{r}.bin'}",
             f"output_model={d / f'{tag}.model{r}.txt'}", "objective=binary",
             "tree_learner=data", "num_machines=2", "pre_partition=true", "num_leaves=7",
             "learning_rate=0.2", "min_data_in_leaf=20", "quantized_training=true",
             f"num_iterations={rounds}", "network_timeout=30", "device=cpu", "verbose=1",
             *extra], cwd=str(d), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = [p.communicate(timeout=JOIN_S)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [(d / f"{tag}.model{r}.txt").read_text() for r in range(2)], logs


@pytest.mark.faultinject
def test_two_processes_move_rows_off_a_slow_rank(tmp_path):
    """Rank 0 sleeps 40 ms at every collective from its 5th on: the
    controller moves rows to rank 1, both ranks keep the same model, and
    that model is the one they train with no rebalancing (quantized folds
    are exact sums, wherever the rows live)."""
    from lightgbm_tpu_torch.obs import report

    _shards(tmp_path)
    slow = {0: {"LIGHTGBM_TPU_FAULT": "delay:40:after:5", "LIGHTGBM_TPU_FAULT_RANK": "0"}}
    moved, logs = _ranks(tmp_path, "rb", ("rebalance=true", "rebalance_patience=3",
                                          "rebalance_max_move_frac=0.25"), slow)
    still, _ = _ranks(tmp_path, "static")
    assert moved[0] == moved[1] == still[0] == still[1]
    m = report.merge_summary(report.load_rank_traces(
        [str(tmp_path / f"rb.trace{r}.jsonl") for r in range(2)]))
    reb = m.get("rebalance")
    assert reb, logs[0][-3000:]
    assert reb[0]["rows_before"] == [256, 256]
    after = reb[-1]["rows_after"]
    assert sum(after) == 512 and after[0] < 256 < after[1]
    assert "Rebalanced shards at iteration" in logs[0]
    events = [json.loads(ln) for ln in (tmp_path / "rb.trace1.jsonl").read_text().splitlines()]
    assert any(e.get("name") == "rebalance.move_rows" for e in events)
