"""Training over several processes (lightgbm_tpu_torch/parallel/
distributed.py, collect.py, net.py, comm.py ``NetComm``) on the CPU, with
real rank processes on 127.0.0.1 and ``device=cpu``.

A rank is this file run as a script (``python test_torch_distributed.py
worker <spec.json>``, ``lgt.train`` on its shard) or the port's CLI
(``python -m lightgbm_tpu_torch task=train ...``).  Two ranks as a rule,
one case of three ranks with unequal shards; a few thousand rows and a few
rounds.  JAX workers cannot run in a subprocess under jax 0.9, so the
processes' results are held against references in this process:

- each mode over 2 processes equals the port's run over ``LocalComm``
  rank threads (parallel/comm.py ``rank_thread``) on the ranks' own bins
  (each rank's ``save_binary``), byte for byte, ledgers equal; feature
  mode equals the port's serial model and voting (2k >= F) data mode;
- data and voting equal the JAX package's ``HostParallelLearner`` over
  its ``LocalComm`` on the same shards (split lines and predictions
  within 3e-3, ledgers equal: NetComm sends the JAX package's bytes);
  quantized data equals it byte for byte;
- the distributed find-bin's mappers equal the JAX one-process mappers,
  the merged sketch banks a one-process bank of all rows, and the global
  label average the mean of all labels;
- ``report merge --json`` equals the JAX ``merge_summary`` of the same
  two traces.

Faults (after the JAX package's tests/test_net_fault.py, a network
timeout of a few seconds): a peer killed mid-allgather makes the survivor
exit 75 within 2 x timeout + 10 s; a bootstrap with no peer is loud and
bounded; a kill in the checkpoint barrier flushes, exits, and the rerun
resumes to the uninterrupted model; a wedged peer makes its partner exit
74; the coordinator's death is bounded; a world-2 checkpoint resumes at
world 1 and at world 2.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
THIS = Path(__file__).resolve()
TIMEOUT = 5.0  # network_timeout of every fault case, seconds
BOUND = 2 * TIMEOUT + 10.0  # a survivor's exit after a peer's death
CALM = 30.0  # network_timeout of the runs that inject no fault (a loaded host)
JOIN_S = 120

PARAMS = dict(objective="regression", num_leaves=15, learning_rate=0.2, max_bin=31,
              min_data_in_leaf=5, min_sum_hessian_in_leaf=1.0, verbose=-1,
              boost_from_average=False, num_machines=2, pre_partition=True, top_k=4,
              network_timeout=CALM)
ROUNDS = 3


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _data(n=3000, f=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f)).round(3)
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 - X[:, 2] * X[:, 3]
         + 0.2 * rng.standard_normal(n)).astype(np.float32)
    return X, y


def _env(rank, nproc, port, extra=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LIGHTGBM_TPU_") and k not in ("XLA_FLAGS",)}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               LIGHTGBM_TPU_COORDINATOR=f"127.0.0.1:{port}",
               LIGHTGBM_TPU_NUM_PROCESSES=str(nproc), LIGHTGBM_TPU_PROCESS_ID=str(rank))
    env.update(extra or {})
    return env


def _spawn_workers(spec, nproc, extra=None):
    """Start ``nproc`` worker ranks of ``spec`` (written beside its
    ``out``); returns the processes."""
    port = _free_port()
    path = spec["out"] + ".spec.json"
    Path(path).write_text(json.dumps(spec))
    return [subprocess.Popen([sys.executable, str(THIS), "worker", path], cwd=str(REPO),
                             env=_env(r, nproc, port, (extra or {}).get(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(nproc)]


def _wait(procs, timeout=JOIN_S):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def _run_workers(spec, nproc, extra=None):
    procs = _spawn_workers(spec, nproc, extra)
    logs = _wait(procs)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def _split_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("Tree=", "num_leaves=", "split_feature=", "threshold=",
                              "decision_type=", "left_child=", "right_child="))]


# ----------------------------------------------------------------------
# the rank threads of the port and of the JAX package, in this process
# ----------------------------------------------------------------------
def _threads(nproc, work):
    """``work(rank, comm)`` on a rank thread each of a LocalGroup; a rank
    that raises aborts the group's barrier and the error is raised."""
    from lightgbm_tpu_torch.parallel import LocalGroup

    group = LocalGroup(nproc)
    out, errs = [None] * nproc, []

    def run(r, c):
        try:
            out[r] = work(r, c)
        except BaseException as e:  # noqa: BLE001 - raised below
            errs.append(e)
            group.barrier.abort()

    ts = [threading.Thread(target=run, args=(r, c), daemon=True)
          for r, c in enumerate(group.comms())]
    for t in ts:
        t.start()
    for t in ts:
        t.join(JOIN_S)
    if errs:
        raise errs[0]
    assert not any(t.is_alive() for t in ts), "a rank thread hung"
    return out


def _port_rank_threads(params, bins, rounds):
    """The port's model texts and ledgers over LocalComm rank threads, each
    rank training on its saved shard."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.parallel.comm import rank_thread

    def work(r, comm):
        with rank_thread(comm):
            b = lgt.train(dict(params), lgt.Dataset(bins[r], params=dict(params)), rounds,
                          device="cpu")
            return b.model_to_string(), dict(comm.ledger)

    return _threads(len(bins), work)


def _jax_rank_threads(params, bins, rounds, mode):
    """The JAX package's boosters over its LocalComm rank threads: each
    rank's booster on the port's saved shard, its mask grower's learner the
    JAX ``HostParallelLearner`` of ``mode``."""
    import lightgbm_tpu as lgb
    from lightgbm_tpu.parallel import HostParallelLearner as JHost
    from lightgbm_tpu.parallel import LocalGroup as JGroup

    jp = {k: v for k, v in params.items()
          if k not in ("num_machines", "pre_partition", "network_timeout", "tree_learner")}
    group = JGroup(len(bins))
    out, errs = [None] * len(bins), []

    def run(r, comm):
        try:
            bst = lgb.Booster(params=dict(jp), train_set=lgb.Dataset(bins[r], params=dict(jp)))
            bst.boosting.learner = JHost(mode, comm, bst.boosting.grow_params)
            for _ in range(rounds):
                bst.update()
            out[r] = (bst, dict(comm.ledger))
        except BaseException as e:  # noqa: BLE001
            errs.append(e)
            group.barrier.abort()

    ts = [threading.Thread(target=run, args=(r, c), daemon=True)
          for r, c in enumerate(group.comms())]
    for t in ts:
        t.start()
    for t in ts:
        t.join(JOIN_S)
    if errs:
        raise errs[0]
    return out


@pytest.fixture(scope="module")
def jax_env():
    """The JAX package's mask grower (``LIGHTGBM_TPU_PGROW=0``) and the
    ``trace_state_clean`` shim jax 0.9 needs; one torch thread."""
    import jax
    import jax._src.core
    import torch

    old = os.environ.get("LIGHTGBM_TPU_PGROW")
    os.environ["LIGHTGBM_TPU_PGROW"] = "0"
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if not had:
        del jax.core.trace_state_clean
    if old is None:
        os.environ.pop("LIGHTGBM_TPU_PGROW", None)
    else:
        os.environ["LIGHTGBM_TPU_PGROW"] = old


MODES = {"data": dict(tree_learner="data"), "feature": dict(tree_learner="feature"),
         "voting": dict(tree_learner="voting"),
         "quantized": dict(tree_learner="data", quantized_training=True)}


@pytest.fixture(scope="module")
def mode_runs(tmp_path_factory):
    """Each mode over 2 worker processes on the halves of one dataset
    (feature mode: both ranks hold every row): {mode: (dir, params)}."""
    d = tmp_path_factory.mktemp("modes")
    X, y = _data()
    halves = np.array_split(np.arange(len(y)), 2)
    np.savez(d / "data.npz", X=X, y=y, **{f"idx{r}": h for r, h in enumerate(halves)})
    out, modes = {}, list(MODES.items())
    for pair in (modes[:2], modes[2:]):  # two runs at a time: the host runs other tests too
        procs = {}
        for mode, extra in pair:
            params = dict(PARAMS, **extra)
            spec = dict(task="train", data=str(d / "data.npz"), params=params, rounds=ROUNDS,
                        out=str(d / mode), replicate=(mode == "feature"), save_bins=True)
            procs[mode] = _spawn_workers(spec, 2)
            out[mode] = (d, params)
        for mode, ps in procs.items():
            logs = _wait(ps)
            for p, log in zip(ps, logs):
                assert p.returncode == 0, f"{mode}: {log[-3000:]}"
    return out


def _rank_results(d, mode, nproc=2):
    return [json.loads(Path(f"{d / mode}.rank{r}.json").read_text()) for r in range(nproc)]


@pytest.mark.parametrize("mode", list(MODES))
def test_processes_equal_rank_threads(mode_runs, mode):
    """Every rank writes the same model; it equals the port's LocalComm
    rank threads on the ranks' own bins byte for byte, rank by rank with
    equal ledgers."""
    import torch

    d, params = mode_runs[mode]
    res = _rank_results(d, mode)
    assert res[0]["model"] == res[1]["model"]
    assert res[0]["trees"] == ROUNDS
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = _port_rank_threads(params, [f"{d / mode}.rank{r}.bin" for r in range(2)], ROUNDS)
    finally:
        torch.set_num_threads(threads)
    for r in range(2):
        assert ref[r][0] == res[r]["model"]
        assert ref[r][1] == res[r]["ledger"]
    purposes = set(res[0]["ledger"])
    assert purposes == {"data": {"hist", "best_split"}, "feature": {"best_split"},
                        "voting": {"best_split", "vote", "elect", "hist"},
                        "quantized": {"hist_q", "best_split"}}[mode]


def test_feature_equals_serial_and_voting_equals_data(mode_runs, monkeypatch):
    """Feature mode equals the serial mask grower (whose split scan it
    shards by columns) on the same rows; voting (2k >= F) equals data."""
    import lightgbm_tpu_torch as lgt

    monkeypatch.setenv("LIGHTGBM_TPU_PGROW", "0")
    d, params = mode_runs["feature"]
    X, y = _data()
    serial = lgt.train(dict(params, tree_learner="serial", num_machines=1),
                       lgt.Dataset(X, label=y), ROUNDS, device="cpu").model_to_string()
    assert _rank_results(d, "feature")[0]["model"] == serial
    # voting with 2 top_k >= F elects every column: data mode's adds
    assert _rank_results(d, "voting")[0]["model"] == _rank_results(d, "data")[0]["model"]


@pytest.mark.parametrize("mode", ["data", "voting", "quantized"])
def test_processes_equal_jax_host_learner(mode_runs, mode, jax_env):
    """The JAX package's HostParallelLearner over its LocalComm on the same
    shards: the same ledgers (NetComm sends the JAX package's bytes), the
    same split lines and predictions within 3e-3; quantized, the same model
    text."""
    import lightgbm_tpu_torch as lgt

    d, params = mode_runs[mode]
    res = _rank_results(d, mode)
    jmode = "data" if mode == "quantized" else mode
    ref = _jax_rank_threads(params, [f"{d / mode}.rank{r}.bin" for r in range(2)], ROUNDS,
                            jmode)
    X, _ = _data()
    port = lgt.Booster(model_str=res[0]["model"], device="cpu")
    for r in range(2):
        assert ref[r][1] == res[r]["ledger"]
    jtext = ref[0][0].model_to_string()
    if mode == "quantized":
        assert jtext.split("feature importances:")[0] == res[0]["model"].split(
            "feature importances:")[0]
    else:
        assert _split_lines(jtext) == _split_lines(res[0]["model"])
    np.testing.assert_allclose(port.predict(X), ref[0][0].predict(X), rtol=3e-3, atol=3e-3)


def test_three_unequal_ranks_global_average_and_find_bin(tmp_path, jax_env):
    """Three ranks with unequal shards: boost_from_average starts from the
    mean of all labels, the quantized headroom counts all rows, and the
    model equals the rank threads'; the distributed find-bin (each rank its
    feature block, from the same rows) equals the JAX one-process mappers,
    and the merged sketch banks equal a one-process bank of all rows."""
    import pickle

    import torch

    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.data.stats import SketchCollector as JSketchCollector
    from lightgbm_tpu.io.dataset import BinnedDataset as JBinned

    X, y = _data(n=3300, f=13, seed=4)
    X[:, 3] = np.round(X[:, 3] * 2)  # a column of few values
    cuts = np.split(np.arange(len(y)), [900, 2600])
    np.savez(tmp_path / "data.npz", X=X, y=y, **{f"idx{r}": c for r, c in enumerate(cuts)})
    params = dict(PARAMS, tree_learner="data", num_machines=3, boost_from_average=True)
    spec = dict(task="train", data=str(tmp_path / "data.npz"), params=params, rounds=2,
                out=str(tmp_path / "three"), save_bins=True, binning=True)
    _run_workers(spec, 3)
    res = _rank_results(tmp_path, "three", 3)
    assert len({r["model"] for r in res}) == 1
    # GBDT::LabelAverage's Allreduce: the shards' (float32) label sums over all rows
    want = float(np.sum([np.float64(y[c].sum()) for c in cuts]) / len(y))
    for r in res:
        assert r["init_score"] == want
        assert r["init_score"] == pytest.approx(float(np.mean(y.astype(np.float64))), rel=1e-6)
        assert r["nproc"] == 3
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = _port_rank_threads(params, [f"{tmp_path / 'three'}.rank{r}.bin" for r in range(3)],
                                 2)
    finally:
        torch.set_num_threads(threads)
    assert [t for t, _ in ref] == [r["model"] for r in res]
    # the find-bin and sketch contracts (every rank held all rows there)
    with open(tmp_path / "three.binning.pkl", "rb") as fh:
        got = pickle.load(fh)
    jref = JBinned.from_raw(X, JConfig.from_params({"max_bin": 31, "verbose": -1}), label=y)
    assert len(got["states"]) == len(jref.bin_mappers)
    for sg, mr in zip(got["states"], jref.bin_mappers):
        sr = mr.state()
        assert set(sg) == set(sr)
        for k in sr:
            np.testing.assert_array_equal(np.asarray(sg[k]), np.asarray(sr[k]), err_msg=k)
    np.testing.assert_array_equal(got["binned"], jref.binned)
    np.testing.assert_array_equal(got["used"], jref.used_feature_map)
    whole = JSketchCollector(categorical={4}, cap=100_000)
    whole.update(_sketch_rows())
    assert got["banks"] == [_bank(sk) for sk in whole.sketches]
    assert got["rows_seen"] == whole.rows_seen


def _sketch_rows():
    rng = np.random.default_rng(17)
    X = rng.integers(-4, 9, size=(3000, 5)).astype(np.float64)
    X[rng.random((3000, 5)) < 0.05] = np.nan
    return X


def _bank(sk):
    vals, cnts = sk.to_distinct_counts()
    return (np.asarray(vals).tolist(), np.asarray(cnts).tolist(), int(sk.total_cnt),
            int(getattr(sk, "zero_cnt", -1)), int(getattr(sk, "nan_cnt", -1)))


def test_world_queries_and_collectives_in_rank_threads():
    """In a rank thread the world queries report its rank and world, and
    the collectives (a barrier, padded blob lists) run through its group;
    ``set_epoch`` scopes the gather uids to an epoch and a real change
    restarts their sequence."""
    from lightgbm_tpu_torch.parallel import collect, distributed, net
    from lightgbm_tpu_torch.parallel.comm import rank_thread

    def work(r, comm):
        with rank_thread(comm):
            assert distributed.is_multiprocess() and distributed.current_epoch() == 0
            assert distributed.ensure_initialized()
            collect.barrier()
            lists = collect.allgather_blob_lists([b"x" * (r + 1)] * (r + 1), list_len=3)
            return distributed.process_index(), distributed.process_count(), lists

    out = _threads(3, work)
    want = [[b"x", b"", b""], [b"xx", b"xx", b""], [b"xxx"] * 3]
    assert out == [(r, 3, want) for r in range(3)]
    assert distributed.process_count() == 1 and not distributed.is_multiprocess()
    try:
        collect.set_epoch(3)
        uid = net.epoch_uid(collect._kv_epoch, next(collect._kv_uid))
        assert net.uid_epoch(uid) == 3 and uid & ((1 << net.EPOCH_SHIFT) - 1) == 0
    finally:
        collect.set_epoch(0)


def test_lambdarank_pads_to_the_global_group_size():
    """Over several processes every rank pads its queries to the global
    largest group (GBDT sets ``pad_group_size`` from an allgather): a
    query's lambdas are then the same bits whatever other queries its
    rank holds, as one process's over all of them at that padding."""
    import torch

    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.objective import create_objective

    rng = np.random.default_rng(8)
    sizes = rng.integers(2, 40, 30)
    sizes[17] = 77  # the global largest group lives on the second "rank"
    label = rng.integers(0, 4, int(sizes.sum())).astype(np.float32)
    score = torch.from_numpy(rng.standard_normal(len(label)).astype(np.float32))
    cut = int(sizes[:12].sum())

    def grads(lo, hi, qs):
        md = Metadata(hi - lo)
        md.set_label(label[lo:hi])
        md.set_query(qs)
        md.pad_group_size = 77
        obj = create_objective(Config.from_params({"objective": "lambdarank"}))
        obj.init(md, hi - lo)
        return obj.get_gradients(score[lo:hi])

    g_all, h_all = grads(0, len(label), sizes)
    g_a, h_a = grads(0, cut, sizes[:12])
    g_b, h_b = grads(cut, len(label), sizes[12:])
    assert torch.equal(torch.cat([g_a, g_b]), g_all) and torch.equal(torch.cat([h_a, h_b]), h_all)


# ----------------------------------------------------------------------
# the canonical checkpoint layout against the JAX package's functions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("len2", [0, 1, 7, 4096, 123457])
def test_crc32_combine_equals_jax_and_zlib(len2):
    import zlib

    from lightgbm_tpu.ckpt import state as jstate

    from lightgbm_tpu_torch.ckpt import state as tstate

    rng = np.random.default_rng(len2)
    a, b = rng.bytes(333), rng.bytes(len2)
    got = tstate.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b))
    assert got == jstate.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) == zlib.crc32(a + b)


def _shard_states(tmp_path, nproc=2):
    """Each rank's TrainState of one 2-rank run over rank threads, after 2
    rounds with bagging and a validation set."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ckpt import capture
    from lightgbm_tpu_torch.parallel.comm import rank_thread

    X, y = _data(n=1600, f=6, seed=3)
    p = dict(PARAMS, tree_learner="data", num_machines=nproc, bagging_fraction=0.7,
             bagging_freq=1)
    cuts = np.array_split(np.arange(len(y)), nproc)

    def work(r, comm):
        with rank_thread(comm):
            ds = lgt.Dataset(X[cuts[r]], label=y[cuts[r]], params=dict(p))
            b = lgt.Booster(params=dict(p), train_set=ds, device="cpu")
            b.add_valid(lgt.Dataset(X[cuts[r]][:50], label=y[cuts[r]][:50], reference=ds), "v")
            for _ in range(2):
                b.update()
            return capture(b)

    return _threads(nproc, work)


def test_merge_and_reshard_equal_jax(tmp_path):
    """``combine_fingerprint_parts``, ``merge_to_canonical`` and
    ``reshard_to_local`` (same partition and another one) give the JAX
    package's states on the same rank states."""
    from lightgbm_tpu.ckpt import state as jstate

    from lightgbm_tpu_torch.ckpt import TrainState
    from lightgbm_tpu_torch.ckpt import state as tstate

    states = _shard_states(tmp_path)
    jstates = [jstate.TrainState.from_bytes(s.to_bytes()) for s in states]
    parts = [s.meta["data_fingerprint_parts"] for s in states]
    assert tstate.combine_fingerprint_parts(parts) == jstate.combine_fingerprint_parts(parts)
    assert tstate.combine_fingerprint_parts(parts[:1]) == states[0].meta["data_fingerprint"]

    def same(a, b):
        assert json.loads(json.dumps(a.meta)) == json.loads(json.dumps(b.meta))
        assert json.loads(json.dumps(a.py)) == json.loads(json.dumps(b.py))
        assert sorted(a.arrays) == sorted(b.arrays)
        for k in a.arrays:
            np.testing.assert_array_equal(np.asarray(a.arrays[k]), np.asarray(b.arrays[k]),
                                          err_msg=k)

    canon = tstate.merge_to_canonical(states)
    jcanon = jstate.merge_to_canonical(jstates)
    same(canon, jcanon)
    assert canon.meta["world_size"] == 2 and canon.meta["num_data"] == 1600
    # the container round trips through bytes, as rank 0 writes it
    same(TrainState.from_bytes(canon.to_bytes()), jcanon)
    rows = canon.meta["shard_rows"]
    valid = canon.meta["valid_shard_rows"]
    for r in range(2):  # the same partition: each rank's own state back
        local_fp = tstate.combine_fingerprint_parts([parts[r]])
        back = tstate.reshard_to_local(canon, r, rows, valid, local_fp, bag_seed=3)
        same(back, jstate.reshard_to_local(jcanon, r, rows, valid, local_fp, bag_seed=3))
        np.testing.assert_array_equal(back.arrays["scores"], states[r].arrays["scores"])
        np.testing.assert_array_equal(back.arrays["bag_rng_keys"],
                                      states[r].arrays["bag_rng_keys"])
    # another partition of the same rows (three ranks): resliced and reseeded
    new_rows, new_valid = [500, 600, 500], [[30, 40, 30]]
    for r in range(3):
        same(tstate.reshard_to_local(canon, r, new_rows, new_valid, "fp", bag_seed=3),
             jstate.reshard_to_local(jcanon, r, new_rows, new_valid, "fp", bag_seed=3))
    with pytest.raises(tstate.CheckpointMismatch, match="global rows"):
        tstate.reshard_to_local(canon, 0, [100, 100], valid, "fp")
    with pytest.raises(tstate.CheckpointMismatch, match="divergent iterations"):
        bad = TrainState.from_bytes(states[1].to_bytes())
        bad.meta["iteration"] = 5
        tstate.merge_to_canonical([states[0], bad])


# ----------------------------------------------------------------------
# ranks as the port's CLI, and their faults
# ----------------------------------------------------------------------
CLI_ROUNDS = 6


def _cli_data(d, nproc=2):
    """Each rank's shard as a binary cache with the whole data's bins (the
    CLI then needs no text parser), and the whole data's cache."""
    import lightgbm_tpu_torch as lgt

    X, y = _data(n=2400, f=6, seed=7)
    full = lgt.Dataset(X, label=y, params={"max_bin": 31})
    full.save_binary(str(d / "all.bin"))
    for r, idx in enumerate(np.array_split(np.arange(len(y)), nproc)):
        lgt.Dataset(X[idx], label=y[idx], reference=full).save_binary(str(d / f"shard{r}.bin"))
    return X, y


def _cli_argv(d, rank, tag, extra=(), timeout=TIMEOUT):
    return [sys.executable, "-m", "lightgbm_tpu_torch", "task=train",
            f"data={d / f'shard{rank}.bin'}", f"output_model={d / f'{tag}.model{rank}.txt'}",
            "objective=regression", "tree_learner=data", "num_machines=2",
            "pre_partition=true", "num_leaves=7", "learning_rate=0.2", "min_data_in_leaf=5",
            f"num_iterations={CLI_ROUNDS}", f"network_timeout={timeout}", "device=cpu",
            "verbose=1", *extra]


def _spawn_cli(d, tag, extra=(), env_extra=None, ranks=(0, 1), timeout=TIMEOUT):
    port = _free_port()
    return [subprocess.Popen(_cli_argv(d, r, tag, extra, timeout), cwd=str(d),
                             env=_env(r, 2, port, (env_extra or {}).get(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in ranks]


def _timed_wait(procs, timeout=JOIN_S):
    """(return codes, logs, seconds from now until each exited)."""
    t0 = time.monotonic()
    ends = [None] * len(procs)
    while any(e is None for e in ends) and time.monotonic() - t0 < timeout:
        for i, p in enumerate(procs):
            if ends[i] is None and p.poll() is not None:
                ends[i] = time.monotonic() - t0
        time.sleep(0.02)
    logs = _wait(procs, timeout=5)
    return [p.returncode for p in procs], logs, ends


def _allgathers_before_barrier(trace, which):
    """The 1-based collective call of a rank's ``which``-th checkpoint
    barrier: its allgathers in the order they ran, up to that barrier's
    own."""
    n = seen = 0
    for line in Path(trace).read_text().splitlines():
        rec = json.loads(line)
        if rec.get("ev") == "span" and rec.get("name") == "net.allgather":
            n += 1
            if rec.get("parent") == "ckpt.barrier":
                seen += 1
                if seen == which:
                    return n
    raise AssertionError("no such checkpoint barrier in the trace")


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The CLI's uninterrupted 2-rank run (traced, with checkpoints every 2
    iterations) and a run whose rank 1 is killed in its second checkpoint
    barrier; the interrupted checkpoint directory is kept."""
    d = tmp_path_factory.mktemp("cli")
    _cli_data(d)
    ck = ("checkpoint_freq=2",)
    env = {r: {"LIGHTGBM_TPU_TRACE": str(d / f"trace{r}.jsonl")} for r in range(2)}
    rcs, logs, _ = _timed_wait(_spawn_cli(d, "full", ck + (f"checkpoint_dir={d / 'ck_full'}",),
                                          env, timeout=CALM))
    assert rcs == [0, 0], logs[0][-3000:] + logs[1][-3000:]
    k = _allgathers_before_barrier(d / "trace1.jsonl", 2)
    env = {1: {"LIGHTGBM_TPU_FAULT": f"die:{k}", "LIGHTGBM_TPU_FAULT_RANK": "1"}}
    rcs, logs, ends = _timed_wait(_spawn_cli(d, "kill", ck + (f"checkpoint_dir={d / 'ck'}",),
                                             env))
    if (d / "ck").exists():
        shutil.copytree(d / "ck", d / "ck_at_kill")
    return d, rcs, logs, ends, k


def test_kill_in_checkpoint_barrier_flushes_exits_and_resumes(cli_runs):
    d, rcs, logs, ends, k = cli_runs
    assert rcs[1] == -9, logs[1][-2000:]
    assert rcs[0] == 75, logs[0][-3000:]
    assert ends[0] is not None and ends[0] - ends[1] <= BOUND
    assert "Checkpoint barrier at iteration 4 failed" in logs[0]
    assert not (d / "kill.model0.txt").exists()
    # the rerun resumes from iteration 2 to the uninterrupted model
    rcs, logs, _ = _timed_wait(_spawn_cli(d, "kill", ("checkpoint_freq=2",
                                                      f"checkpoint_dir={d / 'ck'}")))
    assert rcs == [0, 0], logs[0][-3000:]
    assert "Resuming training from checkpoint at iteration 2" in logs[0]
    full = (d / "full.model0.txt").read_text()
    assert (d / "kill.model0.txt").read_text() == full == (d / "kill.model1.txt").read_text()


def test_world2_checkpoint_resumes_at_world_1_and_2(cli_runs, tmp_path):
    """The canonical container of the killed run (iteration 2) resumes in
    one process on all rows (resliced) and, copied again, at world 2 in
    process over rank threads, byte-identical to the uninterrupted run."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ckpt import TrainState
    from lightgbm_tpu_torch.ckpt.store import CheckpointStore

    d, rcs, logs = cli_runs[:3]
    assert (d / "ck_at_kill").exists(), (rcs, logs[0][-3000:])
    step, blob = CheckpointStore(str(d / "ck_at_kill")).latest_valid()
    meta = TrainState.from_bytes(blob).meta
    assert step == 2 and meta["world_size"] == 2 and meta["num_data"] == 2400
    # the run's keys (the config fingerprint holds is_parallel, the device and
    # the net keys); with no coordinator one process trains serially
    p = dict(objective="regression", tree_learner="data", num_leaves=7, learning_rate=0.2,
             min_data_in_leaf=5, verbose=-1, num_machines=2, pre_partition=True,
             network_timeout=TIMEOUT, device="cpu")
    one = tmp_path / "one"
    shutil.copytree(d / "ck_at_kill", one)
    b = lgt.train(p, lgt.Dataset(str(d / "all.bin")), CLI_ROUNDS, device="cpu",
                  checkpoint_dir=str(one), checkpoint_freq=2)
    # the boost-from-average tree and one a round
    assert b.current_iteration() == CLI_ROUNDS and b.boosting.num_trees == CLI_ROUNDS + 1
    full = lgt.Booster(model_file=str(d / "full.model0.txt"), device="cpu")
    X, _ = _data(n=2400, f=6, seed=7)
    # resumed in one process: the trees up to the checkpoint are the world-2 run's
    # (seven split lines a tree)
    assert _split_lines(b.model_to_string())[:3 * 7] == _split_lines(
        full.model_to_string())[:3 * 7]
    assert np.isfinite(b.predict(X)).all()
    two = tmp_path / "two"
    shutil.copytree(d / "ck_at_kill", two)
    p2 = dict(p)
    from lightgbm_tpu_torch.parallel.comm import rank_thread

    def work(r, comm):
        with rank_thread(comm):
            return lgt.train(dict(p2), lgt.Dataset(str(d / f"shard{r}.bin")), CLI_ROUNDS,
                             device="cpu", checkpoint_dir=str(two),
                             checkpoint_freq=2).model_to_string()

    texts = _threads(2, work)
    assert texts[0] == texts[1] == (d / "full.model0.txt").read_text()


def test_report_merge_equals_jax_merge_summary(cli_runs, capsys):
    from lightgbm_tpu.obs import report as jreport

    from lightgbm_tpu_torch import cli

    d = cli_runs[0]
    paths = [str(d / "trace0.jsonl"), str(d / "trace1.jsonl")]
    assert cli.main(["report", "merge", *paths, "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    want = json.loads(json.dumps(jreport.merge_summary(jreport.load_rank_traces(paths))))
    assert got == want
    assert got["ranks"] == [0, 1] and got["world_size"] == 2 and got["run_id"]
    assert got["aligned_iterations"] == CLI_ROUNDS
    assert cli.main(["report", "merge", str(d)]) == 0
    text = capsys.readouterr().out
    assert "cross-rank report: 2 rank(s), world=2" in text and "straggler: rank" in text


def test_peer_killed_mid_allgather_survivor_exits_75(tmp_path):
    _cli_data(tmp_path)
    env = {1: {"LIGHTGBM_TPU_FAULT": "die:5", "LIGHTGBM_TPU_FAULT_RANK": "1"}}
    rcs, logs, ends = _timed_wait(_spawn_cli(tmp_path, "die", env_extra=env))
    assert rcs[1] == -9 and rcs[0] == 75, logs[0][-3000:]
    assert ends[0] - ends[1] <= BOUND
    assert "Peer failure after" in logs[0] and "ranks [1]" in logs[0]
    assert not (tmp_path / "die.model0.txt").exists()


def test_coordinator_death_is_bounded(tmp_path):
    _cli_data(tmp_path)
    env = {0: {"LIGHTGBM_TPU_FAULT": "die:5", "LIGHTGBM_TPU_FAULT_RANK": "0"}}
    rcs, logs, ends = _timed_wait(_spawn_cli(tmp_path, "coord", env_extra=env))
    assert rcs[0] == -9 and rcs[1] == 75, logs[1][-3000:]
    assert ends[1] - ends[0] <= BOUND
    assert "ranks [0]" in logs[1]


def test_wedged_peer_makes_its_partner_exit_74(tmp_path):
    """Rank 1 stalls a collective for longer than the budget while its
    heartbeat goes on: rank 0 gives up with a timeout, not a peer failure."""
    _cli_data(tmp_path)
    stall_ms = int((2 * TIMEOUT + 6) * 1000)
    env = {1: {"LIGHTGBM_TPU_FAULT": f"delay:{stall_ms}:after:5",
               "LIGHTGBM_TPU_FAULT_RANK": "1"}}
    procs = _spawn_cli(tmp_path, "wedge", env_extra=env)
    rcs, logs, ends = _timed_wait(procs)
    assert rcs[0] == 74, logs[0][-3000:]
    assert "Collective/bootstrap timeout" in logs[0]
    assert ends[0] <= 2 * TIMEOUT + 30
    assert rcs[1] != 0  # it finds its coordinator gone


@pytest.mark.parametrize("who", [0, 1])
def test_bootstrap_with_no_peer_is_loud_and_bounded(tmp_path, who):
    """Rank 0 alone (its store up, no rank 1 ever joins) or rank 1 alone
    (nothing listens): exit 74 within the deadline's bound, no model."""
    _cli_data(tmp_path)
    t0 = time.monotonic()
    rcs, logs, _ = _timed_wait(_spawn_cli(tmp_path, "alone", ranks=(who,),
                                          env_extra={who: {"LIGHTGBM_TPU_NET_RETRIES": "0"}}))
    assert rcs == [74], logs[0][-3000:]
    assert time.monotonic() - t0 <= 3 * TIMEOUT + 15
    assert "bootstrap" in logs[0]
    assert not (tmp_path / f"alone.model{who}.txt").exists()


# ----------------------------------------------------------------------
# the worker: this file run as a script
# ----------------------------------------------------------------------
def _worker(spec_path):
    import pickle

    import torch

    torch.set_num_threads(1)
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.parallel import distributed

    spec = json.loads(Path(spec_path).read_text())
    rank = int(os.environ["LIGHTGBM_TPU_PROCESS_ID"])
    out = spec["out"]
    z = np.load(spec["data"])
    X, y = z["X"], z["y"]
    if not spec.get("replicate"):
        X, y = X[z[f"idx{rank}"]], y[z[f"idx{rank}"]]
    params = spec["params"]
    ds = lgt.Dataset(X, label=y, params=dict(params))
    b = lgt.train(dict(params), ds, spec["rounds"], device="cpu")
    if spec.get("save_bins"):
        ds.save_binary(f"{out}.rank{rank}.bin")
    comm = b.boosting.learner.comm
    first = b.boosting.models[0]
    res = dict(model=b.model_to_string(), ledger=dict(comm.ledger), trees=b.boosting.num_trees,
               nproc=distributed.process_count(),
               init_score=(float(first.leaf_value[0]) if b.boosting.boost_from_average_
                           else None))
    if spec.get("binning"):
        from lightgbm_tpu_torch.config import Config
        from lightgbm_tpu_torch.data.stats import SketchCollector
        from lightgbm_tpu_torch.io.dataset import BinnedDataset

        Xall = z["X"]
        cfg = Config.from_params({"max_bin": 31, "tree_learner": "data",
                                  "num_machines": distributed.process_count(), "verbose": -1})
        assert cfg.is_parallel_find_bin
        bd = BinnedDataset.from_raw(Xall, cfg, label=z["y"])
        rows = _sketch_rows()
        part = np.array_split(rows, distributed.process_count())[rank]
        coll = SketchCollector(categorical={4}, cap=100_000)
        for lo in range(0, len(part), 700):
            coll.update(part[lo:lo + 700])
        coll.merge_across_hosts()
        if rank == 0:
            with open(out + ".binning.pkl", "wb") as fh:
                pickle.dump({"states": [m.state() for m in bd.bin_mappers], "binned": bd.binned,
                             "used": bd.used_feature_map,
                             "banks": [_bank(sk) for sk in coll.sketches],
                             "rows_seen": coll.rows_seen}, fh)
    Path(f"{out}.rank{rank}.json").write_text(json.dumps(res))


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "worker":
    _worker(sys.argv[2])
