"""Rank-sharded out-of-core training (lightgbm_tpu_torch/boosting/
oocdist.py ``DistributedOocTrainer``, its routing in boosting/gbdt.py and
the ``dist/`` schedule exemption of ckpt/state.py) on the CPU.

- in this process, the port's trainer over ``LocalComm`` rank threads
  against the JAX package's ``DistributedOocTrainer`` over its
  ``LocalComm`` on the same shards and gradients: every payload byte for
  byte (the ``hist_q`` planes, the scale maxima, the integer root totals,
  the row counts) and the same quantized L2 tree; float L2, the same
  split lines;
- two rank processes (the port's CLI on binary caches, ``device=cpu``)
  against the same ranks as threads, byte for byte;
- the quantized contract: the same model bytes at 2 and 3 ranks on any
  chunk grid, equal to the in-memory data-parallel learner's;
- an elastic resume: a 2-rank run stopped after its checkpoint at
  iteration 2 resumes at 3 ranks (another per-rank grid, admitted by the
  ``dist/`` exemption) to the uninterrupted run's bytes; a serial
  mismatch, and a ``dist/`` checkpoint into a serial run, are refused;
- the JAX package's config surface cases and ``report merge``'s per-rank
  stall share against the JAX ``merge_summary``.

Integer-valued rows (the membership worker's, five values a feature)
make every shard's bin mappers the same, as the JAX package's oocdist
worker does.
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

import jax
import jax._src.core
import jax.numpy as jnp

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.factory.member_worker import make_data
from lightgbm_tpu_torch.parallel import LocalComm, LocalGroup
from lightgbm_tpu_torch.parallel.comm import rank_thread
from lightgbm_tpu_torch.utils.log import LightGBMError

pytestmark = pytest.mark.oocdist

REPO = Path(__file__).resolve().parents[1]
JOIN_S = 120
P = dict(objective="binary", tree_learner="data", pre_partition=True, num_leaves=7,
         learning_rate=0.2, max_bin=31, min_data_in_leaf=20, quantized_training=True,
         verbose=-1)


@pytest.fixture(scope="module", autouse=True)
def jax_shim_and_one_thread():
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if not had:
        del jax.core.trace_state_clean


def _threads(group, n, work):
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


def _cuts(n, world):
    return [(r * n // world, (r + 1) * n // world) for r in range(world)]


# ----------------------------------------------------------------------
# the trainer against the JAX package's, in process
# ----------------------------------------------------------------------
class _Recording(LocalComm):
    def __init__(self, rank, group):
        super().__init__(rank, group)
        self.sent = []

    def allgather(self, blob, purpose="misc"):
        self.sent.append((purpose, bytes(blob)))
        return super().allgather(blob, purpose)


def _jax_recording():
    from lightgbm_tpu.parallel import LocalComm as JLocalComm

    class _JRecording(JLocalComm):
        def __init__(self, rank, group):
            super().__init__(rank, group)
            self.sent = []

        def allgather(self, blob, purpose="misc"):
            self.sent.append((purpose, bytes(blob)))
            return super().allgather(blob, purpose)

    return _JRecording


@pytest.mark.parametrize("world,quantized", [(2, True), (3, True), (2, False)],
                         ids=["q2", "q3", "float2"])
def test_trainer_wire_and_tree_equal_jax(world, quantized):
    from lightgbm_tpu.boosting.oocdist import DistributedOocTrainer as JTrainer
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset import BinnedDataset as JBinned
    from lightgbm_tpu.ops.grow import GrowParams as JGrowParams
    from lightgbm_tpu.ops.split import FeatureMeta as JMeta
    from lightgbm_tpu.ops.split import SplitHyper as JHyper
    from lightgbm_tpu.parallel import LocalGroup as JLocalGroup

    from lightgbm_tpu_torch.boosting.oocdist import DistributedOocTrainer
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import BinnedDataset
    from lightgbm_tpu_torch.ops.grow import GrowParams
    from lightgbm_tpu_torch.ops.split import FeatureMeta, SplitHyper

    n = 6000
    X, y = make_data(n, 10, 5)
    params = dict(objective="regression", num_leaves=15, max_bin=31, min_data_in_leaf=20,
                  quantized_training=quantized, seed=3, verbose=-1)
    cuts = _cuts(n, world)
    chunk_rows = 1000  # one 4,096-row block a chunk: 1 chunk a rank at world 2

    def port(r, comm):
        cfg = Config.from_params(dict(params))
        ds = BinnedDataset.from_raw(X[slice(*cuts[r])], cfg, label=y[slice(*cuts[r])])
        gp = GrowParams(num_leaves=15, num_bins=int(ds.max_num_bin), has_categorical=False)
        tr = DistributedOocTrainer(ds, cfg, gp, chunk_rows, comm, "cpu")
        lab = torch.from_numpy(np.asarray(ds.metadata.label, np.float32))
        gr = tr.grow(None, -lab, torch.ones_like(lab), torch.ones_like(lab),
                     torch.ones(ds.num_features), FeatureMeta.from_dataset(ds),
                     SplitHyper.from_config(cfg))
        return gr, tr.schedule_fingerprint()

    def jx(r, comm):
        cfg = JConfig.from_params(dict(params))
        ds = JBinned.from_raw(X[slice(*cuts[r])], cfg, label=y[slice(*cuts[r])])
        gp = JGrowParams(num_leaves=15, num_bins=int(ds.max_num_bin), quantized=quantized,
                         quant_seed=3)
        tr = JTrainer(ds, cfg, gp, chunk_rows, comm)
        lab = jnp.asarray(np.asarray(ds.metadata.label, np.float32))
        gr = tr.grow(None, -lab, jnp.ones_like(lab), jnp.ones_like(lab),
                     jnp.ones((ds.num_features,), jnp.float32), JMeta.from_dataset(ds),
                     JHyper.from_config(cfg))
        return jax.tree_util.tree_map(np.asarray, gr), tr.schedule_fingerprint()

    pg, jg = LocalGroup(world), JLocalGroup(world)
    pc = [_Recording(r, pg) for r in range(world)]
    jc = [_jax_recording()(r, jg) for r in range(world)]
    ours = _threads(pg, world, lambda r: port(r, pc[r]))
    theirs = _threads(jg, world, lambda r: jx(r, jc[r]))
    for r in range(world):
        (a, sa), (b, sb) = ours[r], theirs[r]
        assert sa == sb and sa.startswith(f"dist/{world}w/r{r}/")
        assert pc[r].ledger == jc[r].ledger
        assert [p for p, _ in pc[r].sent] == [p for p, _ in jc[r].sent]
        n_s = int(a.num_splits)
        assert n_s == int(b.num_splits) > 5
        for name in ("rec_leaf", "rec_feat", "rec_thr", "rec_dbz"):
            np.testing.assert_array_equal(np.asarray(getattr(a, name))[:n_s],
                                          getattr(b, name)[:n_s], err_msg=name)
        if quantized:
            # every payload (hist_q planes, scale maxima, integer totals,
            # row counts) and the whole tree, byte for byte
            for (purpose, x), (_, z) in zip(pc[r].sent, jc[r].sent):
                assert x == z, purpose
            for name in ("leaf_value", "leaf_cnt", "rec_gain", "rec_lval", "rec_rval",
                         "rec_lcnt", "rec_rcnt"):
                np.testing.assert_array_equal(np.asarray(getattr(a, name)), getattr(b, name),
                                              err_msg=name)
            np.testing.assert_array_equal(a.leaf_id.numpy(), b.leaf_id)
        else:
            np.testing.assert_allclose(np.asarray(a.leaf_value), b.leaf_value, rtol=1e-4,
                                       atol=1e-6)


# ----------------------------------------------------------------------
# worlds, grids and the in-memory learner, as rank threads
# ----------------------------------------------------------------------
def _world(X, y, world, extra, rounds=4, **train_kw):
    """``lgt.train`` on ``world`` rank threads, each on its contiguous
    shard binned against the whole data's mappers: (texts, boosters)."""
    full = lgt.Dataset(X, label=y, params={"max_bin": 31})
    cuts = _cuts(len(y), world)
    group = LocalGroup(world)
    comms = group.comms()

    def work(r):
        with rank_thread(comms[r]):
            ds = lgt.Dataset(X[slice(*cuts[r])], label=y[slice(*cuts[r])], reference=full)
            return lgt.train(dict(P, **extra), ds, rounds, device="cpu", **train_kw)

    boosters = _threads(group, world, work)
    return [b.model_to_string() for b in boosters], boosters


def test_quantized_model_is_the_same_at_any_world_and_grid():
    X, y = make_data(12000, 10, 5)
    models = {}
    for world, grid in ((2, 1000), (2, 5000), (3, 1000), (3, 9999)):
        texts, bs = _world(X, y, world, dict(out_of_core="true", ooc_chunk_rows=grid))
        assert len(set(texts)) == 1
        g = bs[0].boosting
        assert type(g.learner).__name__ == "DistributedOocTrainer" and g.ooc is g.learner
        assert g.ooc.schedule_fingerprint().startswith(f"dist/{world}w/r0/")
        models[(world, grid)] = (texts[0], g.ooc.plan.num_chunks)
    assert models[(2, 1000)][1] == 2 and models[(2, 5000)][1] == 1  # the grids differ
    assert len({m for m, _ in models.values()}) == 1
    resident, bs = _world(X, y, 2, dict(out_of_core="false"))
    assert type(bs[0].boosting.learner).__name__ == "HostParallelLearner"
    assert resident[0] == models[(2, 1000)][0]
    # one process streams serially (the mask grower's learner): the same
    # splits and leaf values; its quantized leaf counts are derived from
    # the hessians, where the data-parallel learners count rows exactly
    one = lgt.train(dict(P, out_of_core="true", ooc_chunk_rows=1000),
                    lgt.Dataset(X, label=y, params={"max_bin": 31}), 4,
                    device="cpu").model_to_string()
    diff = [(a, b) for a, b in zip(one.splitlines(), resident[0].splitlines()) if a != b]
    assert diff and all(a.split("=")[0] in ("leaf_count", "internal_count") for a, _ in diff)


def test_elastic_resume_at_another_world(tmp_path):
    """Stopped after its checkpoint at iteration 2 (a callback raising on
    every rank at the third iteration), the 2-rank run resumes at 3 ranks
    to the uninterrupted run's bytes."""
    X, y = make_data(12000, 10, 5)
    extra = dict(out_of_core="true", ooc_chunk_rows=1000)
    ref, _ = _world(X, y, 2, extra, rounds=6)

    def stop(env):
        if env.iteration >= 2:  # the third iteration, after the checkpoint at 2
            raise RuntimeError("stopped")

    stop.order = 100
    ck = tmp_path / "ck"
    with pytest.raises(RuntimeError, match="stopped"):
        _world(X, y, 2, extra, rounds=6, checkpoint_dir=str(ck), checkpoint_freq=2,
               callbacks=[stop])
    from lightgbm_tpu_torch.ckpt import TrainState
    from lightgbm_tpu_torch.ckpt.store import CheckpointStore

    step, blob = CheckpointStore(str(ck)).latest_valid()
    meta = TrainState.from_bytes(blob).meta
    # the chunk [2, 4) trained before the callback raised; the error's
    # flush may checkpoint it too
    assert step in (2, 4) and meta["world_size"] == 2
    assert meta["ooc_schedule"].startswith("dist/2w/r0/")
    texts, bs = _world(X, y, 3, extra, rounds=6, checkpoint_dir=str(ck), checkpoint_freq=2)
    assert bs[0].boosting.ooc.schedule_fingerprint().startswith("dist/3w/")
    assert texts == [ref[0]] * 3


def test_dist_schedules_are_exempt_and_others_refused():
    from lightgbm_tpu_torch.ckpt import CheckpointMismatch, capture, restore

    rng = np.random.RandomState(3)
    X = rng.randn(600, 8)
    y = (X[:, 0] + 0.2 * rng.randn(600) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 7, "verbose": -1, "out_of_core": "true",
         "ooc_chunk_rows": 512, "min_data_in_leaf": 20}
    bst = lgt.train(dict(p), lgt.Dataset(X, label=y), 2, device="cpu")
    ooc = bst.boosting.ooc
    st = capture(bst)
    st.meta["ooc_schedule"] = "999r/512c/2"
    with pytest.raises(CheckpointMismatch, match="chunk schedule"):
        restore(bst, st)  # a serial mismatch
    st2 = capture(bst)
    st2.meta["ooc_schedule"] = "dist/4w/r0/4096r/4096c/1"
    ooc.schedule_fingerprint = lambda: "dist/2w/r0/8192r/4096c/2"
    try:
        restore(bst, st2)  # per-rank grids differ across worlds: admitted
    finally:
        del ooc.schedule_fingerprint
    st3 = capture(bst)
    st3.meta["ooc_schedule"] = "dist/4w/r0/4096r/4096c/1"
    with pytest.raises(CheckpointMismatch, match="chunk schedule"):
        restore(bst, st3)  # a rank's checkpoint into a serial run


# ----------------------------------------------------------------------
# two rank processes
# ----------------------------------------------------------------------
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_rank_processes_equal_rank_threads(tmp_path):
    X, y = make_data(8000, 10, 5)
    full = lgt.Dataset(X, label=y, params={"max_bin": 31})
    for r, (lo, hi) in enumerate(_cuts(len(y), 2)):
        lgt.Dataset(X[lo:hi], label=y[lo:hi], reference=full).save_binary(
            str(tmp_path / f"s{r}.bin"))
    port = _free_port()
    procs = []
    for r in range(2):
        env = {k: v for k, v in os.environ.items() if not k.startswith("LIGHTGBM_TPU_")}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   LIGHTGBM_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   LIGHTGBM_TPU_NUM_PROCESSES="2", LIGHTGBM_TPU_PROCESS_ID=str(r),
                   LIGHTGBM_TPU_TRACE=str(tmp_path / f"trace{r}.jsonl"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "lightgbm_tpu_torch", "train",
             f"data={tmp_path / f's{r}.bin'}", f"output_model={tmp_path / f'm{r}.txt'}",
             "objective=binary", "tree_learner=data", "num_machines=2", "pre_partition=true",
             "num_leaves=7", "learning_rate=0.2", "min_data_in_leaf=20",
             "quantized_training=true", "out_of_core=true", "ooc_chunk_rows=1000",
             "num_iterations=4", "network_timeout=30", "device=cpu", "verbose=1"],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = [p.communicate(timeout=JOIN_S)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert "Using distributed out-of-core data-parallel learner over 2 processes" in logs[0]
    assert "rank 1/2 streams 4000 rows in 1 chunks" in logs[1]
    texts = [(tmp_path / f"m{r}.txt").read_text() for r in range(2)]
    group = LocalGroup(2)
    comms = group.comms()

    def work(r):
        with rank_thread(comms[r]):
            return lgt.train(dict(P, out_of_core="true", ooc_chunk_rows=1000),
                             lgt.Dataset(str(tmp_path / f"s{r}.bin")), 4,
                             device="cpu").model_to_string()

    assert texts == _threads(group, 2, work)
    # the ranks' stream records carry their rank: report merge's stall share
    from lightgbm_tpu_torch.obs import report

    m = report.merge_summary(report.load_rank_traces(
        [str(tmp_path / f"trace{r}.jsonl") for r in range(2)]))
    assert all("ooc_stall_share" in m["per_rank"][r] for r in (0, 1)), m["per_rank"]


# ----------------------------------------------------------------------
# the config surface and the report column (the JAX package's cases)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("params,match", [
    ({"tree_learner": "feature", "out_of_core": "true"}, "serial.*|tree_learner=data"),
    ({"tree_learner": "voting", "out_of_core": "true"}, "tree_learner=data"),
    ({"ooc_chunk_rows": -1}, "per rank"),
])
def test_config_surface_refusals(params, match):
    from lightgbm_tpu_torch.config import Config

    with pytest.raises(LightGBMError, match=match):
        Config.from_params(dict(params))


def test_data_plus_out_of_core_is_accepted():
    from lightgbm_tpu_torch.config import Config

    cfg = Config.from_params({"tree_learner": "data", "out_of_core": "true", "num_machines": 4})
    assert cfg.is_parallel


def _stall_recs(rank, stall_ms, fetch_ms):
    return [{"ev": "iter", "iter": 0, "wall_s": 2.0, "phases": {"tree": 1.0},
             "net_bytes": 100.0, "rank": rank, "world": 2},
            {"ev": "gauge", "name": "ooc.stall_ms", "value": stall_ms, "rank": rank},
            {"ev": "gauge", "name": "ooc.fetch_ms", "value": fetch_ms, "rank": rank}]


def test_merge_carries_the_per_rank_stall_share_as_jax():
    from lightgbm_tpu.obs import report as jreport

    from lightgbm_tpu_torch.obs import report

    by_rank = {0: _stall_recs(0, 500.0, 900.0), 1: _stall_recs(1, 40.0, 800.0)}
    m = report.merge_summary(by_rank)
    assert json.loads(json.dumps(m)) == json.loads(json.dumps(jreport.merge_summary(by_rank)))
    assert m["per_rank"][0]["ooc_stall_s"] == pytest.approx(0.5)
    assert m["per_rank"][0]["ooc_stall_share"] == pytest.approx(0.25)
    txt = report.render_merge(m)
    assert "ooc_stall_s" in txt and "stall%" in txt
    plain = report.merge_summary({0: [{"ev": "iter", "iter": 0, "wall_s": 1.0, "phases": {},
                                       "net_bytes": 0.0}]})
    assert "ooc_stall_s" not in plain["per_rank"][0]
