"""The port's training factory (factory/: state.py, watch.py, spot.py's
trace and ledger, supervisor.py, ``python -m lightgbm_tpu_torch
factory``) against the JAX package's, on the CPU.

- ``FactoryState`` files across packages both ways, the CRC and the
  garbage refusals, the bounded history;
- ``watch`` fingerprints (a small file and one past two 64 KiB windows),
  ``scan``'s filters, ``changed`` (an append is a change, a touch is
  not), the debounce and ``combined_fingerprint`` against the JAX
  functions;
- ``SpotSchedule.from_script`` / ``sample`` and ``CostLedger`` against
  the JAX classes on the same seed and operations, ledgers loading across
  packages; ``factory spot`` without its fleet directory refused (its
  fleets: tests/test_torch_spot.py);
- in process, the JAX package's drills ``test_cold_then_warm_promote``,
  ``test_kill_after_publish_never_double_publishes`` and
  ``test_eval_gate_rollback_records_verdict`` run by both packages'
  supervisors on the same data directory: the same verdicts, versions,
  warm starts and registry states, and promoted models with the same
  split lines and header, predictions within 3e-3;
- one canary: an in-process replica and ``FleetProxy`` under closed-loop
  traffic, the supervisor spawning its pinned canary replica
  (``python -m lightgbm_tpu_torch serve device=cpu``), promoted with no
  failed request;
- one subprocess: the port's ``factory`` CLI on the CPU SIGKILLed mid
  retrain, then run again: it resumes from its checkpoint and publishes
  once.

The JAX package's factory imports serve/fleet.py and so obs/compilewatch,
which needs the jax 0.9 ``trace_state_clean`` shim; its CLI cannot run as
a subprocess under jax 0.9, so its supervisor runs in process only.
"""

import glob
import importlib
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax._src.core

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.factory import (CostLedger, FactoryState, FactorySupervisor, SpotEvent,
                                        SpotSchedule, watch)
from lightgbm_tpu_torch.serve.fleet import FleetProxy
from lightgbm_tpu_torch.serve.registry import ModelRegistry
from lightgbm_tpu_torch.serve.server import make_server
from lightgbm_tpu_torch.utils.log import LightGBMError

REPO = Path(__file__).resolve().parents[1]
N_FEATURES = 8
TRAIN_PARAMS = {"objective": "binary", "num_leaves": 7, "verbose": -1, "min_data_in_leaf": 5}
FACTORY_KNOBS = {"num_boost_round": 5, "checkpoint_freq": 2, "debounce_ms": 0.0,
                 "canary_fraction": 0.0}


@pytest.fixture(scope="module")
def jfac():
    """The JAX package's factory modules, imported under the shim, and one
    torch intra-op thread for the port's many small CPU ops."""
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mods = {name: importlib.import_module(f"lightgbm_tpu.factory.{name}")
            for name in ("state", "watch", "spot", "supervisor")}
    yield mods
    torch.set_num_threads(threads)
    if not had:
        del jax.core.trace_state_clean


def _write_chunk(data_dir, name, n, seed, backdate=True):
    """Append ``n`` CSV rows (label first) of one fixed rule
    (tests/test_factory.py's chunks)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, N_FEATURES)
    y = (X[:, 0] + 0.5 * X[:, 1] - X[:, 2] > 0).astype(int)
    path = os.path.join(data_dir, name)
    with open(path, "a") as f:
        for yy, row in zip(y, X):
            f.write(",".join([str(yy)] + [f"{v:.6f}" for v in row]) + "\n")
    if backdate:  # out of the debounce window
        t = time.time() - 60
        os.utime(path, (t, t))
    return path


# ----------------------------------------------------------------------
# the state file
# ----------------------------------------------------------------------
def _filled(cls, workdir):
    st = cls(workdir)
    st.ingested = {"a.csv": {"size": 3, "mtime_ns": 1, "crc32": 9}}
    st.run = {"run_id": "r000001-abc", "candidate_version": 2}
    st.current = {"version": 1, "model_path": "/x", "metric": 0.1}
    st.retrain_seq = 4
    st.last_run_ts = 123.5
    st.record_verdict({"run_id": "r000001-abc", "verdict": "promoted"})
    return st


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_state_file_crosses_packages(jfac, tmp_path, writer):
    JState = jfac["state"].FactoryState
    wcls, rcls = (FactoryState, JState) if writer == "port" else (JState, FactoryState)
    st = _filled(wcls, str(tmp_path))
    st.save()
    back = rcls.load(str(tmp_path))
    for key in ("ingested", "run", "current", "retrain_seq", "last_run_ts", "history"):
        assert getattr(back, key) == getattr(st, key), key
    other = tmp_path / "other"
    other.mkdir()
    _filled(rcls, str(other)).save()
    assert (other / "factory_state.json").read_bytes() == (tmp_path / "factory_state.json"
                                                           ).read_bytes()


def test_state_refusals_and_history(tmp_path):
    assert FactoryState.load(str(tmp_path)).run is None  # fresh when absent
    st = FactoryState(str(tmp_path))
    st.retrain_seq = 1
    st.save()
    doc = json.loads(Path(st.path).read_text())
    doc["payload"]["retrain_seq"] = 99  # tampered without a new CRC
    Path(st.path).write_text(json.dumps(doc))
    with pytest.raises(LightGBMError, match="CRC"):
        FactoryState.load(str(tmp_path))
    Path(st.path).write_text("not json{")
    with pytest.raises(LightGBMError, match="unreadable"):
        FactoryState.load(str(tmp_path))
    for i in range(60):
        st.record_verdict({"run_id": f"r{i}"}, keep=50)
    assert len(st.history) == 50 and st.history[-1]["run_id"] == "r59"


# ----------------------------------------------------------------------
# the watcher
# ----------------------------------------------------------------------
def test_watch_matches_jax(jfac, tmp_path):
    jw = jfac["watch"]
    d = str(tmp_path)
    _write_chunk(d, "a.csv", 5, 0)
    _write_chunk(d, ".hidden.csv", 3, 1)
    (tmp_path / "notes.md").write_text("not data\n")
    (tmp_path / "sub.csv").mkdir()
    _write_chunk(d, "big.csv", 3000, 3)  # past two 64 KiB windows: head and tail CRC
    assert os.path.getsize(tmp_path / "big.csv") > 2 * 65536
    for name in ("a.csv", "big.csv"):
        assert watch.fingerprint(str(tmp_path / name)) == jw.fingerprint(str(tmp_path / name))
    prev = watch.scan(d)
    assert list(prev) == ["a.csv", "big.csv"] and prev == jw.scan(d)
    assert watch.combined_fingerprint(prev) == jw.combined_fingerprint(prev)
    os.utime(tmp_path / "a.csv")  # a touch is no change
    assert watch.changed(prev, watch.scan(d)) == [] == jw.changed(prev, jw.scan(d))
    _write_chunk(d, "big.csv", 1, 9)  # an append moves the size and the tail CRC
    _write_chunk(d, "b.csv", 2, 2, backdate=False)
    cur = watch.scan(d)
    assert watch.changed(prev, cur) == jw.changed(prev, cur) == ["b.csv", "big.csv"]
    assert watch.combined_fingerprint(cur) == jw.combined_fingerprint(cur)
    assert watch.combined_fingerprint(cur) != watch.combined_fingerprint(prev)
    for debounce in (0.0, 30.0):
        assert watch.stable(cur, debounce) == jw.stable(cur, debounce)
    assert not watch.stable(cur, 30.0) and watch.stable(cur, 0.0)


# ----------------------------------------------------------------------
# the spot trace and the cost ledger
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7])
def test_spot_schedule_matches_jax(jfac, seed):
    js = jfac["spot"]
    script = "preempt@2.5;spawn@4;price@6=0.5;preempt@8=1"
    for a, b in ((SpotSchedule.from_script(script), js.SpotSchedule.from_script(script)),
                 (SpotSchedule.sample(seed, 60.0, base_price=0.4),
                  js.SpotSchedule.sample(seed, 60.0, base_price=0.4))):
        assert [tuple(vars(e).values()) for e in a.events] == [
            tuple(vars(e).values()) for e in b.events]
        for t in (0.0, 5.9, 6.0, 31.0):
            assert a.price_at(t) == b.price_at(t)
        assert [vars(e) for e in a.due(2.0, 8.0)] == [vars(e) for e in b.due(2.0, 8.0)]
    for bad in ("bogus@1", "price@3", "spawn@2=1"):
        with pytest.raises(ValueError):
            SpotSchedule.from_script(bad)
    with pytest.raises(ValueError, match="unknown spot event kind"):
        SpotSchedule([SpotEvent(1.0, "boom")])


def test_cost_ledger_matches_jax(jfac, tmp_path):
    JLedger = jfac["spot"].CostLedger

    def drive(led):
        led.charge(0, 2.5, 0.3)
        led.charge("m1", 1.0, 0.5)
        led.event(1.23456, "preempt", member=1)
        for it in range(3):
            led.iteration(it, epoch=0 if it < 2 else 1, t_s=0.5 * it)
            led.attempt(it, 0, 0 if it < 2 else 1)
        led.attempt(1, 0, 0)  # idempotent
        led.finish(3)
        led.flush()
        return led

    ours = drive(CostLedger(str(tmp_path / "t.json")))
    theirs = drive(JLedger(str(tmp_path / "j.json")))
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(
        (tmp_path / "j.json").read_text())
    assert ours.total_cost == theirs.total_cost and ours.zero_lost_iterations()
    assert CostLedger.load(str(tmp_path / "j.json")).cost_per_model() == theirs.cost_per_model()
    assert JLedger.load(str(tmp_path / "t.json")).zero_lost_iterations()
    ours.attempt(2, 0, 2)  # the same iteration completed under a second epoch: redone
    assert not ours.zero_lost_iterations()
    (tmp_path / "v.json").write_text(json.dumps({"version": 9}))
    with pytest.raises(ValueError, match="version"):
        CostLedger.load(str(tmp_path / "v.json"))


def test_factory_spot_is_refused(capsys, monkeypatch):
    # ``factory spot`` runs member fleets now (tests/test_torch_spot.py);
    # without its fleet directory it is refused with the usage line, as
    # the JAX package's is, and starts no process
    from lightgbm_tpu_torch.utils.log import Log

    monkeypatch.setattr(Log, "_level", 1)
    assert cli.main(["factory", "spot", "nproc=2"]) == 2
    assert "factory spot: need fleet=DIR" in capsys.readouterr().out


def test_factory_cli_needs_its_directories(capsys, monkeypatch):
    # the usage line is a warning: at the default verbosity, whatever an
    # earlier test in this process left the log level at
    from lightgbm_tpu_torch.utils.log import Log

    monkeypatch.setattr(Log, "_level", 1)
    assert cli.main(["factory", "data=x"]) == 2
    assert "need data=DIR workdir=DIR registry=DIR" in capsys.readouterr().out


# ----------------------------------------------------------------------
# the JAX package's drills, in process, by both supervisors
# ----------------------------------------------------------------------
def _supervisors(jfac, tmp_path, **knobs):
    """(port, JAX) supervisors watching one data directory, each with its
    own workdir and registry."""
    data_dir = str(tmp_path / "data")
    os.makedirs(data_dir, exist_ok=True)
    k = dict(FACTORY_KNOBS, **knobs)
    ours = FactorySupervisor(data_dir, str(tmp_path / "t_work"), str(tmp_path / "t_reg"),
                             params=dict(TRAIN_PARAMS, device="cpu"), **k)
    theirs = jfac["supervisor"].FactorySupervisor(
        data_dir, str(tmp_path / "j_work"), str(tmp_path / "j_reg"), params=dict(TRAIN_PARAMS),
        **k)
    return ours, theirs


def _split_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("Tree=", "num_leaves=", "split_feature=", "threshold=",
                              "decision_type=", "left_child=", "right_child="))]


def _same_verdict(v, jv):
    for key in ("run_id", "version", "verdict", "warm_start", "reason"):
        assert v.get(key) == jv.get(key), key
    assert (v["detail"]["eval"]["baseline"] is None) == (jv["detail"]["eval"]["baseline"] is None)
    assert abs(v["detail"]["eval"]["candidate"] - jv["detail"]["eval"]["candidate"]) <= 0.01


def _same_promoted(ours, theirs):
    """The promoted models: the same split lines and header, predictions
    within 3e-3 (the float limits of ROADMAP.md §C)."""
    text = Path(ours.state.current["model_path"]).read_text()
    jtext = Path(theirs.state.current["model_path"]).read_text()
    assert _split_lines(text) == _split_lines(jtext)
    assert text.split("Tree=0")[0] == jtext.split("Tree=0")[0]
    X = np.random.RandomState(5).randn(200, N_FEATURES)
    np.testing.assert_allclose(lgt.Booster(model_str=text, device="cpu").predict(X),
                               lgb.Booster(model_str=jtext).predict(X), rtol=3e-3, atol=3e-4)


def test_cold_then_warm_promote(jfac, tmp_path):
    ours, theirs = _supervisors(jfac, tmp_path)
    assert ours.run_cycle() is None and theirs.run_cycle() is None  # empty data dir
    _write_chunk(ours.data_dir, "chunk-000.csv", 300, 0)
    v1, jv1 = ours.run_cycle(), theirs.run_cycle()
    _same_verdict(v1, jv1)
    assert v1["verdict"] == "promoted" and v1["version"] == 1 and not v1["warm_start"]
    _same_promoted(ours, theirs)
    assert ours.run_cycle() is None  # unchanged data: no run
    _write_chunk(ours.data_dir, "chunk-000.csv", 100, 1)
    _write_chunk(ours.data_dir, "chunk-001.csv", 200, 2)
    v2, jv2 = ours.run_cycle(), theirs.run_cycle()
    _same_verdict(v2, jv2)
    assert v2["verdict"] == "promoted" and v2["version"] == 2 and v2["warm_start"]
    _same_promoted(ours, theirs)
    assert ours.registry.active_version() == 2
    back = FactoryState.load(ours.workdir)
    assert back.run is None and back.current["version"] == 2
    assert [h["verdict"] for h in back.history] == ["promoted"] * 2
    assert set(back.ingested) == {"chunk-000.csv", "chunk-001.csv"}
    assert glob.glob(os.path.join(ours.workdir, "r0*")) == []  # the run's scratch is gone
    # the JAX package reads the port's state file
    jback = jfac["state"].FactoryState.load(ours.workdir)
    assert jback.history == back.history and jback.current == back.current


def test_kill_after_publish_never_double_publishes(jfac, tmp_path, monkeypatch):
    """A crash between the publish and the verdict replays the run; the
    dedupe key gives the same version back, and one model enters the
    registry."""
    results = []
    for sup, cls, params in zip(_supervisors(jfac, tmp_path),
                                (FactorySupervisor, jfac["supervisor"].FactorySupervisor),
                                (dict(TRAIN_PARAMS, device="cpu"), dict(TRAIN_PARAMS))):
        _write_chunk(sup.data_dir, "chunk-000.csv", 300, 0)
        monkeypatch.setattr(sup, "_eval_gate",
                            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("killed")))
        with pytest.raises(RuntimeError, match="killed"):
            sup.run_cycle()
        assert sup.registry.latest_version() == 1 and sup.registry.active_version() is None
        mid = FactoryState.load(sup.workdir)
        assert mid.run is not None and mid.run["candidate_version"] == 1
        again = cls(sup.data_dir, sup.workdir, sup.registry_dir, params=params, **FACTORY_KNOBS)
        verdict = again.run_cycle()
        assert verdict["run_id"] == mid.run["run_id"]
        assert [m["version"] for m in again.registry.list_models()] == [1]
        assert again.registry.active_version() == 1
        assert FactoryState.load(sup.workdir).run is None
        results.append((verdict, again))
        os.remove(os.path.join(sup.data_dir, "chunk-000.csv"))
    _same_verdict(results[0][0], results[1][0])
    _same_promoted(results[0][1], results[1][1])


def test_eval_gate_rollback_records_verdict(jfac, tmp_path, monkeypatch):
    """A regressed candidate is quarantined with its reason, the active
    version holds, and the next retrain warm-starts from the last good
    model."""
    ours, theirs = _supervisors(jfac, tmp_path)
    _write_chunk(ours.data_dir, "chunk-000.csv", 300, 0)
    assert ours.run_cycle()["verdict"] == theirs.run_cycle()["verdict"] == "promoted"
    _write_chunk(ours.data_dir, "chunk-001.csv", 150, 1)

    def scripted(model_path, data_path):
        if os.sep + "models" + os.sep in model_path:
            return {"name": "binary_error", "value": 0.02}  # the promoted baseline
        return {"name": "binary_error", "value": 0.40}  # the candidate

    verdicts = []
    for sup in (ours, theirs):
        real = sup._eval_metric
        monkeypatch.setattr(sup, "_eval_metric", scripted)
        verdicts.append(sup.run_cycle())
        monkeypatch.setattr(sup, "_eval_metric", real)
    v, jv = verdicts
    assert v["verdict"] == jv["verdict"] == "rolled_back"
    assert v["reason"] == jv["reason"] and "regressed" in v["reason"]
    assert ours.registry.active_version() == 1
    assert ours.registry.quarantined() == {2: v["reason"]} == theirs.registry.quarantined()
    hist = FactoryState.load(ours.workdir).history
    assert [h["verdict"] for h in hist] == ["promoted", "rolled_back"]
    assert hist[-1]["detail"]["eval"]["reason"] == v["reason"]
    _write_chunk(ours.data_dir, "chunk-002.csv", 150, 2)
    v3, jv3 = ours.run_cycle(), theirs.run_cycle()
    _same_verdict(v3, jv3)
    assert v3["verdict"] == "promoted" and v3["version"] == 3 and v3["warm_start"]
    assert ours.registry.active_version() == 3
    _same_promoted(ours, theirs)


# ----------------------------------------------------------------------
# the canary
# ----------------------------------------------------------------------
def _canary_cycle(tmp_path):
    """v1 served by an in-process replica behind the port's proxy; an
    appended chunk's warm retrain is published inactive, canaried on a
    spawned replica pinned to it, promoted; no client request fails, and
    the canary route is torn down."""
    data_dir, work, reg = (str(tmp_path / n) for n in ("data", "work", "reg"))
    os.makedirs(data_dir)
    _write_chunk(data_dir, "chunk-000.csv", 300, 0)
    params = dict(TRAIN_PARAMS, device="cpu")
    assert FactorySupervisor(data_dir, work, reg, params=params, **FACTORY_KNOBS
                             ).run_cycle()["verdict"] == "promoted"
    srv = make_server(registry_dir=reg, port=0, warmup_max_rows=16, max_delay_ms=1.0,
                      registry_poll_ms=100.0, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    proxy = FleetProxy(("127.0.0.1", 0), [f"127.0.0.1:{srv.server_address[1]}"],
                       health_poll_s=0.2, retry_deadline_s=20.0)
    threading.Thread(target=proxy.serve_forever, args=(0.02,), daemon=True).start()
    port = proxy.server_address[1]
    body = "\n".join(json.dumps(list(map(float, r)))
                     for r in np.random.RandomState(21).randn(2, N_FEATURES)).encode()
    stop, seen = threading.Event(), {"n": 0, "errors": [], "versions": set()}

    def client():
        while not stop.is_set():
            try:
                r = urllib.request.urlopen(f"http://127.0.0.1:{port}/predict?model_version=1",
                                           data=body, timeout=60)
                vers = {json.loads(ln)["model_version"] for ln in r.read().decode().splitlines()}
                seen["versions"] |= vers
                if len(vers) != 1:
                    seen["errors"].append(f"mixed versions {vers}")
            except Exception as e:  # noqa: BLE001 - every failure is reported
                seen["errors"].append(f"{type(e).__name__}: {e}")
            seen["n"] += 1

    threads = [threading.Thread(target=client, daemon=True) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        _write_chunk(data_dir, "chunk-001.csv", 150, 1)
        sup = FactorySupervisor(data_dir, work, reg, params=params,
                                proxy=f"127.0.0.1:{port}", num_boost_round=5,
                                checkpoint_freq=2, debounce_ms=0.0, canary_fraction=0.5,
                                observe_s=2.0, min_requests=5)
        verdict = sup.run_cycle()
        assert verdict["verdict"] == "promoted" and verdict["version"] == 2, verdict
        assert verdict["warm_start"]
        canary = verdict["detail"]["canary"]
        assert canary["requests"] >= 5 and canary["errors"] == 0
        assert verdict["detail"]["fleet"]["max_stale_s"] == 0.0
        assert proxy.stats()["canary"] is None and sup.registry.canary_version() is None
        deadline = time.monotonic() + 30
        while 2 not in seen["versions"] and time.monotonic() < deadline:
            time.sleep(0.1)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        proxy.shutdown()
        proxy.server_close()
        srv.shutdown()
        srv.server_close()
    assert seen["errors"] == [], seen["errors"][:5]
    assert seen["n"] > 0 and 2 in seen["versions"]


def test_canary_promotes_under_traffic(tmp_path):
    _canary_cycle(tmp_path)


def test_canary_respawns_when_its_port_is_taken(tmp_path, monkeypatch):
    """The canary's first port is taken by another socket before the
    replica binds it: that replica exits, the supervisor respawns on a
    fresh port, and the cycle promotes as without the collision."""
    import socket

    from lightgbm_tpu_torch.factory import supervisor as sup_mod

    held = socket.socket()
    held.bind(("127.0.0.1", 0))
    held.listen(1)
    picks = []
    real = sup_mod._free_ports

    def free_ports(n, host="127.0.0.1"):
        picks.append(held.getsockname()[1] if not picks else real(n, host)[0])
        return picks[-1:]

    monkeypatch.setattr(sup_mod, "_free_ports", free_ports)
    try:
        _canary_cycle(tmp_path)
    finally:
        held.close()
    assert len(picks) == 2 and picks[0] != picks[1], picks


def test_free_ports_bind_below_the_ephemeral_range():
    import socket

    from lightgbm_tpu_torch.serve import fleet as tfleet

    ports = tfleet._free_ports(4)
    assert len(set(ports)) == 4
    rng = tfleet._ephemeral_range()
    if rng is not None:
        assert all(1024 <= p < rng[0] for p in ports), (ports, rng)
    for p in ports:
        with socket.socket() as s:
            s.bind(("127.0.0.1", p))


def test_wait_ready_stops_when_the_replica_exits():
    from lightgbm_tpu_torch.serve import fleet as tfleet

    proc = subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"])
    t0 = time.monotonic()
    assert not tfleet._wait_ready("127.0.0.1", tfleet._free_ports(1)[0], 60.0, proc)
    assert proc.returncode == 3 and time.monotonic() - t0 < 30


# ----------------------------------------------------------------------
# the CLI as a subprocess: SIGKILL mid-retrain, then resume
# ----------------------------------------------------------------------
def test_sigkill_mid_retrain_resumes_and_publishes_once(tmp_path):
    data_dir, work, reg = (str(tmp_path / n) for n in ("data", "work", "reg"))
    os.makedirs(data_dir)
    _write_chunk(data_dir, "chunk-000.csv", 2000, 0)
    rounds = 30
    cmd = [sys.executable, "-m", "lightgbm_tpu_torch", "factory", f"data={data_dir}",
           f"workdir={work}", f"registry={reg}", "max_cycles=1", "poll_ms=50", "debounce_ms=0",
           f"num_boost_round={rounds}", "checkpoint_freq=1", "canary_fraction=0",
           "objective=binary", "num_leaves=15", "min_data_in_leaf=5", "device=cpu"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120
        ckpts = []
        while time.monotonic() < deadline:
            assert proc.poll() is None, "the factory finished before the kill landed"
            ckpts = glob.glob(os.path.join(work, "r*", "ckpt", "ckpt_*.npz"))
            if len(ckpts) >= 2:
                break
            time.sleep(0.01)
        assert len(ckpts) >= 2, "no checkpoints before the deadline"
        proc.send_signal(signal.SIGKILL)
        assert proc.wait(timeout=30) == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
    mid = FactoryState.load(work)
    assert mid.run is not None
    assert ModelRegistry(reg).active_version() is None
    out = subprocess.run(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         timeout=300)
    text = out.stdout.decode(errors="replace")
    assert out.returncode == 0, text[-2000:]
    saves = [int(m) for m in re.findall(r"Checkpoint saved at iteration (\d+)", text)]
    assert saves and saves[0] > 1, f"the restart checkpointed from iteration {saves[:1]}"
    registry = ModelRegistry(reg)
    assert [m["version"] for m in registry.list_models()] == [1]
    assert registry.active_version() == 1
    done = FactoryState.load(work)
    assert done.run is None and [h["run_id"] for h in done.history] == [mid.run["run_id"]]
    assert done.history[0]["verdict"] == "promoted"
    assert registry.load(1).meta["num_trees"] == rounds
