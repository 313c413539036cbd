"""Observability of lightgbm_tpu_torch (obs/, utils/profiling.py): the
tracer, the flight recorder, the memory gauges, the Prometheus dump, the
split audit trail, ``report`` and ``report diff``, the phase timers and
the profiler capture.

- With tracing off, training builds no record and no flight ring.
- A fused run's ``iter`` records carry each iteration's CUDA-event (here
  host-clock) seconds of the chunk's one read, as ``fused_chunk``; a
  mask-grower run's the JAX package's phases; checkpoints add their
  spans, counter and event; the metrics dump parses and carries the
  mirrored checkpoint counter.
- ``report --json`` (the port's and the JAX package's ``summarize``)
  counts the iterations of a port trace; ``report diff`` finds the first
  divergent record; ``merge``, ``costs`` and ``bench-trend`` raise.
- The port's audit trail against the JAX package's at
  tests/test_torch_custom.py's dyadic configuration (both on the mask
  grower): integer fields equal, floats within 1e-5 relative.
- Every trace and metric name the port writes is in the JAX package's
  docs/OBSERVABILITY.md registry or in the port's README section.
"""

import json
import os
import re
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax._src.core

import lightgbm_tpu as lgb
from lightgbm_tpu.obs import report as jreport
from lightgbm_tpu.obs.audit import audit as jaudit

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.obs import flight, memory, metrics, report, tracer
from lightgbm_tpu_torch.obs.audit import audit
from lightgbm_tpu_torch.utils.profiling import PhaseTimers

REPO = Path(__file__).resolve().parents[1]


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


@pytest.fixture
def traced(tmp_path, monkeypatch):
    """Tracing on (LIGHTGBM_TPU_TRACE) for one test; yields a function
    that closes the sink and returns its records."""
    path = str(tmp_path / "run.jsonl")
    monkeypatch.setenv("LIGHTGBM_TPU_TRACE", path)

    def records():
        tracer.close()
        return report.load_trace(path)

    yield path, records
    tracer.close()


def _data(n=1200, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 6))
    y = (X[:, 0] - 0.6 * X[:, 1] + 0.3 * rng.standard_normal(n) > 0).astype(np.float64)
    return X, y


P = dict(objective="binary", num_leaves=7, learning_rate=0.3, min_data_in_leaf=10, verbose=-1)


def test_tracing_off_builds_no_record(monkeypatch):
    monkeypatch.delenv("LIGHTGBM_TPU_TRACE", raising=False)
    tracer.close()
    X, y = _data()
    ops = tracer.work_ops
    lgt.train(dict(P, bagging_fraction=0.8, bagging_freq=1), lgt.Dataset(X, label=y), 3,
              device="cpu")
    monkeypatch.setenv("LIGHTGBM_TPU_PGROW", "0")
    lgt.train(P, lgt.Dataset(X, label=y), 2, device="cpu")
    assert tracer.work_ops == ops and not tracer.enabled
    assert flight.recorder.ring is None


def test_fused_iteration_records(traced):
    path, records = traced
    X, y = _data()
    b = lgt.train(P, lgt.Dataset(X, label=y), 4, device="cpu")
    recs = records()
    assert recs[0]["ev"] == "meta"
    its = [r for r in recs if r["ev"] == "iter"]
    assert [r["iter"] for r in its] == [0, 1, 2, 3]
    secs = b.boosting.ptrainer.iter_seconds
    for r, s in zip(its, secs):
        assert r["wall_s"] == round(s, 6) and set(r["phases"]) == {"fused_chunk"}
        assert r["mode"] == "fused" and r["trees"] == 1 and r["leaves"] == 7
        assert "host_rss_mb" in r and "dev_mb" not in r  # no card here
    names = {r.get("name") for r in recs}
    assert {"booster_init", "train_begin", "tree", "valid_score"} <= names


def test_mask_grower_iteration_records(traced, monkeypatch):
    path, records = traced
    monkeypatch.setenv("LIGHTGBM_TPU_PGROW", "0")
    X, y = _data()
    ds = lgt.Dataset(X, label=y)
    lgt.train(dict(P, bagging_fraction=0.7, bagging_freq=1, metric="auc"), ds, 3,
              valid_sets=[lgt.Dataset(X[:300], label=y[:300], reference=ds)], verbose_eval=False,
              device="cpu")
    its = [r for r in records() if r["ev"] == "iter"]
    assert [r["iter"] for r in its] == [0, 1, 2]
    for r in its:
        assert set(r["phases"]) == {"boosting", "bagging", "tree", "train_score", "valid_score"}
        assert r["trees"] == 1 and r["leaves"] == 7 and 0 < r["bagged_rows"] < 1200
        assert r["compiles"] == 0  # nothing is captured or built on the CPU


def test_checkpoint_spans_metrics_and_report(traced, tmp_path, capsys):
    path, records = traced
    X, y = _data()
    d = str(tmp_path / "ck")
    lgt.train(P, lgt.Dataset(X, label=y), 4, device="cpu", checkpoint_dir=d, checkpoint_freq=2)
    lgt.train(P, lgt.Dataset(X, label=y), 6, device="cpu", checkpoint_dir=d, checkpoint_freq=2,
              checkpoint_resume="force")
    recs = records()
    spans = [r["name"] for r in recs if r["ev"] == "span"]
    assert spans.count("ckpt.capture") == 3 and spans.count("ckpt.serialize") == 3
    assert spans.count("ckpt.restore") == 1
    saved = [r for r in recs if r.get("name") == "ckpt.saved"]
    assert [r["iter"] for r in saved] == [2, 4, 6] and all(r["bytes"] > 0 for r in saved)
    assert [r["iter"] for r in recs if r.get("name") == "ckpt.restored"] == [4]
    # the Prometheus registry mirrors the checkpoint counter
    text = metrics.registry.render()
    parsed = metrics.parse_text_format(text)
    assert parsed["lightgbm_tpu_ckpt_bytes_total"]["type"] == "counter"
    assert {"lightgbm_tpu_cuda_graph_captures_total", "lightgbm_tpu_lazy_builds_total"} <= set(
        parsed)
    # report --json, the port's and the JAX package's
    assert cli.main(["report", path, "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["iterations"] == 6 and summary["checkpoints"]["saves"] == 3
    assert "fused_chunk" in summary["phases"]
    jsum = jreport.summarize(jreport.load_trace(path))
    assert jsum["iterations"] == 6 and "fused_chunk" in jsum["phases"]
    assert cli.main(["report", path]) == 0
    assert "iterations: 6" in capsys.readouterr().out


def test_report_diff_and_not_ported(tmp_path, capsys):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    recs = [{"ev": "split", "it": 0, "k": 0, "s": i, "gain": 1.0 + i} for i in range(3)]
    a.write_text("".join(json.dumps(r) + "\n" for r in recs))
    b.write_text(a.read_text() + "{torn")
    assert cli.main(["report", "diff", str(a), str(b)]) == 0
    assert "identical (3 records)" in capsys.readouterr().out
    recs[1]["gain"] = 2.5
    b.write_text("".join(json.dumps(r) + "\n" for r in recs))
    assert cli.main(["report", "diff", str(a), str(b), "--json"]) == 1
    div = json.loads(capsys.readouterr().out)
    assert div["index"] == 1 and div["fields"] == ["gain"]
    for sub, why in (("costs", "costmodel"), ("bench-trend", "benchmark")):
        with pytest.raises(NotImplementedError, match=why):
            cli.main(["report", sub, str(a)])
    # merge runs now: a file whose records carry no rank is rank 0 of its argument order
    assert cli.main(["report", "merge", str(a), "--json"]) == 0
    merged = json.loads(capsys.readouterr().out)
    assert merged["ranks"] == [0] and merged["aligned_iterations"] == 0


def test_cli_metrics_flight_and_profiler(tmp_path, monkeypatch, capsys):
    """The CLI's end-of-train metrics dump, the profiler capture
    (a Chrome trace of the window's iterations), SIGUSR1's flight dump and
    the fatal path's."""
    X, y = _data()
    np.savetxt(tmp_path / "t.tsv", np.column_stack([y, X]), delimiter="\t", fmt="%.6g")
    trace = tmp_path / "cli.jsonl"
    monkeypatch.setenv("LIGHTGBM_TPU_TRACE", str(trace))
    monkeypatch.setenv("LIGHTGBM_TPU_METRICS", str(tmp_path / "m.prom"))
    monkeypatch.setenv("LIGHTGBM_TPU_XPROF", str(tmp_path / "xprof"))
    monkeypatch.setenv("LIGHTGBM_TPU_XPROF_ITERS", "2")
    old_usr1 = signal.getsignal(signal.SIGUSR1)
    try:
        argv = ["task=train", "data=t.tsv", "objective=binary", "num_leaves=7", "num_trees=5",
                "min_data_in_leaf=10", "device=cpu", "checkpoint_freq=2", "output_model=m.txt"]
        cwd = os.getcwd()
        os.chdir(tmp_path)
        try:
            assert cli.main(argv) == 0
        finally:
            os.chdir(cwd)
        os.kill(os.getpid(), signal.SIGUSR1)
        crash = tmp_path / "cli.crash.jsonl"
        dumped = [json.loads(ln) for ln in crash.read_text().splitlines()]
        assert dumped[0]["reason"] == "sigusr1" and len(dumped) > 1
        assert cli.main(["task=train", "data=missing.tsv", "device=cpu"]) == 1
        assert json.loads(crash.read_text().splitlines()[0])["reason"] == "fatal_error"
    finally:
        signal.signal(signal.SIGUSR1, old_usr1)
        tracer.close()
    prom = metrics.parse_text_format((tmp_path / "m.prom").read_text())
    assert prom["lightgbm_tpu_ckpt_bytes_total"]["samples"]["lightgbm_tpu_ckpt_bytes_total"] > 0
    chrome = list((tmp_path / "xprof").glob("trace_*.json"))
    assert len(chrome) == 1 and json.loads(chrome[0].read_text())["traceEvents"]
    recs = report.load_trace(str(trace))
    cap = [r for r in recs if r.get("name") == "xprof.capture"]
    assert len(cap) == 1 and cap[0]["iters"] == 2 and cap[0]["skip"] == 1
    # the window's ends were chunk ends: 1, then 1 + 2
    assert "Checkpoint saved at iteration 4" in capsys.readouterr().out


def test_phase_timers_and_memory():
    t = PhaseTimers()
    t.enable()
    with t.phase("tree"):
        pass
    with t.phase("tree"):
        pass
    assert t.counts["tree"] == 2 and t.totals["tree"] >= 0
    g = memory.memory_gauges()
    assert g["host_rss_mb"] > 0 and memory.peaks()["host_rss_mb"] >= g["host_rss_mb"]
    assert memory.device_memory_mb() == {}  # CUDA is not initialized here


def _dyadic_fobj(preds, data):
    p = 1.0 / (1.0 + np.exp(-np.asarray(preds, np.float64)))
    g, h = p - data.get_label(), p * (1.0 - p)
    return np.round(g * 64) / 64, np.round(h * 64) / 64 + 1 / 64


def test_audit_trail_matches_jax(tmp_path):
    """tests/test_torch_custom.py's dyadic configuration, where both
    packages' mask growers build the same trees: the port's trail and the
    JAX package's, record for record."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((2000, 6)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.3 * rng.standard_normal(2000) > 0).astype(np.float32)
    params = dict(num_leaves=7, learning_rate=0.3, max_bin=31, min_data_in_leaf=20, verbose=-1)
    audit.configure(str(tmp_path / "port.jsonl"))
    jaudit.configure(str(tmp_path / "jax.jsonl"))
    try:
        lgt.train(dict(params), lgt.Dataset(X, label=y), 4, fobj=_dyadic_fobj, device="cpu")
        lgb.train(dict(params), lgb.Dataset(X, label=y), 4, fobj=_dyadic_fobj)
    finally:
        audit.close()
        jaudit.close()
    ta = report.load_trace(str(tmp_path / "port.jsonl"))
    ja = report.load_trace(str(tmp_path / "jax.jsonl"))
    assert len(ta) == len(ja) and sum(r["ev"] == "split" for r in ta) == 4 * 6
    for a, b in zip(ta, ja):
        assert a.keys() == b.keys()
        for k in a:
            va, vb = np.asarray(a[k]), np.asarray(b[k])
            if va.dtype.kind == "f" or vb.dtype.kind == "f":
                np.testing.assert_allclose(va, vb, rtol=1e-5, atol=0)
            else:
                assert a[k] == b[k], (k, a, b)
    assert cli.main(["report", "diff", str(tmp_path / "port.jsonl"),
                     str(tmp_path / "port.jsonl")]) == 0


def test_names_are_registered(traced, tmp_path, monkeypatch):
    """Every span, counter, gauge, event and phase name of a traced fused
    run with checkpoints and a resume, and of a traced mask-grower run
    with bagging, monotone constraints and linear leaves, and every metric
    of the registry."""
    path, records = traced
    X, y = _data()
    d = str(tmp_path / "ck")
    lgt.train(P, lgt.Dataset(X, label=y), 2, device="cpu", checkpoint_dir=d, checkpoint_freq=1)
    lgt.train(P, lgt.Dataset(X, label=y), 3, device="cpu", checkpoint_dir=d, checkpoint_freq=1,
              checkpoint_resume="force")
    monkeypatch.setenv("LIGHTGBM_TPU_PGROW", "0")
    lgt.train(dict(P, objective="regression", bagging_fraction=0.7, bagging_freq=1,
                   linear_tree=True, monotone_constraints=[1, 0, 0, 0, 0, 0]),
              lgt.Dataset(X, label=y), 2, device="cpu")
    recs = records()
    names = {r["name"] for r in recs if "name" in r}
    for r in recs:
        names.update((r.get("phases") or {}).keys())
    names.update(metrics.parse_text_format(metrics.registry.render()))
    assert {"fused_chunk", "ckpt.capture", "ckpt.restore", "tree.leaf_fit", "tree.monotone_clip",
            "lightgbm_tpu_ckpt_bytes_total", "lightgbm_tpu_tree_monotone_clip_total"} <= names
    registry = (REPO / "docs" / "OBSERVABILITY.md").read_text()
    readme = (REPO / "README.md").read_text()
    port = readme[readme.index("## PyTorch/CUDA port"):]
    documented = set(re.findall(r"`([A-Za-z0-9_.:]+)`", registry))
    documented |= set(re.findall(r"`([A-Za-z0-9_.:]+)`", port))
    # a mirrored counter or gauge is documented by its trace name
    # (``ckpt.bytes`` -> ``lightgbm_tpu_ckpt_bytes_total``)
    mirrors = {"lightgbm_tpu_" + metrics.sanitize(d) for d in documented}
    for name in sorted(names):
        assert (name in documented or name in mirrors
                or re.sub("_total$", "", name) in mirrors), name


def test_spans_nest_per_thread(traced):
    """A span on another thread (the transport's heartbeat) neither takes
    the main thread's span as its parent nor leaves it on the stack when
    the two close out of order."""
    import threading

    path, records = traced
    tracer.refresh_from_env()
    inside, release = threading.Event(), threading.Event()

    def beat():
        with tracer.span("net.heartbeat"):
            inside.set()
            release.wait(10)

    t = threading.Thread(target=beat)
    with tracer.span("net.allgather"):
        t.start()
        inside.wait(10)
    release.set()
    t.join(10)
    with tracer.span("after"):
        pass
    spans = {r["name"]: r for r in records() if r.get("ev") == "span"}
    for name in ("net.heartbeat", "net.allgather", "after"):
        assert spans[name]["parent"] is None and spans[name]["depth"] == 0, spans[name]
