"""Serving in lightgbm_tpu_torch (serve/: artifacts, bucketed predictors,
the microbatcher, the hot-swap slot, the HTTP server, the CLI's ``serve``)
against the JAX package, on the CPU (``device="cpu"``: the same code as on
the card, eagerly, with no CUDA graph).

The models are the JAX package's (tests/torch_serve_models.py: binary
with a categorical column, K=3 softmax, linear leaves), loaded by both
packages from one model text.  Held:
- ``bucket_for``, ``bucket_ladder`` and ``tree_shape_bucket`` equal the
  JAX functions over a sweep of sizes;
- artifact payloads (v1, v2 float16 and bfloat16, v3) equal array by
  array, and the meta equal; each package loads the other's ``.npz`` and
  the port refuses a future version, a corrupt, a truncated and an
  inconsistent file;
- ``PackedPredictor`` against JAX's, exact and quantized: the walk's
  leaves equal, scores within 1e-5 relative, quantized within
  ``drift_bound`` of exact; a same-shape artifact is adopted in place;
- the batcher (coalescing, shedding, queued timeout, errors, drain), the
  metrics families (rendered as JAX's), and the server in process:
  predictions, raw scores and dict rows, version stamping, 400/404/504,
  readiness, a fault hang, ``/metrics`` parsed by both packages, routes,
  a ``POST /models`` swap under concurrent requests (0 failures, the live
  buffers reused), drain; ``python -m lightgbm_tpu_torch serve`` as a
  process on a JAX-written artifact, to SIGTERM.
"""

import concurrent.futures as cf
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.obs import metrics as jmetrics
from lightgbm_tpu.serve import artifact as jart
from lightgbm_tpu.serve import compilecache as jcc
from torch_serve_models import data, jax_trace_state_shim, model_text

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.model.ensemble import split_hi_lo
from lightgbm_tpu_torch.obs import metrics as tmetrics
from lightgbm_tpu_torch.ops.predict import _leaves_raw
from lightgbm_tpu_torch.ops.qpredict import drift_bound, qleaves
from lightgbm_tpu_torch.serve import (MicroBatcher, PackedPredictor, PredictorArtifact,
                                      RequestTimeout, ServerOverloaded, SwappablePredictor)
from lightgbm_tpu_torch.serve import compilecache as tcc
from lightgbm_tpu_torch.serve.server import make_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
FLAVORS = [("binary", False), ("binary", "float16"), ("binary", "bfloat16"),
           ("multiclass", False), ("multiclass", "float16"), ("linear", False)]


@pytest.fixture(scope="module", autouse=True)
def jax_shim():
    with jax_trace_state_shim():
        yield


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boosters(name):
    text = model_text(name)
    return lgb.Booster(model_str=text), lgt.Booster(model_str=text, device="cpu")


def _rows(seed=5, n=500):
    X, _ = data(seed, n)
    T, _ = data(0, 200)
    rows = np.concatenate([X, T])
    rows[3, 0] = 0.0
    rows[5, 1] = np.nan
    rows[7] = 0.0
    return rows


def _artifacts(name, quant):
    jb, tb = _boosters(name)
    kw = dict(quantized=True, leaf_dtype=quant) if quant else {}
    return (jart.PredictorArtifact.from_booster(jb, **kw),
            PredictorArtifact.from_booster(tb, **kw), jb, tb)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


# -- buckets ---------------------------------------------------------------
@pytest.mark.parametrize("min_bucket", [8, 1, 16, 2, 64])
def test_buckets_equal_jax(min_bucket):
    for n in list(range(0, 70)) + list(range(70, 9000, 37)):
        assert tcc.bucket_for(n, min_bucket) == jcc.bucket_for(n, min_bucket), n
    for m in (1, 7, 8, 9, 100, 4096, 5000):
        assert tcc.bucket_ladder(m, min_bucket) == jcc.bucket_ladder(m, min_bucket)
    for n in range(0, 3000, 7):
        assert tcc.tree_shape_bucket(n) == jcc.tree_shape_bucket(n)


# -- artifacts -------------------------------------------------------------
@pytest.mark.parametrize("name,quant", FLAVORS)
def test_artifact_payloads_equal_jax(name, quant):
    ja, ta, _, _ = _artifacts(name, quant)
    jp, tp = ja._payload(), ta._payload()
    assert sorted(jp) == sorted(tp)
    for k in jp:
        if k == "__meta__":
            assert json.loads(str(jp[k])) == json.loads(str(tp[k]))
            continue
        a = np.asarray(jp[k])
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        assert a.dtype == tp[k].dtype and a.shape == tp[k].shape, k
        np.testing.assert_array_equal(a, tp[k], err_msg=k)
    assert ta.flavor == {False: "linear" if name == "linear" else "exact"}.get(
        quant, "quantized")


@pytest.mark.parametrize("name,quant", FLAVORS)
def test_artifacts_load_across_packages(name, quant, tmp_path):
    ja, ta, jb, tb = _artifacts(name, quant)
    rows = _rows()
    jpath = ja.save(str(tmp_path / "jax"))
    tpath = ta.save(str(tmp_path / "port.npz"))
    from_jax = PredictorArtifact.load(jpath)
    from_port = jart.PredictorArtifact.load(tpath)
    assert from_jax.meta == ta.meta and from_port.meta == ja.meta
    got = PackedPredictor(from_jax, device="cpu").predict(rows, raw_score=True)
    want = np.asarray(jart.PackedPredictor(from_port).predict(rows, raw_score=True))
    _close(got, want)
    blob = io.BytesIO()
    ta.save_to_bytes(blob)
    assert PredictorArtifact.load_bytes(blob.getvalue()).meta == ta.meta


def _corrupt(path, tmp_path, how):
    raw = open(path, "rb").read()
    out = str(tmp_path / f"{how}.npz")
    if how == "truncated":
        raw = raw[: len(raw) // 2]
    elif how == "corrupt":
        raw = bytearray(raw)
        raw[len(raw) // 3: len(raw) // 3 + 64] = b"\x00" * 64
        raw = bytes(raw)
    elif how == "not_an_artifact":
        raw = b"hello, not a zip"
    with open(out, "wb") as f:
        f.write(raw)
    return out


@pytest.mark.parametrize("how", ["truncated", "corrupt", "not_an_artifact", "future",
                                 "missing_field", "flavor_mismatch", "no_meta"])
def test_artifact_refusals(how, tmp_path):
    _, ta, _, _ = _artifacts("binary", False)
    path = ta.save(str(tmp_path / "ok.npz"))
    if how in ("truncated", "corrupt", "not_an_artifact"):
        bad = _corrupt(path, tmp_path, how)
        match = "corrupt|truncated|not a readable"
    else:
        payload = ta._payload()
        meta = dict(ta.meta)
        if how == "future":
            meta["format_version"] = 99
            match = "NEWER"
        elif how == "missing_field":
            del payload["left_child"]
            match = "missing tree arrays"
        elif how == "flavor_mismatch":
            meta["format_version"] = 2
            match = "inconsistent"
        else:
            del payload["__meta__"]
            match = "no __meta__"
        if "__meta__" in payload:
            payload["__meta__"] = np.asarray(json.dumps(meta))
        bad = str(tmp_path / "bad.npz")
        np.savez(bad, **payload)
    with pytest.raises(lgt.LightGBMError, match=match):
        PredictorArtifact.load(bad)
    with pytest.raises(lgt.LightGBMError, match=match):
        PredictorArtifact.load_bytes(open(bad, "rb").read())


def test_linear_artifact_refuses_quantization():
    _, ta, _, _ = _artifacts("linear", False)
    with pytest.raises(lgt.LightGBMError, match="does not support linear-leaf"):
        ta.quantize()


# -- predictors ------------------------------------------------------------
@pytest.mark.parametrize("name,quant", FLAVORS)
def test_packed_predictor_matches_jax(name, quant):
    ja, ta, jb, tb = _artifacts(name, quant)
    rows = _rows()
    tp = PackedPredictor(ta, device="cpu")
    jp = jart.PackedPredictor(ja)
    assert tp.quantized == jp.quantized
    for raw_score in (True, False):
        _close(tp.predict(rows, raw_score=raw_score),
               np.asarray(jp.predict(rows, raw_score=raw_score)))
    # the walk's leaves are the reference's (Tree::GetLeaf)
    jleaves = np.asarray(jb.predict(rows, pred_leaf=True)).T
    raw = tp.raw
    if tp.quantized:
        codes = raw._host_input(rows[:, :raw.num_features])
        leaves = qleaves(torch.from_numpy(codes), raw.trees, raw.levels)
        K = ta.num_tree_per_iteration
        exact = tb.predict(rows, raw_score=True).reshape(len(rows), K).T
        arrays = _artifacts(name, False)[1].arrays
        got = tp.predict(rows, raw_score=True).reshape(len(rows), K).T
        for k in range(K):
            bound = drift_bound(np.asarray(arrays.leaf_value)[k::K], quant)
            assert np.abs(got[k] - exact[k]).max() <= bound
    else:
        planes = [torch.from_numpy(p) for p in split_hi_lo(rows[:, :raw.num_features])]
        leaves = _leaves_raw(planes, raw.trees, levels=raw.levels)
        # the same walk and sums as Booster.predict, at other batch shapes
        # (a float32 reduction's order may follow the shape): 1e-6
        _close(tp.predict(rows), tb.predict(rows), 1e-6)
    np.testing.assert_array_equal(leaves.numpy(), jleaves)


def test_warmup_pieces_and_calls():
    _, ta, _, tb = _artifacts("binary", False)
    rows = _rows()
    cold = PackedPredictor(ta, device="cpu")
    warm = PackedPredictor(ta, device="cpu")
    walks = []
    raw_walk = warm.raw._walk
    warm.raw._walk = lambda x: walks.append(x.shape[1]) or raw_walk(x)
    stats = warm.warmup(64)
    assert stats["buckets"] == [8, 16, 32, 64] and stats["compiles"] == 0
    assert warm.raw.warm_rows == 64 and warm.raw._piece_rows() == 64
    # 700 rows in pieces of the largest warmed bucket: 11 walks
    _close(warm.predict(rows), cold.predict(rows), 1e-6)
    # the warmup's 4 buckets, then 11 pieces of 64 rows (the last padded)
    assert walks == [8, 16, 32, 64] + [64] * 11
    assert cold.raw._piece_rows() >= 4096


@pytest.mark.parametrize("name", ["binary", "multiclass"])
def test_served_rows_equal_booster_predict_at_any_batch_size(name):
    """A row's score does not depend on how many rows share its batch:
    served alone, in small buckets or in pieces, and predicted by the
    Booster at any size, each equals the Booster's 700-row prediction bit
    for bit (the class sums' order on the CPU)."""
    _, ta, _, tb = _artifacts(name, False)
    X = _rows()
    want = tb.predict(X)
    p = PackedPredictor(ta, device="cpu")
    p.warmup(64)
    for n in (1, 3, 8, 17, 64, 129, 700):
        np.testing.assert_array_equal(p.predict(X[:n]), want[:n])
        np.testing.assert_array_equal(tb.predict(X[:n]), want[:n])


def _scaled(art, factor):
    """The artifact with every leaf value times ``factor``: a retrain of
    the same shape class."""
    fields = {f: np.array(getattr(art.arrays, f)) for f in type(art.arrays).FIELDS}
    fields["leaf_value"] = (fields["leaf_value"] * np.float32(factor)).astype(np.float32)
    return PredictorArtifact(type(art.arrays)(**fields), art.meta)


def test_adopt_same_shape_only():
    _, ta, _, _ = _artifacts("binary", False)
    rows = _rows()
    live = PackedPredictor(ta, device="cpu")
    new = PackedPredictor(_scaled(ta, 1.1), device="cpu")
    ptrs = [t.data_ptr() for t in live.raw._tensors()]
    assert live.can_adopt(new)
    live.adopt(new)
    assert [t.data_ptr() for t in live.raw._tensors()] == ptrs
    np.testing.assert_array_equal(live.predict(rows), new.predict(rows))  # same shapes
    other = PackedPredictor(_artifacts("multiclass", False)[1], device="cpu")
    quant = PackedPredictor(ta, quantized=True, device="cpu")
    assert not live.can_adopt(other) and not live.can_adopt(quant)
    with pytest.raises(ValueError, match="same shape class"):
        live.raw.adopt(other.raw)


@pytest.mark.parametrize("name,quant", FLAVORS)
def test_device_bytes_estimate(name, quant):
    _, ta, _, _ = _artifacts(name, quant)
    assert ta.device_bytes_estimate() == PackedPredictor(ta, device="cpu").device_bytes


def test_swappable_predictor_swaps():
    _, ta, _, _ = _artifacts("binary", False)
    rows = _rows()
    slot = SwappablePredictor(PackedPredictor(ta, device="cpu"), version=1)
    live = slot.predictor
    out, ver = slot.predict(rows)
    assert ver == 1
    st = slot.swap_to(_scaled(ta, 1.1), 2, warmup_max_rows=64)
    assert st["in_place"] and st["new_compiles"] == 0 and st["old_drained"]
    assert slot.predictor is live and slot.version == 2
    out2, ver2 = slot.predict(rows)
    assert ver2 == 2 and not np.array_equal(out, out2)
    st = slot.swap_to(_artifacts("multiclass", False)[1], 3, warmup_max_rows=64)
    assert not st["in_place"] and slot.predictor is not live and slot.version == 3
    assert slot.predict(rows)[0].shape == (len(rows), 3)


def test_shard_with_one_device_shards_nothing():
    _, ta, _, _ = _artifacts("binary", False)
    p = PackedPredictor(ta, device="cpu", shard=True)
    assert p.raw.bucket(9) == 16
    np.testing.assert_array_equal(p.predict(_rows()), PackedPredictor(ta, device="cpu")
                                  .predict(_rows()))


# -- metrics ---------------------------------------------------------------
def test_serving_metric_families_render_like_jax():
    regs = [tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()]
    obs = [0.0001, 0.003, 0.02, 0.7, 12.0, 0.003]
    for reg in regs:
        h = reg.histogram("lightgbm_tpu_serve_latency_seconds", "latency")
        b = reg.histogram("lightgbm_tpu_serve_batch_rows", "rows",
                          buckets=tmetrics.BATCH_BUCKETS)
        c = reg.labeled_counter("lightgbm_tpu_serve_version_requests_total", "reqs")
        lh = reg.labeled_histogram("lightgbm_tpu_serve_route_latency_seconds", "lat",
                                   label="model_route")
        for i, v in enumerate(obs):
            h.observe(v)
            b.observe(1 + 300 * i)
            c.labels(i % 2 + 1).inc()
            lh.labels("default" if i % 3 else "r1").observe(v)
        c.prune({"1"})
    assert regs[0].render() == regs[1].render()
    assert regs[0].snapshot() == regs[1].snapshot()
    for q in (0.5, 0.99):
        assert (regs[0]._metrics["lightgbm_tpu_serve_latency_seconds"].quantile(q)
                == regs[1]._metrics["lightgbm_tpu_serve_latency_seconds"].quantile(q))
    rq = [tmetrics.RollingQuantile(4), jmetrics.RollingQuantile(4)]
    for r in rq:
        for v in obs:
            r.observe(v)
    assert [r.quantile(0.95) for r in rq][0] == rq[1].quantile(0.95)
    assert rq[0].count() == 4


# -- batcher ---------------------------------------------------------------
def test_batcher_coalesces_concurrent_requests():
    _, ta, _, tb = _artifacts("binary", False)
    X = _rows()
    packed = PackedPredictor(ta, device="cpu")
    packed.warmup(256)
    mb = MicroBatcher(packed.predict, max_batch_size=128, max_delay_ms=20)
    try:
        with cf.ThreadPoolExecutor(16) as ex:
            futs = [ex.submit(mb.submit, X[i * 4:(i + 1) * 4]) for i in range(16)]
            outs = [f.result() for f in futs]
        exp = tb.predict(X[:64])
        for i, o in enumerate(outs):
            np.testing.assert_array_equal(o, exp[i * 4:(i + 1) * 4])
        st = mb.stats()
        assert st["requests"] == 16 and st["rows"] == 64
        assert st["batches"] < 16, "no coalescing happened"
        assert st["latency_p99_ms"] > 0
    finally:
        mb.close()


def _blocked(**kw):
    release = threading.Event()

    def slow_predict(batch):
        release.wait(5.0)
        return np.zeros(batch.shape[0])

    return MicroBatcher(slow_predict, **kw), release


def test_batcher_sheds_overload():
    mb, release = _blocked(max_batch_size=4, max_delay_ms=1, max_queue_rows=8)
    try:
        t = threading.Thread(target=lambda: mb.submit(np.zeros((8, 3)), timeout_ms=10_000),
                             daemon=True)
        t.start()
        time.sleep(0.2)
        with pytest.raises(ServerOverloaded):
            mb.submit(np.zeros((9, 3)))
        assert mb.stats()["shed"] == 1
    finally:
        release.set()
        mb.close()


def test_batcher_queued_timeout():
    mb, release = _blocked(max_batch_size=2, max_delay_ms=1)
    try:
        t = threading.Thread(target=lambda: mb.submit(np.zeros((2, 3)), timeout_ms=10_000),
                             daemon=True)
        t.start()
        with pytest.raises(RequestTimeout):
            mb.submit(np.zeros((2, 3)), timeout_ms=50)
        with pytest.raises(RequestTimeout, match="on arrival"):
            mb.submit(np.zeros((2, 3)), timeout_ms=0)
        assert mb.stats()["timeouts"] == 2
    finally:
        release.set()
        mb.close()


def test_batcher_error_propagates_and_info():
    def bad_predict(batch):
        raise ValueError("boom")

    mb = MicroBatcher(bad_predict, max_delay_ms=1)
    try:
        with pytest.raises(ValueError, match="boom"):
            mb.submit(np.zeros((2, 3)))
        assert mb.stats()["errors"] == 1
    finally:
        mb.close()
    mb = MicroBatcher(lambda b: (np.arange(b.shape[0]) * 2.0, 7), max_delay_ms=1)
    try:
        out, info = mb.submit_ex(np.zeros((3, 2)))
        assert info == 7 and np.array_equal(out, [0.0, 2.0, 4.0])
        assert np.array_equal(mb.submit(np.zeros((2, 2))), [0.0, 2.0])
    finally:
        mb.close()


def test_batcher_drain_settles_and_sheds():
    gate = threading.Event()

    def predict(batch):
        gate.wait(5.0)
        return np.zeros(batch.shape[0])

    mb = MicroBatcher(predict, max_batch_size=4, max_delay_ms=1)
    try:
        t = threading.Thread(target=lambda: mb.submit(np.zeros((2, 3)), timeout_ms=10_000),
                             daemon=True)
        t.start()
        time.sleep(0.1)
        assert mb.stats()["inflight_rows"] > 0
        done = {}
        dt = threading.Thread(target=lambda: done.update(ok=mb.drain(5.0)), daemon=True)
        dt.start()
        time.sleep(0.05)
        with pytest.raises(ServerOverloaded, match="draining"):
            mb.submit(np.zeros((1, 3)))
        gate.set()
        dt.join(timeout=10)
        t.join(timeout=10)
        assert not dt.is_alive() and done["ok"] is True
        st = mb.stats()
        assert st["inflight_rows"] == 0 and st["draining"] is False
    finally:
        gate.set()
        mb.close()


# -- server ----------------------------------------------------------------
def _post(port, body, path="/predict", headers=None, timeout=30):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _jsonl(rows):
    return ("\n".join(json.dumps([None if np.isnan(v) else float(v) for v in r])
                      for r in rows) + "\n").encode()


def _parse(text):
    return np.asarray([json.loads(ln) for ln in text.splitlines() if ln.strip()], np.float64)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    _, ta, _, tb = _artifacts("binary", False)
    path = ta.save(str(d / "m.npz"))
    srv = make_server(path, port=0, warmup_max_rows=256, max_delay_ms=1.0, device="cpu",
                      registry_dir=str(d / "reg"), registry_poll_ms=50.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, srv.server_address[1], ta, tb
    srv.shutdown()
    srv.server_close()


def _nan_free(rows):
    """JSON carries no NaN: requests send null, which float() refuses, so
    the HTTP tests use rows without missing values."""
    return np.nan_to_num(rows, nan=0.25)


def test_server_predicts_like_booster(served):
    srv, port, _, tb = served
    rows = _nan_free(_rows())[:300]
    code, headers, text = _post(port, _jsonl(rows))
    assert code == 200 and headers["X-Model-Version"] == str(srv.predictor.version)
    np.testing.assert_allclose(_parse(text), tb.predict(rows), rtol=1e-6)
    # raw scores, and rows as {"features": [...]}
    body = "\n".join(json.dumps({"features": list(map(float, r))}) for r in rows[:5])
    code, _, text = _post(port, body.encode(), "/predict?raw_score=1")
    assert code == 200
    np.testing.assert_allclose(_parse(text), tb.predict(rows[:5], raw_score=True),
                               rtol=1e-6)


def test_server_version_stamping(served):
    srv, port, _, _ = served
    code, headers, text = _post(port, _jsonl(_nan_free(_rows())[:4]),
                                "/predict?model_version=1")
    assert code == 200
    lines = [json.loads(ln) for ln in text.splitlines()]
    assert {ln["model_version"] for ln in lines} == {int(headers["X-Model-Version"])}
    assert all(isinstance(ln["prediction"], float) for ln in lines)


@pytest.mark.parametrize("body,path,code", [
    (b"[1, 2]\n[1, 2, 3]\n", "/predict", 400),   # ragged
    (b'"text"\n', "/predict", 400),              # not an array
    (b"", "/predict", 400),                       # empty
    (b"[1, 2,\n", "/predict", 400),               # bad JSON
    (b"[1]\n", "/nowhere", 404),
    (b"[1]\n", "/predict/no-such-route", 404),
])
def test_server_bad_requests(served, body, path, code):
    assert _post(served[1], body, path)[0] == code


def test_server_health_readiness_stats(served):
    srv, port, _, _ = served
    assert _get(port, "/healthz") == (200, json.dumps({"status": "ok"}) + "\n")
    assert _get(port, "/readyz")[0] == 200
    code, text = _get(port, "/stats")
    st = json.loads(text)
    assert code == 200 and st["ready"] and st["device"] == "cpu"
    assert st["compiles"]["predict_compiles"] == 0 and st["num_features"] == 8
    assert st["registry"]["active_version"] == srv.predictor.version


def test_server_deadline_504(served):
    port = served[1]
    code, _, text = _post(port, _jsonl([[0.0] * 8]), headers={"X-Deadline-Ms": "0"})
    assert code == 504 and "deadline" in text
    assert _post(port, _jsonl([[0.0] * 8]), headers={"X-Deadline-Ms": "5000"})[0] == 200


def test_server_fault_hang_and_error(served):
    port = served[1]
    assert _post(port, json.dumps({"spec": "bogus:1"}).encode(), "/fault")[0] == 400
    assert _post(port, json.dumps({"spec": "error:1"}).encode(), "/fault")[0] == 200
    assert _post(port, _jsonl([[0.0] * 8]))[0] == 500
    assert _post(port, json.dumps({"spec": "hang:1"}).encode(), "/fault")[0] == 200
    with pytest.raises((socket.timeout, TimeoutError, urllib.error.URLError)):
        _post(port, _jsonl([[0.0] * 8]), timeout=0.5)
    assert json.loads(_get(port, "/fault")[1])["injected"]["hang"] >= 1
    assert _get(port, "/readyz")[0] == 200  # the gray failure: still "ready"
    assert _post(port, json.dumps({"spec": ""}).encode(), "/fault")[0] == 200
    assert _post(port, _jsonl([[0.0] * 8]))[0] == 200


def test_server_metrics_parse_in_both_packages(served):
    port = served[1]
    _post(port, _jsonl([[0.0] * 8]))
    code, text = _get(port, "/metrics")
    assert code == 200
    for parse in (tmetrics.parse_text_format, jmetrics.parse_text_format):
        fams = parse(text)
        assert fams["lightgbm_tpu_serve_ready"]["samples"]["lightgbm_tpu_serve_ready"] == 1
        assert fams["lightgbm_tpu_serve_latency_seconds"]["type"] == "histogram"
        assert "lightgbm_tpu_cuda_graph_captures_total" in fams


def test_server_routes_and_admission(served):
    srv, port, ta, tb = served
    reg = srv.registry
    v = reg.publish(_artifacts("multiclass", False)[1], activate=False)
    code, _, text = _post(port, json.dumps({"route": "mc", "version": v}).encode(), "/routes")
    assert code == 200 and json.loads(text)["sync"]["routes"] == {"mc": v}
    rows = _nan_free(_rows())[:6]
    code, headers, text = _post(port, _jsonl(rows), "/predict/mc")
    assert code == 200 and headers["X-Model-Route"] == "mc"
    _, mtb = _boosters("multiclass")
    np.testing.assert_allclose(_parse(text), mtb.predict(rows), rtol=1e-6)
    st = json.loads(_get(port, "/routes")[1])
    assert st["routes"]["mc"]["version"] == v and st["admission"]["used_bytes"] > 0
    srv.route_budget_bytes = 1  # no room for another route
    reg.set_route("tiny", v)
    assert srv.sync_routes()["refused"]["tiny"].startswith("route 'tiny'")
    assert _post(port, _jsonl(rows), "/predict/tiny")[0] == 503
    srv.route_budget_bytes = 0
    for name in ("tiny", "mc"):
        assert _post(port, json.dumps({"route": name, "remove": True}).encode(),
                     "/routes")[0] == 200
    assert srv.routes == {}


def test_server_hot_swap_under_load(served):
    """POST /models of a same-shape retrain while 4 clients send requests:
    every request answered, each by one version with that version's
    predictions, and the live predictor's buffers reused (no capture)."""
    srv, port, ta, tb = served
    rows = _nan_free(_rows())[:64]
    live = srv.predictor.predictor
    ptrs = [t.data_ptr() for t in live.raw._tensors()]
    v0 = srv.predictor.version
    v1 = srv.registry.latest_version() + 1
    new = _scaled(ta, 1.1)
    expect = {v0: tb.predict(rows), v1: PackedPredictor(new, device="cpu").predict(rows)}
    stop = threading.Event()
    seen = []

    def client(i):
        while not stop.is_set():
            lo = (i * 7) % 48
            code, headers, text = _post(port, _jsonl(rows[lo:lo + 16]))
            seen.append((code, int(headers.get("X-Model-Version", -1)), lo, text))

    with cf.ThreadPoolExecutor(4) as ex:
        futs = [ex.submit(client, i) for i in range(4)]
        time.sleep(0.3)
        blob = io.BytesIO()
        new.save_to_bytes(blob)
        code, _, text = _post(port, blob.getvalue(), "/models")
        time.sleep(0.3)
        stop.set()
        for f in futs:
            f.result()
    assert code == 200
    swap = json.loads(text)["swap"]
    assert swap["in_place"] and swap["new_compiles"] == 0 and swap["to_version"] == v1
    assert srv.predictor.predictor is live
    assert [t.data_ptr() for t in live.raw._tensors()] == ptrs
    assert seen and all(c == 200 for c, _, _, _ in seen)
    versions = {v for _, v, _, _ in seen}
    assert versions == {v0, v1}
    for _, v, lo, text in seen:
        np.testing.assert_allclose(_parse(text), expect[v][lo:lo + 16], rtol=1e-6)
    listing = json.loads(_get(port, "/models")[1])
    assert listing["serving_version"] == v1 == listing["active_version"]


def test_server_accepts_jax_model_text_and_drains(tmp_path):
    text = model_text("binary")
    path = tmp_path / "model.txt"
    path.write_text(text)
    srv = make_server(str(path), port=0, warmup_max_rows=64, max_delay_ms=1.0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    port = srv.server_address[1]
    try:
        rows = _nan_free(_rows())[:10]
        code, _, out = _post(port, _jsonl(rows))
        assert code == 200
        np.testing.assert_allclose(_parse(out), np.asarray(lgb.Booster(model_str=text)
                                                           .predict(rows)), rtol=RTOL)
        assert srv.drain(5.0) is True
        t.join(timeout=10)
        assert not t.is_alive() and srv.drained and not srv.draining
    finally:
        srv.server_close()


def test_serve_without_model_errors(capsys):
    assert cli.main(["serve"]) == 1
    assert "no model file" in capsys.readouterr().out
    with pytest.raises(lgt.LightGBMError, match="need model="):
        make_server(None, port=0, device="cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli_process_on_jax_artifact(tmp_path):
    """``python -m lightgbm_tpu_torch serve`` on an artifact the JAX package
    wrote: ready after warmup, answers /predict like the JAX predictor,
    and SIGTERM drains it to exit 0."""
    ja, _, _, _ = _artifacts("multiclass", "float16")
    path = ja.save(str(tmp_path / "jax_q.npz"))
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-m", "lightgbm_tpu_torch", "serve",
                             f"model={path}", "device=cpu", f"port={port}",
                             "warmup_max_rows=64"], cwd=str(tmp_path), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            try:
                if _get(port, "/readyz")[0] == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.stdout.read()
            time.sleep(0.2)
        rows = _nan_free(_rows())[:20]
        code, headers, text = _post(port, _jsonl(rows))
        assert code == 200 and headers["X-Model-Version"] == "1"
        _close(_parse(text), np.asarray(jart.PackedPredictor(ja).predict(rows)))
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "draining" in out and "drained and stopped" in out
