"""The serving fleet of lightgbm_tpu_torch (serve/breaker.py,
serve/fleet.py ``FleetProxy``, ``spawn_replicas``, ``python -m
lightgbm_tpu_torch fleet``) against the JAX package's.

- ``LatencyBreaker``: both packages' breakers fed the same observation
  sequences (latency outliers against the fleet median, error streaks,
  the half-open trial closing and re-opening) give the same transitions,
  states and snapshots step by step;
- ``FleetProxy``: each scenario of the JAX package's proxy drills
  (tests/test_servefault.py, tests/test_fleet.py) runs against in-process
  fake replicas through both packages' proxies, with the same outcomes:
  balancing and header relay, a dead backend ejected and retried, 503
  re-routing and relaying, the forwarded deadline budget and the bounded
  504, hedging and its budget, overload shedding with ``Retry-After``,
  canary ejection, and the tried-set bound;
- one subprocess smoke: two ``device=cpu`` replicas on a shared registry
  behind the port's proxy, a same-shape retrain published through the
  proxy and one replica SIGKILLed under closed-loop traffic: no failed
  request, every answer stamped with one version and equal to that
  version's predictions, the survivor on the new version.

The JAX package's fleet module imports obs/compilewatch, which needs the
jax 0.9 ``trace_state_clean`` shim: the module fixture sets it before the
import.
"""

import importlib
import json
import signal
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import jax
import jax._src.core

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.serve import breaker as tbreaker
from lightgbm_tpu_torch.serve import fleet as tfleet
from lightgbm_tpu_torch.serve.artifact import PackedPredictor, PredictorArtifact
from lightgbm_tpu_torch.serve.registry import ModelRegistry


@pytest.fixture(scope="module")
def jfleet():
    """The JAX package's fleet module, imported under the shim."""
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    mod = importlib.import_module("lightgbm_tpu.serve.fleet")
    yield mod
    if not had:
        del jax.core.trace_state_clean


@pytest.fixture(scope="module", params=["port", "jax"])
def fleet_mod(request, jfleet):
    return tfleet if request.param == "port" else jfleet


# ----------------------------------------------------------------------
# circuit breakers, step by step against the JAX package's
# ----------------------------------------------------------------------
SEQUENCES = {
    # (k, m, open_s, [(addr, elapsed_s, ok) | ("sleep", s) | ("begin", addr)])
    "latency outlier": (3.0, 3, 60.0, [(a, 0.01, True) for a in "abc" for _ in range(4)]
                        + [("d", 1.0, True)] * 3 + [("a", 0.01, True)]),
    "error streak": (3.0, 2, 60.0, [("x", 0.01, False), ("x", 0.01, False), ("x", 0.5, True)]),
    "streak broken": (3.0, 3, 60.0, [("x", 0.01, False), ("x", 0.01, False),
                                     ("x", 0.01, True), ("x", 0.01, False), ("x", 0.01, False),
                                     ("x", 0.01, False)]),
    "half open": (3.0, 2, 0.05, [("a", 0.01, True), ("b", 0.01, True), ("c", 0.01, True),
                                 ("x", 0.01, False), ("x", 0.01, False), ("sleep", 0.07),
                                 ("begin", "x"), ("x", 0.012, True), ("x", 0.01, False),
                                 ("x", 0.01, False), ("sleep", 0.07), ("begin", "x"),
                                 ("x", 0.01, False), ("sleep", 0.07), ("begin", "x"),
                                 ("x", 0.9, True), ("sleep", 0.07), ("begin", "x"),
                                 ("x", 0.011, True)]),
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_breaker_equals_jax_step_by_step(name, jfleet):
    jbreaker = importlib.import_module("lightgbm_tpu.serve.breaker")
    k, m, open_s, steps = SEQUENCES[name]
    tb = tbreaker.LatencyBreaker(k=k, m=m, open_s=open_s)
    jb = jbreaker.LatencyBreaker(k=k, m=m, open_s=open_s)
    transitions = []
    for step in steps:
        if step[0] == "sleep":
            time.sleep(step[1])
            continue
        if step[0] == "begin":
            assert tb.trial_eligible(step[1]) == jb.trial_eligible(step[1])
            tb.begin_attempt(step[1])
            jb.begin_attempt(step[1])
        else:
            got, want = tb.observe(*step), jb.observe(*step)
            assert got == want, (step, got, want)
            transitions.append(got)
        addr = step[1] if step[0] == "begin" else step[0]
        assert tb.state(addr) == jb.state(addr)
        assert tb.trial_eligible(addr) == jb.trial_eligible(addr)
        assert tb.open_count() == jb.open_count()
        assert tb.snapshot() == jb.snapshot()
    assert any(transitions), "the sequence made no transition"


# ----------------------------------------------------------------------
# the proxy against in-process fake replicas, through both packages
# ----------------------------------------------------------------------
class _Backend:
    """Replica double: /readyz 200 always, /predict answers a canned
    version after an optional delay, or 503 (a draining replica); records
    every X-Deadline-Ms it sees."""

    def __init__(self, version=1, delay_s=0.0, always_503=False):
        fake = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, headers=()):
                self.send_response(code)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._send(200 if self.path == "/readyz" else 404, b"{}\n")

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length") or 0))
                with fake.lock:
                    fake.deadlines.append(self.headers.get("X-Deadline-Ms"))
                if fake.delay_s > 0:
                    time.sleep(fake.delay_s)
                if fake.always_503:
                    self._send(503, b'{"error": "draining"}\n')
                else:
                    self._send(200, b"0.5\n", [("X-Model-Version", str(fake.version))])

        self.version, self.delay_s, self.always_503 = version, delay_s, always_503
        self.lock = threading.Lock()
        self.deadlines = []
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.addr = f"127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, args=(0.02,), daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class _Fleet:
    """A proxy of ``mod`` over fake backends, torn down on exit."""

    def __init__(self, mod, backends, **kw):
        kw.setdefault("health_poll_s", 0.1)
        kw.setdefault("retry_deadline_s", 5.0)
        self.backends = backends
        self.proxy = mod.FleetProxy(("127.0.0.1", 0), [b.addr for b in backends], **kw)
        threading.Thread(target=self.proxy.serve_forever, args=(0.02,), daemon=True).start()
        self.port = self.proxy.server_address[1]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.proxy.shutdown()
        self.proxy.server_close()
        for b in self.backends:
            b.stop()

    def predict(self, deadline_ms=None):
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}/predict",
                                     data=b"[1.0, 2.0]\n")
        if deadline_ms is not None:
            req.add_header("X-Deadline-Ms", str(deadline_ms))
        try:
            r = urllib.request.urlopen(req, timeout=30)
            return r.status, r.headers.get("X-Model-Version"), None
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Retry-After"), json.loads(e.read() or b"{}")

    def stats(self):
        return json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{self.port}/fleet/stats", timeout=30).read())


def test_balances_and_relays_headers(fleet_mod):
    with _Fleet(fleet_mod, [_Backend(version=7), _Backend(version=7)]) as f:
        assert {f.predict()[:2] for _ in range(8)} == {(200, "7")}
        st = f.stats()
        assert st["healthy"] == 2 and all(b["requests"] > 0 for b in st["backends"])


def test_dead_backend_ejected_and_retried(fleet_mod):
    backends = [_Backend(), _Backend()]
    with _Fleet(fleet_mod, backends) as f:
        backends[0].stop()  # connection refused from now on
        backends[0].stop = lambda: None
        assert [f.predict()[0] for _ in range(6)] == [200] * 6
        deadline = time.monotonic() + 5
        while f.stats()["healthy"] != 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert f.stats()["healthy"] == 1


def test_503_reroutes_and_all_503_relayed(fleet_mod):
    with _Fleet(fleet_mod, [_Backend(always_503=True), _Backend()], policy="rr") as f:
        assert [f.predict()[0] for _ in range(6)] == [200] * 6
    with _Fleet(fleet_mod, [_Backend(always_503=True)]) as f:
        assert f.predict()[0] == 503


def test_deadline_forwarded_and_bounded_504(fleet_mod):
    b = _Backend()
    with _Fleet(fleet_mod, [b]) as f:
        assert f.predict(deadline_ms=5000)[0] == 200 and f.predict()[0] == 200
        assert 0 < float(b.deadlines[0]) <= 5000 and b.deadlines[1] is None
    with _Fleet(fleet_mod, [_Backend(delay_s=0.5)]) as f:
        t0 = time.monotonic()
        code, _, body = f.predict(deadline_ms=200)
        assert code == 504 and "deadline" in body["error"]
        assert time.monotonic() - t0 < 2.0
        assert f.stats()["deadline_rejected"] >= 1


def test_hedge_rescues_a_slow_backend(fleet_mod):
    slow, fast = _Backend(version=1, delay_s=0.6), _Backend(version=2)
    with _Fleet(fleet_mod, [slow, fast], policy="rr", hedge_delay_ms=40.0,
                hedge_budget_pct=100.0) as f:
        t0 = time.monotonic()
        assert [f.predict()[0] for _ in range(6)] == [200] * 6
        assert time.monotonic() - t0 < 3.0
        h = f.stats()["hedges"]
        assert h["launched"] >= 1 and h["wins"] == h["launched"]


def test_hedge_knobs_and_budget(fleet_mod):
    with _Fleet(fleet_mod, [_Backend(), _Backend()], hedge_delay_ms=-1.0) as f:
        p = f.proxy
        assert p.hedge_delay_s() is None
        p.hedge_delay_ms = 75.0
        assert p.hedge_delay_s() == pytest.approx(0.075)
        p.hedge_delay_ms = 0.0
        assert p.hedge_delay_s() == pytest.approx(0.05)
        for _ in range(40):
            p._lat_window.observe(0.2)
        assert p.hedge_delay_s() == pytest.approx(0.2)
        p.hedge_budget_pct = 10.0
        assert [p.take_hedge_token() for _ in range(6)] == [True] * 5 + [False]
        p._fwd_requests = 1000
        assert p.take_hedge_token()
        p.hedge_budget_pct = 0.0
        assert not p.take_hedge_token()
    with _Fleet(fleet_mod, [_Backend()], hedge_delay_ms=50.0) as f:
        assert f.proxy.hedge_delay_s() is None  # one backend never hedges


def test_overload_sheds_with_retry_after(fleet_mod):
    with _Fleet(fleet_mod, [_Backend(delay_s=0.4)], max_concurrent=1, max_queue=0,
                hedge_delay_ms=-1.0) as f:
        results = []
        threads = [threading.Thread(target=lambda: results.append(f.predict()))
                   for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        codes = sorted(r[0] for r in results)
        assert codes[0] == 200 and 503 in codes
        assert all(r[1] == "1" for r in results if r[0] == 503)
        assert f.stats()["overload"]["shed"] >= 1
    with _Fleet(fleet_mod, [_Backend(delay_s=0.15)], max_concurrent=1, max_queue=4,
                hedge_delay_ms=-1.0) as f:
        results = []
        threads = [threading.Thread(target=lambda: results.append(f.predict()[0]))
                   for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert results == [200, 200, 200]  # queued, not shed


def test_dead_canary_is_ejected(fleet_mod):
    canary = _Backend(version=9)
    canary.stop()
    with _Fleet(fleet_mod, [_Backend(version=1)]) as f:
        f.proxy.set_canary(canary.addr, fraction=1.0)
        assert f.predict()[:2] == (200, "1")
        assert not f.proxy.canary.healthy
        t0 = time.monotonic()
        assert {f.predict()[:2] for _ in range(5)} == {(200, "1")}
        assert time.monotonic() - t0 < 1.0


def test_tried_set_bound(fleet_mod):
    a, b = _Backend(), _Backend()
    with _Fleet(fleet_mod, [a, b]) as f:
        p = f.proxy
        assert p.has_untried(set()) and p.has_untried({a.addr})
        assert not p.has_untried({a.addr, b.addr})
        p.eject(p.backends[0])
        assert not p.has_untried({b.addr}) and p.has_untried({a.addr})


def test_fleet_cli_needs_a_model_or_backends(capsys, monkeypatch):
    # the usage line is a warning: at the default verbosity, whatever an
    # earlier test in this process left the log level at
    from lightgbm_tpu_torch.utils.log import Log

    monkeypatch.setattr(Log, "_level", 1)
    assert cli.main(["fleet", "device=cpu"]) == 1
    assert "need model=" in capsys.readouterr().out


# ----------------------------------------------------------------------
# subprocess smoke: two CPU replicas, a swap and a SIGKILL
# ----------------------------------------------------------------------
def _scaled(art, factor):
    fields = {f: np.array(getattr(art.arrays, f)) for f in type(art.arrays).FIELDS}
    fields["leaf_value"] = (fields["leaf_value"] * np.float32(factor)).astype(np.float32)
    return type(art)(type(art.arrays)(**fields), art.meta)


def test_two_cpu_replicas_survive_a_swap_and_a_kill(tmp_path):
    import io

    rng = np.random.default_rng(0)
    X = rng.standard_normal((600, 6))
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float64)
    bst = lgt.train(dict(objective="binary", num_leaves=7, verbose=-1), lgt.Dataset(X, label=y),
                    5, device="cpu")
    art = PredictorArtifact.from_booster(bst)
    retrain = _scaled(art, 1.75)
    rows = X[:3]
    want = {1: PackedPredictor(art, device="cpu").predict(rows),
            2: PackedPredictor(retrain, device="cpu").predict(rows)}
    reg = str(tmp_path / "reg")
    ModelRegistry(reg).publish(art)
    procs = tfleet.spawn_replicas(2, {"registry": reg, "warmup_max_rows": "16",
                                      "max_delay_ms": "1", "registry_poll_ms": "100"},
                                  device="cpu")
    proxy = None
    try:
        for _, port in procs:
            assert tfleet._wait_ready("127.0.0.1", port, 25.0), f"replica {port} not ready"
        proxy = tfleet.FleetProxy(("127.0.0.1", 0), [f"127.0.0.1:{p}" for _, p in procs],
                                  health_poll_s=0.2, retry_deadline_s=20.0)
        threading.Thread(target=proxy.serve_forever, args=(0.02,), daemon=True).start()
        port = proxy.server_address[1]
        body = "\n".join(json.dumps(list(map(float, r))) for r in rows).encode()
        stop = time.monotonic() + 5.0
        lock = threading.Lock()
        seen = {"n": 0, "errors": [], "versions": set()}

        def client():
            while time.monotonic() < stop:
                try:
                    r = urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/predict?model_version=1", data=body,
                        timeout=30)
                    lines = [json.loads(ln) for ln in r.read().decode().splitlines()]
                    vers = {ln["model_version"] for ln in lines}
                    err = None
                    if len(vers) != 1 or next(iter(vers)) not in want:
                        err = f"versions {vers}"
                    elif not np.allclose([ln["prediction"] for ln in lines],
                                         want[next(iter(vers))], rtol=1e-6, atol=1e-6):
                        err = f"v{vers} answer is not that version's"
                except Exception as e:  # noqa: BLE001 - every failure is reported
                    err = f"{type(e).__name__}: {e}"
                    vers = set()
                with lock:
                    seen["n"] += 1
                    if err:
                        seen["errors"].append(err)
                    else:
                        seen["versions"] |= vers

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        buf = io.BytesIO()
        retrain.save_to_bytes(buf)
        r = urllib.request.urlopen(f"http://127.0.0.1:{port}/models", data=buf.getvalue(),
                                   timeout=30)
        assert json.loads(r.read())["version"] == 2
        time.sleep(1.0)
        procs[0][0].send_signal(signal.SIGKILL)
        for t in threads:
            t.join(timeout=60)
        assert seen["errors"] == [], seen["errors"][:5]
        assert seen["n"] > 20 and 2 in seen["versions"]
        st = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{procs[1][1]}/stats",
                                               timeout=30).read())
        assert st["model_version"] == 2
    finally:
        if proxy is not None:
            proxy.shutdown()
            proxy.server_close()
        for p, _ in procs:
            p.kill()
            p.wait(timeout=30)
