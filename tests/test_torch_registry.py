"""The model registry of lightgbm_tpu_torch (serve/registry.py) against the
JAX package's: the same directory layout and manifest, so each package
serves the other's registry.

Held: a registry the port publishes into is listed, CRC-checked and
loaded by the JAX package, and the JAX package's by the port (the loaded
artifacts' payloads equal, predictions within 1e-5 relative); a JAX
registry is served by the port's server (``registry=``), which follows a
JAX publish into it by polling (the same-shape retrain swapped in place,
with no capture); a corrupt or torn version is refused by the CRC; a
corrupt upload never enters the manifest; the publish lock times out
while held and a stale one is broken; concurrent seeds publish one
version; routes, retention and the watch token.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.serve import artifact as jart
from lightgbm_tpu.serve import registry as jreg
from torch_serve_models import data, jax_trace_state_shim, model_text

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.serve import PackedPredictor, PredictorArtifact
from lightgbm_tpu_torch.serve import registry as treg
from lightgbm_tpu_torch.serve.server import make_server

RTOL = 1e-5


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


@pytest.fixture(scope="module")
def arts():
    text = model_text("binary")
    jb, tb = lgb.Booster(model_str=text), lgt.Booster(model_str=text, device="cpu")
    return jart.PredictorArtifact.from_booster(jb), PredictorArtifact.from_booster(tb), tb


def _rows():
    X, _ = data(5, 300)
    return np.nan_to_num(X, nan=0.25)


def _scaled(art, factor):
    fields = {f: np.array(getattr(art.arrays, f)) for f in type(art.arrays).FIELDS}
    fields["leaf_value"] = (fields["leaf_value"] * np.float32(factor)).astype(np.float32)
    return type(art)(type(art.arrays)(**fields), art.meta)


def _payload_equal(a, b):
    pa, pb = a._payload(), b._payload()
    assert sorted(pa) == sorted(pb)
    for k in pa:
        if k == "__meta__":
            assert json.loads(str(pa[k])) == json.loads(str(pb[k]))
        else:
            np.testing.assert_array_equal(np.asarray(pa[k]), np.asarray(pb[k]), err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_registry(writer, arts, tmp_path):
    ja, ta, tb = arts
    d = str(tmp_path / "reg")
    W, R = (treg, jreg) if writer == "port" else (jreg, treg)
    w = W.ModelRegistry(d)
    v1 = w.publish(ta if writer == "port" else ja)
    v2 = w.publish(_scaled(ta, 1.1) if writer == "port" else _scaled(ja, 1.1), activate=False)
    w.set_route("shadow", v2)
    r = R.ModelRegistry(d)
    assert (v1, v2) == (1, 2) and r.active_version() == 1
    assert r.routes() == {"shadow": 2} and r.route_version("shadow") == 2
    assert [m["version"] for m in r.list_models()] == [1, 2]
    assert r.list_models()[0]["active"] and r.list_models()[1]["routes"] == ["shadow"]
    assert r.watch_token() == w.watch_token()
    _payload_equal(r.load(1), ta)
    rows = _rows()
    got = (PackedPredictor(r.load(2), device="cpu").predict(rows) if writer == "jax"
           else np.asarray(jart.PackedPredictor(r.load(2)).predict(rows)))
    want = PackedPredictor(_scaled(ta, 1.1), device="cpu").predict(rows)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # the reader publishes on: versions continue, the writer sees them
    assert r.publish(ta if writer == "jax" else ja) == 3
    assert w.active_version() == 3 and w.latest_version() == 3


def test_port_serves_a_jax_registry_and_follows_its_publishes(arts, tmp_path):
    ja, ta, tb = arts
    d = str(tmp_path / "reg")
    jr = jreg.ModelRegistry(d)
    jr.publish(ja)
    srv = make_server(None, port=0, warmup_max_rows=64, max_delay_ms=1.0, device="cpu",
                      registry_dir=d, registry_poll_ms=20.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    port = srv.server_address[1]
    rows = _rows()[:20]
    body = ("\n".join(json.dumps(list(map(float, r))) for r in rows) + "\n").encode()

    def post():
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            return int(resp.headers["X-Model-Version"]), np.asarray(
                [json.loads(x) for x in resp.read().decode().split()])

    try:
        live = srv.predictor.predictor
        v, out = post()
        assert v == 1
        np.testing.assert_allclose(out, tb.predict(rows), rtol=1e-6)
        jr.publish(_scaled(ja, 1.1))  # the JAX package publishes a retrain
        deadline = time.monotonic() + 20
        while srv.predictor.version != 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        v, out = post()
        assert v == 2 and srv.predictor.predictor is live
        assert srv.predictor.last_swap["in_place"]
        assert srv.predictor.last_swap["new_compiles"] == 0
        np.testing.assert_allclose(
            out, PackedPredictor(_scaled(ta, 1.1), device="cpu").predict(rows), rtol=1e-6)
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_crc_refuses_a_damaged_version(damage, arts, tmp_path):
    _, ta, _ = arts
    r = treg.ModelRegistry(str(tmp_path))
    v = r.publish(ta)
    path = os.path.join(str(tmp_path), "v00000001.npz")
    raw = bytearray(open(path, "rb").read())
    if damage == "flip":
        raw[len(raw) // 2] ^= 0xFF
    else:
        raw = raw[:-100]
    open(path, "wb").write(bytes(raw))
    for reg in (r, jreg.ModelRegistry(str(tmp_path))):
        with pytest.raises(Exception, match="CRC"):
            reg.load(v)


def test_corrupt_upload_never_enters_the_manifest(tmp_path):
    r = treg.ModelRegistry(str(tmp_path))
    with pytest.raises(lgt.LightGBMError, match="not a readable"):
        r.publish_bytes(b"not an artifact")
    assert r.list_models() == [] and r.active_version() is None
    assert not [n for n in os.listdir(str(tmp_path)) if n.endswith(".npz")]


def test_publish_lock_times_out_and_breaks_stale(arts, tmp_path, monkeypatch):
    _, ta, _ = arts
    d = str(tmp_path)
    r = treg.ModelRegistry(d)
    with treg._PublishLock(d):
        with pytest.raises(TimeoutError, match="held for"):
            with treg._PublishLock(d, wait_s=0.1):
                pass
    # a lock left by a crashed publisher (older than LOCK_STALE_S) is broken
    lock = os.path.join(d, ".publish.lock")
    open(lock, "w").write("12345")
    old = time.time() - treg.LOCK_STALE_S - 5
    os.utime(lock, (old, old))
    assert r.publish(ta) == 1 and not os.path.exists(lock)


def test_concurrent_seeds_publish_one_version(arts, tmp_path):
    _, ta, _ = arts
    d = str(tmp_path)
    out = []
    threads = [threading.Thread(target=lambda: out.append(treg.ModelRegistry(d).seed(ta)))
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert out == [1] * 6 and len(treg.ModelRegistry(d).list_models()) == 1


def test_routes_retention_and_watch_token(arts, tmp_path):
    _, ta, _ = arts
    r = treg.ModelRegistry(str(tmp_path), keep_last=2)
    t0 = r.watch_token()
    v1 = r.publish(ta)
    assert r.watch_token() != t0
    r.set_route("tenant", v1)
    with pytest.raises(lgt.LightGBMError, match="invalid route name"):
        r.set_route("../x", v1)
    with pytest.raises(lgt.LightGBMError, match="unknown version"):
        r.set_route("tenant", 99)
    for _ in range(3):
        r.publish(ta)
    kept = [m["version"] for m in r.list_models()]
    assert v1 in kept and len(kept) == 3  # the routed version survives keep_last=2
    t1 = r.watch_token()
    r.activate(kept[1])
    assert r.active_version() == kept[1]
    assert r.remove_route("tenant") and not r.remove_route("tenant")
    assert r.watch_token() != t1 and r.routes() == {}
    r.set_canary(kept[-1])
    r.quarantine(kept[-1], "bad canary")
    assert r.quarantined() == {kept[-1]: "bad canary"} and r.canary_version() is None
    with pytest.raises(lgt.LightGBMError, match="cannot activate unknown version"):
        r.activate(1000)
