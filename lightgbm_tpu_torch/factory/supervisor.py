"""Continuous-training supervisor — PyTorch counterpart of
lightgbm_tpu/factory/supervisor.py: ``python -m lightgbm_tpu_torch
factory``.

The loop: watch a data directory (factory/watch.py), warm-start a
checkpointed retrain, publish the candidate inactive to the serving
registry, gate it on the eval metric (and, with a proxy, on the fleet's
registry freshness and a canary slice of live traffic), then promote or
roll back and record the verdict:

  watch data dir ──▶ warm-start retrain ──▶ publish (inactive)
        ▲                (checkpointed)         │ dedupe_key=run_id
        │                                        ▼
   record verdict ◀── promote / rollback ◀── eval gate + canary
   (state+history)     activate/quarantine     (SLO window)

Crash safety is stage idempotence: the run record is durable before any
work starts, and a kill anywhere restarts into the same run, where every
stage converges (the retrain resumes from its checkpoint, the staging
file and model text are write-once, the publish dedupes on the run id,
promote and quarantine are idempotent registry writes).  So a SIGKILL
never publishes twice and never loses a recorded verdict.

The canary: a serve replica pinned to the candidate (``pin_version``)
takes ``canary_fraction`` of the proxy's /predict traffic (``POST
/fleet/canary``) for ``observe_s``; its per-version requests, errors and
p99 decide.  Promotion is one ``registry.activate`` (the fleet hot-swaps),
rollback a ``registry.quarantine`` with the reason in the history.

Training, evaluation and the canary replica run on the CUDA card unless
the training parameters say ``device=cpu`` (cli.py ``device_of``); the
JAX package has no such key, and the port adds nothing else.
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import signal
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import engine
from ..basic import Booster, Dataset
from ..ckpt.store import _atomic_write
from ..cli import device_of
from ..config import Config
from ..obs import tracer
from ..serve.artifact import PredictorArtifact
from ..serve.fleet import _free_ports, _wait_ready, spawn_replicas
from ..serve.registry import ModelRegistry
from ..utils.log import Log
from . import watch
from .state import FactoryState

DEFAULTS = {
    "poll_ms": 1000.0,       # data-dir scan interval
    "debounce_ms": 500.0,    # a changed file must be this quiet first
    "period_s": 0.0,         # 0 = retrain only on data change
    "num_boost_round": 20,   # NEW rounds per retrain (on top of init)
    "checkpoint_freq": 1,    # retrain checkpoint cadence (iterations)
    "canary_fraction": 0.2,  # slice of fleet /predict traffic diverted
    "observe_s": 5.0,        # bounded canary observation window
    "min_requests": 20,      # canary must see this many requests...
    "max_error_rate": 0.02,  # ...with at most this error rate...
    "p99_slo_ms": 5000.0,    # ...and at most this p99 latency
    "metric_rel_tol": 0.02,  # eval-gate relative regression tolerance
    "metric_abs_tol": 0.005,  # plus this absolute slack (near-zero rates)
    "eval_max_rows": 100000,  # eval-gate row cap (freshest rows win)
    "max_cycles": 0,         # stop after N completed runs (0 = forever)
    "canary_warmup_rows": 256,     # canary replica warmup ladder cap
    "ready_timeout_ms": 120000.0,  # canary replica readiness deadline
    "max_registry_stale_s": 30.0,  # refuse to promote against a fleet
                                   # replica whose registry swaps have
                                   # been failing longer (0 disables)
}

EXIT_OK = 0
EXIT_BAD_ARGS = 2


def _http_json(host: str, port: int, method: str, path: str,
               body=None, timeout_s: float = 5.0):
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout_s)
    try:
        payload = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise OSError(f"{method} {path} on {host}:{port} "
                          f"-> HTTP {resp.status}")
        return json.loads(data.decode("utf-8") or "null")
    finally:
        conn.close()


class FactorySupervisor:
    """One factory instance owns one (data_dir, workdir, registry)
    triple.  ``run_cycle`` drives at most one complete run; a run that
    was interrupted by a kill is re-entered and finished first."""

    def __init__(self, data_dir: str, workdir: str, registry_dir: str,
                 params: Optional[Dict] = None, proxy: Optional[str] = None,
                 host: str = "127.0.0.1", **knobs):
        unknown = set(knobs) - set(DEFAULTS)
        if unknown:
            Log.fatal("factory: unknown knob(s) %s (have: %s)",
                      sorted(unknown), sorted(DEFAULTS))
        self.opts = dict(DEFAULTS)
        self.opts.update(knobs)
        self.data_dir = data_dir
        self.workdir = workdir
        self.registry_dir = registry_dir
        os.makedirs(workdir, exist_ok=True)
        os.makedirs(os.path.join(workdir, "models"), exist_ok=True)
        self.registry = ModelRegistry(registry_dir)
        self.params = dict(params or {})
        self.proxy = proxy  # "host:port" front end, or None (no canary)
        self.host = host
        self.state = FactoryState.load(workdir)
        self.device = device_of({k: str(v) for k, v in self.params.items()})
        self._stop = threading.Event()
        self._eval_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def stop(self) -> None:
        self._stop.set()

    # -- trigger -------------------------------------------------------
    def _period_due(self) -> bool:
        p = float(self.opts["period_s"])
        return p > 0 and (time.time() - self.state.last_run_ts) >= p

    def run_cycle(self, force: bool = False) -> Optional[Dict]:
        """Drive one run to its verdict.  Returns the verdict record,
        or None when there is nothing to do (no data, no change, or a
        change still inside the debounce window)."""
        run = self.state.run
        if run is None:
            cur = watch.scan(self.data_dir)
            if not cur:
                return None
            delta = watch.changed(self.state.ingested, cur)
            if not delta and not self._period_due() and not force:
                return None
            if not watch.stable(cur, float(self.opts["debounce_ms"]) / 1e3):
                return None  # writer still appending; next poll retries
            self.state.retrain_seq += 1
            fp = watch.combined_fingerprint(cur)
            run = {
                "run_id": f"r{self.state.retrain_seq:06d}-{fp}",
                "fingerprint": fp,
                "files": cur,
                "changed": delta,
                "candidate_version": None,
                "warm_start": False,
                "t_start": round(time.time(), 3),
            }
            # durable BEFORE any work: a kill from here on restarts
            # into this same run instead of minting a new one
            self.state.run = run
            self.state.save()
            tracer.counter("factory.runs")
            Log.info("factory: run %s begins (%d file(s), %d changed)",
                     run["run_id"], len(run["files"]), len(delta))
        return self._drive(run)

    # -- the run pipeline ----------------------------------------------
    def _drive(self, run: Dict) -> Dict:
        run_dir = os.path.join(self.workdir, run["run_id"])
        os.makedirs(run_dir, exist_ok=True)
        with tracer.span("factory.retrain", run_id=run["run_id"]):
            model_path = self._retrain(run, run_dir)
        with tracer.span("factory.publish", run_id=run["run_id"]):
            version = self._publish(run, model_path)
        ok, detail = self._eval_gate(run, run_dir, model_path)
        if ok and self.proxy \
                and float(self.opts["max_registry_stale_s"]) > 0:
            ok, stale_detail = self._fleet_fresh()
            detail.update(stale_detail)
        if ok and self.proxy and float(self.opts["canary_fraction"]) > 0 \
                and float(self.opts["observe_s"]) > 0:
            with tracer.span("factory.canary", version=version):
                ok, canary_detail = self._canary(version)
            detail.update(canary_detail)
        return self._finish(run, run_dir, model_path, version, ok, detail)

    # -- fleet freshness gate ------------------------------------------
    def _fleet_fresh(self) -> Tuple[bool, Dict]:
        """A fleet replica whose registry swaps keep failing serves
        last-good no matter what we activate — promoting against it
        only *pretends* to ship the candidate.  Walk the proxy's
        healthy backends and refuse to promote while any reports
        ``registry.stale_seconds`` beyond the knob."""
        limit = float(self.opts["max_registry_stale_s"])
        proxy_host, _, proxy_port_s = self.proxy.rpartition(":")
        proxy_host, proxy_port = (proxy_host or "127.0.0.1",
                                  int(proxy_port_s))
        detail: Dict = {"fleet": {"max_registry_stale_s": limit,
                                  "stale_backends": {}}}
        det = detail["fleet"]
        try:
            st = _http_json(proxy_host, proxy_port, "GET", "/fleet/stats")
        except (OSError, ValueError) as e:
            det["reason"] = f"cannot read fleet stats: {e}"
            return False, detail
        worst = 0.0
        for b in (st or {}).get("backends", []):
            if not b.get("healthy"):
                continue  # reachability is the prober's problem
            host, _, port_s = str(b.get("addr", "")).rpartition(":")
            try:
                bs = _http_json(host or "127.0.0.1", int(port_s),
                                "GET", "/stats")
            except (OSError, ValueError):
                continue  # transiently unreachable: the prober will eject
            stale = float((bs or {}).get("registry", {})
                          .get("stale_seconds") or 0.0)
            if stale > 0:
                det["stale_backends"][b["addr"]] = round(stale, 1)
            worst = max(worst, stale)
        det["max_stale_s"] = round(worst, 1)
        if worst > limit:
            det["reason"] = (
                f"fleet registry staleness {worst:.1f}s > "
                f"{limit:.1f}s on {sorted(det['stale_backends'])} — an "
                f"activation would not reach those replicas; fix the "
                f"registry before promoting")
            tracer.event("factory.fleet_stale", max_stale_s=worst,
                         backends=sorted(det["stale_backends"]))
            return False, detail
        return True, detail

    def _stage_data(self, run: Dict, run_dir: str) -> str:
        """Concatenate the watched chunks (lexical order) into one
        write-once staging file — the frozen input of this run, immune
        to appends landing mid-retrain."""
        staging = os.path.join(run_dir, "train.data")
        if os.path.exists(staging):
            return staging
        tmp = f"{staging}.tmp.{os.getpid()}"
        with open(tmp, "wb") as out:
            for name in sorted(run["files"]):
                last = b"\n"
                with open(os.path.join(self.data_dir, name), "rb") as f:
                    while True:
                        chunk = f.read(1 << 20)
                        if not chunk:
                            break
                        out.write(chunk)
                        last = chunk[-1:]
                if last != b"\n":
                    out.write(b"\n")
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, staging)
        return staging

    def _retrain(self, run: Dict, run_dir: str) -> str:
        """Warm-started incremental retrain, checkpointed so a SIGKILL
        resumes mid-run instead of restarting.  The finished model text
        is write-once: a completed-then-killed retrain is skipped
        entirely on replay."""
        model_path = os.path.join(run_dir, "model.txt")
        if os.path.exists(model_path):
            return model_path
        staging = self._stage_data(run, run_dir)
        params = dict(self.params)
        params.setdefault("out_of_core", "auto")
        init = None
        cur = self.state.current
        if cur and os.path.exists(cur.get("model_path", "")):
            init = cur["model_path"]
        if init is not None:
            # continued training seeds scores from the raw matrix, which
            # the out-of-core streaming path never materializes — when
            # the accumulation outgrows memory, degrade to a cold (but
            # still out-of-core-capable) retrain rather than OOM
            from ..data.ingest import should_stream

            cfg = Config.from_params(
                {k: str(v) for k, v in params.items()})
            if should_stream(staging, cfg):
                Log.warning(
                    "factory: accumulated data now routes out-of-core; "
                    "warm start needs the raw matrix, so run %s retrains "
                    "cold", run["run_id"])
                init = None
        run["warm_start"] = init is not None
        train_set = Dataset(staging, params=dict(params))
        booster = engine.train(
            params, train_set,
            num_boost_round=int(self.opts["num_boost_round"]),
            init_model=init,
            checkpoint_dir=os.path.join(run_dir, "ckpt"),
            checkpoint_freq=int(self.opts["checkpoint_freq"]),
            verbose_eval=False,
            device=self.device,
        )
        _atomic_write(model_path, booster.model_to_string().encode())
        return model_path

    def _publish(self, run: Dict, model_path: str) -> int:
        """Publish the candidate INACTIVE; ``dedupe_key=run_id`` makes a
        kill between publish and the state write idempotent — the replay
        gets the already-claimed version back."""
        # packing only parses the model text: no device is needed
        artifact = PredictorArtifact.from_booster(
            Booster(model_file=model_path, device="cpu"))
        version = self.registry.publish(artifact, activate=False,
                                        dedupe_key=run["run_id"])
        run["candidate_version"] = int(version)
        self.state.save()
        return int(version)

    # -- eval gate -----------------------------------------------------
    def _load_eval(self, data_path: str) -> Tuple[np.ndarray, np.ndarray]:
        cached = self._eval_cache.get(data_path)
        if cached is not None:
            return cached
        from ..io.parser import load_text_file

        cfg = Config.from_params(
            {k: str(v) for k, v in self.params.items()})
        X, y = load_text_file(data_path, cfg)[:2]
        cap = int(self.opts["eval_max_rows"])
        if cap > 0 and len(X) > cap:
            X, y = X[-cap:], y[-cap:]  # freshest rows carry the signal
        out = (np.asarray(X, np.float64), np.asarray(y, np.float64))
        self._eval_cache = {data_path: out}  # one staging file at a time
        return out

    def _eval_metric(self, model_path: str, data_path: str) -> Dict:
        X, y = self._load_eval(data_path)
        pred = np.asarray(Booster(model_file=model_path,
                                  device=self.device).predict(X))
        if str(self.params.get("objective", "")).startswith("binary"):
            err = float(np.mean((pred > 0.5) != (y > 0.5)))
            return {"name": "binary_error", "value": err}
        first = pred.reshape(len(y), -1)[:, 0].astype(np.float64)
        return {"name": "l2", "value": float(np.mean((first - y) ** 2))}

    def _eval_gate(self, run: Dict, run_dir: str,
                   model_path: str) -> Tuple[bool, Dict]:
        """Candidate-vs-promoted metric on this run's frozen data: a
        regression beyond tolerance rolls back WITHOUT spending fleet
        traffic on a canary."""
        staging = os.path.join(run_dir, "train.data")
        cand = self._eval_metric(model_path, staging)
        detail: Dict = {"eval": {"metric": cand["name"],
                                 "candidate": round(cand["value"], 6),
                                 "baseline": None}}
        cur = self.state.current
        if not cur or not os.path.exists(cur.get("model_path", "")):
            return True, detail  # nothing to regress against
        base = self._eval_metric(cur["model_path"], staging)
        detail["eval"]["baseline"] = round(base["value"], 6)
        limit = base["value"] * (1.0 + float(self.opts["metric_rel_tol"])) \
            + float(self.opts["metric_abs_tol"])
        if cand["value"] > limit:
            detail["eval"]["reason"] = (
                f"{cand['name']} regressed: {cand['value']:.6g} vs "
                f"baseline {base['value']:.6g} (limit {limit:.6g})")
            return False, detail
        return True, detail

    # -- canary --------------------------------------------------------
    def _canary(self, version: int) -> Tuple[bool, Dict]:
        """Pin a one-off replica to the candidate, divert a slice of
        proxy traffic to it, and judge the per-version metrics over a
        bounded window.  Everything installed here is torn back down on
        every exit path — a crashed canary leaves no routing residue."""
        proxy_host, _, proxy_port_s = self.proxy.rpartition(":")
        proxy_host, proxy_port = proxy_host or "127.0.0.1", int(proxy_port_s)
        fraction = min(1.0, float(self.opts["canary_fraction"]))
        detail: Dict = {"canary": {"fraction": fraction,
                                   "window_s": float(self.opts["observe_s"])}}
        det = detail["canary"]
        port = _free_ports(1, self.host)[0]
        # retention-protect the candidate for the whole window
        self.registry.set_canary(int(version))
        proc = spawn_replicas(1, {
            "registry": self.registry_dir, "pin_version": int(version),
            "warmup_max_rows": int(self.opts["canary_warmup_rows"]),
            "max_delay_ms": 1, "registry_poll_ms": 1000,
        }, ports=[port], host=self.host, device=self.device)[0][0]
        installed = False
        try:
            if not _wait_ready(self.host, port,
                               float(self.opts["ready_timeout_ms"]) / 1e3):
                det["reason"] = "canary replica never became ready"
                return False, detail
            _http_json(proxy_host, proxy_port, "POST", "/fleet/canary",
                       {"addr": f"{self.host}:{port}", "fraction": fraction})
            installed = True
            deadline = time.monotonic() + float(self.opts["observe_s"])
            while time.monotonic() < deadline and not self._stop.is_set():
                time.sleep(min(0.2, max(deadline - time.monotonic(), 0.01)))
            stats = _http_json(self.host, port, "GET", "/stats")
            obs = (stats or {}).get("per_version", {}).get(str(version), {})
            requests = int(obs.get("requests", 0))
            errors = int(obs.get("errors", 0))
            total = requests + errors
            err_rate = errors / max(total, 1)
            p99 = float(obs.get("latency_p99_ms", 0.0))
            det.update({"requests": requests, "errors": errors,
                        "error_rate": round(err_rate, 5), "p99_ms": p99})
            if total < int(self.opts["min_requests"]):
                det["reason"] = (
                    f"only {total} canary request(s) in the {det['window_s']}"
                    f"s window (min_requests={int(self.opts['min_requests'])})"
                    " — cannot verify the SLO, refusing to promote blind")
                return False, detail
            if err_rate > float(self.opts["max_error_rate"]):
                det["reason"] = (
                    f"canary error rate {err_rate:.4f} > "
                    f"{float(self.opts['max_error_rate'])} "
                    f"({errors}/{total})")
                return False, detail
            if p99 > float(self.opts["p99_slo_ms"]):
                det["reason"] = (f"canary p99 {p99:.1f} ms > SLO "
                                 f"{float(self.opts['p99_slo_ms'])} ms")
                return False, detail
            return True, detail
        except OSError as e:
            det["reason"] = f"canary plumbing failed: {e}"
            return False, detail
        finally:
            if installed:
                try:
                    _http_json(proxy_host, proxy_port, "POST",
                               "/fleet/canary",
                               {"addr": None, "fraction": 0.0})
                except OSError:
                    Log.warning("factory: could not clear the proxy "
                                "canary route on %s", self.proxy)
            try:
                if self.registry.canary_version() == int(version):
                    self.registry.clear_canary()
            except Exception:
                pass
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()

    # -- verdict -------------------------------------------------------
    def _finish(self, run: Dict, run_dir: str, model_path: str,
                version: int, promoted: bool, detail: Dict) -> Dict:
        verdict = {
            "run_id": run["run_id"],
            "version": int(version),
            "verdict": "promoted" if promoted else "rolled_back",
            "warm_start": bool(run.get("warm_start")),
            "detail": detail,
            "t_start": run["t_start"],
            "t_end": round(time.time(), 3),
        }
        if promoted:
            kept = os.path.join(self.workdir, "models",
                                f"v{int(version):08d}.txt")
            if not os.path.exists(kept):
                with open(model_path, "rb") as f:
                    _atomic_write(kept, f.read())
            self.registry.activate(int(version))  # whole-fleet swap
            self.state.current = {
                "version": int(version), "model_path": kept,
                "metric": detail.get("eval", {}).get("candidate"),
            }
            tracer.counter("factory.promotions")
        else:
            reason = "unspecified regression"
            for block in ("canary", "fleet", "eval"):
                d = detail.get(block)
                if isinstance(d, dict) and d.get("reason"):
                    reason = d["reason"]
                    break
            verdict["reason"] = reason
            self.registry.quarantine(int(version), reason)
            if self.registry.active_version() == int(version):
                # a previous life of this run promoted before a kill and
                # this replay's verdict flipped: activate(older) is the
                # whole-fleet rollback
                older = [m["version"] for m in self.registry.list_models()
                         if int(m["version"]) != int(version)
                         and not m.get("quarantined")]
                if older:
                    self.registry.activate(max(older))
            tracer.counter("factory.rollbacks")
        tracer.event("factory.verdict", run_id=run["run_id"],
                     version=int(version), verdict=verdict["verdict"],
                     reason=verdict.get("reason"))
        # ONE durable write retires the run: ingest baseline, verdict
        # history, and run=None move together, so a kill here either
        # replays the whole (idempotent) verdict or sees it recorded
        self.state.ingested = dict(run["files"])
        self.state.last_run_ts = time.time()
        self.state.record_verdict(verdict)
        self.state.run = None
        self.state.save()
        shutil.rmtree(run_dir, ignore_errors=True)
        Log.info("factory: run %s -> %s (v%d)%s", run["run_id"],
                 verdict["verdict"], int(version),
                 f" — {verdict.get('reason')}" if not promoted else "")
        return verdict

    # -- loop ----------------------------------------------------------
    def run_forever(self) -> int:
        poll_s = max(float(self.opts["poll_ms"]), 10.0) / 1e3
        max_cycles = int(self.opts["max_cycles"])
        cycles = 0
        while not self._stop.is_set():
            verdict = self.run_cycle()
            if verdict is not None:
                cycles += 1
                if max_cycles and cycles >= max_cycles:
                    break
            self._stop.wait(poll_s)
        return cycles


def main(argv: List[str]) -> int:
    """``python -m lightgbm_tpu_torch factory data=DIR workdir=DIR
    registry=DIR [proxy=host:port] [knob=value ...] [training params]``.

    Knobs are the DEFAULTS keys; every other key=value is passed to
    training (objective=binary num_leaves=31 device=cpu ...).  Exit codes:
    0 = clean stop (SIGTERM or max_cycles), 2 = bad arguments; a crash
    exits non-zero and a restart resumes the interrupted run."""
    from ..cli import parse_argv

    if argv and argv[0] == "spot":
        # the preemptible-capacity loop (factory/spot.py) waits for the
        # elastic membership runtime
        from .spot import main as spot_main

        return spot_main(argv[1:])
    tracer.refresh_from_env()
    params = parse_argv(argv)
    data_dir = params.pop("data", None)
    workdir = params.pop("workdir", None)
    registry_dir = params.pop("registry", None)
    proxy = params.pop("proxy", None)
    host = params.pop("host", "127.0.0.1")
    if not (data_dir and workdir and registry_dir):
        Log.warning("factory: need data=DIR workdir=DIR registry=DIR "
                    "[proxy=host:port] [knob=value ...] [training params]")
        return EXIT_BAD_ARGS
    knobs = {}
    for k in list(params):
        if k in DEFAULTS:
            knobs[k] = type(DEFAULTS[k])(float(params.pop(k)))
    supervisor = FactorySupervisor(data_dir, workdir, registry_dir,
                                   params=params, proxy=proxy, host=host,
                                   **knobs)

    def _on_sigterm(signum, frame):
        Log.warning("factory: SIGTERM — stopping at the next boundary")
        supervisor.stop()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # pragma: no cover - embedded in a non-main thread
        pass
    cycles = supervisor.run_forever()
    Log.info("factory: stopped after %d completed run(s)", cycles)
    return EXIT_OK
