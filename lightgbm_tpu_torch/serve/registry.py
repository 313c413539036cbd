"""Versioned on-disk model registry — the serving fleet's source of truth;
PyTorch-port copy of lightgbm_tpu/serve/registry.py.  The directory
layout and the manifest are the JAX package's, so a registry that one
package wrote is served by the other.

A serving replica must survive model churn: every retrain publishes a
new ``PredictorArtifact`` and every replica picks it up WITHOUT a
restart (docs/SERVING.md, hot swap).  The registry is a plain directory
any publisher (trainer, CI, ``POST /models``) and any number of replica
processes share:

  registry_dir/
    v00000001.npz     packed PredictorArtifact, immutable once published
    v00000002.npz
    MANIFEST.json     {"entries": {name: {version, crc32, size, ts,
                       num_trees, num_features, ...,
                       dedupe_key?, quarantined?}},
                       "active_version": int|null,
                       "canary_version": int|null,
                       "routes": {route_name: version}}

Named routes (multi-model serving, docs/SERVING.md): ``routes`` maps a
route name (``POST /predict/<route>``) to the version it serves, each
activated/swapped independently of ``active_version`` (the default
route) via ``set_route``/``remove_route``.  Retention protects EVERY
routed version, not just the single active one — N concurrently-active
tenant models must all survive ``keep_last``.

Lifecycle state beyond "active" (the continuous-training factory,
docs/FACTORY.md): ``canary_version`` marks a version under canary
evaluation — retention must not collect the model a canary replica is
serving, however slow the observation window.  ``quarantine(version,
reason)`` records a failed canary verdict on the entry; a quarantined
version is never re-activated by the factory and the most recently
quarantined one survives retention as evidence.  ``publish_bytes``
accepts a ``dedupe_key``: re-publishing the same key returns the
already-claimed version instead of minting a new one, which makes a
crash between publish and the publisher's own state write idempotent
(kill-anywhere restart never double-publishes).

Write protocol (the ckpt/store.py atomic dance, reused literally):
artifact bytes -> tmp + fsync -> hardlink-claim of the next free
``vNNNNNNNN.npz`` name -> directory fsync -> manifest rewritten through
tmp+fsync+rename.  A crash at any point leaves either no trace or an
orphan data file without a manifest entry, which discovery ignores; a
corrupt/truncated artifact fails its manifest CRC at load time and is
refused with a clear error instead of serving garbage.

Watching is poll-based (no inotify dependency): ``watch_token()`` is a
cheap stat of the manifest; replicas poll it and reload on change.
Publishing is cross-process safe: the version name is claimed with an
exclusive hardlink and the manifest read-modify-write runs under a
bounded ``.lock`` file (stale locks from a crashed publisher are broken
after ``LOCK_STALE_S``).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from ..ckpt.store import _atomic_write, _fsync_dir
from ..utils.log import Log
from .artifact import PredictorArtifact

_PREFIX = "v"
_SUFFIX = ".npz"
_MANIFEST = "MANIFEST.json"
_LOCK = ".publish.lock"

LOCK_STALE_S = 30.0
LOCK_WAIT_S = 10.0

# route names land in URLs and manifest keys: path-safe, no dot-prefix
_ROUTE_RE = re.compile(r"^(?!\.)[A-Za-z0-9._\-]{1,64}$")


def _version_name(version: int) -> str:
    return f"{_PREFIX}{int(version):08d}{_SUFFIX}"


def _version_of(name: str) -> Optional[int]:
    base = os.path.basename(name)
    if not (base.startswith(_PREFIX) and base.endswith(_SUFFIX)):
        return None
    try:
        return int(base[len(_PREFIX): -len(_SUFFIX)])
    except ValueError:
        return None


class _PublishLock:
    """Bounded O_EXCL lock file serializing manifest read-modify-write
    across publisher processes.  A lock older than ``LOCK_STALE_S`` is
    from a crashed publisher and is broken with a warning."""

    def __init__(self, directory: str, wait_s: float = LOCK_WAIT_S):
        self.path = os.path.join(directory, _LOCK)
        self.wait_s = float(wait_s)

    def __enter__(self):
        deadline = time.monotonic() + self.wait_s
        while True:
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                return self
            except FileExistsError:
                try:
                    age = time.time() - os.stat(self.path).st_mtime
                    if age > LOCK_STALE_S:
                        Log.warning(
                            "registry: breaking stale publish lock %s "
                            "(%.0fs old)", self.path, age)
                        os.unlink(self.path)
                        continue
                except OSError:
                    continue  # lock vanished between stat attempts
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"registry publish lock {self.path} held for "
                        f">{self.wait_s}s")
                time.sleep(0.02)

    def __exit__(self, *exc):
        try:
            os.unlink(self.path)
        except OSError:
            pass


class ModelRegistry:
    """Directory of immutable versioned artifacts + atomic CRC'd manifest."""

    def __init__(self, directory: str, keep_last: int = 0):
        self.dir = directory
        # keep_last=0 keeps everything; retention never removes the
        # active version (a replica may still be draining onto it)
        self.keep_last = max(0, int(keep_last))
        os.makedirs(self.dir, exist_ok=True)

    # -- manifest ------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, _MANIFEST)

    def read_manifest(self) -> Dict:
        try:
            with open(self._manifest_path()) as f:
                m = json.load(f)
            if isinstance(m, dict) and isinstance(m.get("entries"), dict):
                m.setdefault("canary_version", None)
                if not isinstance(m.get("routes"), dict):
                    m["routes"] = {}
                return m
        except (OSError, ValueError):
            pass
        return {"entries": {}, "active_version": None, "canary_version": None,
                "routes": {}}

    def _write_manifest(self, manifest: Dict) -> None:
        _atomic_write(self._manifest_path(),
                      json.dumps(manifest, indent=1).encode())

    # -- publish -------------------------------------------------------
    def publish(self, artifact: PredictorArtifact, activate: bool = True,
                dedupe_key: Optional[str] = None) -> int:
        """Publish a validated in-memory artifact; returns its version."""
        import io

        buf = io.BytesIO()
        artifact.save_to_bytes(buf)
        return self.publish_bytes(buf.getvalue(), activate=activate,
                                  dedupe_key=dedupe_key,
                                  _validated_meta=dict(artifact.meta))

    def publish_file(self, path: str, activate: bool = True) -> int:
        with open(path, "rb") as f:
            return self.publish_bytes(f.read(), activate=activate)

    def seed(self, artifact: PredictorArtifact) -> int:
        """Publish ``artifact`` only if the registry is still empty once
        the publish lock is held — N replicas racing to seed a shared
        registry produce exactly one version.  Returns the version now
        active (the seed's, or the one that won the race)."""
        import io

        buf = io.BytesIO()
        artifact.save_to_bytes(buf)
        return self.publish_bytes(buf.getvalue(),
                                  _validated_meta=dict(artifact.meta),
                                  _only_if_empty=True)

    def publish_bytes(self, blob: bytes, activate: bool = True,
                      dedupe_key: Optional[str] = None,
                      _validated_meta: Optional[Dict] = None,
                      _only_if_empty: bool = False) -> int:
        """Publish raw ``.npz`` artifact bytes (the ``POST /models``
        body).  The blob is fully validated through
        ``PredictorArtifact.load`` BEFORE it can claim a version — a
        corrupt upload never enters the manifest.  With ``dedupe_key``
        a key already present in the manifest short-circuits to its
        version: a publisher killed between publish and its own durable
        state write retries idempotently instead of double-publishing."""
        meta = _validated_meta
        if meta is None:
            meta = dict(PredictorArtifact.load_bytes(blob).meta)
        # one name per publishing thread: a server publishes from its
        # handler threads, and they share the process id
        tmp = os.path.join(self.dir, f".publish.tmp.{os.getpid()}.{threading.get_ident()}")
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        try:
            with _PublishLock(self.dir):
                manifest = self.read_manifest()
                if _only_if_empty and manifest["entries"]:
                    active = manifest.get("active_version")
                    if active is not None:
                        return int(active)
                    return max(int(e["version"])
                               for e in manifest["entries"].values())
                if dedupe_key is not None:
                    for e in manifest["entries"].values():
                        if e.get("dedupe_key") == dedupe_key:
                            return int(e["version"])
                version = self._next_version(manifest)
                path = os.path.join(self.dir, _version_name(version))
                # hardlink-claim: fails loudly if the name exists (a
                # publisher outside the lock), never overwrites
                os.link(tmp, path)
                _fsync_dir(self.dir)
                manifest["entries"][os.path.basename(path)] = {
                    "version": version,
                    "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
                    "size": len(blob),
                    "ts": round(time.time(), 3),
                    "num_trees": int(meta.get("num_trees", 0)),
                    "num_features": int(meta.get("num_features", 0)),
                    "num_class": int(meta.get("num_class", 1)),
                    "objective": str(meta.get("objective", "")),
                }
                if dedupe_key is not None:
                    manifest["entries"][os.path.basename(path)][
                        "dedupe_key"] = str(dedupe_key)
                if activate:
                    manifest["active_version"] = version
                self._gc(manifest)
                self._write_manifest(manifest)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        from ..obs import tracer
        from ..obs.metrics import registry as metrics_registry

        tracer.event("registry.published", version=version,
                     bytes=len(blob), active=bool(activate))
        metrics_registry.counter(
            "lightgbm_tpu_registry_publish_total",
            "artifacts published into the model registry").inc()
        return version

    def _next_version(self, manifest: Dict) -> int:
        top = 0
        for e in manifest["entries"].values():
            top = max(top, int(e["version"]))
        # also scan the directory: an orphan data file from a crashed
        # publisher must not be overwritten by a version-number reuse
        try:
            for name in os.listdir(self.dir):
                v = _version_of(name)
                if v is not None:
                    top = max(top, v)
        except OSError:
            pass
        return top + 1

    def activate(self, version: int) -> None:
        """Point ``active_version`` at an already-published version
        (rollback is just activating an older one)."""
        with _PublishLock(self.dir):
            manifest = self.read_manifest()
            if not any(int(e["version"]) == int(version)
                       for e in manifest["entries"].values()):
                Log.fatal("registry: cannot activate unknown version %s "
                          "(published: %s)", version,
                          sorted(int(e["version"])
                                 for e in manifest["entries"].values()))
            manifest["active_version"] = int(version)
            self._write_manifest(manifest)

    # -- named routes (multi-model serving, docs/SERVING.md) -----------
    def set_route(self, route: str, version: int) -> None:
        """Point route ``route`` (served at ``POST /predict/<route>``)
        at a published version — creating the route, or independently
        hot-swapping it if it exists.  Route names are path-safe
        identifiers; the version must already be published."""
        route = str(route)
        if not _ROUTE_RE.match(route):
            Log.fatal("registry: invalid route name %r (allowed: 1-64 "
                      "chars of [A-Za-z0-9._-], not starting with '.')",
                      route)
        with _PublishLock(self.dir):
            manifest = self.read_manifest()
            if not any(int(e["version"]) == int(version)
                       for e in manifest["entries"].values()):
                Log.fatal("registry: cannot route %r to unknown version %s "
                          "(published: %s)", route, version,
                          sorted(int(e["version"])
                                 for e in manifest["entries"].values()))
            manifest["routes"][route] = int(version)
            self._write_manifest(manifest)
        from ..obs import tracer

        tracer.event("registry.route_set", route=route, version=int(version))

    def remove_route(self, route: str) -> bool:
        """Drop a named route (its version stays published, now subject
        to normal retention).  Returns False when the route did not
        exist."""
        with _PublishLock(self.dir):
            manifest = self.read_manifest()
            existed = manifest["routes"].pop(str(route), None) is not None
            if existed:
                self._write_manifest(manifest)
        if existed:
            from ..obs import tracer

            tracer.event("registry.route_removed", route=str(route))
        return existed

    def routes(self) -> Dict[str, int]:
        """{route_name: version} for every named route."""
        return {str(r): int(v)
                for r, v in self.read_manifest()["routes"].items()}

    def route_version(self, route: str) -> Optional[int]:
        v = self.read_manifest()["routes"].get(str(route))
        return int(v) if v is not None else None

    # -- canary / quarantine lifecycle (docs/FACTORY.md) ---------------
    def set_canary(self, version: Optional[int]) -> None:
        """Mark ``version`` as under canary evaluation (``None`` clears).
        A canary version is retention-protected for the whole
        observation window — GC must never collect the model the canary
        replica is pinned to."""
        with _PublishLock(self.dir):
            manifest = self.read_manifest()
            if version is not None and not any(
                    int(e["version"]) == int(version)
                    for e in manifest["entries"].values()):
                Log.fatal("registry: cannot canary unknown version %s "
                          "(published: %s)", version,
                          sorted(int(e["version"])
                                 for e in manifest["entries"].values()))
            manifest["canary_version"] = (
                int(version) if version is not None else None)
            self._write_manifest(manifest)

    def clear_canary(self) -> None:
        self.set_canary(None)

    def canary_version(self) -> Optional[int]:
        v = self.read_manifest().get("canary_version")
        return int(v) if v is not None else None

    def quarantine(self, version: int, reason: str) -> None:
        """Record a failed canary verdict on a published version.  A
        quarantined version keeps its artifact (the most recent one is
        retention-protected as evidence) but the factory never
        re-activates it; the reason string is the audit trail."""
        with _PublishLock(self.dir):
            manifest = self.read_manifest()
            entry = None
            for e in manifest["entries"].values():
                if int(e["version"]) == int(version):
                    entry = e
                    break
            if entry is None:
                Log.fatal("registry: cannot quarantine unknown version %s "
                          "(published: %s)", version,
                          sorted(int(e["version"])
                                 for e in manifest["entries"].values()))
            entry["quarantined"] = str(reason)
            if manifest.get("canary_version") == int(version):
                manifest["canary_version"] = None
            self._write_manifest(manifest)
        from ..obs import tracer

        tracer.event("registry.quarantined", version=int(version),
                     reason=str(reason))

    def quarantined(self) -> Dict[int, str]:
        """{version: reason} for every quarantined entry."""
        return {int(e["version"]): str(e["quarantined"])
                for e in self.read_manifest()["entries"].values()
                if e.get("quarantined")}

    def _gc(self, manifest: Dict) -> None:
        if self.keep_last <= 0:
            return
        entries = manifest["entries"]
        # retention protects everything a process may still be serving
        # or a human may still need: the active version (replicas drain
        # onto it), EVERY routed version (multi-model serving keeps N
        # versions concurrently active — collecting any routed active
        # would 404 a live route on its next replica load), the canary
        # version (a slow observation window must not lose the model
        # under evaluation), and the most recently quarantined version
        # (the rollback evidence)
        protected = {manifest.get("active_version"),
                     manifest.get("canary_version")}
        protected.update(int(v) for v in manifest.get("routes", {}).values())
        quarantined = [int(e["version"]) for e in entries.values()
                       if e.get("quarantined")]
        if quarantined:
            protected.add(max(quarantined))
        versions = sorted((int(e["version"]), name)
                          for name, e in entries.items())
        while len(versions) > self.keep_last:
            v, name = versions.pop(0)
            if v in protected:
                continue
            entries.pop(name, None)
            try:
                os.unlink(os.path.join(self.dir, name))
            except OSError:
                pass

    # -- read side -----------------------------------------------------
    def list_models(self) -> List[Dict]:
        """Manifest entries, oldest first, with lifecycle flags set."""
        manifest = self.read_manifest()
        active = manifest.get("active_version")
        canary = manifest.get("canary_version")
        routes = manifest.get("routes", {})
        out = []
        for name, e in sorted(manifest["entries"].items(),
                              key=lambda kv: int(kv[1]["version"])):
            row = dict(e)
            row["name"] = name
            row["active"] = int(e["version"]) == active if active else False
            row["canary"] = (int(e["version"]) == canary
                             if canary is not None else False)
            row["quarantined"] = str(e["quarantined"]) \
                if e.get("quarantined") else None
            row["routes"] = sorted(r for r, v in routes.items()
                                   if int(v) == int(e["version"]))
            out.append(row)
        return out

    def active_version(self) -> Optional[int]:
        v = self.read_manifest().get("active_version")
        return int(v) if v is not None else None

    def latest_version(self) -> Optional[int]:
        versions = [int(e["version"])
                    for e in self.read_manifest()["entries"].values()]
        return max(versions) if versions else None

    def load(self, version: int) -> PredictorArtifact:
        """Load + CRC-verify a published version.  A corrupt or
        truncated file is refused with the manifest evidence — never
        silently served."""
        manifest = self.read_manifest()
        entry = None
        for name, e in manifest["entries"].items():
            if int(e["version"]) == int(version):
                entry = (name, e)
                break
        if entry is None:
            Log.fatal("registry: version %s is not in %s (published: %s)",
                      version, self.dir,
                      sorted(int(e["version"])
                             for e in manifest["entries"].values()))
        name, e = entry
        path = os.path.join(self.dir, name)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as ex:
            Log.fatal("registry: cannot read %s: %s", path, ex)
        if len(blob) != int(e.get("size", -1)) or (
                zlib.crc32(blob) & 0xFFFFFFFF) != int(e.get("crc32", -1)):
            Log.fatal(
                "registry: %s fails its manifest CRC/size check "
                "(%d bytes vs %s recorded) — the artifact is corrupt or "
                "torn; republish it", path, len(blob), e.get("size"))
        return PredictorArtifact.load_bytes(blob)

    def load_active(self) -> Optional[Tuple[int, PredictorArtifact]]:
        v = self.active_version()
        if v is None:
            return None
        return v, self.load(v)

    # -- watch ---------------------------------------------------------
    def watch_token(self) -> Tuple:
        """Cheap change token: manifest identity (size + mtime_ns) plus
        the active version and the route table.  Polling replicas
        reload when it changes — no inotify, works on any filesystem
        including network mounts."""
        try:
            st = os.stat(self._manifest_path())
            ident = (int(st.st_size), int(st.st_mtime_ns))
        except OSError:
            ident = (0, 0)
        m = self.read_manifest()
        active = m.get("active_version")
        return ident + (
            int(active) if active is not None else None,
            tuple(sorted((str(r), int(v)) for r, v in m["routes"].items())),
        )
