"""On-disk checkpoint store: atomic writes, CRC manifest, retention —
PyTorch-port copy of lightgbm_tpu/ckpt/store.py, with the same file names
and manifest, so either package reads the other's directory.

Layout of a checkpoint directory:

  ckpt_00000010.npz      TrainState blob for step 10
  MANIFEST.json          {"entries": {name: {step, crc32, size, ts}},
                          "complete_step": int|null}

Write protocol (crash-safe at every point):

  1. blob -> ``<name>.tmp.<pid>`` in the same directory, flush+fsync;
  2. ``os.rename`` onto the final name (atomic within a filesystem);
  3. directory fsync (the rename itself must survive a crash);
  4. manifest rewritten through the same tmp+fsync+rename dance.

A checkpoint is *valid* only when its manifest entry exists and the
file's size+CRC32 match — a crash between (2) and (4) leaves a data
file without an entry, which discovery ignores; a torn/corrupt tail
file fails the CRC and is skipped with a warning, falling back to the
previous checkpoint (the acceptance contract for kill/resume).
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Dict, List, Optional, Tuple

from ..utils.log import Log

_PREFIX = "ckpt_"
_SUFFIX = ".npz"
_MANIFEST = "MANIFEST.json"


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # a platform without directory fsync
        pass


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


class CheckpointStore:
    """Rolling checkpoint files + CRC manifest in one directory."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = max(1, int(keep_last))

    # -- manifest ------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, _MANIFEST)

    def read_manifest(self) -> Dict:
        try:
            with open(self._manifest_path()) as f:
                m = json.load(f)
            if isinstance(m, dict) and isinstance(m.get("entries"), dict):
                return m
        except (OSError, ValueError):
            pass
        return {"entries": {}, "complete_step": None}

    def _write_manifest(self, manifest: Dict) -> None:
        _atomic_write(self._manifest_path(),
                      json.dumps(manifest, indent=1).encode())

    # -- naming --------------------------------------------------------
    def path_for(self, step: int) -> str:
        return os.path.join(self.dir, f"{_PREFIX}{int(step):08d}{_SUFFIX}")

    # -- write side ----------------------------------------------------
    def save(self, step: int, blob: bytes) -> str:
        """Atomically persist ``blob`` as the step-``step`` checkpoint,
        update the manifest, and apply rolling retention."""
        os.makedirs(self.dir, exist_ok=True)
        path = self.path_for(step)
        _atomic_write(path, blob)
        manifest = self.read_manifest()
        manifest["entries"][os.path.basename(path)] = {
            "step": int(step),
            "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
            "size": len(blob),
            "ts": round(time.time(), 3),
        }
        # a new checkpoint means the run is live again — any stale
        # completion marker from a previous finished run is void
        manifest["complete_step"] = None
        self._gc(manifest)
        self._write_manifest(manifest)
        return path

    def mark_complete(self, step: int) -> None:
        """Record that training finished normally at ``step`` — the
        auto-resume policy then leaves the next fresh run alone.  A run
        that never wrote a checkpoint has nothing to mark (and should
        not litter its output directory with a manifest)."""
        manifest = self.read_manifest()
        if not manifest["entries"] and not os.path.exists(self._manifest_path()):
            return
        manifest["complete_step"] = int(step)
        try:
            self._write_manifest(manifest)
        except OSError:  # the completion marker is best effort
            pass

    def complete_step(self) -> Optional[int]:
        return self.read_manifest().get("complete_step")

    def _gc(self, manifest: Dict) -> None:
        entries = manifest["entries"]
        steps = sorted((e["step"], name) for name, e in entries.items())
        while len(steps) > self.keep_last:
            _, name = steps.pop(0)
            entries.pop(name, None)
            try:
                os.unlink(os.path.join(self.dir, name))
            except OSError:
                pass

    # -- read side -----------------------------------------------------
    def steps(self) -> List[int]:
        return sorted(e["step"] for e in self.read_manifest()["entries"].values())

    def _verify(self, name: str, entry: Dict) -> Optional[bytes]:
        path = os.path.join(self.dir, name)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as e:
            Log.warning("Checkpoint %s unreadable (%s); skipping", path, e)
            return None
        if len(blob) != int(entry.get("size", -1)):
            Log.warning(
                "Checkpoint %s is truncated (%d bytes, manifest says %s); "
                "skipping", path, len(blob), entry.get("size"),
            )
            return None
        if (zlib.crc32(blob) & 0xFFFFFFFF) != int(entry.get("crc32", -1)):
            Log.warning("Checkpoint %s fails its CRC; skipping", path)
            return None
        return blob

    def latest_valid(self) -> Optional[Tuple[int, bytes]]:
        """Newest checkpoint that passes size+CRC verification — a
        corrupt/truncated tail falls back to the previous one."""
        manifest = self.read_manifest()
        ordered = sorted(
            manifest["entries"].items(), key=lambda kv: -kv[1]["step"]
        )
        for name, entry in ordered:
            blob = self._verify(name, entry)
            if blob is not None:
                return int(entry["step"]), blob
        return None
