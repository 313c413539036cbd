"""Crash-safe factory supervisor state — PyTorch counterpart of
lightgbm_tpu/factory/state.py, the same file format (each package reads
the other's).

One JSON file in the factory workdir, ``{"crc32": ..., "payload": ...}``
with a CRC32 over the canonical (sorted-key) payload bytes, written
through the checkpoint store's atomic write (tmp, fsync, rename, fsync of
the directory): a kill at any instruction leaves the previous complete
state or the new one, and a corrupt file is refused.

What survives a kill:

- ``ingested``: the fingerprints of the data files already folded into
  the promoted model, the watcher's baseline;
- ``run``: the run in flight (run id, data fingerprint, stage,
  candidate version); a restart re-enters the same run, every stage of
  which is idempotent;
- ``history``: the recorded verdicts, the last ``HISTORY_KEEP``;
- ``current``: the promoted model (version, model text path, eval
  metric) the next retrain warm-starts from.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, List, Optional

from ..ckpt.store import _atomic_write
from ..utils.log import Log

STATE_FILE = "factory_state.json"
HISTORY_KEEP = 50


def _payload_crc(payload: Dict) -> int:
    blob = json.dumps(payload, sort_keys=True).encode()
    return zlib.crc32(blob) & 0xFFFFFFFF


class FactoryState:
    """The supervisor state in memory, with its atomic save and load."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        self.path = os.path.join(workdir, STATE_FILE)
        self.ingested: Dict[str, Dict] = {}
        self.run: Optional[Dict] = None
        self.history: List[Dict] = []
        self.current: Optional[Dict] = None
        self.retrain_seq = 0
        self.last_run_ts = 0.0

    def _payload(self) -> Dict:
        return {
            "ingested": self.ingested,
            "run": self.run,
            "history": self.history,
            "current": self.current,
            "retrain_seq": int(self.retrain_seq),
            "last_run_ts": float(self.last_run_ts),
        }

    def save(self) -> None:
        payload = self._payload()
        doc = {"crc32": _payload_crc(payload), "payload": payload}
        _atomic_write(self.path, json.dumps(doc, indent=1).encode())

    @classmethod
    def load(cls, workdir: str) -> "FactoryState":
        """The saved state, or a fresh one when there is none.  A file that
        does not parse or fails its CRC is refused: the operator decides
        whether to delete it (the registry's publish dedupe keeps even a
        fresh start from publishing twice)."""
        st = cls(workdir)
        try:
            with open(st.path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return st
        except (OSError, ValueError) as e:
            Log.fatal("factory: unreadable state file %s (%s) — delete it to start fresh "
                      "(publishes are deduped, so no double-publish can result)", st.path, e)
        payload = doc.get("payload") if isinstance(doc, dict) else None
        if not isinstance(payload, dict) or (_payload_crc(payload) != int(doc.get("crc32", -1))):
            Log.fatal("factory: state file %s fails its CRC — the file is corrupt; delete it "
                      "to start fresh (publishes are deduped, so no double-publish can "
                      "result)", st.path)
        st.ingested = dict(payload.get("ingested") or {})
        st.run = payload.get("run") or None
        st.history = list(payload.get("history") or [])
        st.current = payload.get("current") or None
        st.retrain_seq = int(payload.get("retrain_seq") or 0)
        st.last_run_ts = float(payload.get("last_run_ts") or 0.0)
        return st

    def record_verdict(self, verdict: Dict, keep: int = HISTORY_KEEP) -> None:
        self.history.append(verdict)
        if len(self.history) > keep:
            self.history = self.history[-keep:]
