"""Split-decision audit trail — PyTorch-port copy of
lightgbm_tpu/obs/audit.py: every accepted split, as JSONL.

When two runs disagree (card against CPU, or the port against the JAX
package), a model diff says that the trees differ but not which decision
parted first.  This stream records every accepted split in acceptance
order — (iteration, class, split ordinal, leaf, feature, bin threshold,
real threshold, gain, default-left, left/right counts) — and each finished
tree's leaf values, so ``python -m lightgbm_tpu_torch report diff a b``
names the first divergent decision in one line.

Enable with ``LIGHTGBM_TPU_AUDIT=path`` (re-read at every ``engine.train``
and ``GBDT.init``).  Disabled, it costs one attribute check a tree.

Records carry no timestamps, floats are written through Python's repr
(byte-identical exactly when the doubles are), keys come in a fixed order
and records in the grower's acceptance order: two runs that build
bit-identical trees write byte-identical files.  The rows come from
``ops/pgrow.split_audit_rows`` over the records both growers hand to
``Tree.from_grow_result``; the schema is the JAX package's, so a port
trail and a JAX trail compare line by line.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional


class AuditWriter:
    """Process-global JSONL audit sink (LIGHTGBM_TPU_AUDIT=path)."""

    def __init__(self):
        self.enabled = False
        self.path: Optional[str] = None
        self._f = None

    def refresh_from_env(self) -> None:
        path = os.environ.get("LIGHTGBM_TPU_AUDIT", "")
        if path and path != self.path:
            self.configure(path)

    def configure(self, path: str) -> None:
        self.close()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "w", buffering=1)  # line buffered
        self.path = path
        self.enabled = True

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.flush()
                self._f.close()
            except Exception:  # interpreter teardown
                pass
        self._f = None
        self.path = None
        self.enabled = False

    def _write(self, rec: Dict[str, Any]) -> None:
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")

    def record_tree(self, it: int, k: int, view, tree) -> None:
        """The accepted splits of one finished tree, then its leaf values.
        ``view`` carries the grower's host records (``GrowResult`` or a
        host ``PTreeResult``); ``tree`` is the ``model.tree.Tree`` after
        shrinkage, so thresholds and values are the model's."""
        if not self.enabled:
            return
        from ..ops.pgrow import split_audit_rows

        for row in split_audit_rows(view):
            s = row["s"]
            self._write({
                "ev": "split", "it": int(it), "k": int(k), "s": s,
                "leaf": row["leaf"], "feat": int(tree.split_feature[s]),
                "bin": row["bin"],
                "thr": float(tree.threshold[s]),
                "gain": row["gain"],
                # where the zero/missing bin goes under this node's
                # decision type (tree.h decision functions)
                "dl": int(row["dbz"] == row["bin"] if tree.decision_type[s] == 1
                          else row["dbz"] <= row["bin"]),
                "dbz": row["dbz"],
                "lcnt": row["lcnt"], "rcnt": row["rcnt"],
            })
        rec = {"ev": "tree", "it": int(it), "k": int(k), "leaves": int(tree.num_leaves),
               "values": [float(v) for v in tree.leaf_value[: tree.num_leaves]]}
        if getattr(tree, "is_linear", False):
            n = tree.num_leaves
            rec["leaf_model"] = "linear"
            rec["linear_leaves"] = [int(v) for v in tree.leaf_is_linear[:n]]
            rec["const"] = [float(v) for v in tree.leaf_const[:n]]
            rec["coeff"] = [[float(c) for c in tree.leaf_coeff[i]]
                            if i < len(tree.leaf_coeff) else [] for i in range(n)]
            rec["feat"] = [list(tree.leaf_features[i])
                           if i < len(tree.leaf_features) else [] for i in range(n)]
        self._write(rec)


audit = AuditWriter()
