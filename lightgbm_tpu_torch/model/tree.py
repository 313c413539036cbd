"""Host-side tree model — counterpart of Tree (include/LightGBM/tree.h:18-230,
src/io/tree.cpp), constant leaves only (linear trees are not ported yet).

Node indexing parity: the reference's Tree::Split creates node
``num_leaves-1`` at each split (tree.cpp:55-58), so the s-th split record of
a GrowResult becomes node ``s``; child entries are node indices when >= 0
and ``~leaf`` when negative — identical to the reference's convention, so
ToString output is cross-loadable.
"""

from __future__ import annotations

import numpy as np

from ..utils.log import Log

K_MAX_TREE_OUTPUT = 100.0  # tree.h:13 kMaxTreeOutput


def _avoid_inf(x: float) -> float:
    """Common::AvoidInf — clamp +-inf for serialization."""
    if np.isinf(x):
        return 1e300 if x > 0 else -1e300
    return float(x)


def _fmt(values, fmt="%g") -> str:
    return " ".join(fmt % v for v in values)


class Tree:
    """SoA flat-array tree.  Numerical decision: fval <= threshold goes
    left; categorical: fval == threshold goes left (tree.h decision funs)."""

    def __init__(self, max_leaves: int = 2):
        m = max(max_leaves - 1, 1)
        self.num_leaves = 1
        self.left_child = np.zeros(m, np.int32)
        self.right_child = np.zeros(m, np.int32)
        self.split_feature_inner = np.zeros(m, np.int32)
        self.split_feature = np.zeros(m, np.int32)
        self.threshold_in_bin = np.zeros(m, np.int32)
        self.threshold = np.zeros(m, np.float64)
        self.decision_type = np.zeros(m, np.int8)  # 0 numerical, 1 categorical
        self.default_value = np.zeros(m, np.float64)
        self.zero_bin = np.zeros(m, np.int32)
        self.default_bin_for_zero = np.zeros(m, np.int32)
        self.split_gain = np.zeros(m, np.float64)
        self.leaf_parent = np.full(max_leaves, -1, np.int32)
        self.leaf_value = np.zeros(max_leaves, np.float64)
        self.leaf_count = np.zeros(max_leaves, np.int64)
        self.internal_value = np.zeros(m, np.float64)
        self.internal_count = np.zeros(m, np.int64)
        self.shrinkage_rate = 1.0
        self.has_categorical = False

    # ------------------------------------------------------------------
    def split(
        self,
        leaf: int,
        feature: int,
        bin_type_categorical: bool,
        threshold_bin: int,
        real_feature: int,
        threshold_double: float,
        left_value: float,
        right_value: float,
        left_cnt: int,
        right_cnt: int,
        gain: float,
        zero_bin: int,
        default_bin_for_zero: int,
        default_value: float,
    ) -> int:
        """Tree::Split (tree.cpp:55-105)."""
        new_node = self.num_leaves - 1
        parent = self.leaf_parent[leaf]
        if parent >= 0:
            if self.left_child[parent] == ~leaf:
                self.left_child[parent] = new_node
            else:
                self.right_child[parent] = new_node
        self.split_feature_inner[new_node] = feature
        self.split_feature[new_node] = real_feature
        self.zero_bin[new_node] = zero_bin
        self.default_bin_for_zero[new_node] = default_bin_for_zero
        self.default_value[new_node] = _avoid_inf(default_value)
        if bin_type_categorical:
            self.decision_type[new_node] = 1
            self.has_categorical = True
        else:
            self.decision_type[new_node] = 0
        self.threshold_in_bin[new_node] = threshold_bin
        self.threshold[new_node] = _avoid_inf(threshold_double)
        self.split_gain[new_node] = _avoid_inf(gain)
        self.left_child[new_node] = ~leaf
        self.right_child[new_node] = ~self.num_leaves
        self.leaf_parent[leaf] = new_node
        self.leaf_parent[self.num_leaves] = new_node
        self.internal_value[new_node] = self.leaf_value[leaf]
        self.internal_count[new_node] = left_cnt + right_cnt
        self.leaf_value[leaf] = 0.0 if np.isnan(left_value) else left_value
        self.leaf_count[leaf] = left_cnt
        self.leaf_value[self.num_leaves] = 0.0 if np.isnan(right_value) else right_value
        self.leaf_count[self.num_leaves] = right_cnt
        self.num_leaves += 1
        return self.num_leaves - 1

    # ------------------------------------------------------------------
    @classmethod
    def from_grow_result(cls, gr, dataset) -> "Tree":
        """Build from a device GrowResult (ops/grow.py) using the dataset's
        bin mappers for real thresholds (Dataset::RealThreshold)."""
        num_splits = int(gr.num_splits)
        rec_leaf = np.asarray(gr.rec_leaf)
        rec_feat = np.asarray(gr.rec_feat)
        rec_thr = np.asarray(gr.rec_thr)
        rec_dbz = np.asarray(gr.rec_dbz)
        rec_gain = np.asarray(gr.rec_gain)
        rec_lval = np.asarray(gr.rec_lval, np.float64)
        rec_rval = np.asarray(gr.rec_rval, np.float64)
        rec_lcnt = np.asarray(gr.rec_lcnt)
        rec_rcnt = np.asarray(gr.rec_rcnt)
        rec_ival = np.asarray(gr.rec_internal_value, np.float64)

        tree = cls(max(num_splits + 1, 2))
        for s in range(num_splits):
            inner = int(rec_feat[s])
            mapper = dataset.bin_mappers[inner]
            thr_bin = int(rec_thr[s])
            dbz = int(rec_dbz[s])
            tree.split(
                leaf=int(rec_leaf[s]),
                feature=inner,
                bin_type_categorical=mapper.bin_type == 1,
                threshold_bin=thr_bin,
                real_feature=dataset.inner_to_real_feature(inner),
                threshold_double=mapper.bin_to_value(thr_bin),
                left_value=float(rec_lval[s]),
                right_value=float(rec_rval[s]),
                left_cnt=int(rec_lcnt[s]),
                right_cnt=int(rec_rcnt[s]),
                gain=float(rec_gain[s]),
                zero_bin=mapper.default_bin,
                default_bin_for_zero=dbz,
                default_value=mapper.bin_to_value(dbz),
            )
            # the grower stores the PARENT's value in rec_internal_value
            tree.internal_value[s] = rec_ival[s]
        return tree

    @classmethod
    def constant(cls, value: float) -> "Tree":
        """The boost-from-average init tree: 2 leaves, both = value
        (gbdt.cpp:391-394)."""
        tree = cls(2)
        tree.split(0, 0, False, 0, 0, 0.0, value, value, 0, 0, -1.0, 0, 0, 0.0)
        return tree

    # ------------------------------------------------------------------
    def shrinkage(self, rate: float) -> None:
        """Tree::Shrinkage with the +-100 output clamp (tree.h:116-128)."""
        n = self.num_leaves
        self.leaf_value[:n] = np.clip(
            self.leaf_value[:n] * rate, -K_MAX_TREE_OUTPUT, K_MAX_TREE_OUTPUT
        )
        self.shrinkage_rate *= rate

    # ------------------------------------------------------------------
    def to_string(self) -> str:
        """Tree::ToString (tree.cpp:312-343) — reference text format."""
        n = self.num_leaves
        m = n - 1
        lines = [
            f"num_leaves={n}",
            "split_feature=" + _fmt(self.split_feature[:m], "%d"),
            "split_gain=" + _fmt(self.split_gain[:m]),
            "threshold=" + _fmt(self.threshold[:m], "%.17g"),
            "decision_type=" + _fmt(self.decision_type[:m], "%d"),
            "default_value=" + _fmt(self.default_value[:m], "%.17g"),
            "left_child=" + _fmt(self.left_child[:m], "%d"),
            "right_child=" + _fmt(self.right_child[:m], "%d"),
            "leaf_parent=" + _fmt(self.leaf_parent[:n], "%d"),
            "leaf_value=" + _fmt(self.leaf_value[:n], "%.17g"),
            "leaf_count=" + _fmt(self.leaf_count[:n], "%d"),
            "internal_value=" + _fmt(self.internal_value[:m], "%.17g"),
            "internal_count=" + _fmt(self.internal_count[:m], "%d"),
            f"shrinkage={self.shrinkage_rate:g}",
            f"has_categorical={1 if self.has_categorical else 0}",
            "",
        ]
        return "\n".join(lines) + "\n"

    @classmethod
    def from_string(cls, s: str) -> "Tree":
        """Tree::Tree(const std::string&) (tree.cpp:443-552)."""
        kv = {}
        for line in s.splitlines():
            if "=" in line:
                k, _, v = line.partition("=")
                k, v = k.strip(), v.strip()
                if k and v:
                    kv[k] = v
        if "num_leaves" not in kv:
            Log.fatal("Tree model should contain num_leaves field.")
        if int(kv.get("is_linear", "0")):
            raise NotImplementedError("lightgbm_tpu_torch does not support linear trees yet")
        n = int(kv["num_leaves"])
        tree = cls(max(n, 2))
        tree.num_leaves = n
        if n <= 1:
            return tree

        def arr(key, dtype, count, required=True):
            if key not in kv:
                if required:
                    Log.fatal("Tree model string format error, should contain %s field", key)
                return np.zeros(count, dtype)
            return np.array(kv[key].split(), dtype=np.float64).astype(dtype)[:count]

        m = n - 1
        tree.left_child[:m] = arr("left_child", np.int32, m)
        tree.right_child[:m] = arr("right_child", np.int32, m)
        tree.split_feature[:m] = arr("split_feature", np.int32, m)
        tree.split_feature_inner[:m] = tree.split_feature[:m]
        tree.threshold[:m] = arr("threshold", np.float64, m)
        tree.default_value[:m] = arr("default_value", np.float64, m)
        tree.leaf_value[:n] = arr("leaf_value", np.float64, n)
        tree.split_gain[:m] = arr("split_gain", np.float64, m, required=False)
        tree.internal_value[:m] = arr("internal_value", np.float64, m, required=False)
        tree.internal_count[:m] = arr("internal_count", np.int64, m, required=False)
        tree.leaf_count[:n] = arr("leaf_count", np.int64, n, required=False)
        tree.leaf_parent[:n] = arr("leaf_parent", np.int32, n, required=False)
        tree.decision_type[:m] = arr("decision_type", np.int8, m, required=False)
        tree.has_categorical = bool(np.any(tree.decision_type[:m] == 1))
        if "shrinkage" in kv:
            tree.shrinkage_rate = float(kv["shrinkage"])
        return tree
