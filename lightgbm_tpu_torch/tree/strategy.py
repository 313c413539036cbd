"""Tree-growth strategy seams — PyTorch counterpart of
lightgbm_tpu/tree/strategy.py.

A strategy is a NamedTuple of NamedTuples, hashable, so it can key the
mask grower's captured split searches (ops/grow.py ``_child_search``):
a constrained and an unconstrained booster never share a CUDA graph.

``SplitGainStrategy``
    The per-inner-feature monotone direction vector (+1 / 0 / -1); the
    default (empty) runs the unconstrained split scan unchanged.
``LeafFitStrategy``
    ``const`` leaves or ``linear`` ones (per-leaf ridge least squares
    over the leaf's path features, tree/linear.py).
``HistAccumStrategy``
    float32 histograms, or quantized int16 levels summed exactly.
``StateExportStrategy``
    The leaf-model kind the model text carries.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from ..utils.log import Log


class SplitGainStrategy(NamedTuple):
    """Monotone direction per INNER feature (+1 increasing, 0 none, -1
    decreasing); the empty tuple is fully unconstrained."""

    monotone: Tuple[int, ...] = ()

    @property
    def constrained(self) -> bool:
        return any(c != 0 for c in self.monotone)


class LeafFitStrategy(NamedTuple):
    """Leaf-model fit: ``const`` or ``linear`` (and the ridge strength)."""

    kind: str = "const"
    linear_lambda: float = 0.0

    @property
    def linear(self) -> bool:
        return self.kind == "linear"


class HistAccumStrategy(NamedTuple):
    """float32 histograms, or quantized int16 levels with exact int32
    sums (ops/qhist.py)."""

    quantized: bool = False
    quant_bits: int = 0  # 0 = the library default (ops.qhist.QUANT_BITS)
    quant_seed: int = 0


class StateExportStrategy(NamedTuple):
    """What the fitted leaves look like downstream (model text)."""

    leaf_model: str = "const"


class TreeStrategy(NamedTuple):
    split_gain: SplitGainStrategy = SplitGainStrategy()
    leaf_fit: LeafFitStrategy = LeafFitStrategy()
    hist_accum: HistAccumStrategy = HistAccumStrategy()
    state_export: StateExportStrategy = StateExportStrategy()

    @classmethod
    def from_config(cls, config, train_set=None) -> "TreeStrategy":
        """The strategy a Config implies.  With ``train_set`` the
        real-feature monotone constraints map onto INNER feature order,
        categorical columns zeroed."""
        monotone: Tuple[int, ...] = ()
        raw = getattr(config, "monotone_constraints", "") or ""
        if str(raw).strip() and train_set is not None:
            monotone = _inner_monotone(config, train_set)
        leaf = LeafFitStrategy(
            kind="linear" if getattr(config, "linear_tree", False) else "const",
            linear_lambda=float(getattr(config, "linear_lambda", 0.0)))
        hist = HistAccumStrategy(
            quantized=bool(getattr(config, "quantized_training", False)),
            quant_bits=int(getattr(config, "quantized_grad_bits", 0) or 0),
            quant_seed=int(getattr(config, "seed", 0)))
        return cls(split_gain=SplitGainStrategy(monotone=monotone), leaf_fit=leaf,
                   hist_accum=hist, state_export=StateExportStrategy(leaf_model=leaf.kind))


DEFAULT_STRATEGY = TreeStrategy()


def parse_monotone_constraints(value, num_features: int, feature_names=None) -> Tuple[int, ...]:
    """``monotone_constraints`` as a length-``num_features`` tuple over
    REAL feature indices, from a comma list (``"+1,0,-1"``, one entry a
    feature) or a dict keyed by feature index or name (unnamed features
    0).  Bad input raises LightGBMError with the JAX package's message."""

    def _dir(v, what):
        try:
            c = int(str(v).strip() or 0)
        except ValueError:
            Log.fatal("monotone_constraints: %s is not a direction (+1 / 0 / -1)", what)
        if c not in (-1, 0, 1):
            Log.fatal("monotone_constraints: direction %d for %s is out of range; use +1 "
                      "(increasing), 0 (none) or -1 (decreasing)", c, what)
        return c

    if isinstance(value, dict):
        out = [0] * num_features
        names = {str(n): i for i, n in enumerate(feature_names or [])}
        for key, v in value.items():
            k = str(key)
            if k in names:
                idx = names[k]
            else:
                try:
                    idx = int(k)
                except ValueError:
                    Log.fatal("monotone_constraints: unknown feature %r (not an index and not "
                              "one of the dataset's feature names)", key)
                if not 0 <= idx < num_features:
                    Log.fatal("monotone_constraints: feature index %d out of range for %d "
                              "features", idx, num_features)
            out[idx] = _dir(v, f"feature {key!r}")
        return tuple(out)

    parts = str(value).split(",")
    if len(parts) == 1 and not parts[0].strip():
        return tuple([0] * num_features)
    if len(parts) != num_features:
        Log.fatal("monotone_constraints has %d entries but the dataset has %d features; pass "
                  "one +1/0/-1 per feature (comma list) or a {feature: direction} dict",
                  len(parts), num_features)
    return tuple(_dir(p, f"entry {i}") for i, p in enumerate(parts))


def _inner_monotone(config, train_set) -> Tuple[int, ...]:
    """The config's REAL-feature constraints in the dataset's INNER
    feature order, categorical columns zeroed (monotonicity is undefined
    for one-vs-rest splits) with a warning, and a warning for constrained
    features that binning pruned."""
    from ..io.binning import CATEGORICAL

    names = getattr(train_set, "feature_names", None)
    num_real = int(getattr(train_set, "num_total_features", train_set.num_features))
    real = parse_monotone_constraints(config.monotone_constraints, num_real, names)
    if not any(real):
        return ()
    inner = []
    seen_real = set()
    for i in range(train_set.num_features):
        r = int(train_set.inner_to_real_feature(i))
        c = 0 if r < 0 else real[r]
        if train_set.bin_mappers[i].bin_type == CATEGORICAL and c != 0:
            Log.warning("monotone_constraints: feature %d is categorical; monotonicity is "
                        "undefined for one-vs-rest splits — constraint ignored.", r)
            c = 0
        if r >= 0:
            seen_real.add(r)
        inner.append(c)
    dropped = [r for r, c in enumerate(real) if c != 0 and r not in seen_real]
    if dropped:
        Log.warning("monotone_constraints: features %s were pruned or bundled away during "
                    "binning; their constraints do not apply.", dropped)
    return tuple(inner)
