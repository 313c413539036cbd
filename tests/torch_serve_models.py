"""Small seeded models shared by the port's serving tests
(tests/test_torch_serve.py, test_torch_qpredict.py, test_torch_registry.py).

The JAX package trains each reference model once per process on at most
2,000 rows x 8 features; both packages then load the same model text, so
every comparison starts from the same trees.
"""

import contextlib
import functools

import numpy as np

import jax
import jax._src.core

import lightgbm_tpu as lgb

ROWS, COLS = 2000, 8
CAT = 7  # the categorical column of the binary model (integer codes 0-5)


@contextlib.contextmanager
def jax_trace_state_shim():
    """jax 0.9 moved ``trace_state_clean`` out of ``jax.core``, where the
    JAX package's compile watch imports it from; put it back meanwhile."""
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    try:
        yield
    finally:
        if not had:
            del jax.core.trace_state_clean


def data(seed: int = 0, n: int = ROWS):
    """(X, y): standard normal features with 5 % NaN and 5 % exact zeros
    (the DefaultValueForZero range), column CAT integer codes 0-5, and
    binary labels."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, COLS))
    X[:, CAT] = rng.integers(0, 6, n)
    y = ((X[:, 0] + X[:, 1] * X[:, 2] + (X[:, CAT] == 3)) > 0).astype(np.float64)
    X[:, :CAT][rng.random((n, CAT)) < 0.05] = np.nan
    X[:, :CAT][rng.random((n, CAT)) < 0.05] = 0.0
    return X, y


# name -> (params, rounds); trees: binary 8, multiclass 3 x 3 = 9, linear 6
MODELS = {
    "binary": (dict(objective="binary", num_leaves=15, learning_rate=0.3,
                    min_data_in_leaf=10), 8),
    "multiclass": (dict(objective="multiclass", num_class=3, num_leaves=7,
                        learning_rate=0.3, min_data_in_leaf=10), 3),
    "linear": (dict(objective="regression", num_leaves=7, learning_rate=0.3,
                    linear_tree=True, linear_lambda=0.01, min_data_in_leaf=20), 6),
}


@functools.lru_cache(maxsize=None)
def model_text(name: str) -> str:
    """The JAX package's model text of ``MODELS[name]``."""
    params, rounds = MODELS[name]
    X, y = data()
    if name == "multiclass":
        y = (np.nan_to_num(X[:, 0]) > 0.4).astype(np.float64) + (X[:, CAT] > 2)
    elif name == "linear":
        y = np.nan_to_num(X[:, 0]) - 0.5 * np.nan_to_num(X[:, 1]) + 0.3 * X[:, CAT]
    with jax_trace_state_shim():
        ds = lgb.Dataset(X, label=y, categorical_feature=[CAT] if name == "binary" else None)
        bst = lgb.train(dict(params, verbose=-1), ds, rounds)
    return bst.model_to_string()
