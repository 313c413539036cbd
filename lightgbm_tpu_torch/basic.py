"""User-facing Dataset and Booster — PyTorch counterpart of
lightgbm_tpu/basic.py (python-package/lightgbm/basic.py Dataset:551,
Booster:1176) for in-memory arrays, pandas frames, scipy sparse
matrices (densified) and data files: a binary dataset cache, or a CSV,
TSV or LibSVM text file with its ``.weight`` / ``.query`` side files,
parsed in memory or streamed (data/ingest.py) when large.  A validation
Dataset built with ``reference=``
bins with the training set's mappers and is evaluated on its unbundled
bins.  Pandas ``category`` columns train as categorical features; their
levels travel in the model text's ``pandas_categorical:`` line, through
which a DataFrame given to ``predict`` is coded.  pandas is imported only
when a frame is given, so the package imports without it."""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .boosting import create_boosting
from .config import Config
from .io.dataset import BinnedDataset
from .metric import create_metric, metric_names_for_objective
from .objective import create_objective, objective_from_string
from .utils.device import resolve_device
from .utils.log import Log


def _pandas_frame(data):
    """The pandas module when ``data`` is a DataFrame, else None (pandas
    stays unimported for every other input)."""
    if type(data).__module__.split(".")[0] != "pandas":
        return None
    try:
        import pandas as pd
    except ImportError:  # pragma: no cover
        return None
    return pd if isinstance(data, pd.DataFrame) else None


def _to_2d_float(data):
    """-> (float64 matrix, column names or None, auto-categorical column
    indices, their levels).  A pandas ``category``
    column becomes its codes (missing -> NaN) and an auto-detected
    categorical feature (the reference's _data_from_pandas under
    categorical_feature="auto"); scipy sparse input is densified."""
    pd = _pandas_frame(data)
    if pd is not None:
        cat_idx = [i for i, c in enumerate(data.columns)
                   if isinstance(data.dtypes.iloc[i], pd.CategoricalDtype)]
        levels = []
        if cat_idx:
            data = data.copy(deep=False)
            for i in cat_idx:
                col = data.columns[i]
                levels.append(list(data[col].cat.categories))
                codes = data[col].cat.codes.to_numpy(np.float64)
                codes[codes < 0] = np.nan  # code -1 == missing
                data[col] = codes
        arr = data.to_numpy(dtype=np.float64)
        names = [str(c) for c in data.columns]
        return arr, names, cat_idx, levels
    if hasattr(data, "tocsr") and hasattr(data, "toarray"):
        # the pipeline is dense by design; EFB re-compacts exclusive columns
        Log.warning("Sparse input is densified (%d x %d); EFB bundling recovers "
                    "the memory on the device", *data.shape)
        return np.asarray(data.toarray(), dtype=np.float64), None, [], []
    arr = np.asarray(data, dtype=np.float64)
    return (arr.reshape(-1, 1) if arr.ndim == 1 else arr), None, [], []


def _map_pandas_categorical(data, pandas_categorical):
    """A DataFrame to predict: its category columns coded through the
    training levels (the model's ``pandas_categorical``), so the codes
    line up with the trees' thresholds; unseen levels become NaN."""
    pd = _pandas_frame(data)
    if pd is None or not pandas_categorical:
        return data
    cat_cols = [c for i, c in enumerate(data.columns)
                if isinstance(data.dtypes.iloc[i], pd.CategoricalDtype)]
    if not cat_cols:
        return data
    if len(cat_cols) != len(pandas_categorical):
        Log.fatal("predict data has %d pandas categorical columns but the model "
                  "was trained with %d", len(cat_cols), len(pandas_categorical))
    data = data.copy(deep=False)
    for col, levels in zip(cat_cols, pandas_categorical):
        codes = pd.Categorical(data[col], categories=levels).codes.astype(np.float64)
        codes[codes < 0] = np.nan
        data[col] = codes
    return data


class Dataset:
    """Lazily-constructed binned dataset over a dense float matrix (a
    numpy array, a pandas frame or a scipy sparse matrix) or a data file
    (a path).  A file is, in this order: a binary dataset cache
    (``save_binary``); a text file streamed in two passes
    (``data/ingest.py should_stream``: above 256 MiB, or as
    ``stream_ingest`` / ``use_two_round_loading`` say); else a text file
    parsed in memory.  The file's label, weights and query groups give
    way to those passed here.  ``free_raw_data`` drops the raw matrix
    once binned (continued training and subsets' raw rows then have
    none); ``silent`` is accepted for the reference's signature (the
    ``verbose`` parameter sets the log level)."""

    def __init__(self, data, label=None, max_bin: Optional[int] = None,
                 reference: Optional["Dataset"] = None, weight=None, group=None,
                 init_score=None, silent: bool = False, feature_name="auto",
                 categorical_feature="auto", params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = False):
        if isinstance(data, str):
            self.data_path = data
            self.data, self.pandas_columns = None, None
            self._auto_categorical, self.pandas_categorical = [], []
        else:
            self.data_path = None
            (self.data, self.pandas_columns, self._auto_categorical,
             self.pandas_categorical) = _to_2d_float(data)
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group  # per-query sizes of a ranking task
        self.init_score = init_score
        self.params = dict(params) if params else {}
        if max_bin is not None:
            self.params.setdefault("max_bin", max_bin)
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.free_raw_data = free_raw_data
        self.label_idx = 0  # the label's column in a text file
        self._constructed: Optional[BinnedDataset] = None

    def construct(self, extra_params: Optional[Dict[str, Any]] = None) -> BinnedDataset:
        """Build (or return) the binned dataset; ``extra_params`` (booster
        params) fill gaps, the Dataset's own params win."""
        if self._constructed is not None:
            return self._constructed
        merged = dict(extra_params) if extra_params else {}
        merged.update(self.params)
        cfg = Config.from_params({k: v for k, v in merged.items() if k != "categorical_feature"})
        if self.data is None and self.data_path is not None:
            ds = self._construct_from_file(cfg)
            if ds is not None:
                self._constructed = ds
                return ds
        names = None
        if self.feature_name != "auto" and self.feature_name is not None:
            names = list(self.feature_name)
        elif self.pandas_columns is not None:
            names = self.pandas_columns
        cats: Optional[Sequence[int]] = None
        if self.categorical_feature != "auto" and self.categorical_feature:
            cats = []
            for c in self.categorical_feature:
                if isinstance(c, str):
                    if names and c in names:
                        cats.append(names.index(c))
                    else:
                        Log.fatal("Unknown categorical feature %s", c)
                else:
                    cats.append(int(c))
        elif self.categorical_feature == "auto" and self._auto_categorical:
            cats = list(self._auto_categorical)
        ref = None
        if self.reference is not None:
            ref = self.reference.construct()
            self._remap_categorical_to_reference(self.reference)
        self._constructed = BinnedDataset.from_raw(
            self.data, cfg, label=self.label, weight=self.weight, group=self.group,
            init_score=self.init_score, feature_names=names, categorical_features=cats,
            reference=ref)
        self._constructed.label_idx = self.label_idx
        if self.free_raw_data:
            self.data = None
        return self._constructed

    def _construct_from_file(self, cfg: Config) -> Optional[BinnedDataset]:
        """The binned dataset of a binary cache or of a streamed text file
        (the label, weights, groups and init score given here override the
        file's); None after parsing a text file into ``self.data``, which
        ``construct`` then bins like an array."""
        if BinnedDataset.is_binary_cache(self.data_path):
            # DatasetLoader::LoadFromBinFile
            ds = BinnedDataset.load_binary(self.data_path)
        else:
            from .data.ingest import should_stream, stream_dataset

            if not should_stream(self.data_path, cfg):
                from .io.parser import load_text_file

                feats, label, weights, group, names, self.label_idx = load_text_file(
                    self.data_path, cfg)
                self.data = feats
                if self.label is None:
                    self.label = label
                if self.weight is None:
                    self.weight = weights
                if self.group is None:
                    self.group = group
                if self.feature_name == "auto":
                    self.feature_name = names
                return None
            ref = self.reference.construct() if self.reference is not None else None
            ds = stream_dataset(self.data_path, cfg, feature_name=self.feature_name,
                                categorical_feature=self.categorical_feature, reference=ref)
            self.label_idx = ds.label_idx
        md = ds.metadata
        if self.label is not None:
            md.set_label(self.label)
        if self.weight is not None:
            md.set_weights(self.weight)
        if self.group is not None:
            md.set_query(self.group)
        if self.init_score is not None:
            md.set_init_score(self.init_score)
        return ds

    def _remap_categorical_to_reference(self, ref: "Dataset") -> None:
        """A validation frame's category codes follow its own levels; the
        trees' thresholds follow the training set's.  Re-code each column
        through the reference's ``pandas_categorical`` (levels unseen in
        training become NaN); the categorical column counts must match."""
        train_levels = ref.pandas_categorical or []
        my_levels = self.pandas_categorical or []
        if not my_levels and not train_levels:
            return
        if len(my_levels) != len(train_levels):
            Log.fatal("train and valid dataset categorical_feature do not match: valid has %d "
                      "pandas categorical columns, train has %d", len(my_levels),
                      len(train_levels))
        if self.data is None:
            return
        for col_idx, vl, tl in zip(self._auto_categorical, my_levels, train_levels):
            if list(vl) == list(tl):
                continue
            pos = {v: i for i, v in enumerate(tl)}
            lut = np.asarray([pos.get(v, np.nan) for v in vl], np.float64)
            col = np.asarray(self.data[:, col_idx], np.float64)
            ok = ~np.isnan(col)
            out = np.full(col.shape, np.nan)
            out[ok] = lut[col[ok].astype(np.int64)]
            self.data[:, col_idx] = out
        self.pandas_categorical = [list(t) for t in train_levels]

    def create_valid(self, data, label=None, weight=None, group=None, init_score=None,
                     silent: bool = False, params=None) -> "Dataset":
        """A validation Dataset (an array, a frame or a data file) binned
        with this one's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight, group=group,
                       init_score=init_score, silent=silent, params=params or self.params)

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._constructed is not None:
            self._constructed.metadata.set_label(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._constructed is not None:
            self._constructed.metadata.set_weights(weight)
        return self

    def set_group(self, group) -> "Dataset":
        """Per-query sizes of a ranking task (Metadata::SetQuery)."""
        self.group = group
        if self._constructed is not None:
            self._constructed.metadata.set_query(group)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._constructed is not None:
            self._constructed.metadata.set_init_score(init_score)
        return self

    def get_group(self):
        return None if self.group is None else np.asarray(self.group)

    def get_label(self):
        if self._constructed is not None:
            return np.asarray(self._constructed.metadata.label)
        return None if self.label is None else np.asarray(self.label)

    def get_weight(self):
        if self._constructed is not None and self._constructed.metadata.weights is not None:
            return np.asarray(self._constructed.metadata.weights)
        return None if self.weight is None else np.asarray(self.weight)

    def get_init_score(self):
        return None if self.init_score is None else np.asarray(self.init_score)

    @classmethod
    def _of_binned(cls, binned: BinnedDataset) -> "Dataset":
        """A constructed Dataset over ``binned`` (no raw data): what a
        custom metric receives for a validation set."""
        ds = cls.__new__(cls)
        ds.data, ds.data_path = None, None
        ds._constructed = binned
        ds.label, ds.weight, ds.init_score = None, binned.metadata.weights, None
        qb = binned.metadata.query_boundaries
        ds.group = None if qb is None else np.diff(qb)
        return ds

    def num_data(self) -> int:
        if self._constructed is not None:
            return self._constructed.num_data
        return 0 if self.data is None else self.data.shape[0]

    def num_feature(self) -> int:
        if self._constructed is not None:
            return self._constructed.num_total_features
        return 0 if self.data is None else self.data.shape[1]

    def save_binary(self, filename: str) -> "Dataset":
        """Write the binned dataset to ``filename`` as a binary dataset
        cache (Dataset::SaveBinaryFile; the JAX package's format, which
        either package loads).  A dataset built from a text file records
        that file's identity, so the cache is refused once the file
        changes."""
        self.construct().save_binary(filename, source_path=self.data_path)
        return self

    def subset(self, used_indices, params=None) -> "Dataset":
        """A row subset sharing this dataset's bin mappers and binned rows
        (Dataset::CopySubset; cv's folds): nothing is re-binned."""
        used_indices = np.asarray(used_indices)
        sub = Dataset.__new__(Dataset)
        sub.data_path = None
        sub.label_idx = self.label_idx
        sub.data = self.data[used_indices] if self.data is not None else None
        sub.pandas_columns = self.pandas_columns
        sub._auto_categorical = list(self._auto_categorical)
        sub.pandas_categorical = list(self.pandas_categorical)
        sub.label = sub.weight = sub.init_score = None
        sub.reference = self
        sub.params = dict(params) if params else dict(self.params)
        sub.feature_name = self.feature_name
        sub.categorical_feature = self.categorical_feature
        sub.free_raw_data = False
        sub._constructed = self.construct().subset(used_indices)
        qb = sub._constructed.metadata.query_boundaries
        sub.group = None if qb is None else np.diff(qb)
        return sub


class Booster:
    """Training/prediction handle (basic.py:1176 Booster)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None, model_file: Optional[str] = None,
                 model_str: Optional[str] = None, silent: bool = False, device=None):
        self.params = dict(params) if params else {}
        self.device = resolve_device(device)
        self.config = Config.from_params(self.params)
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._name_to_index: Dict[str, int] = {}
        self.pandas_categorical = []
        self._init_predictor: Optional["Booster"] = None  # continued training's initial model
        if train_set is not None:
            self.pandas_categorical = train_set.pandas_categorical
            binned = train_set.construct(extra_params=self.params)
            self.train_dataset = train_set
            self.objective = create_objective(self.config)
            self.boosting = create_boosting(self.config.boosting_type, self.device)
            # training metrics only when asked (is_provide_training_metric);
            # the engine evaluates "training" as a validation set instead
            training_metrics = (self._make_metrics(binned) if self.config.is_training_metric
                                else [])
            self.boosting.init(self.config, binned, self.objective, training_metrics)
            self._num_datasets = 1
        elif model_file is not None or model_str is not None:
            self.boosting = create_boosting("gbdt", self.device)
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            model_str = self._strip_pandas_categorical(model_str)
            self.boosting.config = self.config
            self.boosting.load_model_from_string(model_str)
            self.objective = objective_from_string(self.boosting.objective_name_loaded)
            self.boosting.objective = self.objective
            self.train_dataset = None
            self._num_datasets = 0
        else:
            Log.fatal("Booster needs a train_set, model_file or model_str")

    def _strip_pandas_categorical(self, model_str: str) -> str:
        """Parse and remove the trailing ``pandas_categorical:`` line that
        ``model_to_string`` writes; the span is cut from the raw line, so
        CRLF files and trailing blanks strip cleanly."""
        marker = "\npandas_categorical:"
        pos = model_str.rfind(marker)
        if pos >= 0:
            raw_line, _, rest = model_str[pos + len(marker):].partition("\n")
            try:
                self.pandas_categorical = json.loads(raw_line.strip()) or []
            except ValueError:
                self.pandas_categorical = []
            model_str = model_str[:pos] + rest
        return model_str

    def _make_metrics(self, binned):
        """The configured metrics (the objective's name when none is set),
        bound to ``binned``'s labels and weights; unknown names warn."""
        names = self.config.metric or metric_names_for_objective(self.config.objective)
        metrics = []
        for name in names:
            if name.lower() in ("none", "null", ""):
                continue
            m = create_metric(name, self.config)
            if m is None:
                Log.warning("Unknown metric %s", name)
                continue
            m.init(binned.metadata, binned.num_data)
            metrics.append(m)
        return metrics

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Evaluate ``data`` (built with ``reference=`` the training
        Dataset) under ``name`` after every iteration.  In continued
        training its scores start from the initial model's predictions of
        its raw rows."""
        binned = data.construct()
        init = None
        if self._init_predictor is not None:
            if data.data is None:
                Log.fatal("Continued training requires the raw validation data")
            init = self._init_predictor.boosting.predict_raw_scores(data.data)
        self.boosting.add_valid(binned, self._make_metrics(binned), name, init_scores=init)
        self._name_to_index[name] = self._num_datasets
        self._num_datasets += 1
        return self

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; True when training should stop.  With
        a custom objective ``fobj(preds, train_set) -> (grad, hess)``
        (LGBM_BoosterUpdateOneIterCustom), ``preds`` are the raw training
        scores, (N,) or class-major (K*N,), and the iteration trains on
        the gradients it returns."""
        if fobj is None:
            return self.boosting.train_iters(1)
        grad, hess = fobj(self._raw_train_scores(), self.train_dataset)
        return self.boosting.train_one_iter_custom(grad, hess)

    def _raw_train_scores(self) -> np.ndarray:
        sc = self.boosting.train_score_host()
        return sc[0] if sc.shape[0] == 1 else sc.reshape(-1)

    def rollback_one_iter(self) -> "Booster":
        """Remove the last iteration's trees and their scores
        (LGBM_BoosterRollbackOneIter)."""
        self.boosting.rollback_one_iter()
        return self

    def current_iteration(self) -> int:
        return self.boosting.current_iteration()

    @property
    def num_trees(self) -> int:
        return self.boosting.num_trees

    # ------------------------------------------------------------------
    def eval_train(self, feval=None):
        """[(data name, metric name, value, bigger_is_better), ...] of the
        training set's metrics, then of ``feval``'s."""
        return self._inner_eval("training", 0, feval)

    def eval_valid(self, feval=None):
        """The same for every validation set, in the order added."""
        out = []
        for name, idx in self._name_to_index.items():
            out.extend(self._inner_eval(name, idx, feval))
        return out

    def eval(self, data: Dataset, name: str, feval=None):
        """The metrics of the validation set added as ``name``."""
        if name not in self._name_to_index:
            Log.fatal("Dataset %s was not added with add_valid", name)
        return self._inner_eval(name, self._name_to_index[name], feval)

    def _inner_eval(self, data_name: str, data_idx: int, feval=None):
        """The configured metrics, then a custom ``feval(preds, data) ->
        (name, value, bigger_is_better)`` (or a list of them) on the raw
        scores, (N,) or class-major (K*N,)."""
        results = [(data_name, name, val, bigger)
                   for name, val, bigger in self.boosting.get_eval_at(data_idx)]
        if feval is not None:
            if data_idx == 0:
                preds, fdata = self._raw_train_scores(), self.train_dataset
            else:
                sc = self.boosting.valid_score_host(data_idx - 1)
                preds = sc[0] if sc.shape[0] == 1 else sc.reshape(-1)
                fdata = Dataset._of_binned(self.boosting.valid_sets[data_idx - 1])
            ret = feval(preds, fdata)
            for name, val, bigger in [ret] if isinstance(ret, tuple) else ret:
                results.append((data_name, name, val, bigger))
        return results

    # ------------------------------------------------------------------
    def predict(self, data, num_iteration: int = -1, raw_score: bool = False,
                pred_leaf: bool = False, data_has_header: bool = False,
                is_reshape: bool = True, **kwargs) -> np.ndarray:
        """Predictions of the first ``num_iteration`` iterations; -1 (the
        default) takes every tree the booster holds, also after early
        stopping, as the JAX package's ``Booster.predict`` does; pass
        ``num_iteration=bst.best_iteration`` for the best iteration's.
        ``pred_leaf`` gives each row's leaf index in every tree, (N, T)
        int32.  Prediction parameters (``pred_early_stop``,
        ``pred_early_stop_freq``, ``pred_early_stop_margin``) come from the
        booster's params, and ``kwargs`` override them for this call.  A
        DataFrame's category columns are coded through the training
        levels.  ``data`` may be a text file (CSV, TSV or LibSVM), parsed
        with the booster's column parameters (``label_column``,
        ``ignore_column``, ...), its label column left out; it has a header
        when ``data_has_header`` or the ``header`` parameter says so.
        ``is_reshape`` concerns flat outputs, which this package does not
        produce."""
        config = Config.from_params(dict(self.params, **kwargs)) if kwargs else self.config
        if isinstance(data, str):
            from .io.parser import load_text_file

            file_config = config
            if data_has_header and not config.has_header:
                file_config = copy.copy(config)
                file_config.has_header = True
            data = load_text_file(data, file_config)[0]
        data = _to_2d_float(_map_pandas_categorical(data, self.pandas_categorical))[0]
        return self.boosting.predict(data, num_iteration=num_iteration, raw_score=raw_score,
                                     pred_leaf=pred_leaf, config=config)

    def save_model(self, filename: str, num_iteration: int = -1) -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration))
        return self

    def model_to_string(self, num_iteration: int = -1) -> str:
        s = self.boosting.save_model_to_string(num_iteration)
        if self.pandas_categorical:
            s += "\npandas_categorical:" + json.dumps(self.pandas_categorical, default=str) + "\n"
        return s

    def dump_model(self, num_iteration: int = -1) -> dict:
        """The model as JSON (GBDT::DumpModel, gbdt.cpp:702-736)."""
        b = self.boosting
        return {
            "name": b.sub_model_name(),
            "version": "v2",
            "num_class": b.num_class,
            "num_tree_per_iteration": b.num_tree_per_iteration,
            "label_index": b.label_idx,
            "max_feature_idx": b.max_feature_idx,
            "objective": b.objective.to_string() if b.objective else "",
            "feature_names": list(b.feature_names),
            "tree_info": [t.to_json() for t in b._used_models(num_iteration)],
        }

    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        """(F,) split counts (``"split"``) or summed split gains
        (``"gain"``) of every tree, by original feature."""
        return self.boosting.feature_importance(importance_type)

    def feature_name(self) -> List[str]:
        return list(self.boosting.feature_names)

    # pickling goes through the model text; the device travels with it
    # and must exist where the booster is unpickled
    def __getstate__(self):
        return {"params": self.params, "model_str": self.model_to_string(),
                "best_iteration": self.best_iteration, "best_score": self.best_score,
                "device": str(self.device)}

    def __setstate__(self, state):
        new = Booster(params=state["params"], model_str=state["model_str"],
                      device=state["device"])
        self.__dict__.update(new.__dict__)
        self.best_iteration = state["best_iteration"]
        self.best_score = state["best_score"]

    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, memo):
        return Booster(params=self.params, model_str=self.model_to_string(), device=self.device)
