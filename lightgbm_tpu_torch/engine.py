"""``train`` and ``cv`` — PyTorch counterpart of lightgbm_tpu/engine.py
(engine.py:23-489, python-package/lightgbm/engine.py train:17-199,
cv:~250) with validation sets, metrics, callbacks, early stopping and
continued training (``init_model``).

Three loops, as in the JAX package:

- no validation set, no before-iteration callback, no early stopping
  and no custom objective: the trainer runs every iteration in one
  chunk; the after-iteration callbacks then see each iteration with no
  results;
- ``output_freq`` > 1 and no custom objective: chunks of ``output_freq``
  iterations, evaluated and passed to the callbacks at each chunk's end;
- otherwise one iteration at a time, evaluated after each.

With a checkpoint manager (``checkpoint_dir`` or ``checkpoint_manager``)
the chunks of the first two loops end on its checkpoint steps (the
manager captures between chunks; the trees do not depend on the
chunking), a preemption ends training at the next boundary with the
state on disk, and a resumed run counts its iterations from the restored
one (engine.py:135-200).

A custom objective ``fobj`` sets ``objective`` to ``none`` unless the
parameters name one, so the mask grower trains on its gradients; a
custom metric ``feval`` joins every evaluation.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .ckpt.manager import PreemptionExit
from .config import canonicalize_params
from .obs import tracer
from .obs.audit import audit
from .parallel.net import NetError
from .utils.log import Log


def train(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
          valid_sets=None, valid_names=None, fobj=None, feval=None, init_model=None,
          feature_name="auto", categorical_feature="auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[dict] = None, verbose_eval=True, learning_rates=None,
          keep_training_booster: bool = True, callbacks=None,
          checkpoint_dir: Optional[str] = None, checkpoint_freq: int = 0,
          checkpoint_keep: int = 3, checkpoint_resume="auto", checkpoint_manager=None,
          device=None, **kwargs) -> Booster:
    """Train a booster on ``device`` (``None``: the CUDA card; raises when
    none is present; ``"cpu"`` runs the kernels' plain PyTorch versions).

    ``valid_sets`` (Datasets built with ``reference=train_set``, or
    ``train_set`` itself, named "training") are evaluated with the
    configured metrics; ``early_stopping_rounds`` (or the
    ``early_stopping_round`` parameter) stops when no validation metric
    improved for that many iterations and sets ``best_iteration`` and
    ``best_score``; ``evals_result`` receives the history;
    ``learning_rates`` is a list or a function of the iteration.
    ``fobj(preds, train_set) -> (grad, hess)`` is a custom objective on
    the raw scores; ``feval(preds, data) -> (name, value,
    bigger_is_better)`` (or a list of them) a custom metric.
    ``init_model`` (a Booster or a model file) continues training from
    its trees: the new trees are added after them, the training scores
    start from its predictions of ``train_set``'s raw rows.
    ``feature_name`` and ``categorical_feature`` override the Dataset's;
    ``keep_training_booster`` is accepted for the reference's signature
    (the booster returned can always train on).

    Checkpoints (ckpt/): ``checkpoint_dir`` and ``checkpoint_freq`` (or the
    parameters of those names, or a ``checkpoint_manager``) write the
    whole training state every ``checkpoint_freq`` iterations, keeping the
    last ``checkpoint_keep``.  ``checkpoint_resume`` is ``"auto"`` (resume
    an interrupted run, not a completed one), ``False`` (never) or
    ``"force"`` (a checkpoint is required).  A resumed run is bit for bit
    the run that never stopped."""
    if kwargs:
        raise TypeError(f"train() got unexpected arguments {sorted(kwargs)}")
    tracer.refresh_from_env()  # LIGHTGBM_TPU_TRACE=trace.jsonl
    audit.refresh_from_env()  # LIGHTGBM_TPU_AUDIT=audit.jsonl
    params = dict(params or {})
    canon = canonicalize_params(params)
    num_boost_round = int(canon.pop("num_iterations", num_boost_round))
    if "early_stopping_round" in canon:
        early_stopping_rounds = int(canon["early_stopping_round"])
    # the loop below owns the iteration count and early stopping
    for alias in ("num_iterations", "num_iteration", "num_tree", "num_trees", "num_round",
                  "num_rounds", "num_boost_round", "early_stopping_round",
                  "early_stopping_rounds", "early_stopping"):
        params.pop(alias, None)
    if fobj is not None:
        params.setdefault("objective", "none")
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature

    with tracer.span("booster_init"):
        booster = Booster(params=params, train_set=train_set, device=device)
    tracer.event("train_begin", num_boost_round=num_boost_round,
                 objective=str(params.get("objective", "")),
                 num_leaves=str(params.get("num_leaves", "")),
                 num_data=train_set.num_data(), mode="in_memory")
    if init_model is not None:
        _apply_init_model(booster, init_model, train_set)

    name_list: List[str] = []
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        for i, vs in enumerate(valid_sets):
            if vs is train_set:
                name_list.append("training")
                continue
            name = valid_names[i] if valid_names is not None and i < len(valid_names) \
                else f"valid_{i}"
            booster.add_valid(vs, name)
            name_list.append(name)
    eval_train = "training" in name_list

    # callbacks (engine.py:120-152)
    cbs = set(callbacks or [])
    if verbose_eval is True:
        cbs.add(callback_mod.print_evaluation())
    elif isinstance(verbose_eval, int) and verbose_eval is not False:
        cbs.add(callback_mod.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        cbs.add(callback_mod.early_stopping(early_stopping_rounds, verbose=bool(verbose_eval)))
    if learning_rates is not None:
        cbs.add(callback_mod.reset_parameter(learning_rate=learning_rates))
    if evals_result is not None:
        cbs.add(callback_mod.record_evaluation(evals_result))
    cbs_before = sorted((c for c in cbs if getattr(c, "before_iteration", False)),
                        key=lambda c: getattr(c, "order", 0))
    cbs_after = sorted((c for c in cbs if not getattr(c, "before_iteration", False)),
                       key=lambda c: getattr(c, "order", 0))
    gbdt = booster.boosting

    # checkpoints: the parameters may carry the config's keys; the
    # arguments win
    ckpt_mgr, own_mgr = checkpoint_manager, False
    if ckpt_mgr is None:
        cdir = checkpoint_dir or str(canon.get("checkpoint_dir", "") or "")
        if cdir:
            from .ckpt import CheckpointManager

            ckpt_mgr = CheckpointManager(
                cdir, freq=int(checkpoint_freq or canon.get("checkpoint_freq", 0) or 0),
                keep_last=int(canon.get("checkpoint_keep", checkpoint_keep)))
            own_mgr = True
    start_iter = 0
    if ckpt_mgr is not None:
        ckpt_mgr.track_callbacks(cbs_before + cbs_after)
        cbs_after = sorted(cbs_after + [ckpt_mgr], key=lambda c: getattr(c, "order", 0))
        resume = checkpoint_resume.lower() if isinstance(checkpoint_resume, str) \
            else checkpoint_resume
        if resume not in (False, None, "false", "0", "none"):
            state = ckpt_mgr.try_restore(booster, require=resume == "force",
                                         ignore_complete=resume == "force")
            if state is not None:
                start_iter = state.iteration

    def bounded(step: int, i: int) -> int:
        """A chunk's length clipped to end on the next checkpoint step
        (``_ckpt_bounded``: the manager captures between chunks)."""
        if ckpt_mgr is not None:
            step = min(step, ckpt_mgr.boundary(i, i + step) - i)
        return max(step, 1)

    def evaluate():
        results = []
        if name_list:
            with tracer.span("eval", iter=gbdt.iter):
                if eval_train:
                    results.extend(booster.eval_train(feval))
                results.extend(booster.eval_valid(feval))
        return results

    def after(i, results) -> bool:
        """Run the after-iteration callbacks; True when training ends
        here: early stopping fired (best_iteration and best_score are then
        set) or a preemption's checkpoint was flushed."""
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(booster, params, i, 0, num_boost_round, results))
        except callback_mod.EarlyStopException as es:
            booster.best_iteration = es.best_iteration + 1
            _record_best_score(booster, es.best_score)
            return True
        except PreemptionExit:
            return True
        return False

    def iterate() -> None:
        period = int(canon.get("output_freq", 1))
        if fobj is None and not name_list and not cbs_before and not early_stopping_rounds:
            # nothing to decide between iterations: one chunk, or chunks
            # ending on checkpoint steps
            i = start_iter
            while i < num_boost_round:
                step = bounded(num_boost_round - i, i)
                iter_before = gbdt.iter
                gbdt.train_iters(step)
                done = gbdt.iter - iter_before
                if any(after(i + t, []) for t in range(done)):
                    break
                i += done
                if done < step:
                    break
        elif fobj is None and not cbs_before and period > 1:
            # chunks of output_freq iterations, evaluated at each chunk's end
            # (the reference CLI evaluates at output_freq, application.cpp:225-250)
            i = start_iter
            while i < num_boost_round:
                step = bounded(min(period, num_boost_round - i), i)
                iter_before = gbdt.iter
                gbdt.train_iters(step)
                done = gbdt.iter - iter_before
                i += done
                if after(i - 1, evaluate()):
                    break
                if done < step:
                    Log.info("Finished training with %d iterations", i)
                    break
        else:
            for i in range(start_iter, num_boost_round):
                for cb in cbs_before:
                    cb(callback_mod.CallbackEnv(booster, params, i, 0, num_boost_round, None))
                finished = booster.update(fobj=fobj)
                if after(i, evaluate()):
                    break
                if finished:
                    Log.info("Finished training with %d iterations", i + 1)
                    break

    try:
        iterate()
    except BaseException as e:
        if ckpt_mgr is not None:  # the last checkpoint is durable before the error leaves
            ckpt_mgr.flush()
            if own_mgr:
                ckpt_mgr.close()
        if isinstance(e, NetError):
            _net_abort(e)
        raise
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
    if ckpt_mgr is not None:
        if ckpt_mgr.preempted:
            ckpt_mgr.flush()  # the resumable state stays
        else:
            ckpt_mgr.mark_complete(booster)
        if own_mgr:
            ckpt_mgr.close()
    return booster


def _net_abort(e: NetError) -> None:
    """The cooperative abort (JAX engine.py:166-180): a peer died or a
    collective timed out, the last complete checkpoint has been flushed;
    the typed error goes on to the caller (the CLI maps it to exit code 75
    or 74) and the next run resumes from that checkpoint."""
    Log.warning("Training aborted by transport failure (%s): %s — latest completed "
                "checkpoint preserved; rerun to auto-resume", type(e).__name__, e)


def _record_best_score(booster: Booster, best_score_list) -> None:
    """{data name: {metric name: value}} of the best iteration."""
    if not best_score_list:
        return
    out: Dict[str, Dict[str, float]] = collections.defaultdict(dict)
    for item in best_score_list:
        out[item[0]][item[1]] = item[2]
    booster.best_score = dict(out)


def _apply_init_model(booster: Booster, init_model, train_set: Dataset) -> None:
    """Continued training (engine.py:343-385, gbdt.cpp input_model): the
    initial model's trees go first, and the training scores start from
    its raw predictions of ``train_set``'s rows.  The initial model must
    read the same features and grow as many trees an iteration."""
    if isinstance(init_model, Booster):
        model_str = init_model.model_to_string()
    else:
        with open(init_model) as f:
            model_str = f.read()
    prev = Booster(params=booster.params, model_str=model_str, device=booster.device)
    b = booster.boosting
    prev_nf = int(prev.boosting.max_feature_idx) + 1
    new_nf = int(train_set.num_feature())
    if prev_nf > 0 and prev_nf != new_nf:
        Log.fatal("init_model was trained on %d features but the new training data has %d — "
                  "continued training requires the same feature schema (same columns, same "
                  "order). Retrain from scratch, or fix the data source that drifted.",
                  prev_nf, new_nf)
    prev_tpi = int(max(prev.boosting.num_tree_per_iteration, 1))
    new_tpi = int(max(b.num_tree_per_iteration, 1))
    if prev_tpi != new_tpi:
        Log.fatal("init_model boosts %d tree(s) per iteration but the new training config "
                  "boosts %d (different objective/num_class?) — continued training requires "
                  "the same objective shape.", prev_tpi, new_tpi)
    b.models = prev.boosting.models + b.models
    b.num_init_trees = len(prev.boosting.models)
    b.num_init_iteration = len(prev.boosting.models) // prev_tpi
    b.boost_from_average_ = prev.boosting.boost_from_average_
    if train_set.data is None:
        Log.fatal("Continued training requires the raw training data")
    init_scores = prev.boosting.predict_raw_scores(np.asarray(train_set.data, np.float64))
    b.add_init_scores(init_scores.astype(np.float32))
    booster._init_predictor = prev


def _metric_rank(name: str, params: Dict[str, Any]) -> int:
    """Position of a result metric in the configured metric list (a
    prefix match takes decorated names like ndcg@5); unknown: last."""
    metric = params.get("metric", "")
    if isinstance(metric, str):
        metric = [m for m in metric.replace(",", " ").split() if m]
    for i, m in enumerate(metric or []):
        if name == m or name.startswith(str(m)):
            return i
    return 1 << 30


def _make_n_folds(n: int, label, nfold: int, stratified: bool, shuffle: bool, seed: int):
    """[(train indices, test indices)] of each fold (engine.py _make_n_folds):
    scikit-learn's StratifiedKFold for ``stratified`` when it imports,
    else contiguous parts of a RandomState(seed) permutation."""
    if stratified:
        try:
            from sklearn.model_selection import StratifiedKFold
        except ImportError:
            stratified = False
        else:
            skf = StratifiedKFold(n_splits=nfold, shuffle=shuffle,
                                  random_state=seed if shuffle else None)
            return list(skf.split(np.zeros(n), label))
    idx = np.random.RandomState(seed).permutation(n) if shuffle else np.arange(n)
    parts = np.array_split(idx, nfold)
    return [(np.concatenate([parts[j] for j in range(nfold) if j != i]), parts[i])
            for i in range(nfold)]


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 10, folds=None,
       nfold: int = 5, stratified: bool = False, shuffle: bool = True, metrics=None,
       fobj=None, feval=None, init_model=None, feature_name="auto",
       categorical_feature="auto", early_stopping_rounds: Optional[int] = None,
       fpreproc=None, verbose_eval=None, show_stdv: bool = True, seed: int = 0,
       callbacks=None, return_cvbooster: bool = False,
       device=None) -> Dict[str, List[float]]:
    """k-fold cross-validation (engine.py:388-489): one booster a fold on
    ``device`` (``None``: the CUDA card), each trained on the other folds'
    rows of ``train_set`` (subsets sharing its bins) and evaluated on its
    own, one iteration of every fold at a time.  Returns {"<metric>-mean":
    [...], "<metric>-stdv": [...]} over the iterations.

    ``folds`` (pairs of train and test indices) replace the ``nfold``
    folds of a RandomState(``seed``) permutation (``shuffle``), or of
    scikit-learn's StratifiedKFold (``stratified``, when it imports);
    ``fpreproc(train, test, params)`` may change a fold's data and
    params; ``init_model`` continues every fold from that model;
    ``early_stopping_rounds`` stops when the first configured metric's
    mean has not improved for that many iterations and cuts the results
    at its best.  ``callbacks`` run after each iteration with the
    aggregated results ("cv_agg", name, mean, bigger_is_better, stdv);
    an early-stopping callback's stop cuts them the same way.  With
    ``return_cvbooster`` the fold boosters come back under "cvbooster"
    (the reference's later option)."""
    params = dict(params or {})
    if metrics is not None:
        params["metric"] = metrics
    canon = canonicalize_params(params)
    num_boost_round = int(canon.pop("num_iterations", num_boost_round))
    for alias in ("num_iterations", "num_iteration", "num_tree", "num_trees", "num_round",
                  "num_rounds", "num_boost_round"):
        params.pop(alias, None)
    if fobj is not None:
        params.setdefault("objective", "none")
    if feature_name != "auto":
        train_set.feature_name = feature_name
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature

    full = train_set.construct()
    if folds is None:
        folds = _make_n_folds(full.num_data, np.asarray(full.metadata.label), nfold,
                              stratified, shuffle, seed)
    boosters = []
    for train_idx, test_idx in folds:
        tr = train_set.subset(np.sort(train_idx))
        te = train_set.subset(np.sort(test_idx))
        fold_params = params.copy()
        if fpreproc is not None:
            tr, te, fold_params = fpreproc(tr, te, fold_params)
        bst = Booster(params=fold_params, train_set=tr, device=device)
        if init_model is not None:
            _apply_init_model(bst, init_model, tr)
        bst.add_valid(te, "valid")
        boosters.append(bst)

    cbs = sorted(callbacks or [], key=lambda c: getattr(c, "order", 0))
    cbs_before = [c for c in cbs if getattr(c, "before_iteration", False)]
    cbs_after = [c for c in cbs if not getattr(c, "before_iteration", False)]
    results = collections.defaultdict(list)
    history: List[Dict[str, float]] = []
    for i in range(num_boost_round):
        for cb in cbs_before:
            cb(callback_mod.CallbackEnv(boosters, params, i, 0, num_boost_round, None))
        merged = collections.defaultdict(list)
        for bst in boosters:
            bst.update(fobj=fobj)
            for _, name, val, bigger in bst.eval_valid(feval):
                merged[(name, bigger)].append(val)
        agg = []
        for (name, bigger), vals in merged.items():
            mean, std = float(np.mean(vals)), float(np.std(vals))
            results[name + "-mean"].append(mean)
            results[name + "-stdv"].append(std)
            agg.append(("cv_agg", name, mean, bigger, std))
        history.append({name: mean for _, name, mean, _, _ in agg})
        if verbose_eval:
            Log.info("[%d]\t%s", i + 1, "\t".join(
                f"cv_agg {name}: {mean:g}" + (f" + {std:g}" if show_stdv else "")
                for _, name, mean, _, std in agg))
        best = None
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(boosters, params, i, 0, num_boost_round, agg))
        except callback_mod.EarlyStopException as es:
            best = es.best_iteration
        if best is None and early_stopping_rounds and len(history) > early_stopping_rounds:
            # the first configured metric decides (the reference keys early
            # stopping off the config's order)
            name, bigger = min(merged.keys(), key=lambda kb: _metric_rank(kb[0], params))
            series = results[name + "-mean"]
            at = int(np.argmax(series) if bigger else np.argmin(series))
            if len(series) - 1 - at >= early_stopping_rounds:
                best = at
        if best is not None:
            for k in list(results.keys()):
                results[k] = results[k][:best + 1]
            break
    out = dict(results)
    if return_cvbooster:
        out["cvbooster"] = boosters
    return out
