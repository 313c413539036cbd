"""``train`` — PyTorch counterpart of lightgbm_tpu/engine.py (engine.py:23-320,
python-package/lightgbm/engine.py train:17-199) with validation sets,
metrics, callbacks and early stopping.

Three loops, as in the JAX package:

- no validation set, no before-iteration callback, no early stopping
  and no custom objective: the trainer runs every iteration in one
  chunk; the after-iteration callbacks then see each iteration with no
  results;
- ``output_freq`` > 1 and no custom objective: chunks of ``output_freq``
  iterations, evaluated and passed to the callbacks at each chunk's end;
- otherwise one iteration at a time, evaluated after each.

A custom objective ``fobj`` sets ``objective`` to ``none`` unless the
parameters name one, so the mask grower trains on its gradients; a
custom metric ``feval`` joins every evaluation.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

from . import callback as callback_mod
from .basic import Booster, Dataset
from .config import canonicalize_params
from .utils.log import Log

_NOT_YET = ("init_model", "checkpoint_dir", "checkpoint_manager")


def train(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
          valid_sets=None, valid_names=None, fobj=None, feval=None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[dict] = None, verbose_eval=True, learning_rates=None,
          callbacks=None, device=None, **kwargs) -> Booster:
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
    ``init_model`` and checkpoints are not ported yet and raise
    NotImplementedError."""
    for name in _NOT_YET:
        if kwargs.pop(name, None) is not None:
            raise NotImplementedError(f"lightgbm_tpu_torch does not support {name} yet")
    if kwargs:
        raise TypeError(f"train() got unexpected arguments {sorted(kwargs)}")
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

    booster = Booster(params=params, train_set=train_set, device=device)

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

    def evaluate():
        results = []
        if name_list:
            if eval_train:
                results.extend(booster.eval_train(feval))
            results.extend(booster.eval_valid(feval))
        return results

    def after(i, results) -> bool:
        """Run the after-iteration callbacks; True when early stopping
        fired (best_iteration and best_score are then set)."""
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(booster, params, i, 0, num_boost_round, results))
        except callback_mod.EarlyStopException as es:
            booster.best_iteration = es.best_iteration + 1
            _record_best_score(booster, es.best_score)
            return True
        return False

    period = int(canon.get("output_freq", 1))
    if fobj is None and not name_list and not cbs_before and not early_stopping_rounds:
        # one chunk: nothing to decide between iterations
        iter_before = gbdt.iter
        gbdt.train_iters(num_boost_round)
        for t in range(gbdt.iter - iter_before):
            if after(t, []):
                break
    elif fobj is None and not cbs_before and period > 1:
        # chunks of output_freq iterations, evaluated at each chunk's end
        # (the reference CLI evaluates at output_freq, application.cpp:225-250)
        i = 0
        while i < num_boost_round:
            step = min(period, num_boost_round - i)
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
        for i in range(num_boost_round):
            for cb in cbs_before:
                cb(callback_mod.CallbackEnv(booster, params, i, 0, num_boost_round, None))
            finished = booster.update(fobj=fobj)
            if after(i, evaluate()):
                break
            if finished:
                Log.info("Finished training with %d iterations", i + 1)
                break
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
    return booster


def _record_best_score(booster: Booster, best_score_list) -> None:
    """{data name: {metric name: value}} of the best iteration."""
    if not best_score_list:
        return
    out: Dict[str, Dict[str, float]] = collections.defaultdict(dict)
    for item in best_score_list:
        out[item[0]][item[1]] = item[2]
    booster.best_score = dict(out)
