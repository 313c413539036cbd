"""Training callbacks — PyTorch-port copy of lightgbm_tpu/callback.py
(python-package/lightgbm/callback.py print_evaluation:35,
record_evaluation:73, reset_parameter:106, early_stopping:141).

``record_evaluation`` and ``early_stopping`` carry the checkpoint hooks
(``ckpt_name``, ``ckpt_state``, ``ckpt_restore``; callback.py:81-95,
185-211) through which ``ckpt.CheckpointManager`` saves and restores
their state, so a resumed run records the same history and stops where
the uninterrupted run stops.
"""

from __future__ import annotations

import collections
from typing import Callable, List

from .utils.log import Log


class EarlyStopException(Exception):
    """Raised by early_stopping to halt train() (callback.py:11-19)."""

    def __init__(self, best_iteration: int, best_score=None):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"],
)


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Log evaluation results every ``period`` iterations
    (callback.py:35-70)."""

    def callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list and (env.iteration + 1) % period == 0:
            result = "\t".join(
                _format_eval_result(x, show_stdv) for x in env.evaluation_result_list
            )
            Log.info("[%d]\t%s", env.iteration + 1, result)

    callback.order = 10
    return callback


log_evaluation = print_evaluation  # the reference's later name


def record_evaluation(eval_result: dict) -> Callable:
    """Record eval history into ``eval_result`` (callback.py:73-103)."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")
    eval_result.clear()

    def init(env: CallbackEnv) -> None:
        for item in env.evaluation_result_list:
            data_name, eval_name = item[0], item[1]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])

    def callback(env: CallbackEnv) -> None:
        if not eval_result:
            init(env)
        for item in env.evaluation_result_list:
            data_name, eval_name, result = item[0], item[1], item[2]
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])
            eval_result[data_name][eval_name].append(result)

    # checkpoint hooks: the history lives in the caller's dict
    def ckpt_state():
        return {d: {m: list(v) for m, v in dd.items()} for d, dd in eval_result.items()}

    def ckpt_restore(state):
        eval_result.clear()
        for d, dd in state.items():
            eval_result[d] = collections.OrderedDict(
                (m, [float(x) for x in v]) for m, v in dd.items())

    callback.order = 20
    callback.ckpt_name = "record_evaluation"
    callback.ckpt_state = ckpt_state
    callback.ckpt_restore = ckpt_restore
    return callback


def reset_parameter(**kwargs) -> Callable:
    """Reset parameters (e.g. learning_rate) per iteration from a list or
    a function of the iteration index (callback.py:106-138)."""

    def callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(
                        f"Length of list {key!r} has to equal to 'num_boost_round'."
                    )
                new_param = value[env.iteration - env.begin_iteration]
            else:
                new_param = value(env.iteration - env.begin_iteration)
            new_parameters[key] = new_param
        if new_parameters:
            # push into the live config and re-derive dependent state
            # (the reference resets the model config via ResetConfig)
            env.model.boosting.config.update(new_parameters)
            env.model.boosting.refresh_config()
            env.params.update(new_parameters)

    callback.before_iteration = True
    callback.order = 10
    return callback


def early_stopping(stopping_rounds: int, verbose: bool = True) -> Callable:
    """Stop when no validation metric improves in ``stopping_rounds``
    rounds (callback.py:141-187)."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[list] = []
    cmp_op: List[Callable] = []

    def init(env: CallbackEnv) -> None:
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric is "
                "required for evaluation"
            )
        if verbose:
            Log.info(
                "Training until validation scores don't improve for %d rounds.",
                stopping_rounds,
            )
        for eval_ret in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if eval_ret[3]:  # bigger is better
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y: x > y)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y: x < y)

    def callback(env: CallbackEnv) -> None:
        if not cmp_op:
            init(env)
        for i, eval_ret in enumerate(env.evaluation_result_list):
            score = eval_ret[2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            elif env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    Log.info(
                        "Early stopping, best iteration is:\n[%d]\t%s",
                        best_iter[i] + 1,
                        "\t".join(_format_eval_result(x) for x in best_score_list[i]),
                    )
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    Log.info(
                        "Did not meet early stopping. Best iteration is:\n[%d]\t%s",
                        best_iter[i] + 1,
                        "\t".join(_format_eval_result(x) for x in best_score_list[i]),
                    )
                raise EarlyStopException(best_iter[i], best_score_list[i])

    # checkpoint hooks: the bests and their iterations are the patience
    # state; without them a resumed run would restart the window
    def ckpt_state():
        return {
            "best_score": list(best_score),
            "best_iter": list(best_iter),
            "best_score_list": [None if b is None else [list(x) for x in b]
                                for b in best_score_list],
            "bigger": [bool(op(1.0, 0.0)) for op in cmp_op],
        }

    def ckpt_restore(state):
        best_score[:] = [float(x) for x in state["best_score"]]
        best_iter[:] = [int(x) for x in state["best_iter"]]
        best_score_list[:] = [None if b is None else [tuple(x) for x in b]
                              for b in state["best_score_list"]]
        cmp_op[:] = [(lambda x, y: x > y) if big else (lambda x, y: x < y)
                     for big in state["bigger"]]

    callback.order = 30
    callback.ckpt_name = "early_stopping"
    callback.ckpt_state = ckpt_state
    callback.ckpt_restore = ckpt_restore
    return callback
