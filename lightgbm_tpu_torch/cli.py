"""The command line — PyTorch counterpart of lightgbm_tpu/cli.py
(src/application/application.cpp + src/main.cpp):
``python -m lightgbm_tpu_torch task=train config=train.conf`` reads the
reference's key=value argv and .conf files unmodified (LoadParameters,
application.cpp:48-104); the command line wins over the file.

Tasks: ``train`` (a text file or a binary cache, validation files, the
model file, ``is_save_binary_file``, the reference's model-text
snapshots at ``snapshot_freq``, training checkpoints and their resume),
``predict`` (one ``%g`` line a row,
tab-separated columns for several outputs), ``convert_model`` (the
standalone C++ predictor) and ``ingest`` (a text file streamed into the
binary cache ``<data>.bin``; also the ``ingest`` subcommand; ``train`` is
the subcommand of ``task=train``).

Checkpoints (as the JAX CLI, cli.py:85-190): every ``task=train`` with
``checkpoint_freq`` or ``snapshot_freq`` > 0 writes the whole training
state every that many iterations into ``checkpoint_dir`` (else the model
file's directory) and resumes an interrupted run found there
(``checkpoint_resume``: ``auto``, ``false``, or ``force``, which the
``resume`` subcommand sets); SIGTERM flushes a checkpoint at the next
chunk's end and the process returns 0, logging "preempted".  SIGUSR1 and
the fatal path dump the flight recorder; ``LIGHTGBM_TPU_METRICS=path``
writes the Prometheus metrics at the end of training;
``LIGHTGBM_TPU_XPROF=dir`` captures a few iterations with the PyTorch
profiler.  ``report`` summarizes a trace, diffs two audit trails or
merges the ranks' traces of one run (obs/report.py).

Several processes (``tree_learner=data|feature|voting`` with
``num_machines`` and ``machines`` / ``machine_list_file``, or the
launcher's ``LIGHTGBM_TPU_COORDINATOR`` / ``_NUM_PROCESSES`` /
``_PROCESS_ID``): a transport failure flushes the checkpoint and the
process exits 75 (``EXIT_PEER_FAILURE``, a peer died) or 74
(``EXIT_NET_TIMEOUT``, a collective or the bootstrap timed out), through
``net.hard_exit`` when the world formed; a rerun resumes.

Training and prediction run on the CUDA card unless the ``device``
parameter says ``cpu`` (``gpu`` and ``cuda`` name the card; any other
value is refused).  ``serve`` runs the prediction server
(serve/server.py: ``python -m lightgbm_tpu_torch serve model=m.npz``, on
the card unless ``device=cpu``); ``fleet`` runs replicas behind the
load-balancing proxy (serve/fleet.py: ``python -m lightgbm_tpu_torch
fleet registry=dir replicas=2``, or ``backends=h:p,...`` in front of
running servers); ``factory`` runs the continuous-training supervisor
(factory/supervisor.py: ``python -m lightgbm_tpu_torch factory data=dir
workdir=dir registry=dir``, training on the card unless ``device=cpu``).
"""

from __future__ import annotations

import json
import os
import resource
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .config import PARAM_ALIASES, Config
from .utils.log import Log

# exit codes (sysexits): a retryable death of a peer (EX_TEMPFAIL), and a
# collective or bootstrap that timed out with its peers alive (EX_IOERR)
EXIT_PEER_FAILURE = 75
EXIT_NET_TIMEOUT = 74

def parse_argv(argv: List[str]) -> Dict[str, str]:
    """key=value argv parsing (LoadParameters, application.cpp:48-61)."""
    params: Dict[str, str] = {}
    for arg in argv:
        if "=" in arg:
            key, _, value = arg.partition("=")
            key = key.strip().strip('"').strip("'")
            value = value.strip().strip('"').strip("'")
            if key:
                params[key] = value
        else:
            Log.warning("Unknown parameter in command line: %s", arg)
    return params


def parse_config_file(path: str) -> Dict[str, str]:
    """.conf parsing with '#' comments (application.cpp:66-98)."""
    params: Dict[str, str] = {}
    if not os.path.exists(path):
        Log.warning("Config file %s doesn't exist, will ignore", path)
        return params
    with open(path) as f:
        for line in f:
            if "#" in line:
                line = line[: line.index("#")]
            line = line.strip()
            if not line:
                continue
            if "=" in line:
                key, _, value = line.partition("=")
                key = key.strip().strip('"').strip("'")
                value = value.strip().strip('"').strip("'")
                if key:
                    params[key] = value
            else:
                Log.warning("Unknown parameter in config file: %s", line)
    return params


def load_all_params(argv: List[str]) -> Dict[str, str]:
    """The command line's parameters, then the config file's that the
    command line does not set under any alias (application.cpp:87-89)."""
    params = parse_argv(argv)
    cfg_path = params.get("config_file") or params.get("config")
    if cfg_path:
        for key, value in parse_config_file(cfg_path).items():
            canon = PARAM_ALIASES.get(key, key)
            if key not in params and canon not in params and not any(
                    PARAM_ALIASES.get(k, k) == canon for k in params):
                params[key] = value
    params.pop("config", None)
    params.pop("config_file", None)
    return params


def device_of(params: Dict[str, str]) -> Optional[str]:
    """The device the parameters ask for: None (the CUDA card) unless the
    ``device`` key says ``cpu``; ``gpu`` and ``cuda`` name the card, any
    other value raises."""
    value = None
    for key, v in params.items():
        if PARAM_ALIASES.get(key, key) == "device":
            value = str(v).strip().lower()
    if value is None or value in ("gpu", "cuda"):
        return None
    if value == "cpu":
        return "cpu"
    Log.fatal("device=%s: lightgbm_tpu_torch runs on the CUDA card (device=gpu or cuda) "
              "or on the CPU (device=cpu)", value)
    raise AssertionError  # unreachable


def _eval_period(gbdt, config: Config, num_iters: int) -> int:
    """Iterations a chunk may run before the loop must evaluate: every
    iteration for early stopping on a validation set, every
    ``output_freq`` when a metric is logged, else the whole run."""
    has_valid = any(gbdt.valid_metrics)
    if config.early_stopping_round > 0 and has_valid:
        return 1
    if has_valid or gbdt.training_metrics:
        return max(int(config.output_freq), 1)
    return max(num_iters, 1)


def run_train(config: Config, params: Dict[str, str], device=None) -> Booster:
    """InitTrain + Train (application.cpp:188-250): the training file (a
    text file or a binary cache) and the validation files, then
    ``GBDT.train_iters(is_eval=True)`` in chunks that end where the
    reference's loop evaluates (early stopping, ``output_freq``), writes a
    snapshot or a checkpoint, or where the profiler capture opens or
    closes; each iteration's seconds are logged from the chunk's record.
    Resumes from a checkpoint as the module says; writes
    ``output_model`` (not after a preemption)."""
    from .ckpt import CheckpointManager, PreemptionExit
    from .obs import flight
    from .parallel.net import NetError
    from .utils.profiling import maybe_xprof_capture

    if not config.data:
        Log.fatal("No training data, application quit")
    train_ds = Dataset(config.data, params=dict(params))
    booster = Booster(params=dict(params), train_set=train_ds, device=device)
    for vpath in config.valid_data:
        booster.add_valid(train_ds.create_valid(vpath), os.path.basename(vpath))
    if config.is_save_binary_file:
        train_ds.save_binary(config.data + ".bin")

    # SIGUSR1 dumps the flight recorder's ring beside the trace
    flight.install_signal_handler()
    b = booster.boosting
    num_iters = config.num_iterations
    it = 0
    ckpt_freq = config.checkpoint_freq or config.snapshot_freq
    resume = str(config.checkpoint_resume).lower()
    mgr = None
    if ckpt_freq > 0 or resume == "force":
        ckpt_dir = config.checkpoint_dir or os.path.dirname(os.path.abspath(config.output_model))
        mgr = CheckpointManager(ckpt_dir, freq=max(ckpt_freq, 0), keep_last=config.checkpoint_keep)
        mgr.install_signal_handlers()
        if resume not in ("false", "0", "none", ""):
            state = mgr.try_restore(booster, require=resume == "force",
                                    ignore_complete=resume == "force")
            if state is not None:
                it = state.iteration
                Log.info("Resuming training from checkpoint at iteration %d", it)
    xprof = maybe_xprof_capture()
    ends = [it + x for x in xprof.boundaries()] if xprof is not None else []
    period = _eval_period(b, config, num_iters)
    snap = config.snapshot_freq
    Log.info("Started training...")
    try:
        while it < num_iters:
            stop = min(num_iters, (it // period + 1) * period)
            if snap > 0:
                stop = min(stop, (it // snap + 1) * snap)
            if mgr is not None:
                stop = mgr.boundary(it, stop)
            stop = min([stop] + [e for e in ends if e > it])
            record = b.ptrainer.iter_seconds if b.ptrainer is not None else b.iter_seconds
            n_rec, iter_before, t0 = len(record), b.iter, time.perf_counter()
            if xprof is not None:
                xprof.on_iter_start()
            finished = b.train_iters(stop - it, is_eval=True)
            done = b.iter - iter_before
            if xprof is not None:
                xprof.on_iter_end(done)
            secs = record[n_rec:]
            if len(secs) != done:  # a learner that keeps no per-iteration record
                secs = [(time.perf_counter() - t0) / max(done, 1)] * done
            for k, sec in enumerate(secs):
                Log.info("%f seconds elapsed, finished iteration %d", sec, it + k + 1)
            it += done
            if snap > 0 and done and it % snap == 0:
                path = f"{config.output_model}.snapshot_iter_{it}"
                booster.save_model(path)
                Log.info("Saved snapshot to %s", path)
            if mgr is not None:
                mgr.maybe_save(booster)
            if finished or done == 0:
                Log.info("Early stopping at iteration %d", it)
                break
        if mgr is not None:
            mgr.mark_complete(booster)
    except PreemptionExit as px:
        Log.warning("Training preempted: checkpoint flushed at iteration %d; rerun task=train "
                    "(or `python -m lightgbm_tpu_torch resume`) to continue bit for bit",
                    px.step)
        _log_resources(booster)
        return booster
    except NetError:
        # a peer died or a collective timed out: the last complete
        # checkpoint is made durable, and main maps the error to its code
        if mgr is not None:
            mgr.flush()
        raise
    finally:
        if xprof is not None:
            xprof.close()
        if mgr is not None:
            mgr.close()
    booster.save_model(config.output_model)
    Log.info("Finished training, model saved to %s", config.output_model)
    _log_resources(booster)
    _dump_metrics_if_requested()
    return booster


def _log_resources(booster: Booster) -> None:
    """The process's peak host and device memory, a parallel learner's
    bytes by purpose and, at verbosity 2, every kernel's launches; with
    tracing on, the launches and the bytes are also ``kernel.launches``
    and ``net.ledger`` events of the trace."""
    Log.info("Peak host memory %.3f GiB (resident)",
             resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
    if booster.device.type == "cuda":
        import torch

        peak = torch.cuda.max_memory_allocated(booster.device) / 2**30
        Log.info("Peak device memory %.3f GiB", peak)
    from .obs import tracer
    from .ops import pkernels

    if Log.get_level() >= 2:
        Log.debug("Kernel launches: %s", json.dumps(pkernels.launch_counts()))
    tracer.event("kernel.launches", counts=pkernels.launch_counts())
    learner = getattr(booster.boosting, "learner", None)
    if learner is not None:  # a parallel learner's bytes sent, by purpose
        Log.info("Bytes sent by purpose: %s", json.dumps(learner.comm.ledger))
        tracer.event("net.ledger", ledger=dict(learner.comm.ledger))


def _dump_metrics_if_requested() -> None:
    """``LIGHTGBM_TPU_METRICS=path``: the metrics registry (the compile
    analogue and every mirrored trace counter and gauge) in the
    Prometheus text format, at the end of training."""
    path = os.environ.get("LIGHTGBM_TPU_METRICS", "").strip()
    if not path:
        return
    from .obs.metrics import registry

    try:
        registry.dump(path)
        Log.info("Metrics dumped to %s", path)
    except OSError as e:
        Log.warning("Could not dump metrics to %s: %s", path, e)


def run_predict(config: Config, params: Dict[str, str], device=None) -> None:
    """Predict path (application.cpp:252-260, predictor.hpp): one line a
    row, ``%g``, tab-separated for several outputs."""
    if not config.data:
        Log.fatal("No data for prediction, application quit")
    if not config.input_model:
        Log.fatal("No model file for prediction, application quit")
    booster = Booster(params=dict(params), model_file=config.input_model, device=device)
    preds = np.atleast_1d(booster.predict(
        config.data, num_iteration=config.num_iteration_predict,
        raw_score=config.is_predict_raw_score, pred_leaf=config.is_predict_leaf_index))
    with open(config.output_result, "w") as f:
        if preds.ndim == 1:
            f.writelines(f"{v:g}\n" for v in preds)
        else:
            f.writelines("\t".join(f"{v:g}" for v in row) + "\n" for row in preds)
    Log.info("Finished prediction, results saved to %s", config.output_result)


def run_convert_model(config: Config, params: Dict[str, str], device=None) -> None:
    """task=convert_model (application.cpp:268-273): the standalone C++
    if-else predictor (convert_model.py, GBDT::ModelToIfElse)."""
    from .convert_model import model_to_cpp

    if not config.input_model:
        Log.fatal("No model file for convert_model, application quit")
    if config.convert_model_language not in ("", "cpp"):
        Log.fatal("Unsupported convert_model_language %s (only cpp)",
                  config.convert_model_language)
    booster = Booster(model_file=config.input_model, device=device)
    out = config.convert_model or "gbdt_prediction.cpp"
    with open(out, "w") as f:
        f.write(model_to_cpp(booster.boosting))
    Log.info("Finished converting model to C++ code, saved to %s", out)


def run_ingest(config: Config, params: Dict[str, str], device=None) -> None:
    """task=ingest: stream a text file through the two-pass ingest
    (data/ingest.py) into the binary cache ``<data>.bin`` without ever
    holding its raw float matrix; training then loads the cache.  Host
    only: no device is used."""
    from .data.ingest import stream_dataset

    if not config.data:
        Log.fatal("No data for ingest, application quit")
    ds = stream_dataset(config.data, config)
    out = config.data + ".bin"
    ds.save_binary(out, source_path=config.data)
    report = dict(ds.ingest_report, output=out)
    Log.info("Finished ingest: %s", json.dumps(report))


_TASKS = {"train": run_train, "predict": run_predict, "prediction": run_predict,
          "test": run_predict, "convert_model": run_convert_model, "ingest": run_ingest}


def main(argv: Optional[List[str]] = None) -> int:
    """Application::Run (application.h:82, main.cpp:4-21): 0 on success
    (and after a preemption's flushed checkpoint), 75 or 74 after a
    transport failure, 1 (with the error logged) when the task fails;
    ``report`` returns its own code."""
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "report":
        from .obs.report import main as report_main

        return report_main(argv[1:])
    if argv and argv[0] == "serve":
        from .serve.server import main as serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "fleet":
        from .serve.fleet import main as fleet_main

        return fleet_main(argv[1:])
    if argv and argv[0] == "factory":
        from .factory import main as factory_main

        return factory_main(argv[1:])
    if argv and argv[0] in ("ingest", "train"):
        argv = [f"task={argv[0]}"] + argv[1:]
    if argv and argv[0] == "resume":
        # task=train that requires a checkpoint (plain task=train already
        # resumes an interrupted run)
        argv = ["task=train", "checkpoint_resume=force"] + argv[1:]
    from .parallel.net import CollectiveTimeoutError, PeerFailureError

    try:
        params = load_all_params(argv)
        config = Config.from_params(params)
        run = _TASKS.get(config.task)
        if run is None:
            Log.fatal("Unknown task type %s", config.task)
        device = device_of(params)
        if run is not run_ingest:
            from .utils.device import resolve_device

            device = resolve_device(device)
        run(config, params, device)
    except PeerFailureError as ex:
        Log.warning("Peer failure after %.1fs (ranks %s): %s — restart the job to auto-resume "
                    "from the last checkpoint", ex.elapsed_s, list(ex.ranks), ex)
        return _net_exit(EXIT_PEER_FAILURE)
    except CollectiveTimeoutError as ex:
        Log.warning("Collective/bootstrap timeout after %.1fs: %s — restart the job to "
                    "auto-resume from the last checkpoint", ex.elapsed_s, ex)
        return _net_exit(EXIT_NET_TIMEOUT)
    except Exception as ex:  # main.cpp catches and exits non-zero
        from .obs import flight

        flight.dump("fatal_error", error=ex)  # beside the trace, when tracing
        Log.warning("Met Exceptions: %s", ex)
        return 1
    return 0


def _net_exit(code: int) -> int:
    """Leave after a transport failure: with several processes up, or a
    bootstrap call still stuck in the store's native code, through
    ``net.hard_exit`` (the flushed tracer, then ``os._exit``): the store's
    shutdown barrier would wait on the dead peer, and the stuck thread
    would abort the interpreter's exit; else return the code."""
    from .parallel import distributed, net

    if distributed.process_count() > 1 or net.abandoned_calls():
        net.hard_exit(code)  # never returns
    return code


if __name__ == "__main__":
    sys.exit(main())
