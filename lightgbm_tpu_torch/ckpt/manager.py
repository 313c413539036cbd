"""``CheckpointManager`` — the training side of checkpoints, PyTorch-port
copy of lightgbm_tpu/ckpt/manager.py for one process.

Used two ways:

  - as an after-iteration **callback** (``engine.train`` adds it to the
    callbacks; ``order = 40`` puts it after ``early_stopping``, so the
    callback state it captures is current through the iteration);
  - **directly** by the CLI's training loop through :meth:`maybe_save`.

Capture is synchronous: the card's tensors are read at an iteration
boundary, and the state is serialized to bytes on the calling thread.
The fsync'd write of those bytes runs on one background thread, so
training overlaps the disk; at most one write is in flight (the next save
waits for it), which bounds the buffered checkpoints to one blob.  The
writer thread is handed host bytes only, never a tensor.

Preemption: :meth:`install_signal_handlers` arms SIGTERM.  The handler
only sets a flag; at the next boundary :meth:`maybe_save` writes a final
checkpoint synchronously and raises :class:`PreemptionExit`, which
``engine.train`` and the CLI catch, finish and return; the next run
resumes bit for bit.

Over several processes (the JAX package's protocol, manager.py:156-200,
:270-330): a save is a barrier, an allgather of each rank's step and
state; steps that disagree are fatal, and rank 0 writes the ranks' states
merged into one canonical container in global row order
(``merge_to_canonical``).  A transport failure in the barrier flushes the
writer (the last complete checkpoint stays the resume point) and
re-raises.  A resume gathers the ranks' row counts and fingerprint parts,
checks the global fingerprint and slices the container to this rank
(``reshard_to_local``): the same world resumes byte for byte, a static
world of another size by reslicing.
"""

from __future__ import annotations

import concurrent.futures
import json
import signal
import threading
import time
from typing import Any, Dict, List, Optional

from ..obs import tracer
from ..utils.log import Log
from .state import (CheckpointMismatch, TrainState, capture, combine_fingerprint_parts,
                    data_fingerprint_parts, merge_to_canonical, reshard_to_local, restore)
from .store import CheckpointStore


class PreemptionExit(RuntimeError):
    """Raised at an iteration boundary after a preemption signal, once the
    final checkpoint is on disk."""

    def __init__(self, step: int):
        super().__init__(f"preempted; checkpoint flushed at iteration {step}")
        self.step = step


class CheckpointManager:
    """Periodic TrainState checkpoints with background writes."""

    order = 40  # after early_stopping (30): its state is current
    before_iteration = False

    def __init__(self, directory: str, freq: int = 0, keep_last: int = 3):
        self.store = CheckpointStore(directory, keep_last=keep_last)
        self.freq = int(freq)
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: Optional[concurrent.futures.Future] = None
        self._preempt = threading.Event()
        self._tracked: List[Any] = []
        self._last_saved = -1
        self._old_handlers: Dict[int, Any] = {}

    # -- wiring --------------------------------------------------------
    def track_callbacks(self, callbacks) -> None:
        """Register the callbacks whose state must survive a resume (those
        with ``ckpt_state`` / ``ckpt_restore``)."""
        self._tracked = [cb for cb in callbacks if hasattr(cb, "ckpt_state") and cb is not self]

    def install_signal_handlers(self, signals=(signal.SIGTERM,)) -> None:
        """Arm the preemption signals: the handler only sets a flag; the
        flush happens at the next iteration boundary on the main thread.
        ``close`` puts the previous handlers back."""
        def _handler(signum, frame):
            Log.warning("Received signal %d: flushing a checkpoint at the next iteration "
                        "boundary, then exiting", signum)
            self._preempt.set()

        for sig in signals:
            self._old_handlers.setdefault(sig, signal.signal(sig, _handler))

    def request_preemption(self) -> None:
        """Preempt without a signal (tests, embedding runtimes)."""
        self._preempt.set()

    @property
    def preempted(self) -> bool:
        return self._preempt.is_set()

    def boundary(self, it: int, limit: int) -> int:
        """The next iteration after ``it``, at most ``limit``, where a
        chunk of iterations must end so that this manager can act: the
        next multiple of ``freq``."""
        if self.freq > 0:
            return min(limit, (it // self.freq + 1) * self.freq)
        return limit

    # -- callback protocol ---------------------------------------------
    def __call__(self, env) -> None:
        self.maybe_save(env.model)

    # -- core ----------------------------------------------------------
    def maybe_save(self, booster, force: bool = False) -> bool:
        """Checkpoint when the iteration counter sits on a ``freq``
        boundary (or ``force``).  After a preemption signal: flush, then
        raise :class:`PreemptionExit`."""
        step = int(booster.boosting.iter)
        if self._preempt.is_set():
            if step != self._last_saved:
                self.save(booster, sync=True)
            else:
                self.flush()
            raise PreemptionExit(step)
        if not force and (self.freq <= 0 or step <= 0 or step % self.freq != 0):
            return False
        if step == self._last_saved:
            return False
        self.save(booster)
        return True

    def save(self, booster, sync: bool = False) -> int:
        """Capture and write one checkpoint (in the background unless
        ``sync``); returns its step."""
        t0 = time.perf_counter()
        state = capture(booster, extra_py=self._callback_state())
        step = state.iteration
        with tracer.span("ckpt.serialize", iter=step):
            blob = state.to_bytes()
        from ..parallel import distributed

        nproc = distributed.process_count()
        if nproc > 1:
            from ..parallel.collect import allgather_bytes
            from ..parallel.net import NetError

            try:
                with tracer.span("ckpt.barrier", iter=step):
                    gathered = allgather_bytes(step.to_bytes(8, "little") + blob)
            except NetError as e:
                # nothing of this boundary is durable, the last complete
                # checkpoint is: its write finishes, and the failure goes on
                # to the cooperative abort
                self.flush()
                Log.warning("Checkpoint barrier at iteration %d failed (%s); the last "
                            "completed checkpoint remains the resume point", step, e)
                raise
            steps = [int.from_bytes(g[:8], "little") for g in gathered]
            if len(set(steps)) != 1:
                Log.fatal("Checkpoint barrier saw divergent iterations across processes: %s",
                          steps)
            self._last_saved = step
            if distributed.process_index() != 0:
                return step  # rank 0 writes
            with tracer.span("ckpt.merge_canonical", iter=step, world=nproc):
                blob = merge_to_canonical([TrainState.from_bytes(g[8:])
                                           for g in gathered]).to_bytes()
        self._last_saved = step
        if not sync:
            if self._executor is None:
                self._executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt-writer")
            self.flush()  # one write in flight
            self._pending = self._executor.submit(self._write, step, blob, t0)
        else:
            self.flush()
            self._write(step, blob, t0)
        return step

    def _write(self, step: int, blob: bytes, t0: float) -> None:
        tw = time.perf_counter()
        try:
            path = self.store.save(step, blob)
        except Exception as e:  # a full disk and the like
            Log.warning("Checkpoint write for iteration %d failed: %s", step, e)
            return
        now = time.perf_counter()
        tracer.counter("ckpt.bytes", len(blob))
        tracer.event("ckpt.saved", iter=step, bytes=len(blob), secs=round(now - t0, 4),
                     write_s=round(now - tw, 6), path=path)
        Log.info("Checkpoint saved at iteration %d (%d bytes)", step, len(blob))

    def flush(self) -> None:
        """Wait for the background write in flight, if any."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self) -> None:
        self.flush()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        for sig, old in self._old_handlers.items():
            signal.signal(sig, old)
        self._old_handlers.clear()

    def mark_complete(self, booster) -> None:
        """Training finished normally: flush and leave the completion
        marker, so the next fresh run does not resume a finished one.
        Over several processes rank 0, which writes the checkpoints,
        writes the marker."""
        self.flush()
        from ..parallel import distributed

        if distributed.process_index() == 0:
            self.store.mark_complete(int(booster.boosting.iter))

    # -- resume --------------------------------------------------------
    def try_restore(self, booster, require: bool = False,
                    ignore_complete: bool = False) -> Optional[TrainState]:
        """Restore the latest valid checkpoint into ``booster``: the state,
        or None when there is nothing to resume (no valid checkpoint, or
        a completed run and not ``ignore_complete``).  A mismatch raises
        ``CheckpointMismatch``: a resume never retrains silently."""
        latest = self.store.latest_valid()
        if latest is None:
            if require:
                Log.fatal("No valid checkpoint found in %s", self.store.dir)
            return None
        if not ignore_complete and self.store.complete_step() is not None:
            Log.info("Checkpoints in %s belong to a completed run; starting fresh",
                     self.store.dir)
            return None
        step, blob = latest
        state = TrainState.from_bytes(blob)
        if "world_size" in state.meta:
            state = self._reshard_to_current(booster, state)
        restore(booster, state)
        self._restore_callbacks(state)
        self._last_saved = step
        return state

    def _reshard_to_current(self, booster, state: TrainState) -> TrainState:
        """A canonical container sliced to this rank of the current world.
        Every rank enters together (they read the same container): one
        allgather of the ranks' row counts and CRC parts gives the current
        partition and proves that the shards, concatenated, are the saved
        global dataset before anything is sliced."""
        from ..parallel import collect, distributed

        b = booster.boosting
        rank, nproc = distributed.process_index(), distributed.process_count()
        parts = data_fingerprint_parts(b.train_set)
        entry = {"rows": int(b.num_data), "valid": [int(vs.shape[1]) for vs in b.valid_scores],
                 "parts": parts}
        gathered = [json.loads(g) for g in collect.allgather_bytes(json.dumps(entry).encode(),
                                                                   "ckpt_reshard")]
        shard_rows = [int(g["rows"]) for g in gathered]
        valid_shard = [[int(g["valid"][i]) for g in gathered]
                       for i in range(len(entry["valid"]))]
        global_fp = combine_fingerprint_parts([g["parts"] for g in gathered])
        if global_fp != state.meta["data_fingerprint"]:
            raise CheckpointMismatch(
                "checkpoint was written against a different global dataset (checkpoint "
                f"{state.meta['data_fingerprint']}, run {global_fp}); refusing to resume")
        saved_w = int(state.meta.get("world_size", 1))
        if saved_w != nproc:
            Log.info("Resharding checkpoint from world size %d to %d (canonical global "
                     "layout)", saved_w, nproc)
        return reshard_to_local(state, rank, shard_rows, valid_shard,
                                combine_fingerprint_parts([parts]),
                                bag_seed=int(getattr(b.config, "bagging_seed", 0)))

    # -- tracked-callback state ----------------------------------------
    def _callback_state(self) -> Dict[str, Any]:
        out = {}
        for i, cb in enumerate(self._tracked):
            name = getattr(cb, "ckpt_name", type(cb).__name__)
            try:
                out[f"cb/{i}/{name}"] = cb.ckpt_state()
            except Exception as e:
                Log.warning("callback %s state capture failed: %s", name, e)
        return {"callbacks": json.loads(json.dumps(out, default=str))} if out else {}

    def _restore_callbacks(self, state: TrainState) -> None:
        saved = state.py.get("callbacks") or {}
        for i, cb in enumerate(self._tracked):
            name = getattr(cb, "ckpt_name", type(cb).__name__)
            st = saved.get(f"cb/{i}/{name}")
            if st is not None and hasattr(cb, "ckpt_restore"):
                cb.ckpt_restore(st)
