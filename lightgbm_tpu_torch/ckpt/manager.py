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

The JAX package's multi-host protocol (a barrier on the iteration, host 0
writing the canonical global layout, resharding on resume) waits for the
port's distributed training.
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
from .state import TrainState, capture, restore
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
        marker, so the next fresh run does not resume a finished one."""
        self.flush()
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
        restore(booster, state)
        self._restore_callbacks(state)
        self._last_saved = step
        return state

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
