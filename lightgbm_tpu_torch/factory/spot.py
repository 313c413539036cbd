"""Preemptible-capacity economics — PyTorch counterpart of
lightgbm_tpu/factory/spot.py, its trace and its ledger:

``SpotSchedule``
    A deterministic price and preemption trace, scripted
    (``from_script``) or sampled from a seed (``sample``, Poisson
    arrivals over a clipped random-walk price): a trace replays.

``CostLedger``
    An atomic (tmp + fsync + rename) single-document JSON ledger of a
    fleet's spend: member-seconds priced by the trace, preempt / spawn
    events, the iterations completed and by whom, and
    ``zero_lost_iterations``, the proof that churn lost and redid no
    iteration.  The JAX package's ledger files load here and back.

``SpotFleet``
    Drives real member processes (the port's
    ``lightgbm_tpu_torch.factory.member_worker`` by default) over one
    shared fleet directory: a ``preempt`` event SIGKILLs a live member
    mid-iteration, a ``spawn`` event starts a mid-run joiner that resumes
    from the coordinator's handoff, and the survivors train on throughout
    (parallel/membership.py does the recovery; SpotFleet only sends
    signals and reads the store).

``python -m lightgbm_tpu_torch factory spot fleet=DIR ...`` runs one fleet
against a schedule and prints the ledger; ``baseline=1`` runs the static
on-demand reference (``run_static_baseline``) instead, so the two ledgers
compare (``factory.cost_per_model`` against ``factory.cost_baseline``).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..obs import tracer
from ..utils.log import Log

#: on-demand price of one member for one second — the unit every spot
#: price in a trace is a fraction of
ON_DEMAND_PRICE = 1.0


# ----------------------------------------------------------------------
# schedule
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class SpotEvent:
    """One point on the capacity/price trace.

    kind ``price``   — the spot price becomes ``value`` at ``t_s``
    kind ``preempt`` — SIGKILL a live member at ``t_s`` (``target`` is a
                       bootstrap member id, or None for the youngest)
    kind ``spawn``   — launch a mid-run joiner at ``t_s``
    """

    t_s: float
    kind: str
    value: float = 0.0
    target: Optional[int] = None


class SpotSchedule:
    """Deterministic price + preemption trace (sorted :class:`SpotEvent`
    list over a base price).  Replayable by construction: randomness is
    only ever drawn in :meth:`sample` from an explicit seed."""

    KINDS = ("price", "preempt", "spawn")

    def __init__(self, events: List[SpotEvent], base_price: float = 0.3):
        for ev in events:
            if ev.kind not in self.KINDS:
                raise ValueError(f"unknown spot event kind {ev.kind!r}")
        self.events = sorted(events, key=lambda e: (e.t_s, e.kind))
        self.base_price = float(base_price)

    @classmethod
    def from_script(cls, script: str, base_price: float = 0.3):
        """``"preempt@2.5;spawn@4;price@6=0.5;preempt@8=1"`` — kind at
        time, ``=N`` is a price for ``price`` and a target member id for
        ``preempt``."""
        events = []
        for tok in script.split(";"):
            tok = tok.strip()
            if not tok:
                continue
            kind, _, rest = tok.partition("@")
            when, _, arg = rest.partition("=")
            kind = kind.strip()
            if kind not in cls.KINDS or not when:
                raise ValueError(f"bad spot script token {tok!r}")
            if kind == "price" and not arg:
                raise ValueError(
                    f"price event needs a value (price@T=P): {tok!r}")
            value, target = 0.0, None
            if arg:
                if kind == "price":
                    value = float(arg)
                elif kind == "preempt":
                    target = int(arg)
                else:
                    raise ValueError(f"bad spot script token {tok!r}")
            events.append(SpotEvent(float(when), kind, value, target))
        return cls(events, base_price)

    @classmethod
    def sample(cls, seed: int, horizon_s: float, preempt_hz: float = 0.1,
               spawn_hz: float = 0.1, base_price: float = 0.3,
               volatility: float = 0.25, price_step_s: float = 5.0):
        """Seeded Poisson preempt/spawn arrivals over a clipped
        random-walk price — the same seed always yields the same trace."""
        import numpy as np

        rng = np.random.default_rng(seed)
        events: List[SpotEvent] = []
        for kind, hz in (("preempt", preempt_hz), ("spawn", spawn_hz)):
            t = 0.0
            while True:
                t += float(rng.exponential(1.0 / hz)) if hz > 0 else horizon_s
                if t >= horizon_s:
                    break
                events.append(SpotEvent(round(t, 3), kind))
        price, t = base_price, price_step_s
        while t < horizon_s:
            price = float(np.clip(
                price * (1.0 + volatility * rng.standard_normal()),
                0.05 * base_price, ON_DEMAND_PRICE))
            events.append(SpotEvent(round(t, 3), "price", round(price, 4)))
            t += price_step_s
        return cls(events, base_price)

    def price_at(self, t_s: float) -> float:
        price = self.base_price
        for ev in self.events:
            if ev.kind == "price" and ev.t_s <= t_s:
                price = ev.value
        return price

    def due(self, t_prev: float, t_now: float) -> List[SpotEvent]:
        """Capacity events (preempt/spawn) with ``t_prev < t_s <= t_now``."""
        return [ev for ev in self.events
                if ev.kind != "price" and t_prev < ev.t_s <= t_now]


# ----------------------------------------------------------------------
# ledger
# ----------------------------------------------------------------------
class CostLedger:
    """Atomic single-document JSON ledger (tmp + fsync + rename, the
    checkpoint-store publish idiom): a SIGKILL of the fleet runner at
    any instant leaves either the previous or the next complete ledger
    on disk, never a torn one.  Format documented in docs/FACTORY.md."""

    VERSION = 1

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._doc = {
            "version": self.VERSION,
            "member_seconds": {},   # member key -> seconds alive
            "cost": {},             # member key -> priced spend
            "events": [],           # preempt/spawn/price changes, timed
            "iterations": {},       # iter -> {"epoch": E, "t_s": ...}
            "attempts": {},         # "iter.mM" -> [epochs it completed in]
            "total_cost": 0.0,
            "completed": False,
            "trees": None,
        }

    # -- mutation ------------------------------------------------------
    def charge(self, member, dt_s: float, price: float) -> None:
        key = str(member)
        self._doc["member_seconds"][key] = (
            self._doc["member_seconds"].get(key, 0.0) + dt_s)
        self._doc["cost"][key] = (
            self._doc["cost"].get(key, 0.0) + dt_s * price)
        self._doc["total_cost"] = sum(self._doc["cost"].values())

    def event(self, t_s: float, kind: str, **attrs) -> None:
        self._doc["events"].append(dict(t_s=round(t_s, 3), kind=kind,
                                        **attrs))

    def iteration(self, it: int, epoch: int, t_s: float) -> None:
        self._doc["iterations"].setdefault(
            str(it), {"epoch": epoch, "t_s": round(t_s, 3)})

    def attempt(self, it: int, member, epoch: int) -> None:
        """One member completed iteration ``it`` under ``epoch`` (from a
        write-once ``attempts/<it>.m<member>.e<epoch>`` KV record —
        idempotent, the harvest loop re-reads the store every poll)."""
        epochs = self._doc.setdefault("attempts", {}).setdefault(
            f"{int(it)}.m{member}", [])
        if int(epoch) not in epochs:
            epochs.append(int(epoch))
            epochs.sort()

    def finish(self, trees: int) -> None:
        self._doc["completed"] = True
        self._doc["trees"] = int(trees)

    # -- queries -------------------------------------------------------
    @property
    def total_cost(self) -> float:
        return float(self._doc["total_cost"])

    def zero_lost_iterations(self) -> bool:
        """No training iteration was lost OR redone across the churn:
        the write-once ``progress/<it>`` slots must cover exactly
        ``0..trees-1`` (nothing lost), and — when per-attempt records
        were harvested — no member may have completed the same iteration
        under two different epochs (nothing redone; a redo necessarily
        lands in a later epoch, so it leaves a second attempt key even
        though it cannot re-claim the write-once progress slot)."""
        trees = self._doc["trees"]
        if not self._doc["completed"] or trees is None:
            return False
        got = sorted(int(k) for k in self._doc["iterations"])
        if got != list(range(int(trees))):
            return False
        attempts = self._doc.get("attempts") or {}
        return all(len(epochs) == 1 for epochs in attempts.values())

    def cost_per_model(self) -> Optional[float]:
        return self.total_cost if self._doc["completed"] else None

    # -- persistence ---------------------------------------------------
    def flush(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._doc, fh, indent=1, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)

    @classmethod
    def load(cls, path: str) -> "CostLedger":
        ledger = cls(path)
        with open(path) as fh:
            doc = json.load(fh)
        if doc.get("version") != cls.VERSION:
            raise ValueError(
                f"cost ledger {path}: version {doc.get('version')!r} "
                f"(supported: {cls.VERSION})")
        ledger._doc = doc
        return ledger


# ----------------------------------------------------------------------
# the fleet runner
# ----------------------------------------------------------------------
def _default_worker() -> List[str]:
    return [sys.executable, "-m", "lightgbm_tpu_torch.factory.member_worker"]


def _worker_argv(worker) -> List[str]:
    """A worker given as a script path runs under this interpreter; a
    sequence is the command itself."""
    if worker is None:
        return _default_worker()
    if isinstance(worker, str):
        return [sys.executable, worker]
    return list(worker)


class SpotFleet:
    """One elastic training fleet of real processes run against a
    :class:`SpotSchedule`, every member-second priced into a
    :class:`CostLedger`.

    SpotFleet only sends signals and reads the shared store: eviction,
    resize and the joiner's restore are the members' own membership
    runtime, as under a cloud scheduler."""

    def __init__(self, fleet_dir: str, schedule: SpotSchedule, nproc: int, ledger_path: str,
                 trees: int = 12, rows: int = 600, worker=None,
                 extra_env: Optional[Dict[str, str]] = None, poll_s: float = 0.2):
        self.fleet_dir = os.path.abspath(fleet_dir)
        self.schedule = schedule
        self.nproc = int(nproc)
        self.trees = int(trees)
        self.rows = int(rows)
        self.worker = _worker_argv(worker)
        self.extra_env = dict(extra_env or {})
        self.poll_s = float(poll_s)
        self.ledger = CostLedger(ledger_path)
        self.out = os.path.join(self.fleet_dir, "out")
        self._procs: List[dict] = []  # {proc, key, kind, log, started}
        self._spawned_joiners = 0

    # -- workers -------------------------------------------------------
    def _env(self) -> Dict[str, str]:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("LIGHTGBM_TPU_", "MEMBER_"))}
        # the port's package wherever the fleet runs from
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        env["LIGHTGBM_TPU_NET_TIMEOUT"] = os.environ.get("LIGHTGBM_TPU_NET_TIMEOUT", "8")
        env.update({
            "MEMBER_NPROC": str(self.nproc),
            "MEMBER_ROWS": str(self.rows),
            "MEMBER_TREES": str(self.trees),
            "MEMBER_PROGRESS": "1",
            # pace iterations so that scripted event times land mid-run;
            # the ledger prices member-seconds, so the pacing inflates the
            # spot run and the baseline alike
            "MEMBER_ITER_SLEEP": "0.3",
        })
        env.update(self.extra_env)
        return env

    def _spawn(self, member_arg) -> dict:
        key = str(member_arg)
        if member_arg == "join":
            # ledger keys are unique a worker, not an argv form
            key = f"join{sum(1 for r in self._procs if r['kind'] == 'join') + 1}"
        # a log file a member, not a pipe: nothing drains a pipe until the
        # run ends, and a chatty member would block on a full pipe
        os.makedirs(self.fleet_dir, exist_ok=True)
        log_path = os.path.join(self.fleet_dir, f"worker.{key}.log")
        with open(log_path, "w") as log_fh:
            proc = subprocess.Popen(self.worker + [str(member_arg), self.fleet_dir, self.out],
                                    env=self._env(), stdout=log_fh, stderr=subprocess.STDOUT,
                                    text=True)
        rec = dict(proc=proc, key=key, log=log_path, started=time.time(),
                   kind="join" if member_arg == "join" else "bootstrap")
        self._procs.append(rec)
        return rec

    def _live(self) -> List[dict]:
        return [r for r in self._procs if r["proc"].poll() is None]

    def _preempt(self, ev: SpotEvent, t: float) -> None:
        live = self._live()
        victim = None
        if ev.target is not None:
            victim = next((r for r in live if r["key"] == str(ev.target)), None)
        elif live:
            victim = live[-1]  # the youngest capacity goes first
        if victim is None:
            Log.warning("spot: preempt@%.1fs found no live member", ev.t_s)
            return
        victim["proc"].send_signal(signal.SIGKILL)
        victim["proc"].wait()
        tracer.event("spot.preempt", member=victim["key"], t_s=round(t, 3))
        self.ledger.event(t, "preempt", member=victim["key"])

    def _spawn_joiner(self, t: float) -> None:
        self._spawned_joiners += 1
        self._spawn("join")
        tracer.event("spot.spawn", ordinal=self._spawned_joiners, t_s=round(t, 3))
        self.ledger.event(t, "spawn", ordinal=self._spawned_joiners)

    # -- progress ------------------------------------------------------
    def _harvest_progress(self, t: float) -> None:
        from ..parallel.membership import FileKVClient

        client = FileKVClient(os.path.join(self.fleet_dir, "kv"))
        for key, value in client.key_value_dir_get("progress/"):
            it = int(key.rsplit("/", 1)[-1])
            try:
                epoch = int(json.loads(value)["epoch"])
            except (ValueError, KeyError, TypeError):
                epoch = -1
            self.ledger.iteration(it, epoch, t)
        for key, _value in client.key_value_dir_get("attempts/"):
            # "attempts/<it>.m<member>.e<epoch>": one write-once key an
            # attempt, for the nothing-redone proof
            name = key.rsplit("/", 1)[-1]
            try:
                it_s, m_s, e_s = name.split(".")
                self.ledger.attempt(int(it_s), m_s[1:], int(e_s[1:]))
            except (ValueError, IndexError):
                Log.warning("spot: unparsable attempt key %r", key)

    # -- run -----------------------------------------------------------
    def run(self, timeout_s: float = 300.0) -> dict:
        """Start the fleet, play the schedule against it until every
        member has exited (or ``timeout_s``, when the rest are killed), and
        return the summary: wall, cost, ``zero_lost_iterations``, each
        member's exit code, model text and result record."""
        os.makedirs(self.fleet_dir, exist_ok=True)
        for m in range(self.nproc):
            self._spawn(m)
        t0 = time.monotonic()
        last = 0.0
        self.ledger.event(0.0, "price", price=self.schedule.base_price)
        while True:
            time.sleep(self.poll_s)
            t = time.monotonic() - t0
            price = self.schedule.price_at(t)
            for rec in self._live():
                self.ledger.charge(rec["key"], t - last, price)
            for ev in self.schedule.due(last, t):
                if ev.kind == "preempt":
                    self._preempt(ev, t)
                elif ev.kind == "spawn":
                    self._spawn_joiner(t)
            self._harvest_progress(t)
            self.ledger.flush()
            last = t
            if not self._live():
                break
            if t > timeout_s:
                Log.warning("spot: fleet timeout after %.0fs — killing", t)
                for rec in self._live():
                    rec["proc"].kill()
                break
        wall = time.monotonic() - t0
        results = self._collect()
        if results["models"]:
            self.ledger.finish(self.trees)
        self.ledger.event(wall, "done", completed=bool(results["models"]))
        self.ledger.flush()
        cost = self.ledger.cost_per_model()
        if cost is not None:
            tracer.gauge("factory.cost_per_model", cost, fleet=os.path.basename(self.fleet_dir))
        return dict(wall_s=round(wall, 3), cost=cost,
                    zero_lost_iterations=self.ledger.zero_lost_iterations(),
                    ledger=self.ledger.path, **results)

    def _collect(self) -> dict:
        exits, models, metas, started = {}, {}, {}, {}
        for rec in self._procs:
            rec["proc"].wait()
            exits[rec["key"]] = rec["proc"].returncode
            started[rec["key"]] = rec["started"]
        for name in sorted(os.listdir(self.fleet_dir)):
            if name.startswith("out.m") and name.endswith(".txt"):
                with open(os.path.join(self.fleet_dir, name)) as fh:
                    models[name[len("out.m"):-len(".txt")]] = fh.read()
            elif name.startswith("out.m") and name.endswith(".json"):
                with open(os.path.join(self.fleet_dir, name)) as fh:
                    metas[name[len("out.m"):-len(".json")]] = json.load(fh)
        return dict(exits=exits, models=models, metas=metas, started=started)


def run_static_baseline(fleet_dir: str, nproc: int, ledger_path: str, trees: int = 12,
                        rows: int = 600, worker=None,
                        extra_env: Optional[Dict[str, str]] = None,
                        timeout_s: float = 300.0) -> dict:
    """The on-demand reference: the same fleet with no churn, every
    member-second priced at :data:`ON_DEMAND_PRICE`."""
    fleet = SpotFleet(fleet_dir, SpotSchedule([], base_price=ON_DEMAND_PRICE), nproc,
                      ledger_path, trees=trees, rows=rows, worker=worker, extra_env=extra_env)
    summary = fleet.run(timeout_s=timeout_s)
    if summary["cost"] is not None:
        tracer.gauge("factory.cost_baseline", summary["cost"],
                     fleet=os.path.basename(os.path.abspath(fleet_dir)))
    return summary


# the member's width and device, as ``factory spot`` keys (the JAX
# package's worker has no such knobs)
_WORKER_KEYS = {"leaves": "MEMBER_LEAVES", "features": "MEMBER_FEATURES",
                "max_bin": "MEMBER_MAX_BIN"}


def main(argv: Sequence[str]) -> int:
    """``python -m lightgbm_tpu_torch factory spot fleet=DIR [nproc=3]
    [trees=12] [rows=600] [script=preempt@3;spawn@6] [seed=N] [horizon=30]
    [price=0.3] [baseline=1] [ledger=PATH] [leaves=7] [features=10]
    [max_bin=31] [device=cpu]``: the JAX package's keys, and the members'
    width and device (on the card without ``device``)."""
    from ..cli import parse_argv
    from .supervisor import EXIT_BAD_ARGS, EXIT_OK

    tracer.refresh_from_env()
    params = parse_argv(list(argv))
    fleet_dir = params.get("fleet")
    if not fleet_dir:
        Log.warning("factory spot: need fleet=DIR [nproc=3] [trees=12] [script=...|seed=N] "
                    "[price=0.3] [baseline=1]")
        return EXIT_BAD_ARGS
    nproc = int(params.get("nproc", "3"))
    trees = int(params.get("trees", "12"))
    rows = int(params.get("rows", "600"))
    price = float(params.get("price", "0.3"))
    ledger = params.get("ledger", os.path.join(fleet_dir, "cost_ledger.json"))
    extra = {env: str(int(params[key])) for key, env in _WORKER_KEYS.items() if key in params}
    device = params.get("device", "").strip().lower()
    if device == "cpu":
        extra["MEMBER_DEVICE"] = "cpu"
    elif device not in ("", "gpu", "cuda"):
        Log.warning("factory spot: device must be cpu, gpu or cuda, got %r", device)
        return EXIT_BAD_ARGS
    if params.get("baseline", "0") == "1":
        summary = run_static_baseline(fleet_dir, nproc, ledger, trees=trees, rows=rows,
                                      extra_env=extra)
    else:
        if "script" in params:
            schedule = SpotSchedule.from_script(params["script"], price)
        else:
            schedule = SpotSchedule.sample(int(params.get("seed", "0")),
                                           float(params.get("horizon", "30")), base_price=price)
        summary = SpotFleet(fleet_dir, schedule, nproc, ledger, trees=trees, rows=rows,
                            extra_env=extra).run()
    print(json.dumps({k: v for k, v in summary.items() if k != "models"}, indent=1,
                     sort_keys=True))
    return EXIT_OK if summary["cost"] is not None else 1
