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

The fleet runner (``SpotFleet``, ``run_static_baseline`` and ``python -m
lightgbm_tpu_torch factory spot``) drives membership workers, which wait
for the elastic membership runtime (parallel/membership.py in the JAX
package): ``main`` refuses until then.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional

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


def main(argv: List[str]) -> int:
    """``factory spot``: refused until the elastic membership runtime,
    which its fleet's workers ride, is ported."""
    del argv
    raise NotImplementedError(
        "lightgbm_tpu_torch does not support 'factory spot' yet: its fleet drives elastic "
        "membership workers (queue A2c)")
