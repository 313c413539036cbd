"""A member of a live elastic training fleet:
``python -m lightgbm_tpu_torch.factory.member_worker member_id fleet_dir out``.

The port's own worker for ``factory spot`` (factory/spot.py ``SpotFleet``)
and for fleet drills: no ``torch.distributed`` bootstrap, every member a
process of its own, all coordination through the fleet directory's
``FileKVClient`` (parallel/membership.py).  ``member_id`` ``join`` is a
mid-run arrival (its id comes from the store).  It trains on the card
unless ``MEMBER_DEVICE=cpu``; without a card it fails.

The global dataset is made the same on every member from one seed:
integer-valued features (the value set is the same in every contiguous
slice, so each member's bin mappers are the same), which doubles as the
``row_provider`` seam (a transition rebuilds row slices in RAM).  The
features take ``MEMBER_MAX_BIN`` values when it is set, else 5 (the
problem of the JAX package's worker, ``tests/membership_worker.py``,
which this one trains at its defaults).

Environment (set by the parent):
  MEMBER_NPROC        the launch-time world (bootstrap members)
  MEMBER_ROWS / MEMBER_TREES / MEMBER_LEAVES   the problem (600, 12, 7)
  MEMBER_FEATURES / MEMBER_MAX_BIN             its width (10, 31)
  MEMBER_DEVICE       ``cpu`` for the plain PyTorch versions of the kernels
  MEMBER_KILL_ITER=i  SIGKILL itself after 0-based iteration i (an eviction)
  MEMBER_LEAVE_ITER=i request a clean leave after iteration i
  MEMBER_SIGTERM_ITER=i  SIGTERM itself after iteration i (the signal
                      handler's request_leave path, at a fixed point)
  MEMBER_ITER_SLEEP=s sleep s seconds after each iteration (paces the
                      fleet so that a joiner lands mid-run)
  MEMBER_REBALANCE=1  arm straggler rebalancing
  MEMBER_QUANTIZED=0  train on float32 gradients (quantized by default)
  MEMBER_PROGRESS=1   write-once ``progress/<iter>`` records (the first
                      finisher claims the slot) and per-attempt
                      ``attempts/<iter>.m<id>.e<epoch>`` keys, for the
                      spot cost ledger
and the LIGHTGBM_TPU_FAULT / _TRACE / _NET_* variables.

Exit codes: 0 on a finished model or a clean leave; 75 (``cli.
EXIT_PEER_FAILURE``, through ``net.hard_exit``) when the membership
recovery itself fails.  Writes ``out.mM.json`` always and ``out.mM.txt``
(the model) when training finished.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

import numpy as np


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def make_data(n: int, features: int, values: int):
    """The global rows, the same on every member: ``values`` integer levels
    a feature, labels from a seeded logistic model (the JAX worker's data
    at 10 features and 5 values)."""
    rng = np.random.default_rng(42)
    X = rng.integers(0, values, size=(n, features)).astype(np.float32)
    w = rng.standard_normal(features)
    center = np.float32((values - 1) / 2.0)
    scale = np.float32(4.0 / max(values - 1, 1))
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-((X - center) * scale) @ w * 0.35))
         ).astype(np.float32)
    return X, y


def main(argv) -> int:
    member_arg, fleet_dir, out = argv[0], argv[1], argv[2]
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.cli import EXIT_PEER_FAILURE
    from lightgbm_tpu_torch.ops import pkernels
    from lightgbm_tpu_torch.parallel import membership, net
    from lightgbm_tpu_torch.parallel.shardplan import ShardPlan

    n = _env_int("MEMBER_ROWS", 600)
    trees = _env_int("MEMBER_TREES", 12)
    leaves = _env_int("MEMBER_LEAVES", 7)
    features = _env_int("MEMBER_FEATURES", 10)
    max_bin = _env_int("MEMBER_MAX_BIN", 31)
    values = max_bin if "MEMBER_MAX_BIN" in os.environ else 5
    kill_iter = _env_int("MEMBER_KILL_ITER", -1)
    leave_iter = _env_int("MEMBER_LEAVE_ITER", -1)
    sigterm_iter = _env_int("MEMBER_SIGTERM_ITER", -1)
    iter_sleep = float(os.environ.get("MEMBER_ITER_SLEEP", "0"))
    rebalance = os.environ.get("MEMBER_REBALANCE", "0") == "1"
    quantized = os.environ.get("MEMBER_QUANTIZED", "1") == "1"
    progress = os.environ.get("MEMBER_PROGRESS", "0") == "1"
    device = "cpu" if os.environ.get("MEMBER_DEVICE", "").strip().lower() == "cpu" else None

    X, y = make_data(n, features, values)
    rt = membership.MembershipRuntime(fleet_dir, None if member_arg == "join" else int(member_arg))
    rt.row_provider = lambda lo, hi: (X[lo:hi], y[lo:hi])
    signal.signal(signal.SIGTERM, lambda *_a: rt.request_leave())
    if member_arg == "join":
        rt.join()
    else:
        nproc = int(os.environ["MEMBER_NPROC"])
        rt.bootstrap(nproc, [(r + 1) * n // nproc - r * n // nproc for r in range(nproc)])
    mid = rt.id

    def write(payload: dict) -> None:
        with open(out + f".m{mid}.json", "w") as fh:
            json.dump(payload, fh)

    lo, hi = ShardPlan.from_counts(rt.counts).rank_range(rt.rank)
    membership.set_runtime(rt)
    p = dict(objective="binary", tree_learner="data", pre_partition=True,
             elastic_membership=True, num_leaves=leaves, learning_rate=0.2, max_bin=max_bin,
             min_data_in_leaf=20, boost_from_average=False, quantized_training=quantized,
             seed=7, verbose=-1)
    if rebalance:
        p.update(rebalance=True, rebalance_threshold=1.5, rebalance_patience=3,
                 rebalance_max_move_frac=0.25)
    ds = lgt.Dataset(X[lo:hi], label=y[lo:hi], params=dict(p))
    epochs_seen, iter_s = [], []
    t_first = None
    try:
        # a loop on current_iteration(): a joiner restores at the fleet's
        # iteration and trains only the rounds left
        booster = lgt.Booster(params=dict(p), train_set=ds, device=device)
        pkernels.reset_launch_counts()
        while booster.current_iteration() < trees:
            t0 = time.perf_counter()
            booster.update()
            iter_s.append(time.perf_counter() - t0)
            if t_first is None:
                t_first = time.time()
            it = booster.current_iteration() - 1
            epochs_seen.append(rt.epoch)
            if progress:
                # the first member to finish an iteration claims its slot,
                # so a redone iteration cannot claim it again; the attempt
                # key carries the epoch, so a redo (a resize always bumps
                # it) leaves a second key the ledger sees
                rt.client.try_create(f"progress/{it}",
                                     json.dumps({"epoch": rt.epoch, "member": mid}).encode())
                rt.client.try_create(f"attempts/{it}.m{mid}.e{rt.epoch}", b"1")
            if 0 <= leave_iter <= it:
                rt.request_leave()
            if 0 <= sigterm_iter <= it:
                os.kill(os.getpid(), signal.SIGTERM)
            if 0 <= kill_iter <= it:
                os.kill(os.getpid(), signal.SIGKILL)
            if iter_sleep > 0:
                time.sleep(iter_sleep)
    except membership.CleanLeave as e:
        rt.stop()
        write({"error": None, "left_at_epoch": e.epoch, "member": mid,
               "epochs_seen": epochs_seen})
        print(f"member {mid} left cleanly at epoch {e.epoch}", flush=True)
        return 0
    except net.PeerFailureError as e:
        rt.stop()
        write({"error": "PeerFailureError", "ranks": list(e.ranks), "member": mid,
               "epochs_seen": epochs_seen})
        print(f"member {mid} unrecoverable peer failure: {e}", flush=True)
        net.hard_exit(EXIT_PEER_FAILURE)
    rt.stop()
    with open(out + f".m{mid}.txt", "w") as fh:
        fh.write(booster.model_to_string())
    b = booster.boosting
    comm = getattr(b.learner, "comm", None)
    write({
        "error": None,
        "member": mid,
        "trees": booster.num_trees,
        "iters": booster.current_iteration(),
        "final_epoch": rt.epoch,
        "final_members": list(rt.members),
        "final_counts": list(rt.counts),
        "rows_end": int(b.num_data),
        "epochs_seen": epochs_seen,
        "resize_pauses": [round(s, 4) for s in b._membership_pauses],
        "iter_s": [round(s, 6) for s in iter_s],
        "first_iter_at": t_first,  # the host clock at its first iteration's end
        "ledger": dict(comm.ledger) if comm is not None else {},
        "launches": pkernels.launch_counts(),
        "device": str(b.device),
    })
    print(f"member {mid} train done (epoch={rt.epoch}, members={list(rt.members)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
