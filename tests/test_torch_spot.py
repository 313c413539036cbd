"""The port's preemptible-capacity loop end to end on the CPU
(lightgbm_tpu_torch/factory/spot.py ``SpotFleet``, ``run_static_baseline``
and ``python -m lightgbm_tpu_torch factory spot``, driving the port's
member worker with ``MEMBER_DEVICE=cpu``).

- a two-member fleet with member 1 preempted (SIGKILL) at 3 s and a
  joiner spawned at 4 s finishes the model; the ledger prices every
  member-second at the spot price, and the write-once iteration and
  attempt records prove no iteration lost or redone;
- the static baseline prices every member-second on demand;
- ``factory spot`` through the CLI (``device=cpu``) ends with a cost and
  zero lost iterations; without ``fleet=`` it exits 2;
- a ``CostLedger`` file written by one package loads in the other.

The schedule's grammar and the ledger's arithmetic are held against the
JAX package in tests/test_torch_factory.py.
"""

import json
import os

import pytest

from lightgbm_tpu_torch.factory.spot import (ON_DEMAND_PRICE, CostLedger, SpotFleet,
                                             SpotSchedule, run_static_baseline)

pytestmark = [pytest.mark.factory, pytest.mark.membership]

CPU = {"MEMBER_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}


def test_spot_fleet_preempt_respawn_e2e(tmp_path):
    fleet_dir = str(tmp_path / "fleet")
    ledger_path = str(tmp_path / "ledger.json")
    fleet = SpotFleet(fleet_dir, SpotSchedule.from_script("preempt@3=1;spawn@4", base_price=0.25),
                      2, ledger_path, trees=10, rows=600,
                      extra_env=dict(CPU, MEMBER_ITER_SLEEP="0.5"))
    summary = fleet.run(timeout_s=180)
    assert summary["cost"] is not None, summary["exits"]
    assert summary["zero_lost_iterations"], summary
    assert summary["models"], "no finisher wrote a model"
    assert len(set(summary["models"].values())) == 1  # every finisher the same bytes
    assert summary["exits"]["1"] == -9 and "1" not in summary["models"]
    assert summary["exits"]["0"] == 0 and summary["exits"]["join1"] == 0
    assert all(m["device"] == "cpu" for m in summary["metas"].values() if "device" in m)
    led = CostLedger.load(ledger_path)
    assert led.total_cost == pytest.approx(summary["cost"])
    kinds = [e["kind"] for e in led._doc["events"]]
    assert "preempt" in kinds and "spawn" in kinds
    assert led._doc["attempts"] and all(len(v) == 1 for v in led._doc["attempts"].values())
    for key in ("0", "1", "join1"):  # a log file a member, kept for the post-mortem
        assert os.path.exists(os.path.join(fleet_dir, f"worker.{key}.log"))
    secs = sum(led._doc["member_seconds"].values())
    assert led.total_cost == pytest.approx(secs * 0.25, rel=1e-6)


def test_static_baseline_prices_on_demand(tmp_path):
    summary = run_static_baseline(str(tmp_path / "fleet"), 2, str(tmp_path / "ledger.json"),
                                  trees=6, rows=600, extra_env=dict(CPU, MEMBER_ITER_SLEEP="0"))
    assert summary["cost"] is not None, summary["exits"]
    assert summary["zero_lost_iterations"] and summary["exits"] == {"0": 0, "1": 0}
    led = CostLedger.load(str(tmp_path / "ledger.json"))
    secs = sum(led._doc["member_seconds"].values())
    assert led.total_cost == pytest.approx(secs * ON_DEMAND_PRICE, rel=1e-6)


def test_factory_spot_cli_prices_a_fleet(tmp_path, capsys):
    from lightgbm_tpu_torch import cli

    fleet = tmp_path / "fleet"
    rc = cli.main(["factory", "spot", f"fleet={fleet}", "nproc=2", "trees=6",
                   "script=preempt@3;spawn@4", "price=0.3", "device=cpu"])
    lines = capsys.readouterr().out.splitlines()
    first = max(i for i, ln in enumerate(lines) if ln == "{")  # the summary is printed last
    summary = json.loads("\n".join(lines[first:]))
    assert rc == 0
    assert summary["cost"] is not None and summary["zero_lost_iterations"], summary
    assert summary["exits"]["1"] == -9 and "models" not in summary
    led = CostLedger.load(str(fleet / "cost_ledger.json"))
    assert led.cost_per_model() == pytest.approx(summary["cost"])
    assert any(e["kind"] == "preempt" for e in led._doc["events"])


@pytest.mark.parametrize("argv", [[], ["nproc=2"], ["fleet=x", "device=tpu"]])
def test_spot_cli_refuses_bad_arguments(argv, tmp_path, monkeypatch):
    from lightgbm_tpu_torch.factory.spot import main

    monkeypatch.chdir(tmp_path)
    assert main(argv) == 2  # EXIT_BAD_ARGS, no process started
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cost_ledger_files_cross_packages(tmp_path, writer):
    import jax
    import jax._src.core

    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    try:
        from lightgbm_tpu.factory.spot import CostLedger as JLedger
    finally:
        if not had:
            del jax.core.trace_state_clean
    W, R = (CostLedger, JLedger) if writer == "port" else (JLedger, CostLedger)
    path = str(tmp_path / "ledger.json")
    led = W(path)
    led.charge("0", 2.0, 0.3)
    led.charge("join1", 1.5, 0.3)
    led.event(1.0, "preempt", member="1")
    for it in range(3):
        led.iteration(it, epoch=0 if it < 2 else 1, t_s=0.5 * it)
        led.attempt(it, "0", 0 if it < 2 else 1)
    led.finish(3)
    led.flush()
    back = R.load(path)
    assert back.total_cost == pytest.approx(led.total_cost)
    assert back.cost_per_model() == pytest.approx(led.cost_per_model())
    assert back.zero_lost_iterations() and led.zero_lost_iterations()
