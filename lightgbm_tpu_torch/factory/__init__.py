"""Continuous-training model factory — PyTorch counterpart of
lightgbm_tpu/factory/.

``python -m lightgbm_tpu_torch factory`` watches a data directory
(``watch.py``), warm-starts a checkpointed retrain, publishes to the
serving registry, canaries the candidate on a slice of live traffic and
promotes or rolls back on the eval metric and the serving SLO
(``supervisor.py``).  Its state is an atomic CRC'd file (``state.py``),
so a kill anywhere restarts into the same run without publishing twice.
``spot.py`` runs elastic member fleets (``member_worker.py``) against a
preemptible-capacity trace and prices them in a cost ledger.
"""

from .spot import CostLedger, SpotEvent, SpotFleet, SpotSchedule, run_static_baseline
from .state import FactoryState
from .supervisor import DEFAULTS, FactorySupervisor, main

__all__ = ["CostLedger", "DEFAULTS", "FactoryState", "FactorySupervisor", "SpotEvent",
           "SpotFleet", "SpotSchedule", "main", "run_static_baseline"]
