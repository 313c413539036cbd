"""Continuous-training model factory — PyTorch counterpart of
lightgbm_tpu/factory/.

``python -m lightgbm_tpu_torch factory`` watches a data directory
(``watch.py``), warm-starts a checkpointed retrain, publishes to the
serving registry, canaries the candidate on a slice of live traffic and
promotes or rolls back on the eval metric and the serving SLO
(``supervisor.py``).  Its state is an atomic CRC'd file (``state.py``),
so a kill anywhere restarts into the same run without publishing twice.
``spot.py`` holds the preemptible-capacity trace and cost ledger; its
fleet runner waits for the elastic membership runtime.
"""

from .spot import CostLedger, SpotEvent, SpotSchedule
from .state import FactoryState
from .supervisor import DEFAULTS, FactorySupervisor, main

__all__ = ["CostLedger", "DEFAULTS", "FactoryState", "FactorySupervisor", "SpotEvent",
           "SpotSchedule", "main"]
