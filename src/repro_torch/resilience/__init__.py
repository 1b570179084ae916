"""Fault tolerance for the SWAP train -> average -> publish -> serve loop:
twin of ``repro/resilience``.

Layers:

  * liveness    -- ``repro_torch.dist.heartbeat`` (file beacons -> elastic
                   arrivals and live masks);
  * supervision -- ``PhaseSupervisor`` here: bounded retry and backoff
                   around ``run_phase``, rollback on divergence, recovery
                   from a dead worker by shrinking the ensemble;
  * integrity   -- checksummed checkpoint sidecars and verified fallback
                   (``repro_torch.checkpoint.state``);
  * degradation -- serving admission deadlines and publish retry
                   (``repro_torch.serve``).

``repro_torch.testing.faults`` drives each of them in the tests.
"""
from repro_torch.resilience.supervisor import (DivergenceError,
                                               PhaseSupervisor,
                                               RecoveryEvent,
                                               SupervisedResult,
                                               SupervisorConfig,
                                               SupervisorError,
                                               WorkerLostError)

__all__ = [
    "DivergenceError",
    "PhaseSupervisor",
    "RecoveryEvent",
    "SupervisedResult",
    "SupervisorConfig",
    "SupervisorError",
    "WorkerLostError",
]
