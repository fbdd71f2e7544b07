"""Resilience subsystem of the port: the deterministic fault plane, the
degradation ladder and circuit breaker, exactly-once batch accounting,
the graceful-drain state, admission control and the soak harness — the
port of ``fishnet_tpu/resilience/``.

* :mod:`fishnet_tpu_torch.resilience.faults` — a seedable, deterministic
  fault plane with named injection sites at the serving chokepoints
  (``net.acquire``, ``net.submit``, ``engine.spawn``,
  ``service.device_step``, ``queue.schedule``, ``queue.admit``,
  ``rpc.detach``). Plans
  come from ``FISHNET_FAULT_PLAN`` / ``--fault-plan``; when no plan is
  installed every site costs one module-attribute read.
* :mod:`fishnet_tpu_torch.resilience.supervisor` — the degradation
  ladder (on CUDA fused -> host-material, both on the hand kernel),
  bounded pool respawns, and the submit-endpoint circuit breaker.
* :mod:`fishnet_tpu_torch.resilience.accounting` — the batch ledger
  (acquired -> scheduled -> stepped -> submitted, with requeue
  generations) asserting no batch is lost or double-submitted.
* :mod:`fishnet_tpu_torch.resilience.drain` — the draining flag, its
  ``fishnet_drain_state`` gauge and the ``/healthz`` readiness provider.
* :mod:`fishnet_tpu_torch.resilience.shedding` — the multi-tenant front
  end's admission policy: watermark hysteresis on the throughput lane,
  a latency-lane bound, capacity scaled by the ladder's rung.
* :mod:`fishnet_tpu_torch.resilience.soak` — ``python -m
  fishnet_tpu_torch.resilience.soak``: the client, the supervised
  service and the front end under canned fault plans.

Everything is **off by default**: with no fault plan installed, no
ledger installed, and no supervisor wrapped around the service builder,
the serving hot paths are unchanged.
"""

from __future__ import annotations

from fishnet_tpu_torch.resilience import accounting, faults  # noqa: F401
from fishnet_tpu_torch.resilience.faults import (  # noqa: F401 - public API
    SITES,
    FaultCrash,
    FaultInjected,
    FaultPlan,
    FaultPlanError,
)
