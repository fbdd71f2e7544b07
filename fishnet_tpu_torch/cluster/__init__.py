"""Fleet-scale crash tolerance harness: the port of ``fishnet_tpu/cluster/``.

Everything below this package treats a *process* as the unit of
failure: the chaos proxy (:mod:`fishnet_tpu_torch.cluster.proxy`) sits
between each client process and the server and injects partitions,
latency and 5xx storms; the fleet supervisor
(:mod:`fishnet_tpu_torch.cluster.supervisor`) spawns real
``python -m fishnet_tpu_torch run`` client processes (and ``rpc.host``
evaluators), kills or drains them on a deterministic fault plan, and
restarts them under a bounded budget. ``python -m
fishnet_tpu_torch.cluster.chaos`` wires both against the stdlib fake
server of ``chip_smoke.py`` and audits the fleet ledger: every work
unit handed to any process is completed exactly once, across SIGKILL,
SIGTERM drain and network partitions.

All chaos is driven by the fault-plan grammar
(:mod:`fishnet_tpu_torch.resilience.faults`) through the fleet sites
``proxy.partition``, ``proxy.latency``, ``proxy.error5xx``,
``proc.kill`` and ``proc.sigterm``, seedable and deterministic, as in
the JAX package.

The package also hosts the fleet-wide position tier
(:mod:`fishnet_tpu_torch.cluster.position_tier`), imported by the
search service and the AZ plane in every client process, so the
chaos-harness names below are resolved lazily: attaching the shared
eval segment must not load the proxy or the supervisor.
"""

_LAZY = {
    "ChaosProxy": "fishnet_tpu_torch.cluster.proxy",
    "FleetSupervisor": "fishnet_tpu_torch.cluster.supervisor",
    "ProcSpec": "fishnet_tpu_torch.cluster.supervisor",
}

__all__ = ["ChaosProxy", "FleetSupervisor", "ProcSpec"]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
