"""Deterministic fault plane: named injection sites at the serving
chokepoints, driven by a seedable plan.

The port's copy of ``fishnet_tpu/resilience/faults.py``, with the same
grammar, sites, triggers, actions and counter
(``fishnet_faults_injected_total{site,action}`` on the port's
registry). A plan names a site, a trigger, and an action, and the site
fires deterministically, so the recovery machinery (429 suspension,
jittered error backoff, engine-restart backoff, the degradation ladder,
the circuit breaker, batch requeue, the deadline flush) can be
exercised on demand.

Plan grammar::

    plan    := clause (';' clause)*
    clause  := 'seed=' INT | site ':' trigger ':' action
    site    := net.acquire | net.submit | engine.spawn
             | service.device_step | queue.schedule | queue.admit
             | proxy.partition | proxy.latency | proxy.error5xx
             | proc.kill | proc.sigterm | rpc.detach
    trigger := 'nth=' N | 'nth=' A '..' B     -- 1-based call index
             | 'every=' N                     -- every Nth call
             | 'p=' FLOAT                     -- per-call probability
    action  := 'error'                        -- raise FaultInjected
             | 'crash'                        -- raise FaultCrash
             | 'latency=' SECONDS             -- sleep, then proceed
             | 'hang=' SECONDS                -- sleep, then raise
                                              -- (a hung call whose
                                              -- deadline fires)

Example: ``seed=7;net.acquire:nth=2..3:error;service.device_step:nth=1:crash``.

Sites of the port: ``net.acquire`` and ``net.submit`` (the API actor,
net/api.py), ``engine.spawn`` (a worker's engine start, client.py),
``queue.schedule`` (the trust boundary of an acquired batch,
sched/queue.py), ``queue.admit`` (the multi-tenant front end's
admission of an acquired batch, sched/frontend.py: a fault there sheds
the batch), ``service.device_step`` (a driver thread right before its
device dispatch, search/service.py) and ``rpc.detach`` (polled once per
sweep of the split plane's evaluator host while at least one link is
attached, rpc/host.py). The fleet sites ``proxy.*`` and ``proc.*`` are
polled by the chaos proxy (cluster/proxy.py, per forwarded request) and
the fleet supervisor (cluster/supervisor.py, per monitor tick) on each
supervised process's own plan.

Determinism: ``nth``/``every`` triggers depend only on the per-site
call count; ``p`` triggers draw from the plan's own
``random.Random(seed)``, so a given (seed, call sequence) produces the
same faults here as in the JAX package. With several threads hitting
one site the call *order* is the scheduler's — use ``nth`` when a test
needs strict determinism.

Hot-path discipline: sites gate on :func:`enabled` — one module
attribute read when no plan is installed, so production traffic pays
nothing.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from fishnet_tpu_torch import telemetry as _telemetry

#: The injection-site registry, the JAX package's names. Plans naming an
#: unknown site fail to parse. The ``proxy.*`` and ``proc.*`` sites are
#: FLEET sites: the chaos proxy (cluster/proxy.py) polls ``proxy.*`` per
#: forwarded request and the fleet supervisor (cluster/supervisor.py)
#: ``proc.*`` per monitor tick, each on its process's own plan; nothing
#: in a client process polls them.
SITES = (
    "net.acquire",
    "net.submit",
    "engine.spawn",
    "service.device_step",
    "queue.schedule",
    "queue.admit",
    "proxy.partition",
    "proxy.latency",
    "proxy.error5xx",
    "proc.kill",
    "proc.sigterm",
    "rpc.detach",
)

ACTIONS = ("error", "crash", "latency", "hang")

_INJECTED = _telemetry.REGISTRY.counter(
    "fishnet_faults_injected_total",
    "Faults injected by the resilience fault plane, per site and action.",
    labelnames=("site", "action"),
)

#: Environment variable carrying the plan: the fallback of ``--fault-plan``
#: and the only way in for processes without that flag (the split
#: plane's evaluator host).
PLAN_ENV = "FISHNET_FAULT_PLAN"


class FaultPlanError(ValueError):
    """A fault-plan spec failed to parse."""


class FaultInjected(RuntimeError):
    """An injected fault (action ``error`` or ``hang``)."""

    def __init__(self, site: str, action: str) -> None:
        super().__init__(f"injected fault at {site} ({action})")
        self.site = site
        self.action = action


class FaultCrash(FaultInjected):
    """An injected crash: sites must NOT handle this gracefully — it
    models a component death (driver crash, process kill) the layer
    above recovers from."""


@dataclass
class FaultRule:
    site: str
    trigger: str  # "nth" | "every" | "p"
    lo: int = 0  # nth lower bound / every period
    hi: int = 0  # nth upper bound (== lo for single nth)
    prob: float = 0.0
    action: str = "error"
    arg: float = 0.0  # seconds for latency / hang

    def matches(self, n: int, rng: random.Random) -> bool:
        if self.trigger == "nth":
            return self.lo <= n <= self.hi
        if self.trigger == "every":
            return self.lo > 0 and n % self.lo == 0
        return rng.random() < self.prob


class FaultPlan:
    """A parsed plan: per-site rules, per-site call counts, seeded RNG.

    ``poll(site)`` counts the call and returns the first matching rule
    (or None). Counting is under a lock — acceptable because a plan is
    only ever installed in tests/soaks, never in production serving.
    """

    def __init__(self, rules: List[FaultRule], seed: int = 0) -> None:
        self.seed = seed
        self.rules: Dict[str, List[FaultRule]] = {}
        for rule in rules:
            self.rules.setdefault(rule.site, []).append(rule)
        self._counts: Dict[str, int] = {site: 0 for site in SITES}
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        rules: List[FaultRule] = []
        seed = 0
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if clause.startswith("seed="):
                try:
                    seed = int(clause[len("seed="):])
                except ValueError as err:
                    raise FaultPlanError(f"bad seed clause: {clause!r}") from err
                continue
            parts = clause.split(":")
            if len(parts) != 3:
                raise FaultPlanError(
                    f"clause {clause!r} is not site:trigger:action"
                )
            site, trigger, action = (p.strip() for p in parts)
            if site not in SITES:
                raise FaultPlanError(
                    f"unknown site {site!r} (sites: {', '.join(SITES)})"
                )
            rules.append(cls._parse_rule(site, trigger, action, clause))
        return cls(rules, seed=seed)

    @staticmethod
    def _parse_rule(
        site: str, trigger: str, action: str, clause: str
    ) -> FaultRule:
        rule = FaultRule(site=site, trigger="nth")
        try:
            if trigger.startswith("nth="):
                body = trigger[len("nth="):]
                if ".." in body:
                    lo, hi = body.split("..", 1)
                    rule.lo, rule.hi = int(lo), int(hi)
                else:
                    rule.lo = rule.hi = int(body)
                if rule.lo < 1 or rule.hi < rule.lo:
                    raise FaultPlanError(f"bad nth bounds in {clause!r}")
            elif trigger.startswith("every="):
                rule.trigger = "every"
                rule.lo = int(trigger[len("every="):])
                if rule.lo < 1:
                    raise FaultPlanError(f"bad every period in {clause!r}")
            elif trigger.startswith("p="):
                rule.trigger = "p"
                rule.prob = float(trigger[len("p="):])
                if not 0.0 <= rule.prob <= 1.0:
                    raise FaultPlanError(f"probability out of [0,1] in {clause!r}")
            else:
                raise FaultPlanError(f"unknown trigger {trigger!r} in {clause!r}")
            if action in ("error", "crash"):
                rule.action = action
            elif action.startswith("latency="):
                rule.action = "latency"
                rule.arg = float(action[len("latency="):])
            elif action.startswith("hang="):
                rule.action = "hang"
                rule.arg = float(action[len("hang="):])
            else:
                raise FaultPlanError(f"unknown action {action!r} in {clause!r}")
        except FaultPlanError:
            raise
        except ValueError as err:
            raise FaultPlanError(f"bad clause {clause!r}: {err}") from err
        if rule.arg < 0:
            raise FaultPlanError(f"negative duration in {clause!r}")
        return rule

    def poll(self, site: str) -> Optional[FaultRule]:
        """Count one call at ``site``; return the rule to apply, if any."""
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            for rule in self.rules.get(site, ()):
                if rule.matches(n, self._rng):
                    _INJECTED.inc(site=site, action=rule.action)
                    return rule
        return None

    def counts(self) -> Dict[str, int]:
        """Per-site call counts so far (diagnostics / tests)."""
        with self._lock:
            return dict(self._counts)


#: The installed plan; None = fault injection off (the production state).
_PLAN: Optional[FaultPlan] = None


def enabled() -> bool:
    """Whether a fault plan is installed (one attribute read when off)."""
    return _PLAN is not None


def install(plan) -> FaultPlan:
    """Install a plan (a FaultPlan or a spec string). Returns it."""
    global _PLAN
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    _PLAN = plan
    return plan


def clear() -> None:
    global _PLAN
    _PLAN = None


def current() -> Optional[FaultPlan]:
    return _PLAN


def install_from_env(environ=None) -> Optional[FaultPlan]:
    """Install from ``FISHNET_FAULT_PLAN`` if set; None otherwise."""
    spec = (environ if environ is not None else os.environ).get(PLAN_ENV)
    if not spec:
        return None
    return install(spec)


def _raise_for(rule: FaultRule) -> None:
    if rule.action == "crash":
        raise FaultCrash(rule.site, rule.action)
    raise FaultInjected(rule.site, rule.action)


def fire(site: str) -> None:
    """Synchronous injection point (driver threads, sync call sites).

    Call sites gate on :func:`enabled` first so this is never reached
    in production. ``latency`` sleeps and returns; ``hang`` sleeps its
    deadline then raises; ``error``/``crash`` raise immediately.
    """
    plan = _PLAN
    if plan is None:
        return
    rule = plan.poll(site)
    if rule is None:
        return
    if rule.action == "latency":
        time.sleep(rule.arg)
        return
    if rule.action == "hang":
        time.sleep(rule.arg)
    _raise_for(rule)


async def fire_async(site: str) -> None:
    """Event-loop injection point: like :func:`fire` but sleeps
    cooperatively, so an injected latency/hang never blocks the loop."""
    import asyncio

    plan = _PLAN
    if plan is None:
        return
    rule = plan.poll(site)
    if rule is None:
        return
    if rule.action == "latency":
        await asyncio.sleep(rule.arg)
        return
    if rule.action == "hang":
        await asyncio.sleep(rule.arg)
    _raise_for(rule)
