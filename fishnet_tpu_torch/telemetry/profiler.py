"""Continuous low-overhead sampling profiler + live stage-duration
histograms (the profiling half of the observability plane; the other
half is telemetry/cost.py) — the port of
``fishnet_tpu/telemetry/profiler.py``, with its roles, buckets, gate
and ``/profile`` bodies.

Two signals, both answering "where do the milliseconds go?":

* **Folded stacks.** A daemon thread walks ``sys._current_frames()``
  at ``FISHNET_PROFILE_HZ`` (default 47 — deliberately co-prime with
  common loop periods so the sampler never phase-locks onto a periodic
  workload) and folds every thread's stack under its fishnet ROLE
  (driver / pack / decode / acquire / frontend / main / other, from
  the thread-name contract below). The aggregate is served at the
  exporter's ``/profile`` endpoint as JSON, or as the classic
  root-first collapsed format (``role;frame;frame count`` — what
  ``flamegraph.pl`` and speedscope ingest) with ``?format=collapsed``.
* **Stage durations.** A spans.STAGE_OBSERVER hook feeds every
  recorded span's duration into ``fishnet_stage_duration_seconds
  {stage}`` — pack/transport/compute/decode p99s become live series a
  scrape can watch continuously. The observer takes the span
  recorder's one stage-observer slot (``spans.set_stage_observer``).

Gate discipline (doc/observability.md): everything here is OFF by
default. ``enabled()`` is one module-attribute read; the spans hook is
one module-attribute read inside ``record()`` (itself already gated on
``telemetry.enabled()``). ``FISHNET_PROFILE=1`` arms the plane at
``start_exporter`` time; tests and callers call :func:`start`
directly. The sampler's own cost is self-accounted (``self_seconds``)
so its overhead is a measured number, not a promise: the snapshot's
``duty_cycle`` is ``self_seconds`` over wall.

Thread-name -> role contract (the names are set at thread creation in
the named modules and pinned by tests):

==========  ==================================================
role        thread-name prefixes
==========  ==================================================
driver      ``search-driver`` (search/service.py),
            ``az-mcts-driver`` (engine/az_engine.py)
pack        ``dispatch-pack`` (search/coalesce.py)
decode      ``dispatch-decode`` (search/coalesce.py)
acquire     ``acquire``, ``api`` (net tier)
frontend    ``frontend``, ``tenant`` (sched/frontend.py)
main        ``MainThread`` (asyncio event loop: the scheduler,
            acquire streams, and front end all run here)
other       everything else (exporter, aggregator, sampler...)
==========  ==================================================
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs

from fishnet_tpu_torch.telemetry import spans as _spans
from fishnet_tpu_torch.telemetry.registry import (
    REGISTRY,
    histogram_quantiles,
)

__all__ = [
    "DEFAULT_HZ",
    "SamplingProfiler",
    "enabled",
    "maybe_start_from_env",
    "profiler",
    "render_endpoint",
    "role_of",
    "stage_quantiles",
    "start",
    "stop",
]

#: Default sampling rate. 47 Hz: high enough that a 1-second stage
#: shows ~47 samples (±20% at 95% confidence), low enough that one
#: sample's cost (~50-200 us walking every thread) stays well under a
#: 3% duty cycle, and prime so the sampler cannot phase-lock with a
#: periodic driver loop and systematically over/under-sample one stage.
DEFAULT_HZ = 47.0

#: Stack frames kept per sample; deeper stacks are truncated at the
#: ROOT end (the leaf frames are the ones that attribute self time).
MAX_DEPTH = 48

#: Distinct folded stacks kept before new ones collapse into the
#: per-role ``[truncated]`` bucket — bounds memory under pathological
#: stack churn (recursive interpreters, deep asyncio chains).
MAX_STACKS = 4000

#: Buckets for fishnet_stage_duration_seconds: spans range from ~100 us
#: (a pack of an empty batch) to multi-second device stalls.
STAGE_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0,
)

#: (role, thread-name prefixes) in match order — first hit wins.
ROLE_PREFIXES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("driver", ("search-driver", "az-mcts-driver")),
    ("pack", ("dispatch-pack",)),
    ("decode", ("dispatch-decode",)),
    ("acquire", ("acquire", "api")),
    ("frontend", ("frontend", "tenant")),
    ("main", ("MainThread",)),
)


def role_of(thread_name: str) -> str:
    """Map a thread name onto its fishnet role (module docstring)."""
    for role, prefixes in ROLE_PREFIXES:
        for p in prefixes:
            if thread_name.startswith(p):
                return role
    return "other"


def _frame_label(code) -> str:
    """``module.py:function`` — short enough to fold, unique enough to
    find (the full path would make every stack line unreadable)."""
    return f"{os.path.basename(code.co_filename)}:{code.co_name}"


class SamplingProfiler:
    """The sampling daemon + folded-stack aggregate.

    The sampler thread is the SINGLE writer of ``_stacks`` under
    ``_lock``; readers (``/profile``, callers of ``snapshot``) take
    the same lock for a snapshot — sampling is ~Hz, so the lock is
    never hot. ``self_seconds`` accumulates the sampler's own walk
    time: its duty cycle (``self_seconds / wall``) IS the measured
    overhead."""

    def __init__(self, hz: float = DEFAULT_HZ,
                 max_stacks: int = MAX_STACKS) -> None:
        self.hz = max(1.0, float(hz))
        self._max_stacks = max_stacks
        self._lock = threading.Lock()
        # (role, folded-stack tuple) -> sample count
        self._stacks: Dict[Tuple[str, Tuple[str, ...]], int] = {}
        self._roles: Dict[str, int] = {}
        self.samples = 0
        self.self_seconds = 0.0
        self.started_at = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="profile-sampler", daemon=True
        )

    # -- sampling ---------------------------------------------------------

    def start(self) -> None:
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    def _loop(self) -> None:
        period = 1.0 / self.hz
        while not self._stop.wait(period):
            t0 = time.monotonic()
            try:
                self._sample()
            except Exception:  # noqa: BLE001 - the sampler must not die
                pass
            self.self_seconds += time.monotonic() - t0

    def _sample(self) -> None:
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        me = threading.get_ident()
        folded: List[Tuple[str, Tuple[str, ...]]] = []
        for ident, frame in frames.items():
            if ident == me:
                continue  # never profile the profiler
            role = role_of(names.get(ident, "?"))
            stack: List[str] = []
            f = frame
            while f is not None and len(stack) < MAX_DEPTH:
                stack.append(_frame_label(f.f_code))
                f = f.f_back
            stack.reverse()  # root-first: the collapsed-format order
            folded.append((role, tuple(stack)))
        with self._lock:
            self.samples += 1
            for role, stack in folded:
                self._roles[role] = self._roles.get(role, 0) + 1
                key = (role, stack)
                n = self._stacks.get(key)
                if n is None and len(self._stacks) >= self._max_stacks:
                    key = (role, ("[truncated]",))
                    n = self._stacks.get(key)
                self._stacks[key] = (n or 0) + 1

    # -- reading ----------------------------------------------------------

    def top_stacks(self, k: int = 10) -> List[dict]:
        """The k hottest folded stacks by sample count (= self+child
        time at the fold granularity), with each stack's share of all
        samples."""
        with self._lock:
            items = sorted(
                self._stacks.items(), key=lambda kv: -kv[1]
            )[:k]
            total = sum(self._stacks.values()) or 1
        return [
            {
                "role": role,
                "stack": list(stack),
                "count": count,
                "share": round(count / total, 4),
            }
            for (role, stack), count in items
        ]

    def collapsed(self) -> str:
        """Brendan-Gregg collapsed format: one ``role;frame;...;frame
        count`` line per distinct stack, hottest first — pipe straight
        into ``flamegraph.pl`` or load in speedscope."""
        with self._lock:
            items = sorted(self._stacks.items(), key=lambda kv: -kv[1])
        return "\n".join(
            ";".join((role,) + stack) + f" {count}"
            for (role, stack), count in items
        ) + ("\n" if items else "")

    def snapshot(self) -> dict:
        wall = max(1e-9, time.monotonic() - self.started_at)
        with self._lock:
            n_stacks = len(self._stacks)
            roles = dict(self._roles)
        return {
            "enabled": True,
            "hz": self.hz,
            "samples": self.samples,
            "distinct_stacks": n_stacks,
            "wall_seconds": round(wall, 3),
            "self_seconds": round(self.self_seconds, 6),
            # The measured overhead bound: fraction of one core the
            # sampler itself consumed.
            "duty_cycle": round(self.self_seconds / wall, 6),
            "samples_by_role": roles,
            "stacks": self.top_stacks(50),
            "stages": stage_quantiles(),
        }


# -- stage-duration histograms ------------------------------------------------

_STAGE_HIST = None


def _install_stage_observer():
    """Create (idempotently) the stage-duration histogram and hook it
    into the span recorder: every ``record()`` observes its span's
    duration into ``fishnet_stage_duration_seconds{stage}``. Histogram
    cells are per-thread, so the observer adds no lock to the span hot
    path."""
    global _STAGE_HIST
    if _STAGE_HIST is None:
        _STAGE_HIST = REGISTRY.histogram(
            "fishnet_stage_duration_seconds",
            "Continuous per-stage span durations (live while "
            "FISHNET_PROFILE is on): the pipeline stages plus event "
            "stages, fed from the span flight recorder's hook.",
            labelnames=("stage",),
            buckets=STAGE_BUCKETS,
        )
    hist = _STAGE_HIST

    def observe(stage: str, dur: float) -> None:
        hist.observe(dur, stage=stage)

    _spans.set_stage_observer(observe)


def stage_quantiles() -> Dict[str, dict]:
    """Per-stage ``{count, sum, p50, p90, p99}`` (seconds) from the
    live histogram; empty dict while the profiling plane is off."""
    if _STAGE_HIST is None:
        return {}
    out: Dict[str, dict] = {}
    for row in histogram_quantiles(_STAGE_HIST.collect()):
        stage = row["labels"].get("stage", "?")
        out[stage] = {k: v for k, v in row.items() if k != "labels"}
    return out


# -- the module-level gate ----------------------------------------------------

#: The gate: one module-attribute read when off, exactly like
#: telemetry._enabled.
_PROFILER: Optional[SamplingProfiler] = None


def enabled() -> bool:
    """Whether the continuous profiler is running (off by default)."""
    return _PROFILER is not None


def profiler() -> Optional[SamplingProfiler]:
    return _PROFILER


def start(hz: Optional[float] = None) -> SamplingProfiler:
    """Arm the profiling plane: start the sampling daemon (idempotent)
    and install the stage-duration observer. ``hz`` defaults to
    ``FISHNET_PROFILE_HZ`` or :data:`DEFAULT_HZ`."""
    global _PROFILER
    if _PROFILER is not None:
        return _PROFILER
    if hz is None:
        try:
            hz = float(os.environ.get("FISHNET_PROFILE_HZ", "") or DEFAULT_HZ)
        except ValueError:
            hz = DEFAULT_HZ
    prof = SamplingProfiler(hz=hz)
    _install_stage_observer()
    prof.start()
    _PROFILER = prof
    return prof


def stop() -> None:
    """Disarm: stop the sampler and remove the span hook (the
    histogram instrument stays registered — counters never vanish
    mid-scrape)."""
    global _PROFILER
    _spans.set_stage_observer(None)
    prof = _PROFILER
    _PROFILER = None
    if prof is not None:
        prof.stop()


def maybe_start_from_env() -> Optional[SamplingProfiler]:
    """``FISHNET_PROFILE=1`` (anything non-empty, non-"0") arms the
    plane — called by ``telemetry.start_exporter`` so one opt-in flag
    turns a metrics-serving process into a profiled one."""
    flag = os.environ.get("FISHNET_PROFILE", "")
    if flag and flag != "0":
        return start()
    return None


# -- the /profile endpoint ----------------------------------------------------


def render_endpoint(query: str = "") -> Tuple[int, str, bytes]:
    """Body for ``GET /profile[?format=collapsed]`` (exporter.py routes
    here). 503 with a JSON hint while the plane is off — scrapers can
    distinguish "not armed" from "not serving"."""
    prof = _PROFILER
    if prof is None:
        body = json.dumps({
            "enabled": False,
            "hint": "set FISHNET_PROFILE=1 (or call telemetry.profiler"
                    ".start()) to arm the sampling profiler",
        }).encode()
        return 503, "application/json", body
    fmt = parse_qs(query).get("format", [""])[0]
    if fmt == "collapsed":
        return 200, "text/plain; charset=utf-8", prof.collapsed().encode()
    return 200, "application/json", json.dumps(prof.snapshot()).encode()
