"""Persistent throughput stats and the NPS self-model.

Equivalent of the reference's stats layer (src/stats.rs): cumulative
batch/position/node counters JSON-persisted to disk (default
``~/.fishnet-tpu-stats``), plus an EWMA nodes-per-second estimator that
feeds the acquire-pacing policy (``min_user_backlog``,
src/stats.rs:135-148).

The port's copy of ``fishnet_tpu/utils/stats.py``, with its metrics
collector (``register_stats_collector``). Persistence is debounced: the file is rewritten at most
every ``FLUSH_INTERVAL_SECONDS`` (first batch writes immediately so
short runs still persist), with a ``flush()`` for shutdown.
"""

from __future__ import annotations

import json
import os
import time
import weakref
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Optional

#: Minimum seconds between stats-file rewrites (see module docstring).
FLUSH_INTERVAL_SECONDS = 30.0


def default_stats_file() -> Optional[Path]:
    try:
        home = Path.home()
    except RuntimeError:
        # Path.home() *raises* when no home directory can be resolved
        # (stripped container/daemon environments) — it never returns a
        # falsy value. No home: stats are simply not persisted.
        return None
    return home / ".fishnet-tpu-stats"


@dataclass
class Stats:
    total_batches: int = 0
    total_positions: int = 0
    total_nodes: int = 0


class NpsRecorder:
    """EWMA (alpha=0.9) NPS estimate with decaying uncertainty
    (src/stats.rs:151-186). Starts at a deliberately low 400 knps x cores."""

    def __init__(self, cores: int) -> None:
        self.nps = 400_000 * max(1, cores)
        self.uncertainty = 1.0

    def record(self, nps: int) -> None:
        alpha = 0.9
        self.uncertainty *= alpha
        self.nps = int(self.nps * alpha + nps * (1.0 - alpha))

    def __str__(self) -> str:
        s = f"{self.nps // 1000} knps"
        for threshold in (0.7, 0.4, 0.1):
            if self.uncertainty > threshold:
                s += "?"
        return s


class StatsRecorder:
    def __init__(
        self,
        cores: int,
        stats_file: Optional[Path] = None,
        no_stats_file: bool = False,
        flush_interval: float = FLUSH_INTERVAL_SECONDS,
    ) -> None:
        self.stats = Stats()
        self.nnue_nps = NpsRecorder(cores)
        self.path: Optional[Path] = None
        self.flush_interval = flush_interval
        self._dirty = False
        self._last_flush: Optional[float] = None  # None = never written

        if no_stats_file:
            return
        path = stats_file or default_stats_file()
        if path is None:
            return
        self.path = Path(path)
        try:
            if self.path.exists() and self.path.stat().st_size > 0:
                data = json.loads(self.path.read_text())
                self.stats = Stats(
                    total_batches=int(data.get("total_batches", 0)),
                    total_positions=int(data.get("total_positions", 0)),
                    total_nodes=int(data.get("total_nodes", 0)),
                )
        except (OSError, ValueError, TypeError, AttributeError):
            # Corrupt, unreadable, or wrong-shaped stats: reset, as the
            # reference does (src/stats.rs:99-102).
            self.stats = Stats()

    def record_batch(
        self, positions: int, nodes: int, nnue_nps: Optional[int] = None
    ) -> None:
        self.stats.total_batches += 1
        self.stats.total_positions += positions
        self.stats.total_nodes += nodes
        if nnue_nps is not None:
            self.nnue_nps.record(nnue_nps)
        self._dirty = True
        # Debounced persistence: a busy client finishing a batch every
        # few hundred ms must not pay a write+rename per batch. The
        # first batch flushes immediately (short runs still persist);
        # call flush() at shutdown for the tail.
        if self.path is not None and (
            self._last_flush is None
            or time.monotonic() - self._last_flush >= self.flush_interval
        ):
            self.flush()

    def flush(self) -> None:
        """Write pending totals to the stats file (atomic rename)."""
        if self.path is None or not self._dirty:
            return
        self._last_flush = time.monotonic()
        self._dirty = False
        try:
            tmp = self.path.with_suffix(".tmp")
            tmp.write_text(json.dumps(asdict(self.stats), indent=2))
            os.replace(tmp, self.path)
        except OSError:
            pass

    def min_user_backlog(self) -> float:
        """Seconds of user-queue backlog below which this client should not
        take latency-sensitive work (it would be slower than letting a top
        client do it). Model: average batch = 60 positions x 2 Mnodes; a
        top client takes <= 35 s (src/stats.rs:135-148)."""
        best_batch_seconds = 35
        estimated_batch_seconds = min(6 * 60, 60 * 2_000_000 // max(1, self.nnue_nps.nps))
        return float(max(0, estimated_batch_seconds - best_batch_seconds))


def register_stats_collector(recorder: StatsRecorder) -> int:
    """Expose the recorder's cumulative totals + EWMA NPS through the
    telemetry registry (doc/observability.md: ``fishnet_stats_*``,
    ``fishnet_nnue_nps``). Pull-style via weakref: recording a batch
    stays exactly as cheap as before."""
    from fishnet_tpu_torch import telemetry

    ref = weakref.ref(recorder)

    def collect():
        rec = ref()
        if rec is None:
            return None
        return [
            telemetry.counter_family(
                "fishnet_stats_batches_total",
                "Analysis batches completed (persistent total).",
                rec.stats.total_batches,
            ),
            telemetry.counter_family(
                "fishnet_stats_positions_total",
                "Positions analysed (persistent total).",
                rec.stats.total_positions,
            ),
            telemetry.counter_family(
                "fishnet_stats_nodes_total",
                "Search nodes across all batches (persistent total).",
                rec.stats.total_nodes,
            ),
            telemetry.gauge_family(
                "fishnet_nnue_nps",
                "EWMA nodes-per-second estimate (NNUE batches).",
                rec.nnue_nps.nps,
            ),
            telemetry.gauge_family(
                "fishnet_nnue_nps_uncertainty",
                "Decaying uncertainty of the NPS estimate (1 = no data).",
                rec.nnue_nps.uncertainty,
            ),
        ]

    return telemetry.REGISTRY.register_collector(collect, name="stats")
