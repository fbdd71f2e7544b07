"""SearchService: the bridge between asyncio callers and the native
fiber pool + the torch NNUE evaluator.

The port of ``fishnet_tpu/search/service.py`` with the dispatch
coalescer, the async pipeline, the position-keyed eval cache, the
bounds tier and the serving mesh, as the JAX service runs by default.
Every ``search(position)`` is submitted into one shared native pool
(cpp/src/pool.cpp over ctypes). Driver threads run the
pool's step/evaluate/provide cycle: ``fc_pool_step`` advances a slot
group's search fibers to their next leaf evaluations and packs them on
the compact wire, the leaves are evaluated as ONE microbatch on the
device (``evaluate_packed_anchored``), ``fc_pool_provide`` wakes the
fibers. Results resolve asyncio futures back on the event loop.

Metrics: ``counters()`` and ``shard_report()`` are adapted as the JAX
service's registry families (``_register_service_collector``:
``fishnet_pool_*``, ``fishnet_service_*``, ``fishnet_dispatches_total``,
``fishnet_shard_*`` with one ``shard="0"`` sample without a mesh, ...),
pulled only when something scrapes; ``close()`` unregisters them, under
the registry's scrape lock, before it frees the pool.

Pipelining: each driver thread owns ``pipeline_depth`` slot groups.
A group's step uploads its packed rows, row offsets, buckets and
parents from pinned host buffers with ``non_blocking`` copies, queues
the evaluation and the copy of the values — and of the kernel's error
word — back into pinned buffers on the current CUDA stream, records an
event and moves on to step the next group's fibers on the CPU while the
device works; the values are read when the event has fired
(``_resolve_eval``), just before that group's next step. A step whose
error word has grown (an index the kernel refused to read) raises.

Coalescing (search/coalesce.py): with more than one group, a stepped
group's microbatch is parked with the coalescer, which fuses the ready
groups' microbatches into ONE segmented dispatch (``_dispatch_segmented``:
one kernel launch over every segment, on the groups' flat anchor table)
at the policy width or when an owner needs its result; the async
pipeline's pack worker stages and launches the flushes, its decode
worker waits for them. ``FISHNET_NO_COALESCE=1`` restores the per-group
dispatch loop exactly, ``FISHNET_COALESCE_WIDTH`` pins the width,
``FISHNET_NO_ASYNC=1`` flushes inline on the driver threads and
``FISHNET_NO_DEDUP=1`` ships cross-segment duplicates as they are.

Position-keyed eval reuse (search/eval_cache.py): after each step the
driver exports the batch's Zobrist hashes and probes the process-wide
cache (keys salted with the net's fingerprint); a batch whose every
entry is known skips its dispatch, and its values resolve on the host.
Partial hits ride the coalescer's ticket: a fused dispatch then plans
its dedup by position (``plan_segment_dedup(hashes=...)``), drops the
cache-known entries and the duplicates of earlier ones — persistent
anchor codes included, whose table rows the kernel's copy-source mode
still stores — and fills their values on the host. Every provided batch
is inserted into the cache. The bounds tier seeds cached search facts
into the pool TT (at submit, along the cached best-move chain and the
root's children, and per batch before its dispatch) and harvests the
finished search's PV records back. ``FISHNET_NO_EVAL_CACHE=1`` turns
both off, ``FISHNET_NO_BOUNDS=1`` the bounds tier alone;
``FISHNET_CACHE_PREFETCH=1`` steers the pool's speculation budget by
the cache's hit rate.

Serving mesh (``mesh_devices=``, parallel/mesh.py): with the coalescer
on and more than one device resolved, the coalescer drives
``min(devices, groups)`` shards. Each shard has its own parameter
replica, its own flat anchor and PSQT tables (one block per group, so a
fused launch rebases persistent codes by ``g * A`` over its shard's
allocation as the single device does), its own async pipeline and its
own rung of its device's ladder (``ladder_for``: fused -> host-material
on CUDA, then a drain onto the siblings). The ``ShardRouter`` places
each group; a group's live table block follows it when the router
re-homes it (first traffic, drain): the thread that dispatches it next
copies the block from the shard that holds it (tracked by shard, not by
device, so two shards on one card never read each other's stale
blocks). On the mesh every rung stores the anchors' PSQT (the
host-material rung too, its head reading the wire's material), so a
group that moves between rungs finds exact tables. Without a mesh
nothing of this runs.

Fault site (resilience/faults.py): with a plan installed, every stepped
group passes ``service.device_step`` before its dispatch. An injected
fault takes the driver down (the supervisor respawns one rung down);
on the mesh a plain error steps the group's shard down instead and the
step goes out on the degraded path. With no plan the site is one
attribute read.

Spans (telemetry/spans.py), the JAX service's driver stages: with
``telemetry.enabled()`` each driver step records ``pack`` (the root of a
fresh step trace when the step emitted a batch), ``device_step`` (the
host-side issue, with ``cache_skip=1`` on a whole-batch cache skip),
``cache_probe`` and ``bounds_probe`` under it, and, when the batch is
resolved, ``wire_decode`` and ``postprocess`` (``op="provide"``); the
harvest records ``postprocess`` with ``op="harvest"``. The
``device_step`` context rides the coalesce ticket to the pack and
decode workers (search/coalesce.py). ``close()`` dumps the recorder
(``reason="close"``), and a driver failing live searches dumps it too
(``fail_all:...``). With telemetry off each step reads the flag once.

External evaluator (``evaluator=``, the split plane's frontend,
rpc/client.py, or ``parallel.mesh.ShardedEvaluator``): the service
holds no device. Each group's step goes out
as its dense expansion (``expand_packed_np``) on the host-material wire,
with in-batch parents only (no persistent anchors), one group at a time:
no coalescer, no async pipeline, no eval cache or bounds tier (those are
gated on the packed wire, as in the JAX package). The evaluator may
return a lazy handle; ``_resolve_eval`` materialises it with
``np.asarray`` before the group's next step. An evaluator with a
``size_multiple`` above 1 (the legacy sharded evaluator) gets capacities
rounded to it, one entry bucket, the pool's emission aligned to its
shard size (no delta references across a shard), and — with
``supports_packed`` — the packed wire, repacked per shard
(``_dispatch_sharded_packed``).

Streams: every ``ft_gather`` launch of a service — solo or fused, from
a driver thread or a pack worker, of any shard — goes to its device's
default stream (no thread of the service sets another), because the
kernel's entry ticket and ready words are one state per device
(ops/ft_gather.py ``_device_state``): two launches at once on two
streams would share them. One stream also keeps a reallocation of the
ready words safe behind a launch in flight: the freed block is reused
in stream order. Every dispatch runs under its shard's device
(``on_device``), whatever thread issues it.
"""

from __future__ import annotations

import asyncio
import ctypes
import os
import tempfile
import threading
import time
import weakref
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from fishnet_tpu_torch import telemetry as _telemetry
from fishnet_tpu_torch.chess.board import (
    _VARIANT_CODES,
    Board,
    IllegalMoveError,
    InvalidFenError,
)
from fishnet_tpu_torch.chess.core import NativeCoreError, load, load_held
from fishnet_tpu_torch.device import DeviceLike, on_device, resolve_device
from fishnet_tpu_torch.nnue import spec
from fishnet_tpu_torch.nnue.torch_eval import expand_packed_np
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.ops.ft_gather import (
    derive_segment_offsets_np,
    error_word,
    kernel_errors,
    plan_segment_dedup,
    recode_segment_parents_np,
)
from fishnet_tpu_torch.protocol.types import Variant
from fishnet_tpu_torch.resilience import faults as _faults
from fishnet_tpu_torch.resilience.supervisor import RUNGS, ladder_for
from fishnet_tpu_torch.search import eval_cache as _eval_cache_mod
from fishnet_tpu_torch.search.coalesce import (
    COALESCE_WIDTH,
    PAD_ROWS,
    SHARD_DEGRADATIONS,
    CoalesceBackend,
    DispatchProbe,
    _AsyncDispatchPipeline,
    _CoalesceTicket,
    _DispatchCoalescer,
    _FusedValues,
    _SeqAllocator,
    fit_dispatch_cost,
)
from fishnet_tpu_torch.telemetry import cost as _cost
from fishnet_tpu_torch.telemetry import tracing as _tracing
from fishnet_tpu_torch.telemetry.spans import RECORDER as _SPANS


@dataclass
class PvLineData:
    multipv: int
    depth: int
    is_mate: bool
    value: int
    pv: List[str]


@dataclass
class SearchResultData:
    lines: List[PvLineData]
    best_move: Optional[str]
    depth: int
    nodes: int
    time_seconds: float


@dataclass
class _Pending:
    future: asyncio.Future
    loop: asyncio.AbstractEventLoop
    started: float
    token: object = None
    stop_event: Optional[threading.Event] = None
    thread: int = 0  # owning driver thread index
    fen: str = ""  # root FEN for the bounds harvest ("" = no harvest)
    moves: str = ""
    children: Optional[List[int]] = None  # root children's Zobrist keys


def _bind_pool_api(lib: ctypes.CDLL) -> None:
    """Declare the pool's C signatures (ABI 11) on ``lib`` — the subset
    this service calls."""
    if getattr(lib, "_pool_bound", False):
        return
    lib.fc_pool_new.argtypes = [
        ctypes.c_int, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.fc_pool_new.restype = ctypes.c_void_p
    lib.fc_pool_free.argtypes = [ctypes.c_void_p]
    lib.fc_pool_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.fc_pool_submit.restype = ctypes.c_int
    lib.fc_pool_stop.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fc_pool_stop_all.argtypes = [ctypes.c_void_p]
    lib.fc_pool_step.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.fc_pool_step.restype = ctypes.c_int
    lib.fc_pool_provide.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    # Returns entries consumed, or -1 when anchors are enabled and the
    # provide is not the full batch (the full-provide contract is
    # load-bearing for device anchor state — see cpp fc_pool_provide).
    lib.fc_pool_provide.restype = ctypes.c_int
    lib.fc_pool_active.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fc_pool_active.restype = ctypes.c_int
    lib.fc_pool_next_finished.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fc_pool_next_finished.restype = ctypes.c_int
    lib.fc_pool_result_summary.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.fc_pool_result_summary.restype = ctypes.c_int
    lib.fc_pool_result_line.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.fc_pool_result_line.restype = ctypes.c_int
    lib.fc_pool_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fc_pool_counters.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
    ]
    lib.fc_pool_counters.restype = ctypes.c_int
    lib.fc_pool_set_prefetch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.fc_pool_set_anchors.argtypes = [ctypes.c_void_p, ctypes.c_int]
    # ABI 10: position-keyed eval reuse.
    lib.fc_pool_batch_hashes.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int,
    ]
    lib.fc_pool_batch_hashes.restype = ctypes.c_int
    lib.fc_pool_cancel_anchors.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fc_pool_cancel_anchors.restype = ctypes.c_int
    lib.fc_pool_tt_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32,
    ]
    lib.fc_pool_tt_fill.restype = None
    # ABI 11: the bounds tier (seed bound records, export them back).
    lib.fc_pool_tt_fill_bound.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32,
    ]
    lib.fc_pool_tt_fill_bound.restype = None
    lib.fc_pool_tt_export.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.fc_pool_tt_export.restype = ctypes.c_int
    lib._pool_bound = True


#: Must cover the native core's largest single eval block
#: (cpp/src/search.h EVAL_BLOCK_MAX): emit_block is all-or-nothing, so a
#: capacity below one block would never fit it and the fiber would wait
#: forever while the driver spins.
MIN_BATCH_CAPACITY = 40

#: Eval-path rungs, named as in the JAX package's degradation ladder
#: (resilience/supervisor.py): "fused" is the hand CUDA kernel with
#: device PSQT, "xla" the plain torch version (the CPU path), and
#: "host-material" ships the pool's material term on the wire (the
#: kernel, or the plain version on the CPU, then runs without PSQT).
PSQT_PATHS = ("fused", "xla", "host-material")

#: The entry-bucket ladder's first rung, as in the JAX package.
MIN_EVAL_BUCKET = 64


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def eval_bucket_sizes(capacity: int, first: int = MIN_EVAL_BUCKET) -> List[int]:
    """Entry-count buckets of a group: a step ships the smallest power
    of two from ``first`` that holds its entries, capped at the group
    ``capacity`` (padding entries are all-sentinel fulls)."""
    sizes = {capacity}
    s = first
    while s < capacity:
        sizes.add(s)
        s *= 2
    return sorted(sizes)

#: The native search's skill level for analysis: 20 searches at full
#: strength (below 20 it samples among near-best lines: play jobs).
FULL_STRENGTH = 20


class _Staging:
    """Pinned host buffers of one fused dispatch: the concatenated wire,
    offsets, buckets, parents (and material, and the position-dedup
    ``copy_src`` fan-in) in; the values and a copy of the kernel's error
    word out. ``lock`` is held from staging until
    the launch and the copies back are queued; ``holder`` is the
    ``_FusedValues`` of the last dispatch staged here, read back before
    the slot is written again (its uploads and its copies back are then
    done)."""

    def __init__(self, width: int, size: int, host, material: bool) -> None:
        self.packed_t = host((width * (4 * size + 4), 2, 8), torch.int16)
        self.packed = self.packed_t.numpy().view(np.uint16)
        self.offsets_t = host((width * size,), torch.int32)
        self.buckets_t = host((width * size,), torch.int32)
        self.parents_t = host((width * size,), torch.int32)
        self.copy_src_t = host((width * size,), torch.int32)
        self.material_t = (
            host((width * size,), torch.int32) if material else None
        )
        self.values_t = host((width * size,), torch.int32)
        self.err_t = host((1,), torch.int32)
        self.lock = threading.Lock()
        self.holder: Optional[_FusedValues] = None


#: ``SearchService.counters()`` key -> (metric name, type, help). The
#: exported names are part of the doc/observability.md contract; the
#: native keys mirror cpp SearchCounters, the service keys the per-
#: thread wire accounting.
_COUNTER_METRICS = {
    "steps": ("fishnet_pool_steps_total", "counter",
              "Native pool step calls that advanced search fibers."),
    "evals_shipped": ("fishnet_pool_evals_shipped_total", "counter",
                      "Eval slots shipped to the device, cumulative."),
    "suspensions": ("fishnet_pool_suspensions_total", "counter",
                    "Fiber suspensions at leaf-eval blocks."),
    "step_capacity": ("fishnet_pool_step_capacity_slots_total", "counter",
                      "Configured batch capacity summed over steps."),
    "demand_evals": ("fishnet_pool_demand_evals_total", "counter",
                     "Demand (non-speculative) eval slots shipped."),
    "prefetch_shipped": ("fishnet_pool_prefetch_shipped_total", "counter",
                         "Speculative prefetch eval slots shipped."),
    "prefetch_hits": ("fishnet_pool_prefetch_hits_total", "counter",
                      "Speculative evals later consumed by a search."),
    "tt_eval_hits": ("fishnet_pool_tt_eval_hits_total", "counter",
                     "Leaf evals answered from the transposition table."),
    "prefetch_budget": ("fishnet_pool_prefetch_budget", "gauge",
                        "Current AIMD speculation budget (slots)."),
    "delta_evals": ("fishnet_pool_delta_evals_total", "counter",
                    "Eval slots shipped as incremental delta entries."),
    "dedup_retired": ("fishnet_pool_dedup_retired_total", "counter",
                      "Eval slots retired by in-batch deduplication."),
    "nodes": ("fishnet_pool_nodes_total", "counter",
              "Search nodes visited across all fibers."),
    "anchor_deltas": ("fishnet_pool_anchor_deltas_total", "counter",
                      "Delta evals resolved against device-resident "
                      "anchors."),
    "eval_steps": ("fishnet_service_eval_steps_total", "counter",
                   "Device microbatches dispatched by the service."),
    "dispatches": ("fishnet_dispatches_total", "counter",
                   "Device dispatch calls actually issued — a fused "
                   "segmented dispatch counts ONCE for all its groups, "
                   "so dispatches < eval_steps measures coalescing."),
    "fused_dispatches": ("fishnet_coalesced_dispatches_total", "counter",
                         "Dispatches that fused >= 2 group microbatches."),
    "bucket_slots": ("fishnet_service_bucket_slots_total", "counter",
                     "Slots actually transferred (size-bucketed)."),
    "wire_feature_bytes": ("fishnet_service_wire_feature_bytes_total",
                           "counter",
                           "Host->device feature payload bytes shipped."),
    "wire_material_bytes": ("fishnet_service_wire_material_bytes_total",
                            "counter",
                            "Host->device material payload bytes shipped."),
    "wire_bytes": ("fishnet_service_wire_bytes_total", "counter",
                   "Total host->device payload bytes shipped."),
    "fused_dedup": ("fishnet_fused_dedup_total", "counter",
                    "Eval entries deduplicated across segments of fused "
                    "dispatches (duplicate plain fulls shipped as one-row "
                    "sentinel deltas; values restored host-side)."),
    "position_dedup": ("fishnet_position_dedup_total", "counter",
                       "Eval entries dropped because another entry in the "
                       "same fused dispatch carries the identical position "
                       "(hash-keyed; value fanned out host-side)."),
    "cache_skipped_dispatches": (
        "fishnet_eval_cache_skipped_dispatches_total", "counter",
        "Device dispatches skipped entirely because every entry of the "
        "batch was satisfied by the process-wide eval cache."),
    "bounds_seeded": (
        "fishnet_bounds_seeded_total", "counter",
        "Bound records seeded into the pool TT pre-dispatch (batch "
        "probe + submit-time best-move chain walk)."),
    "bounds_harvested": (
        "fishnet_bounds_harvested_total", "counter",
        "Bound records exported from the pool TT into the bounds tier "
        "at search finish (PV replay)."),
    "inflight_dispatches": ("fishnet_inflight_dispatches", "gauge",
                            "Device dispatches currently in flight in the "
                            "async pipeline (0..2: the ping-pong double "
                            "buffer's depth)."),
    "async_ready_queue": ("fishnet_dispatch_ready_queue_depth", "gauge",
                          "Flush batches queued in front of the async "
                          "pack/decode workers."),
    "decode_queue": ("fishnet_decode_queue_depth", "gauge",
                     "Issued dispatches queued behind the decode worker "
                     "(output-side backlog; pair with "
                     "fishnet_dispatch_ready_queue_depth on the input "
                     "side)."),
}


def _register_service_collector(svc: "SearchService") -> int:
    """Adapt this service's counters as a pull collector (the JAX
    package's families). Holds only a weakref: a service that is garbage
    collected (or closed, which unregisters explicitly) stops being
    scraped."""
    ref = weakref.ref(svc)

    def collect():
        service = ref()
        if service is None or service._pool is None:
            return None
        fams = []
        counters = service.counters()
        for key, value in counters.items():
            spec_ = _COUNTER_METRICS.get(key)
            if spec_ is None:
                continue
            name, kind, help_ = spec_
            maker = (
                _telemetry.gauge_family if kind == "gauge"
                else _telemetry.counter_family
            )
            fams.append(maker(name, help_, value))
        # Eval-cache hit split: `prewire` hits were satisfied host-side
        # from the process cache before any wire bytes moved; `pool` hits
        # are the native TT's leaf-eval hits.
        for scope, key in (("prewire", "cache_prewire_hits"),
                           ("pool", "tt_eval_hits")):
            fams.append(_telemetry.counter_family(
                "fishnet_eval_cache_hits_total",
                "Leaf evals satisfied by the position-keyed reuse plane, "
                "by scope (prewire=host cache before dispatch, pool=native "
                "TT inside the search).",
                counters.get(key, 0),
                labels={"scope": scope},
            ))
        fams.append(_telemetry.counter_family(
            "fishnet_eval_steps_total",
            "Group eval microbatches evaluated (alias of "
            "fishnet_service_eval_steps_total; pair with "
            "fishnet_dispatches_total for the coalesce ratio).",
            counters.get("eval_steps", 0),
        ))
        busy = counters.get("overlap_busy_us", 0)
        dual = counters.get("overlap_dual_us", 0)
        fams.append(_telemetry.gauge_family(
            "fishnet_dispatch_overlap_ratio",
            "Fraction of dispatch-busy wall time with >=2 device "
            "dispatches in flight (async pipeline; 0 when synchronous).",
            dual / busy if busy > 0 else 0.0,
        ))
        # Per-shard serving-mesh families: one shard="0" sample without
        # a mesh, so dashboards need no mesh-vs-single special case. The
        # rung index is into the JAX lattice (0 fused, 1 xla,
        # 2 host-material; 3 drained).
        rep = service.shard_report()
        for s in range(rep["n_shards"]):
            lbl = {"shard": str(s)}
            rung = rep["rungs"][s]
            fams.append(_telemetry.counter_family(
                "fishnet_shard_dispatches_total",
                "Device dispatches issued per serving-mesh shard.",
                rep["dispatches"][s], labels=lbl,
            ))
            fams.append(_telemetry.gauge_family(
                "fishnet_shard_occupancy",
                "Per-shard occupancy EMA (real entries per microbatch) "
                "feeding that shard's coalesce-width policy.",
                rep["occupancy"][s], labels=lbl,
            ))
            fams.append(_telemetry.gauge_family(
                "fishnet_shard_ladder_rung",
                "Per-shard degradation-ladder rung index "
                "(0=fused, 1=xla, 2=host-material; 3=drained/dead).",
                RUNGS.index(rung) if rung in RUNGS else len(RUNGS),
                labels=lbl,
            ))
        with service._lock:
            pending = sum(len(p) for p in service._pending)
            queued = sum(len(s) for s in service._submissions)
        fams.append(_telemetry.gauge_family(
            "fishnet_service_pending_searches",
            "Searches currently occupying pool slots.", pending,
        ))
        fams.append(_telemetry.gauge_family(
            "fishnet_service_queued_submissions",
            "Searches queued but not yet in a slot.", queued,
        ))
        fams.append(_telemetry.gauge_family(
            "fishnet_service_info",
            "Static service configuration (value is always 1).", 1,
            labels={
                "backend": service.backend,
                "psqt_path": service.psqt_path or "",
                "driver_threads": str(service.driver_threads),
                "pipeline_depth": str(service.pipeline_depth),
            },
        ))
        return fams

    return _telemetry.REGISTRY.register_collector(collect, name="search-service")


#: The JAX service's other always-on instruments. The port's service has
#: no failure listener, so the first stays at zero.
_LISTENER_ERRORS = _telemetry.REGISTRY.counter(
    "fishnet_service_listener_errors_total",
    "failure_listener callbacks that raised during driver-crash "
    "teardown (swallowed so the original crash stays visible).",
)
_HARVEST_ERRORS = _telemetry.REGISTRY.counter(
    "fishnet_bounds_harvest_errors_total",
    "Bounds-tier harvests that raised after a completed search. "
    "Harvest is advisory — the search result ships regardless — but a "
    "silent failure here starves warm re-searches of their seed "
    "records (R5: counted, not swallowed).",
)


class SearchService(CoalesceBackend):
    """Shared batched-search backend. One instance per process."""

    def __init__(
        self,
        weights: Optional[NnueWeights] = None,
        net_path: Optional[Union[str, Path]] = None,
        pool_slots: int = 256,
        batch_capacity: int = 256,
        tt_bytes: int = 64 << 20,
        backend: str = "torch",  # "torch" | "scalar"
        pipeline_depth: int = 1,
        driver_threads: int = 1,
        psqt_path: Optional[str] = None,
        device: DeviceLike = None,
        evaluator=None,
        mesh_devices=None,
    ) -> None:
        """``backend="torch"`` evaluates leaves in batches on ``device``
        (``cuda`` unless the caller asks for ``"cpu"``; without a GPU a
        CUDA request raises). ``backend="scalar"`` evaluates them one at
        a time with the native core's C++ evaluator and uses no device.

        ``psqt_path`` requests a rung (PSQT_PATHS): "host-material" ships
        the material term on the wire; "fused" (CUDA only) and "xla"
        (CPU only) compute it on the device, as None does. A request the
        device cannot run raises: "xla" is never taken on the card, so
        nothing steps the card off its kernel. ``self.psqt_path``
        reports the rung that runs. All rungs give bit-identical
        results.

        With more than one pipeline group (``driver_threads *
        pipeline_depth``) the service builds the dispatch coalescer and
        the async pipeline, unless ``FISHNET_NO_COALESCE=1`` (or
        ``FISHNET_NO_ASYNC=1`` for the pipeline alone); the warm-up
        measures the dispatch cost that seeds its width policy
        (``_probe_dispatch_cost``, kept in ``self.dispatch_probe``).

        The device backend uses the process-wide eval cache and the
        bounds tier (search/eval_cache.py) unless
        ``FISHNET_NO_EVAL_CACHE=1`` / ``FISHNET_NO_BOUNDS=1``. The JAX
        package's fleet position tier is not ported:
        ``FISHNET_POSITION_TIER=1`` raises where the JAX service would
        attach it.

        ``evaluator``: a callable ``(params, feats, buckets, parents,
        material) -> int32 [B]`` (or a lazy handle that ``np.asarray``
        materialises) that evaluates every microbatch instead of this
        process's device, as the JAX package's seam takes it: feats
        uint16 [B, 2, 32] (the dense expansion), buckets, in-batch
        parent codes and the host material term int32 [B]; ``params`` is
        None. The service then holds no device (``device`` must be
        None), runs the host-material wire (``psqt_path`` reports
        "host-material" whatever was requested) and builds no coalescer,
        async pipeline, eval cache or bounds tier. An evaluator's
        ``size_multiple`` (> 1: ``parallel.mesh.ShardedEvaluator``) rounds
        the capacities to it and aligns the pool's emission to its shard
        size; with ``supports_packed`` it gets the packed wire, repacked
        per shard, through its ``packed_eval``.

        ``mesh_devices``: the serving mesh (parallel/mesh.py
        ``serving_devices``): None (default) is the single-device
        service; ``"auto"`` every visible device of ``device``'s type; an
        int the first N; a sequence of devices exactly those (one device
        may appear twice: two logical shards on one card). Its first
        device must be ``device``. The mesh is on only with the
        coalescer on (more than one group, no ``FISHNET_NO_COALESCE``)
        and more than one device resolved (``FISHNET_NO_MESH=1`` clamps
        to one); it drives ``min(devices, groups)`` shards.
        """
        if backend not in ("torch", "scalar"):
            raise ValueError(f"unknown backend: {backend!r}")
        if evaluator is not None and (backend != "torch"
                                      or device is not None):
            raise ValueError(
                "an external evaluator replaces the device backend: pass "
                "backend='torch' and no device")
        # The packed, anchored wire of this process's own device: the
        # coalescer, the async pipeline, the eval cache and the bounds
        # tier all ride it (an external evaluator gets the dense wire).
        self._packed_wire = backend == "torch" and evaluator is None
        if (self._packed_wire and not _eval_cache_mod.cache_disabled()
                and os.environ.get("FISHNET_POSITION_TIER", "") == "1"):
            raise NotImplementedError(
                "FISHNET_POSITION_TIER=1: the fleet position tier "
                "(fishnet_tpu/cluster/position_tier.py) is not ported to "
                "fishnet_tpu_torch yet; unset it")
        if psqt_path not in (None,) + PSQT_PATHS:
            raise ValueError(f"unknown psqt_path request: {psqt_path!r}")
        self.device = (
            resolve_device(device) if self._packed_wire else None)
        self._evaluator = evaluator
        if evaluator is not None:
            self.psqt_path = "host-material"
        elif self.device is None:
            self.psqt_path = None
        else:
            own = "fused" if self.device.type == "cuda" else "xla"
            if psqt_path in ("fused", "xla") and psqt_path != own:
                raise ValueError(
                    f"psqt_path {psqt_path!r} does not run on "
                    f"{self.device.type} (its device rung is {own!r})"
                )
            self.psqt_path = psqt_path or own
        self._lib = load()
        _bind_pool_api(self._lib)
        # The same pool calls keeping the interpreter lock: the bounds
        # tier's and the cache's TT fills and board walks, short calls
        # made in runs on the driver threads.
        self._held = load_held()
        _bind_pool_api(self._held)

        if weights is None and net_path is None:
            raise ValueError("need weights or net_path")
        self._tmp = None
        if net_path is None:
            self._tmp = tempfile.NamedTemporaryFile(suffix=".nnue", delete=False)
            self._tmp.close()
            weights.save(self._tmp.name)
            net_path = self._tmp.name
        self.net_path = str(net_path)
        self.backend = backend
        # A sharded evaluator splits every batch over its devices: the
        # capacities round to its multiple, and each shard must hold one
        # maximal eval block (aligned emission never splits a block).
        mult = max(1, int(getattr(evaluator, "size_multiple", 1)))
        self.shard_multiple = mult
        self._sharded_packed = (
            evaluator is not None and mult > 1
            and bool(getattr(evaluator, "supports_packed", False))
        )
        self.batch_capacity = batch_capacity = _round_up(
            max(batch_capacity, MIN_BATCH_CAPACITY * mult), mult
        )
        # Pipeline depth: the pool's slots are partitioned into this many
        # groups per driver thread, each with its own in-flight device
        # batch, so one group's fibers run on the CPU while another's
        # eval is on the device.
        self.pipeline_depth = (
            1 if backend == "scalar" else max(1, min(pipeline_depth, pool_slots))
        )
        # Each driver thread owns pipeline_depth groups; clamp so the
        # group count never exceeds pool_slots (the native pool would
        # silently clamp its groups while threads kept driving the rest).
        self.driver_threads = max(
            1, min(int(driver_threads), pool_slots // self.pipeline_depth)
        )
        self._n_groups = k = self.driver_threads * self.pipeline_depth

        # THE SERVING MESH (module docstring). None of its fields leaves
        # its single-device default unless it turns on.
        coalesce_on = (
            self._packed_wire and self._n_groups > 1
            and os.environ.get("FISHNET_NO_COALESCE", "0") != "1"
        )
        self._router = None
        self._n_shards = 1
        self._shard_devices = [self.device]
        self._mesh_lock = threading.Lock()
        self._ladder = (
            ladder_for(self.device.type) if self.device is not None
            else ("host-material",)
        )
        self._shard_rungs = [
            self._ladder.index(self.psqt_path)
            if self.psqt_path in self._ladder else 0
        ]
        self._degradations: List[Tuple[int, str, str]] = []
        self._migrations = 0
        if coalesce_on and mesh_devices is not None:
            from fishnet_tpu_torch.parallel.mesh import (
                ShardRouter,
                serving_devices,
            )

            devs = serving_devices(mesh_devices, self.device.type)
            if len(devs) > 1:
                if devs[0] != self.device or any(
                        d.type != self.device.type for d in devs):
                    raise ValueError(
                        f"mesh devices {devs} must start with the "
                        f"service's device {self.device}, all of its type")
                self._n_shards = min(len(devs), self._n_groups)
                self._shard_devices = devs[: self._n_shards]
                self._router = ShardRouter(self._n_groups, self._n_shards)
                self._shard_rungs = self._shard_rungs * self._n_shards

        #: ``counters()`` as close() left them, read after the pool is freed.
        self._closed_counters: Dict[str, int] = {}
        self._pool = self._lib.fc_pool_new(
            pool_slots, tt_bytes, self.net_path.encode(), self._n_groups
        )
        if not self._pool:
            raise NativeCoreError("failed to create search pool")

        cap = batch_capacity
        # Each group steps at most cap/k leaves so the k groups together
        # fill one batch_capacity of in-flight work.
        self._group_capacity = _round_up(
            max(MIN_BATCH_CAPACITY * mult, cap // self.pipeline_depth), mult
        )
        if mult > 1:
            # One bucket: the pool aligns its emission to the shard size
            # of the shipped batch, a constant only at one size.
            self._eval_sizes = [self._group_capacity]
            self._shard_align = self._group_capacity // mult
        else:
            self._eval_sizes = eval_bucket_sizes(self._group_capacity)
            self._shard_align = 0

        self._params = None
        self._shard_params = [None]
        self._anchor_shards: List[torch.Tensor] = []
        self._psqt_shards: List[torch.Tensor] = []
        self._table_home: Optional[List[int]] = None
        self._anchor_tabs: List[torch.Tensor] = []
        self._psqt_tabs: List[torch.Tensor] = []
        self._anchor_rows = 0
        self._material_buf = None
        on_gpu = self.device is not None and self.device.type == "cuda"

        def host(shape, dtype):
            # Pinned on the GPU path, so the uploads can be asynchronous.
            return torch.empty(shape, dtype=dtype, pin_memory=on_gpu)

        # One host buffer set per group: a group's buffers stay untouched
        # while its dispatched eval is in flight, and each group is only
        # ever touched by its owning thread. The pool writes the uint16
        # wire into the int16 tensor's bytes; torch has few uint16
        # kernels, and the evaluator widens int16 wire rows with a mask.
        self._packed_t = host((k, 4 * cap + 4, 2, 8), torch.int16)
        self._bucket_t = host((k, cap), torch.int32)
        self._parent_t = host((k, cap), torch.int32)
        self._values_t = host((k, cap), torch.int32)
        self._packed_buf = self._packed_t.numpy().view(np.uint16)
        self._bucket_buf = self._bucket_t.numpy()
        self._parent_buf = self._parent_t.numpy()
        # The pool's row offsets ship with the wire (padding entries
        # point at the sentinel block), so the device derives none.
        self._offset_t = host((k, cap), torch.int32)
        self._offset_buf = self._offset_t.numpy()
        self._slot_buf = np.empty((k, cap), dtype=np.int32)
        if self.device is not None:
            from fishnet_tpu_torch.nnue.torch_eval import (
                evaluate_packed_anchored,
                params_from_weights,
            )

            w = weights if weights is not None else NnueWeights.load(net_path)
            self._params = params_from_weights(w, self.device)
            self._shard_params = [self._params]
            if self._router is not None:
                from fishnet_tpu_torch.parallel.mesh import replicate_params

                self._shard_params = replicate_params(
                    self._params, self._shard_devices)
            self._eval_fn = evaluate_packed_anchored
            # PERSISTENT DEVICE ANCHORS: one feature-transformer
            # accumulator (and its PSQT twin) per pool slot lives on the
            # device across steps, so a slot's next demand eval ships as
            # a one-row delta. Group g's table is block g of one
            # allocation: a solo dispatch reads and stores its view, a
            # fused one the flat [k * A, ...] table with its persistent
            # codes rebased by g * A — no stacking or splitting copies.
            # Each group's eval chain is serialized by its owner.
            self._anchor_rows = rows = -(-pool_slots // self._n_groups)
            self._anchor_all = torch.zeros(
                (k, rows, 2, spec.L1), dtype=torch.int32, device=self.device)
            self._psqt_all = torch.zeros(
                (k, rows, 2, spec.NUM_PSQT_BUCKETS), dtype=torch.int32,
                device=self.device)
            self._anchor_tabs = list(self._anchor_all.unbind(0))
            self._psqt_tabs = list(self._psqt_all.unbind(0))
            # On the mesh each shard has its own flat allocation of all k
            # blocks; _table_home[g] is the shard holding group g's live
            # block (the router's initial placement: all blocks zero).
            self._anchor_shards = [self._anchor_all] + [
                torch.zeros_like(self._anchor_all, device=d)
                for d in self._shard_devices[1:]
            ]
            self._psqt_shards = [self._psqt_all] + [
                torch.zeros_like(self._psqt_all, device=d)
                for d in self._shard_devices[1:]
            ]
            self._table_home = (
                None if self._router is None
                else [self._router.shard_of(g) for g in range(k)]
            )
            self._lib.fc_pool_set_anchors(self._pool, 1)
            if on_gpu:
                # Each group's copy of the kernel's error word, read with
                # its values; the count at warm-up is the baseline.
                self._err_t = host((k, 1), torch.int32)
                self._err_base = 0
                # The other mesh devices' baselines, by device index.
                self._err_bases: Dict[int, int] = {}
        # The pool's material term rides the host-material wire; on the
        # mesh it is always made, since any shard may step down to it.
        if self.psqt_path == "host-material" or self._router is not None:
            self._material_t = host((k, cap), torch.int32)
            self._material_buf = self._material_t.numpy()

        # DISPATCH COALESCER and ASYNC PIPELINE (search/coalesce.py),
        # under the JAX service's conditions and escape hatches.
        self._coalescer: Optional[_DispatchCoalescer] = None
        self._async_pipes: List[_AsyncDispatchPipeline] = []
        self._dedup_fused = os.environ.get("FISHNET_NO_DEDUP", "0") != "1"
        # One ring of staging slots per shard.
        self._staging: List[List[_Staging]] = []
        self._staging_next = [0] * self._n_shards
        self._staging_lock = threading.Lock()
        self.dispatch_probe: Optional[DispatchProbe] = None
        self._latency_active = 0
        if coalesce_on:
            pinned = None
            pin_env = os.environ.get("FISHNET_COALESCE_WIDTH")
            if pin_env:
                pinned = max(1, min(int(pin_env), self._n_groups))
            self._coalescer = _DispatchCoalescer(self, pinned_width=pinned)
            # One staging slot per dispatch the pipeline may hold in
            # flight, each sized for the widest fused dispatch.
            width = min(self._n_groups, _DispatchCoalescer.MAX_WIDTH)
            self._staging = [[
                _Staging(width, self._eval_sizes[-1], host,
                         self._material_buf is not None)
                for _ in range(_AsyncDispatchPipeline.MAX_DEPTH)
            ] for _ in range(self._n_shards)]
            if os.environ.get("FISHNET_NO_ASYNC", "0") != "1":
                if self._n_shards > 1:
                    # One pipeline per shard, numbered across the mesh.
                    alloc = _SeqAllocator()
                    self._async_pipes = [
                        _AsyncDispatchPipeline(self, shard=s, seq_alloc=alloc)
                        for s in range(self._n_shards)
                    ]
                else:
                    self._async_pipes = [_AsyncDispatchPipeline(self)]
        # POSITION-KEYED EVAL REUSE: the process-wide cache (None with
        # FISHNET_NO_EVAL_CACHE=1, or off the packed wire: the scalar
        # backend and an external evaluator — every
        # probe and insert site gates on it), per-group Zobrist-hash and
        # probe-value buffers. Keys are hash ^ salt, the net's
        # fingerprint, so services with different weights never read
        # each other's evals; the raw hashes feed the pool TT fills and
        # the dedup planner.
        self._eval_cache = (
            _eval_cache_mod.get_cache() if self._packed_wire else None
        )
        self._cache_salt = (
            np.uint64(_eval_cache_mod.net_fingerprint(self.net_path))
            if self._eval_cache is not None else np.uint64(0)
        )
        self._hash_buf = np.zeros((k, cap), dtype=np.uint64)
        self._cache_val_buf = np.zeros((k, cap), dtype=np.int32)
        self._miss_hist = _eval_cache_mod.MissHistory()
        # BOUNDS TIER: cached search facts, seeded into the pool TT at
        # submit and per batch, harvested at _finish_slot. None with
        # FISHNET_NO_BOUNDS=1 (or the cache hatch).
        self._bounds_cache = (
            _eval_cache_mod.get_bounds_cache()
            if self._eval_cache is not None else None
        )
        # Opt-in prefetch steering by the cache's hit rate (off by
        # default: it changes dispatch composition).
        self._cache_steer = (
            os.environ.get("FISHNET_CACHE_PREFETCH", "0") == "1"
            and self._eval_cache is not None
        )
        self._steer_state: Dict[int, bool] = {}
        # Eval-reuse and bounds traffic (under self._lock).
        self._cache_prewire_hits = 0
        self._cache_skipped_dispatches = 0
        self._position_dedup = 0
        self._bounds_seeded = 0
        self._bounds_harvested = 0
        self._bounds_harvest_errors = 0
        T = self.driver_threads
        # Per-thread accounting cells (the owning thread writes its own).
        self._eval_steps = [0] * T
        self._bucket_slots = [0] * T
        self._wire_feature_bytes = [0] * T
        self._wire_material_bytes = [0] * T
        self._pending: List[Dict[int, _Pending]] = [{} for _ in range(T)]
        self._submissions: List[List[Tuple]] = [[] for _ in range(T)]
        self._cancelled_tokens: List[set] = [set() for _ in range(T)]
        # Cost attribution (telemetry/cost.py): pool slot -> (tenant,
        # family) for live searches, so a stepped batch's per-entry slot
        # ids map back to owners. Written/popped under _lock at submit
        # and finish; read lock-free on the owning driver only while the
        # cost plane is enabled.
        self._slot_owner: Dict[int, Tuple[str, str]] = {}
        self._lock = threading.Lock()
        self._warmup_lock = threading.Lock()
        self._warmed = False
        self._wakes = [threading.Event() for _ in range(T)]
        self._rr = 0  # round-robin submission cursor over threads
        self._stopping = False
        self._threads = [
            threading.Thread(
                target=self._drive, args=(t,), name=f"search-driver-{t}",
                daemon=True,
            )
            for t in range(T)
        ]
        # Telemetry: the native + service counters as a pull collector.
        # Registration is free until something scrapes /metrics; close()
        # unregisters BEFORE freeing the pool — the registry's scrape
        # lock guarantees no collector call is in flight once unregister
        # returns, so a scrape never reads a freed pool.
        self._collector_token: Optional[int] = _register_service_collector(self)
        for th in self._threads:
            th.start()

    # -- public API -------------------------------------------------------

    async def search(
        self,
        root_fen: str,
        moves: List[str],
        nodes: int = 0,
        depth: int = 0,
        multipv: int = 1,
        movetime_seconds: Optional[float] = None,
        variant: Variant = Variant.STANDARD,
        stop_event: Optional[threading.Event] = None,
        skill_level: int = FULL_STRENGTH,
        lane: str = "throughput",
        tenant: str = "",
    ) -> SearchResultData:
        """Search ``root_fen`` after ``moves`` within the node, depth and
        time limits. With ``stop_event``: setting it (then ``poke()``)
        stops the native search gracefully — the call still returns the
        partial result (completed iterations), unlike cancellation,
        which discards the search. ``skill_level`` -9..20: below 20 the
        native search samples its best move among near-best lines (play
        jobs). ``lane="latency"`` (a best-move search) keeps the
        coalescer from lingering for sibling threads' microbatches while
        it is in flight. ``tenant`` attributes this search's device cost
        when the cost plane is on (telemetry/cost.py); the workload
        family follows the lane (latency → best-move, throughput →
        analysis)."""
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        token = object()
        latency = lane == "latency"
        owner = (tenant, "best-move" if latency else "analysis")
        with self._lock:
            if self._stopping:
                raise NativeCoreError("search service is shut down")
            if latency:
                self._latency_active += 1
            t = self._rr % self.driver_threads
            self._rr += 1
            self._submissions[t].append(
                (root_fen, " ".join(moves), nodes, depth, multipv, future, loop,
                 movetime_seconds, variant, token, stop_event, skill_level,
                 owner)
            )
        self._wakes[t].set()
        try:
            return await future
        except asyncio.CancelledError:
            # Caller gave up (UCI stop / a superseding go): stop the
            # native search so it frees its pool slot. The token also
            # covers the still-queued case (skipped at drain).
            with self._lock:
                self._cancelled_tokens[t].add(token)
                for slot, p in self._pending[t].items():
                    if p.token is token:
                        self._lib.fc_pool_stop(self._pool, slot)
                        break
            self._wakes[t].set()
            raise
        finally:
            if latency:
                with self._lock:
                    self._latency_active -= 1

    def warmup(self) -> None:
        """Run one all-padding eval at the largest bucket: builds the
        CUDA kernel and initialises the device libraries before the
        first real step. With a coalescer, then seed its width policy:
        measure this eval path's fixed-versus-marginal dispatch cost,
        unless the width is pinned. (Torch
        compiles nothing per shape, so there is nothing like the JAX
        service's warm-up compiles of the segmented shapes.)
        With an external evaluator: one all-padding microbatch through
        it, which proves it answers before the first real step.
        Idempotent; safe from several threads."""
        if self._params is None and self._evaluator is None:
            return
        with self._warmup_lock:
            if self._warmed or self._stopping:
                return
            if self._evaluator is not None:
                size = self._eval_sizes[-1]
                np.asarray(self._evaluator(
                    None,
                    np.full((size, 2, spec.MAX_ACTIVE_FEATURES),
                            spec.NUM_FEATURES, np.uint16),
                    np.zeros(size, np.int32), np.full(size, -1, np.int32),
                    np.zeros(size, np.int32)))
                self._warmed = True
                return
            self._padding_eval(self._eval_sizes[-1])
            if self._router is not None:
                self._warm_shards()
            if self.device.type == "cuda":
                self._err_base = kernel_errors(self.device)
                for dev in self._shard_devices[1:]:
                    if dev != self.device:
                        self._err_bases[dev.index] = kernel_errors(dev)
            co = self._coalescer
            if co is not None and co._pinned is None and not self._stopping:
                self.dispatch_probe = self._probe_dispatch_cost()
                co.set_probe(self.dispatch_probe)
            self._warmed = True

    def _padding_eval(self, size: int, shard: int = 0) -> None:
        """One blocking solo dispatch of ``size`` all-padding entries on
        block 0 of ``shard``'s table, uploaded from the host as a step's
        are. All plain fulls: nothing is stored, the tables stay as they
        were."""
        dev = self._shard_devices[shard]
        packed = torch.full((4, 2, 8), spec.NUM_FEATURES, dtype=torch.int16)
        zeros = torch.zeros((size,), dtype=torch.int32)
        parents = torch.full((size,), -1, dtype=torch.int32)
        with on_device(dev):
            z = zeros.to(dev, non_blocking=True)
            values, _, _ = self._eval_fn(
                self._shard_params[shard], packed.to(dev, non_blocking=True),
                z, parents.to(dev, non_blocking=True),
                z if self._host_material(shard) else None,
                self._anchor_shards[shard][0], 0, self._psqt_shards[shard][0],
                offsets=z,
            )
            values.cpu()

    def _warm_shards(self) -> None:
        """One padding dispatch on every shard past the first (the
        warm-up covered shard 0): each device initialises its libraries
        and the kernel's state before the first real step."""
        for s in range(1, self._n_shards):
            if self._stopping:
                return
            self._padding_eval(self._eval_sizes[-1], shard=s)

    def _probe_dispatch_cost(self, rounds: int = 3) -> DispatchProbe:
        """Time blocking solo dispatches at the smallest and largest
        entry buckets on this service's device and fit the two-point
        cost model (the median of ``rounds`` each)."""
        s_small, s_big = self._eval_sizes[0], self._eval_sizes[-1]

        def timed(size: int) -> float:
            ts = []
            for _ in range(rounds):
                t0 = time.perf_counter()
                self._padding_eval(size)
                ts.append(time.perf_counter() - t0)
            return sorted(ts)[len(ts) // 2]

        return fit_dispatch_cost(timed(s_small), timed(s_big), s_small, s_big)

    def poke(self) -> None:
        """Wake the drivers (after setting a search's stop_event). Also
        applies set stop_events directly: the native per-slot stop flags
        are atomic latches safe from any thread, and the owning driver
        may be blocked inside fc_pool_step running that very search."""
        with self._lock:
            for t in range(self.driver_threads):
                for slot, p in self._pending[t].items():
                    if p.stop_event is not None and p.stop_event.is_set():
                        self._lib.fc_pool_stop(self._pool, slot)
        for w in self._wakes:
            w.set()

    def set_prefetch(self, budget: int, adaptive: bool = True) -> None:
        """Pin (adaptive=False) or re-seed the pool's speculation budget.
        Pinning makes TT evolution deterministic across backends — the
        cross-backend parity checks rely on it."""
        self._lib.fc_pool_set_prefetch(
            self._pool, int(budget), 1 if adaptive else 0
        )

    def counters(self) -> Dict[str, int]:
        """Cumulative eval-traffic counters: the native pool's (see cpp
        SearchCounters) and this service's dispatch accounting. After
        close() they are the final counts, as close() read them once
        every driver and worker had stopped."""
        if not self._pool:
            return dict(self._closed_counters)
        buf = (ctypes.c_uint64 * 13)()
        n = self._lib.fc_pool_counters(self._pool, buf, 13)
        out = {k: int(buf[i]) for i, k in enumerate((
            "steps", "evals_shipped", "suspensions", "step_capacity",
            "demand_evals", "prefetch_shipped", "prefetch_hits",
            "tt_eval_hits", "prefetch_budget", "delta_evals",
            "dedup_retired", "nodes", "anchor_deltas",
        )[:n])}
        out["eval_steps"] = sum(self._eval_steps)
        out["latency_active"] = self._latency_active
        out["bucket_slots"] = sum(self._bucket_slots)
        out["wire_feature_bytes"] = sum(self._wire_feature_bytes)
        out["wire_material_bytes"] = sum(self._wire_material_bytes)
        out["wire_bytes"] = (
            out["wire_feature_bytes"] + out["wire_material_bytes"]
        )
        # Device dispatches actually issued (a fused dispatch counts once
        # for all its groups): eval_steps / dispatches is the mean
        # coalesce width.
        co = self._coalescer
        if co is not None:
            with co._lock:
                out["dispatches"] = co.dispatches
                out["fused_dispatches"] = co.fused_dispatches
                out["coalesced_steps"] = co.coalesced_steps
                out["fused_dedup"] = co.deduped_evals
                if self._router is not None:
                    for s, d in enumerate(co.shard_dispatches):
                        out[f"shard{s}_dispatches"] = d
        else:
            out["dispatches"] = out["eval_steps"]
            out["fused_dispatches"] = 0
            out["coalesced_steps"] = 0
            out["fused_dedup"] = 0
        # The async pipeline's in-flight count and busy/dual integrals
        # (microseconds; dual / busy is its overlap ratio).
        out["inflight_dispatches"] = 0
        out["async_ready_queue"] = 0
        out["decode_queue"] = 0
        out["overlap_busy_us"] = 0
        out["overlap_dual_us"] = 0
        for pipe in self._async_pipes:
            out["inflight_dispatches"] += pipe.inflight()
            out["async_ready_queue"] += pipe.queue_depth()
            out["decode_queue"] += pipe.decode_queue_depth()
            with pipe._lock:
                out["overlap_busy_us"] += int(pipe._busy_s * 1e6)
                out["overlap_dual_us"] += int(pipe._dual_s * 1e6)
        # Position-keyed eval reuse: entries answered by the cache before
        # any wire bytes moved (whole-batch skips and fused-plan fills),
        # dispatches skipped outright, position-keyed dedup drops; the
        # bounds tier's seeded and harvested records and harvest errors;
        # the process cache's size and evictions (0 with it off).
        with self._lock:
            out["cache_prewire_hits"] = self._cache_prewire_hits
            out["cache_skipped_dispatches"] = self._cache_skipped_dispatches
            out["position_dedup"] = self._position_dedup
            out["bounds_seeded"] = self._bounds_seeded
            out["bounds_harvested"] = self._bounds_harvested
            out["bounds_harvest_errors"] = self._bounds_harvest_errors
        st = self._eval_cache.stats() if self._eval_cache is not None else {}
        out["cache_entries"] = st.get("entries", 0)
        out["cache_evictions"] = st.get("evictions", 0)
        return out

    #: Prefetch-steering hysteresis (FISHNET_CACHE_PREFETCH=1): pin the
    #: speculation budget to 0 when the cache hit rate crosses _PIN
    #: (speculative evals would mostly duplicate cached positions), and
    #: restore the adaptive policy when it falls under _UNPIN.
    _STEER_PIN = 0.6
    _STEER_UNPIN = 0.3

    def _steer_prefetch(self, group: int) -> None:
        """Pin or unpin the pool's speculation budget by ``group``'s
        rolling cache hit rate, with hysteresis. The budget is
        pool-wide, so the steer state is too: whichever driver thread
        crosses a threshold first applies the transition."""
        rate = self._miss_hist.hit_rate(group)
        if rate is None:
            return
        with self._lock:
            pinned = self._steer_state.get(0, False)
            if not pinned and rate > self._STEER_PIN:
                self._steer_state[0] = True
            elif pinned and rate < self._STEER_UNPIN:
                self._steer_state[0] = False
            else:
                return
            pin = self._steer_state[0]
        if pin:
            self.set_prefetch(0, adaptive=False)
        else:
            # Re-seed the adaptive policy at one block's worth (the
            # pool's own startup default, cpp EVAL_BLOCK_MAX).
            self.set_prefetch(MIN_BATCH_CAPACITY, adaptive=True)

    # -- scheduling knobs (the JAX service's control-plane seams) ---------
    # Bounded, revertible setters over scheduling only: none of them can
    # change what any position evaluates to.

    def set_coalesce_width(self, width: Optional[int]) -> None:
        """Force the coalesce policy width (None restores the probe
        policy). No-op without a coalescer."""
        if self._coalescer is not None:
            self._coalescer.set_width_override(width)

    def coalesce_width(self) -> Optional[int]:
        """The live coalesce width (None when coalescing is off)."""
        co = self._coalescer
        return co.width if co is not None else None

    def set_async_depth(self, depth: Optional[int]) -> None:
        """Re-tune the async pipeline's in-flight depth (bounded
        1..MAX_DEPTH; None restores the default). Not the
        ``pipeline_depth`` constructor knob, which sets the groups per
        driver thread. No-op without the pipeline."""
        if depth is None:
            depth = _AsyncDispatchPipeline.DEPTH
        for pipe in self._async_pipes:
            pipe.set_depth(depth)

    def async_depth(self) -> Optional[int]:
        """The async pipeline's in-flight depth (None without one)."""
        pipes = self._async_pipes
        return max(p.depth() for p in pipes) if pipes else None

    def is_alive(self) -> bool:
        """False once the service is shut down or any driver crashed —
        callers holding a handle should build a fresh service (the
        engine-restart analogue of the reference's subprocess respawn,
        src/main.rs:284-312)."""
        with self._lock:
            if self._stopping:
                return False
        return all(th.is_alive() for th in self._threads)

    def _maybe_stop(self, slot: int, pending: _Pending) -> None:
        """Movetime watchdog (event-loop thread): stop the native search
        directly; the identity check under _lock closes the slot-reuse
        race (submit and harvest hold the same lock)."""
        with self._lock:
            if self._pending[pending.thread].get(slot) is pending:
                self._lib.fc_pool_stop(self._pool, slot)
        self._wakes[pending.thread].set()

    def close(self) -> None:
        with self._lock:
            self._stopping = True
        # Unblock drivers stuck inside a long native step: every search
        # polls its stop flag per node.
        if self._pool:
            self._lib.fc_pool_stop_all(self._pool)
        for w in self._wakes:
            w.set()
        deadline = time.monotonic() + 60
        for th in self._threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        # The pack and decode workers stop AFTER the drivers: a driver
        # blocked in demand() needs the pack worker to set its ticket.
        for pipe in self._async_pipes:
            pipe.close()
        if _telemetry.enabled():
            # Clean-close flight-recorder dump.
            _SPANS.dump(reason="close")
        if any(th.is_alive() for th in self._threads):
            # Driver stuck: leak the pool rather than free memory a
            # thread still dereferences.
            return
        if self._collector_token is not None:
            # Under the registry's scrape lock: once this returns no
            # scrape is reading counters() of the pool freed below.
            _telemetry.REGISTRY.unregister_collector(self._collector_token)
            self._collector_token = None
        if self._pool:
            self._closed_counters = self.counters()
            self._lib.fc_pool_free(self._pool)
            self._pool = None
        if self._tmp is not None:
            Path(self._tmp.name).unlink(missing_ok=True)
            self._tmp = None

    # -- the serving mesh's plumbing -------------------------------------

    def _host_material(self, shard: int) -> bool:
        """Whether ``shard``'s dispatches ship the pool's material term
        (the host-material rung) instead of computing PSQT on the
        device."""
        if self._router is None:
            return self._material_buf is not None
        return self._ladder[self._shard_rungs[shard]] == "host-material"

    def _eval_state(self, group: int):
        """``(shard, params, device, ship_material)`` for ``group``'s
        current placement: on the mesh its shard's replica, device and
        rung; otherwise shard 0, the service's own."""
        shard = 0 if self._router is None else self._router.shard_of(group)
        return (shard, self._shard_params[shard], self._shard_devices[shard],
                self._host_material(shard))

    def _mesh_kw(self, material) -> dict:
        """The evaluator's extra arguments on the mesh: a host-material
        dispatch still stores the anchors' PSQT there (module
        docstring). None without a mesh, where a service's rung never
        changes."""
        if self._router is None or material is None:
            return {}
        return {"store_psqt": True}

    def _handle(self, done, out, err, dev):
        """A CUDA dispatch's in-flight handle; on a mesh device other
        than the service's it carries that device's error baseline."""
        if dev == self.device:
            return done, out, err
        return done, out, err, self._err_bases.get(dev.index, 0)

    def _place_group_tables(self, group: int, shard: int) -> None:
        """Bring ``group``'s live table block to ``shard``'s allocation
        when the router re-homed it (first traffic, a drain): a copy
        from the shard that holds it, before the dispatch that reads
        it, on the thread that issues that dispatch. The group's eval
        chain is serial — its last dispatch was read back before it
        stepped again — so the old block is final."""
        if self._table_home is None:
            return
        old = self._table_home[group]
        if old == shard:
            return
        with on_device(self._shard_devices[shard]):
            self._anchor_shards[shard][group].copy_(
                self._anchor_shards[old][group])
            self._psqt_shards[shard][group].copy_(
                self._psqt_shards[old][group])
        self._table_home[group] = shard
        with self._mesh_lock:
            self._migrations += 1

    def _degrade_shard_for(self, group: int, err: BaseException) -> None:
        """One step of the per-shard ladder after a device fault on
        ``group``'s shard: the next rung of its device's ladder
        (``ladder_for``: fused -> host-material on CUDA), then a DRAIN —
        the shard is marked dead and its groups re-homed on the
        survivors (their tables follow at their next dispatch). Other
        shards never move. Raises ``err`` without a mesh or when no
        shard is left."""
        if self._router is None:
            raise err
        shard = self._router.shard_of(group)
        with self._mesh_lock:
            rung = self._shard_rungs[shard]
            if rung < len(self._ladder) - 1:
                self._shard_rungs[shard] = rung + 1
                self._degradations.append(
                    (shard, self._ladder[rung], self._ladder[rung + 1]))
                SHARD_DEGRADATIONS.inc(**{
                    "shard": str(shard), "from": self._ladder[rung],
                    "to": self._ladder[rung + 1]})
                return
            try:
                moved = self._router.drain(shard)
            except RuntimeError:
                raise err
            self._coalescer.migrate(moved)
            self._degradations.append((shard, self._ladder[rung], "drained"))
            SHARD_DEGRADATIONS.inc(**{
                "shard": str(shard), "from": self._ladder[rung],
                "to": "drained"})

    def shard_report(self) -> dict:
        """Per-shard snapshot: device, dispatches, the microbatches they
        carried (steps / dispatches: the mean coalesce width), occupancy
        EMA, rung (``"drained"`` for a dead shard), liveness, groups, and
        the mesh-wide degradation steps ``(shard, from, to)``, table
        migrations and router re-homes. A service without a mesh reports
        one healthy shard."""
        co = self._coalescer
        n = self._n_shards
        if co is not None:
            with co._lock:
                dispatches = list(co.shard_dispatches)
                steps = list(co.shard_steps)
                occ = [float(co._occ_ema[s] or 0.0) for s in range(n)]
        else:
            dispatches = steps = [sum(self._eval_steps)]
            occ = [0.0]
        router = self._router
        alive = set(router.alive_shards()) if router else {0}
        with self._mesh_lock:
            rung_idx = [
                self._shard_rungs[s] if s in alive else len(self._ladder)
                for s in range(n)
            ]
            degradations = list(self._degradations)
            migrations = self._migrations
        return {
            "n_shards": n,
            "devices": [str(d) for d in self._shard_devices],
            "dispatches": dispatches,
            "steps": steps,
            "occupancy": occ,
            "rungs": [self._ladder[i] if i < len(self._ladder) else "drained"
                      for i in rung_idx],
            "rung_index": rung_idx,
            "alive": [s in alive for s in range(n)],
            "groups": ([router.groups_of(s) for s in range(n)] if router
                       else [list(range(self._n_groups))]),
            "degradations": degradations,
            "migrations": migrations,
            "rehomes": router.rehomes if router else 0,
        }

    # -- evaluation -------------------------------------------------------

    def _dispatch_eval(self, group: int, n: int, rows: int):
        """Queue group ``group``'s microbatch on the device WITHOUT
        waiting for the result; ``_resolve_eval`` reads it later, so
        other groups' fibers run meanwhile. Ships the smallest entry
        bucket covering ``n`` and the ``rows`` emitted packed rows plus
        one sentinel block. Returns ``(handle, acct)``: the in-flight
        handle and the (bucket, feature-bytes, material-bytes) wire
        accounting."""
        size = self._eval_sizes[-1]
        for s in self._eval_sizes:
            if n <= s:
                size = s
                break
        packed = self._packed_buf[group]
        buckets = self._bucket_buf[group]
        parents = self._parent_buf[group]
        material = (
            None if self._material_buf is None else self._material_buf[group]
        )
        # Padding entries: plain fulls whose offsets point (n_rows) at the
        # 4 sentinel rows appended past the emitted stream.
        packed[rows: rows + 4] = spec.NUM_FEATURES
        self._offset_buf[group, n:size] = rows
        buckets[n:size] = 0
        parents[n:size] = -1
        if material is not None:
            material[n:size] = 0
        if self._sharded_packed:
            return self._dispatch_sharded_packed(
                size, n, rows, packed, buckets, parents, material,
                self._offset_buf[group])
        if self._evaluator is not None:
            # The dense expansion, handed to the external evaluator,
            # which reads (or copies) it before this group steps again.
            feats = expand_packed_np(
                packed[: rows + 4], self._offset_buf[group, :size],
                parents[:size])
            acct = (size, feats.nbytes + size * 2 * 4, size * 4)
            return self._evaluator(
                None, feats, buckets[:size], parents[:size],
                material[:size]), acct
        shard, params, dev, ship = self._eval_state(group)
        self._place_group_tables(group, shard)
        with on_device(dev):
            pk = self._packed_t[group, : rows + 4].to(dev, non_blocking=True)
            of = self._offset_t[group, :size].to(dev, non_blocking=True)
            bk = self._bucket_t[group, :size].to(dev, non_blocking=True)
            pa = self._parent_t[group, :size].to(dev, non_blocking=True)
            mat = (
                None if not ship
                else self._material_t[group, :size].to(dev, non_blocking=True)
            )
            acct = (
                size,
                (rows + 4) * 2 * 8 * 2 + size * 3 * 4,
                0 if mat is None else size * 4,
            )
            values, _, _ = self._eval_fn(
                params, pk, bk, pa, mat,
                self._anchor_shards[shard][group], rows,
                self._psqt_shards[shard][group], offsets=of,
                **self._mesh_kw(mat),
            )
            out = self._values_t[group, :size]
            if dev.type != "cuda":
                out.copy_(values)
                return (None, out, None), acct
            out.copy_(values, non_blocking=True)
            err = self._err_t[group]
            err.copy_(error_word(dev), non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return self._handle(done, out, err, dev), acct

    def _dispatch_sharded_packed(self, size, n, rows, packed, buckets,
                                 parents, material, offsets):
        """Repack a group's row stream into one row tier per shard of
        the sharded evaluator and ship it to its ``packed_eval``. The
        pool's aligned emission keeps every entry's rows and every
        delta's anchor inside one shard's entry span; the row stream is
        cut at the shard boundaries (each boundary entry starts a block,
        so its offset is the cut), each slice padded with sentinel rows
        to the common tier, offsets made shard-local."""
        mult = self.shard_multiple
        shard = size // mult
        bounds = np.empty(mult + 1, np.int64)
        for k in range(mult):
            idx = k * shard
            bounds[k] = offsets[idx] if idx < n else rows
        bounds[mult] = rows
        need = int(np.diff(bounds).max()) + 4
        tiers = self._shard_row_tiers(shard)
        tier = next((rt for rt in tiers if need <= rt), tiers[-1])
        out_packed = np.full((mult * tier, 2, 8), spec.NUM_FEATURES,
                             np.uint16)
        out_offsets = np.empty(size, np.int32)
        for k in range(mult):
            rs, re = int(bounds[k]), int(bounds[k + 1])
            out_packed[k * tier: k * tier + (re - rs)] = packed[rs:re]
            lo, hi = k * shard, (k + 1) * shard
            real_hi = min(hi, n)
            if lo < real_hi:
                out_offsets[lo:real_hi] = offsets[lo:real_hi] - rs
            if real_hi < hi:
                # Padding entries read the shard's own sentinel block.
                out_offsets[real_hi:hi] = tier - 4
        acct = (size, mult * tier * 2 * 8 * 2 + size * 3 * 4, size * 4)
        return self._evaluator.packed_eval(
            None, out_packed, out_offsets, buckets[:size], parents[:size],
            material[:size]), acct

    @staticmethod
    def _shard_row_tiers(shard: int) -> List[int]:
        """Per-shard row tiers of the sharded packed wire (the JAX
        package's compiled shapes): every shard pads its rows to one
        common tier; ``4 * shard + 4`` always fits."""
        return [2 * shard + 4, 3 * shard + 4, 4 * shard + 4]

    def _dispatch_segmented(self, tickets: List[_CoalesceTicket]) -> None:
        """ONE device dispatch covering every ticket's group microbatch
        (the coalescer's fused flush), on whichever thread flushes —
        the pack worker, or a driver without the pipeline. The owners'
        buffers are quiescent: a group never steps again before its
        ticket is resolved. Each owner applies its own accounting from
        ``ticket.acct``.

        All segments share one entry bucket (the smallest covering the
        largest n); each takes its exact span of the concatenated row
        stream (its rows, then its own sentinel block). The stream meets
        the single-group contract: offsets are derived on the host over
        the segment spans (``derive_segment_offsets_np``), parent codes
        rebased into the fused frame with the groups' own table blocks
        (``recode_segment_parents_np``), and ONE ``evaluate_packed_
        anchored`` call on the flat [n_groups * A, ...] tables — one
        kernel launch on the card — evaluates every segment and stores
        every anchor entry to its own group's rows.

        Cross-segment dedup (``plan_segment_dedup``; off with
        FISHNET_NO_DEDUP=1), in one of two modes:

        * position-keyed, when every ticket carries its batch's hashes
          (the eval cache is on): any entry whose position an earlier
          entry of the dispatch holds, or whose eval the cache knows,
          leaves the wire — a dropped 4-row entry ships one sentinel
          row — and its value is restored on the host (``_FusedValues``
          dups and fills). A dropped persistent anchor code keeps its
          table row and store bit: the kernel's copy-source mode
          (``copy_src``) gives it its source's accumulator before the
          stores, so its row holds the bytes it would have stored.
        * byte mode (the cache off): a plain full whose feature block
          duplicates an earlier one is dropped the same way; plain
          fulls store nothing, so no fan-in is needed (checked below).

        On the mesh a flush holds one shard's groups (the coalescer parks
        per shard), dispatched on that shard's device, replica, tables
        and rung; a flush queued before a drain re-homed some of its
        groups is split by their current shards."""
        if self._router is not None:
            parts: Dict[int, List[_CoalesceTicket]] = {}
            for tk in tickets:
                parts.setdefault(self._router.shard_of(tk.group), []).append(tk)
            if len(parts) > 1:
                for part in parts.values():
                    if len(part) == 1:
                        tk = part[0]
                        tk.values, tk.acct = self._dispatch_eval(
                            tk.group, tk.n, tk.rows)
                    else:
                        self._dispatch_segmented(part)
                return
        k_segs = len(tickets)
        groups = [tk.group for tk in tickets]
        size = self._eval_sizes[-1]
        for s in self._eval_sizes:
            if max(tk.n for tk in tickets) <= s:
                size = s
                break
        shard, params, dev, mat_on = self._eval_state(tickets[0].group)
        for tk in tickets:
            # The padding writes the solo path makes: a sentinel block
            # past the emitted rows, sentinel entries past n.
            g, n = tk.group, tk.n
            self._packed_buf[g][tk.rows: tk.rows + 4] = spec.NUM_FEATURES
            self._offset_buf[g][n:size] = tk.rows
            self._bucket_buf[g][n:size] = 0
            self._parent_buf[g][n:size] = -1
            if mat_on:
                self._material_buf[g][n:size] = 0
        drops = refs = dups = fills = None
        eff_rows = [tk.rows for tk in tickets]
        use_hash = all(tk.hashes is not None for tk in tickets)
        if self._dedup_fused and (self._repeats_or_hits(tickets) if use_hash
                                  else self._shares_a_block(tickets)):
            planned = plan_segment_dedup(
                [self._parent_buf[g] for g in groups],
                [self._bucket_buf[g] for g in groups],
                [self._offset_buf[g] for g in groups],
                [tk.n for tk in tickets],
                [self._packed_buf[g] for g in groups],
                [self._material_buf[g] for g in groups] if mat_on else None,
                hashes=[tk.hashes for tk in tickets] if use_hash else None,
                cache_hits=[
                    None if tk.cache_mask is None
                    else (tk.cache_mask, tk.cache_vals) for tk in tickets
                ] if use_hash else None,
            )
            drops, refs, pairs = planned[:3]
            hits = planned[3] if use_hash else []
            if pairs or hits:
                for k, tk in enumerate(tickets):
                    code = self._parent_buf[tk.group][drops[k]]
                    if not use_hash and (code != -1).any():
                        raise NativeCoreError(
                            "dedup dropped an entry other than a plain "
                            "full: its anchor store would be lost")
                    # A dropped 4-row entry (a plain full or a persistent
                    # full) ships 1 row; dropped deltas were 1 row.
                    full4 = (code == -1) | (
                        (code <= -2) & ((((-code - 2) >> 1) & 1) == 0))
                    eff_rows[k] = tk.rows - 3 * int(full4.sum())
                dups = [(dk * size + di, sk * size + si)
                        for dk, di, sk, si in pairs]
                fills = [(fk * size + fi, val) for fk, fi, val in hits]
                with self._coalescer._lock:
                    self._coalescer.deduped_evals += len(pairs)
                with self._lock:
                    if use_hash:
                        self._position_dedup += len(pairs)
                    self._cache_prewire_hits += len(fills)
        st = self._take_staging(shard)
        try:
            for g in groups:
                self._place_group_tables(g, shard)
            # Byte mode drops only plain fulls, which store nothing: the
            # launch needs no fan-in there.
            with on_device(dev):
                handle = self._stage_and_launch(
                    st, tickets, groups, size, eff_rows,
                    drops if dups or fills else None, refs, use_hash,
                    dups if use_hash else None, shard=shard, params=params,
                    dev=dev, mat_on=mat_on)
            shared = _FusedValues(
                handle, lambda h: self._resolve_eval(k_segs * size, h), dups,
                fills)
            st.holder = shared
        finally:
            st.lock.release()
        for k, tk in enumerate(tickets):
            tk.values = shared
            tk.start = k * size
            tk.seg_size = size
            tk.acct = (
                size,
                (eff_rows[k] + 4) * 2 * 8 * 2 + size * 3 * 4,
                size * 4 if mat_on else 0,
            )

    def _shares_a_block(self, tickets: List[_CoalesceTicket]) -> bool:
        """Whether two 4-row entries of the dispatch share their feature
        block, bucket (and material): the byte-mode planner's key.
        Without such a pair it finds nothing, so its per-entry Python
        loop is skipped (on anchored traffic, almost always)."""
        keys = []
        for tk in tickets:
            g, n = tk.group, tk.n
            p = self._parent_buf[g][:n]
            v = -p - 2
            full4 = np.flatnonzero(
                (p == -1) | ((p <= -2) & (((v >> 1) & 1) == 0)))
            rows = self._offset_buf[g][full4][:, None] + np.arange(4)
            cols = [self._packed_buf[g][rows].reshape(len(full4), 64),
                    self._bucket_buf[g][full4].view(np.uint16).reshape(-1, 2)]
            if self._material_buf is not None:
                cols.append(self._material_buf[g][full4].view(
                    np.uint16).reshape(-1, 2))
            keys.append(np.concatenate(cols, axis=1))
        keys = np.ascontiguousarray(np.concatenate(keys))
        blocks = keys.view(np.dtype((np.void, keys.shape[1] * 2))).ravel()
        return len(np.unique(blocks)) < len(blocks)

    def _repeats_or_hits(self, tickets: List[_CoalesceTicket]) -> bool:
        """Whether a position repeats across the dispatch or the cache
        knows an entry: without either, the position-keyed planner finds
        nothing, so its per-entry Python loop is skipped."""
        if any(tk.cache_mask is not None and tk.cache_mask[:tk.n].any()
               for tk in tickets):
            return True
        keys = np.concatenate([tk.hashes[:tk.n] for tk in tickets])
        return len(np.unique(keys)) < len(keys)

    def _take_staging(self, shard: int = 0) -> _Staging:
        """The next staging slot of ``shard``'s ring, locked. The
        dispatch last staged there is read back first: until then its
        uploads may still read the slot and its owners not yet have
        copied its values out."""
        ring = self._staging[shard]
        with self._staging_lock:
            st = ring[self._staging_next[shard] % len(ring)]
            self._staging_next[shard] += 1
        st.lock.acquire()
        prev, st.holder = st.holder, None
        if prev is not None:
            try:
                prev.materialize()
            except NativeCoreError:
                pass  # its owners raise it when they resolve
        return st

    def _stage_and_launch(self, st: _Staging, tickets, groups, size: int,
                          eff_rows, drops, refs, ready_codes: bool = False,
                          dups=None, *, shard: int = 0, params=None,
                          dev=None, mat_on: bool = False):
        """Write the fused wire into ``st``, upload it to ``dev`` (the
        dispatch's shard ``shard``, with ``params`` its replica and
        ``mat_on`` its rung's material wire), launch on that shard's flat
        tables, and queue the copies of the values and the error word
        back; returns the in-flight handle as ``_dispatch_eval`` does.
        ``refs`` are the dropped entries' new parent codes
        (``ready_codes``: as the position-keyed planner gives them) or
        in-batch anchor indices (byte mode); ``dups`` (flat ``(dst,
        src)`` pairs) become the launch's ``copy_src`` fan-in."""
        k_segs = len(tickets)
        n_all = k_segs * size
        parents = st.parents_t.numpy()[:n_all].reshape(k_segs, size)
        buckets = st.buckets_t.numpy()
        bases = np.zeros(k_segs, np.int64)
        pos = 0
        for k, tk in enumerate(tickets):
            g = tk.group
            parents[k] = self._parent_buf[g][:size]
            buckets[k * size: (k + 1) * size] = self._bucket_buf[g][:size]
            if mat_on:
                st.material_t.numpy()[k * size: (k + 1) * size] = \
                    self._material_buf[g][:size]
            bases[k] = pos
            span = eff_rows[k] + 4
            if drops is None or not drops[k]:
                st.packed[pos: pos + span] = self._packed_buf[g][:span]
            else:
                self._compact_segment(st.packed[pos: pos + span], g, tk.n,
                                      drops[k])
                codes = np.asarray(refs[k], np.int32)
                parents[k, drops[k]] = codes if ready_codes else codes << 1
            pos += span
        # A persistent code past its group's block would land in another
        # group's rows of the flat table, where the kernel's range check
        # (against the whole table) cannot see it: refuse it here.
        v = -parents - 2
        if bool(((parents <= -2) & ((v >> 2) >= self._anchor_rows)).any()):
            raise NativeCoreError(
                "a persistent anchor code is past its group's table rows")
        st.offsets_t.numpy()[:n_all] = derive_segment_offsets_np(
            parents, eff_rows, bases)
        st.parents_t.numpy()[:n_all] = recode_segment_parents_np(
            parents, self._anchor_rows, groups)
        pk = st.packed_t[:pos].to(dev, non_blocking=True)
        of = st.offsets_t[:n_all].to(dev, non_blocking=True)
        bk = st.buckets_t[:n_all].to(dev, non_blocking=True)
        pa = st.parents_t[:n_all].to(dev, non_blocking=True)
        mat = (
            None if not mat_on
            else st.material_t[:n_all].to(dev, non_blocking=True)
        )
        copy_src = None
        if dups:
            # The position-dedup fan-in, handed over on the host: the
            # evaluator checks its contract before the upload.
            cs = st.copy_src_t.numpy()[:n_all]
            cs[:] = np.arange(n_all, dtype=np.int32)
            dst, src = np.asarray(dups, dtype=np.int64).T
            cs[dst] = src
            copy_src = st.copy_src_t[:n_all]
        n_tab = self._anchor_all.shape[0] * self._anchor_rows
        values, _, _ = self._eval_fn(
            params, pk, bk, pa, mat,
            self._anchor_shards[shard].view(n_tab, 2, spec.L1), pos,
            self._psqt_shards[shard].view(n_tab, 2, spec.NUM_PSQT_BUCKETS),
            offsets=of, copy_src=copy_src,
            parent_host=None if copy_src is None
            else st.parents_t.numpy()[:n_all], **self._mesh_kw(mat),
        )
        out = st.values_t[:n_all]
        if dev.type != "cuda":
            out.copy_(values)
            return None, out, None
        out.copy_(values, non_blocking=True)
        st.err_t.copy_(error_word(dev), non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return self._handle(done, out, st.err_t, dev)

    def _compact_segment(self, dst: np.ndarray, g: int, n: int,
                         drops) -> None:
        """Group ``g``'s row stream without its dropped duplicates, into
        ``dst``: kept entries keep their rows, each dropped full
        collapses to one sentinel delta row (no adds, no removals), and
        the sentinel block follows."""
        code = self._parent_buf[g][:n].astype(np.int64)
        delta = (code >= 0) | ((code <= -2) & ((((-code - 2) >> 1) & 1) != 0))
        lens = np.where(delta, 1, 4)
        drop_idx = np.asarray(drops, dtype=np.int64)
        lens[drop_idx] = 1
        starts = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        new_rows = int(starts[-1] + lens[-1])
        within = np.arange(new_rows, dtype=np.int64) - np.repeat(starts, lens)
        src_rows = np.repeat(self._offset_buf[g][:n].astype(np.int64),
                             lens) + within
        dst[:new_rows] = self._packed_buf[g][src_rows]
        dst[new_rows: new_rows + 4] = spec.NUM_FEATURES
        dst[starts[drop_idx], :, :4] = spec.NUM_FEATURES
        dst[starts[drop_idx], :, 4:] = spec.DELTA_BASE + spec.NUM_FEATURES

    def _wait_values(self, handle) -> None:
        """Block until a solo dispatch's values are on the host."""
        if handle[0] is not None:
            handle[0].synchronize()

    def _bind_worker(self, shard: int = 0) -> None:
        """A pipeline worker's CUDA device is its shard's (events and
        launches go to that device's default stream)."""
        dev = self._shard_devices[shard]
        if dev is not None and dev.type == "cuda":
            torch.cuda.set_device(dev)

    def _resolve_eval(self, n: int, handle) -> np.ndarray:
        """Block until a dispatched eval is done; contiguous int32 [n].
        Raises if the kernel refused an index or reference meanwhile.
        ``handle`` may also be a fused dispatch's slice, already read
        back (``_DispatchCoalescer.demand``), or an external evaluator's
        result (an array or a lazy handle ``np.asarray`` materialises)."""
        if not isinstance(handle, tuple):
            handle = np.asarray(handle)
        if isinstance(handle, np.ndarray):
            return np.array(handle[:n], dtype=np.int32)
        done, out, err = handle[:3]
        if done is not None:
            done.synchronize()
        if err is not None:
            base = handle[3] if len(handle) > 3 else self._err_base
            if int(err[0]) > base:
                raise NativeCoreError(
                    f"ft_gather kernel refused {int(err[0]) - base} "
                    "out-of-range indices or malformed references"
                )
        return np.array(out.numpy()[:n], dtype=np.int32)

    # -- driver thread ----------------------------------------------------

    def _drive(self, t: int) -> None:
        try:
            self._drive_inner(t)
        except Exception as err:  # noqa: BLE001 - driver must not die silently
            # Flag first so sibling threads stop too, then fail this
            # thread's own futures (each sibling fails its own on exit).
            with self._lock:
                self._stopping = True
            if self._pool:
                self._lib.fc_pool_stop_all(self._pool)
            for w in self._wakes:
                w.set()
            self._fail_all(t, NativeCoreError(f"search driver crashed: {err!r}"))
            raise

    def _drive_inner(self, t: int) -> None:
        lib = self._lib
        # This thread's slot groups (disjoint from every other thread's).
        groups = range(t * self.pipeline_depth, (t + 1) * self.pipeline_depth)
        pending = self._pending[t]

        def ptrs(buf, ctype):
            return {
                g: buf[g].ctypes.data_as(ctypes.POINTER(ctype)) for g in groups
            }

        packed_ptrs = ptrs(self._packed_buf, ctypes.c_uint16)
        offset_ptrs = ptrs(self._offset_buf, ctypes.c_int32)
        bucket_ptrs = ptrs(self._bucket_buf, ctypes.c_int32)
        slot_ptrs = ptrs(self._slot_buf, ctypes.c_int32)
        parent_ptrs = ptrs(self._parent_buf, ctypes.c_int32)
        # The material column is optional on the wire: the device-PSQT
        # path hands the pool a NULL pointer and the pool skips it.
        material_ptrs = (
            {g: None for g in groups} if self._material_buf is None
            else ptrs(self._material_buf, ctypes.c_int32)
        )
        # The eval cache (None: off): probed between step and dispatch,
        # filled at provide time; keys are hash ^ salt.
        cache = self._eval_cache
        salt = self._cache_salt
        hash_ptrs = ptrs(self._hash_buf, ctypes.c_uint64)
        # In-flight device evals per group: group -> (n, handle, its
        # device_step trace context or None, the batch's hashes or None,
        # its cache-hit mask or None), the handle a coalescer ticket
        # when there is a coalescer, or the values themselves when the
        # cache answered the whole batch.
        # Resolve group g's previous eval, wake its fibers, step them to
        # new leaves, dispatch (or park) the next eval — then move to
        # group g+1 while this one runs on the device.
        inflight: Dict[int, Tuple[int, object, object, object, object]] = {}
        co = self._coalescer

        if self.device is not None and self.device.type == "cuda":
            # The current device is per thread: events and the kernel's
            # stream must be this service's device, not cuda:0.
            torch.cuda.set_device(self.device)
        self.warmup()

        while True:
            if self._stopping:
                self._fail_all(t, NativeCoreError("service shut down"))
                return

            # Catch-up stop pass: stop_events set without a poke() and
            # tokens cancelled while their search was still queued.
            with self._lock:
                cancelled = self._cancelled_tokens[t]
                self._cancelled_tokens[t] = set()
                for slot, p in pending.items():
                    if p.token in cancelled or (
                        p.stop_event is not None and p.stop_event.is_set()
                    ):
                        lib.fc_pool_stop(self._pool, slot)

            # Drain this thread's submissions into its groups' slots.
            with self._lock:
                submissions = self._submissions[t]
                self._submissions[t] = []
            for item in submissions:
                (fen, moves, nodes, depth, multipv, future, loop, movetime,
                 variant, token, stop_event, skill, owner) = item
                if token in cancelled:
                    continue
                use_scalar = 1 if self.backend == "scalar" else 0
                # Standard chess only: bound records never cross
                # variant rule sets.
                std = variant == Variant.STANDARD
                slot = -1
                for g in groups:
                    slot = lib.fc_pool_submit(
                        self._pool, g, fen.encode(), moves.encode(),
                        nodes, depth, multipv, skill, use_scalar,
                        _VARIANT_CODES[variant],
                    )
                    if slot != -1:
                        break
                if slot == -1:
                    # Groups momentarily full: requeue; a slot frees up
                    # once a running search is harvested below.
                    with self._lock:
                        self._submissions[t].append(item)
                    continue
                if slot < 0:
                    loop.call_soon_threadsafe(
                        _set_exc, future,
                        NativeCoreError(f"submit failed ({slot})"),
                    )
                    continue
                children = None
                if std and self._bounds_cache is not None:
                    children = self._seed_bound_chain(fen, moves)
                p = _Pending(future, loop, time.monotonic(), token,
                             stop_event, t, fen=fen if std else "",
                             moves=moves, children=children)
                # Under _lock: the event-loop side (watchdog, cancel,
                # poke) identity-checks this map before stopping a slot.
                with self._lock:
                    pending[slot] = p
                    self._slot_owner[slot] = owner
                if movetime is not None:
                    loop.call_soon_threadsafe(
                        loop.call_later, movetime, self._maybe_stop, slot, p
                    )

            # close() may have raced the submission drain above: re-check
            # before any potentially long native step.
            with self._lock:
                if self._stopping:
                    continue

            # Flight-recorder gate, read once per iteration: one module
            # attribute read when telemetry is off, and then no clock
            # read and no trace context anywhere below.
            tel = _telemetry.enabled()
            # Cost-attribution gate, the same discipline: with the plane
            # off, no owner table and no extra clock read below.
            cost_on = _cost.enabled()

            stepped = 0
            for g in groups:
                if g in inflight:
                    n_prev, handle, dctx, hb, hmask = inflight.pop(g)
                    t0 = time.monotonic() if tel else 0.0
                    if isinstance(handle, _CoalesceTicket):
                        # Flushes the coalescer if the ticket is still
                        # parked, then waits for its dispatch; the
                        # accounting rides the ticket to its owner.
                        arr = co.demand(handle)
                        self._apply_acct(t, handle.acct)
                    else:
                        arr = handle
                    values = self._resolve_eval(n_prev, arr)
                    if cache is not None and hb is not None:
                        # Provide-time fill, the one insert site: teach
                        # the cache this batch's evals, and land the
                        # cache-known ones in the pool's TT too (raw
                        # hashes), so the pool and the cache agree.
                        cache.insert_block(hb ^ salt, values)
                        for i in np.flatnonzero(hmask).tolist():
                            self._held.fc_pool_tt_fill(
                                self._pool, int(hb[i]), int(values[i]))
                    if tel:
                        _SPANS.record(
                            "wire_decode", t0,
                            trace=dctx.child() if dctx else None,
                            group=g, n=n_prev,
                        )
                        t0 = time.monotonic()
                    rc = lib.fc_pool_provide(
                        self._pool, g,
                        values.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        n_prev,
                    )
                    if tel:
                        _SPANS.record(
                            "postprocess", t0,
                            trace=dctx.child() if dctx else None,
                            group=g, n=n_prev, op="provide",
                        )
                    if rc < 0:
                        raise NativeCoreError(
                            f"fc_pool_provide rejected {n_prev} values for "
                            f"group {g}: full-provide contract violated"
                        )
                # Advance this group's fibers; fill its eval batch.
                rows = ctypes.c_int32()
                t0 = time.monotonic() if tel else 0.0
                n = lib.fc_pool_step(
                    self._pool, g, packed_ptrs[g], offset_ptrs[g],
                    bucket_ptrs[g], slot_ptrs[g],
                    parent_ptrs[g], material_ptrs[g], self._group_capacity,
                    self._shard_align, ctypes.byref(rows),
                )
                # Step-trace root: each eval microbatch gets a fresh
                # trace at pack time; device_step chains under it and
                # the context rides the coalesce ticket across the
                # pack/decode worker handoffs.
                step_ctx = _tracing.new_trace() if tel and n > 0 else None
                if tel:
                    _SPANS.record(
                        "pack", t0, trace=step_ctx,
                        group=g, n=n, rows=rows.value,
                    )
                stepped += n
                if n > 0:
                    if self._params is None and self._evaluator is None:
                        raise NativeCoreError("no evaluator")  # pragma: no cover
                    # "service.device_step" fault site: an injected
                    # error/crash takes this driver down exactly like a
                    # real dispatch failure would — the supervisor's
                    # respawn and degradation ladder is the recovery.
                    # On the mesh a plain injected error degrades the
                    # group's SHARD instead (its ladder, then a drain)
                    # and the step is dispatched normally on the
                    # degraded path; siblings never notice. A FaultCrash
                    # still takes the driver down on the mesh.
                    if _faults.enabled():
                        if self._router is None:
                            _faults.fire("service.device_step")
                        else:
                            try:
                                _faults.fire("service.device_step")
                            except _faults.FaultCrash:
                                raise
                            except _faults.FaultInjected as err:
                                self._degrade_shard_for(g, err)
                    t0 = time.monotonic() if tel else 0.0
                    dctx = step_ctx.child() if step_ctx is not None else None
                    hashes = hmask = hvals = None
                    if cache is not None:
                        hashes, hvals, hmask = self._probe_batch(
                            g, n, hash_ptrs[g], dctx)
                        if cost_on and hmask.any():
                            # Credit cache hits (full or partial) to the
                            # tenants whose entries hit — device work
                            # they did not pay for.
                            _cost.note_cache_hits(
                                self._entry_owners(g, n, mask=hmask))
                        if hmask.all():
                            # Every entry known: no dispatch. The pool's
                            # device anchors are invalidated first, so
                            # its next blocks reseed instead of
                            # delta-ing against rows this batch never
                            # wrote.
                            lib.fc_pool_cancel_anchors(self._pool, g)
                            with self._lock:
                                self._cache_prewire_hits += n
                                self._cache_skipped_dispatches += 1
                            inflight[g] = (n, np.array(hvals, copy=True),
                                           dctx, hashes, hmask)
                            if tel:
                                _SPANS.record(
                                    "device_step", t0, trace=dctx,
                                    group=g, n=n, cache_skip=1,
                                )
                            continue
                    owners = self._entry_owners(g, n) if cost_on else None
                    if co is not None:
                        inflight[g] = (n, co.submit(
                            g, n, rows.value, trace=dctx, hashes=hashes,
                            cache_mask=hmask, cache_vals=hvals,
                            owners=owners),
                            dctx, hashes, hmask)
                    else:
                        t0c = time.monotonic() if cost_on else 0.0
                        handle, acct = self._dispatch_eval(g, n, rows.value)
                        if cost_on:
                            # The solo dispatch's issue wall, inline.
                            _cost.note_dispatch(
                                owners, n, _cost._acct_wire_bytes(acct),
                                time.monotonic() - t0c)
                        self._apply_acct(t, acct)
                        COALESCE_WIDTH.observe(1)
                        if acct[0] > n:
                            PAD_ROWS.inc(acct[0] - n, path="service")
                        inflight[g] = (n, handle, dctx, hashes, hmask)
                    if tel:
                        # The host-side issue: on the GPU the launch is
                        # asynchronous, and the device's work shows in
                        # wire_decode and dispatch_wait.
                        _SPANS.record(
                            "device_step", t0, trace=dctx, group=g, n=n
                        )

            # Harvest this thread's finished searches.
            for g in groups:
                t0 = time.monotonic() if tel else 0.0
                harvested = 0
                while True:
                    slot = lib.fc_pool_next_finished(self._pool, g)
                    if slot < 0:
                        break
                    self._finish_slot(t, slot)
                    harvested += 1
                if tel and harvested:
                    _SPANS.record(
                        "postprocess", t0, group=g, n=harvested, op="harvest"
                    )

            if stepped == 0 and not inflight and all(
                lib.fc_pool_active(self._pool, g) == 0 for g in groups
            ):
                with self._lock:
                    idle = not self._submissions[t] and not self._stopping
                if idle:
                    self._wakes[t].wait(timeout=0.05)
                    self._wakes[t].clear()

    def _probe_batch(self, g: int, n: int, hash_ptr, dctx=None):
        """The pre-dispatch probe of group ``g``'s stepped batch: export
        its Zobrist hashes, probe the eval cache, seed the bounds tier's
        records for these positions into the pool TT, and feed the miss
        history. With ``dctx`` (the batch's ``device_step`` trace
        context, None when telemetry is off) the ``cache_probe`` and
        ``bounds_probe`` spans are recorded under it. Returns (raw
        hashes, cached values, hit mask), views of the group's buffers
        valid until its next step."""
        lib = self._lib
        salt = self._cache_salt
        tel = dctx is not None
        t0 = time.monotonic() if tel else 0.0
        lib.fc_pool_batch_hashes(self._pool, g, hash_ptr,
                                 self._group_capacity)
        hashes = self._hash_buf[g][:n]
        hvals, hmask = self._eval_cache.probe_block(
            hashes ^ salt, out=self._cache_val_buf[g][:n])
        if tel:
            _SPANS.record("cache_probe", t0, trace=dctx, group=g, n=n,
                          hits=int(hmask.sum()))
        bcache = self._bounds_cache
        if bcache is not None:
            t0 = time.monotonic() if tel else 0.0
            # Cached search facts land in the pool TT before the
            # dispatch: cutoffs and window narrowing for the native
            # search, best moves for its move ordering.
            bv, be, bd, bb, bmv = bcache.probe_bounds_block(hashes ^ salt)
            rows = np.flatnonzero(bb).tolist()
            for i in rows:
                self._held.fc_pool_tt_fill_bound(
                    self._pool, int(hashes[i]), int(bv[i]), int(be[i]),
                    int(bd[i]), int(bb[i]), int(bmv[i]))
            if rows:
                with self._lock:
                    self._bounds_seeded += len(rows)
            if tel:
                _SPANS.record("bounds_probe", t0, trace=dctx, group=g, n=n,
                              hits=len(rows))
        self._miss_hist.record(g, int(hmask.sum()), n)
        if self._cache_steer:
            self._steer_prefetch(g)
        return hashes, hvals, hmask

    def _entry_owners(self, g: int, n: int, mask=None):
        """Cost-plane owner table for a stepped batch: counts the
        ``(tenant, family)`` owners over group ``g``'s first ``n``
        packed entries (``self._slot_buf[g]``, the per-entry slot ids
        fc_pool_step just filled), optionally restricted to a boolean
        ``mask`` over those entries. Runs on the owning driver only
        when ``_cost.enabled()``."""
        slots = self._slot_buf[g][:n]
        if mask is not None:
            slots = slots[np.asarray(mask, dtype=bool)]
        counts: Dict[Tuple[str, str], int] = {}
        owner_of = self._slot_owner
        for s in slots:
            o = owner_of.get(int(s), _cost.UNKNOWN_OWNER)
            counts[o] = counts.get(o, 0) + 1
        return list(counts.items())

    def _apply_acct(self, t: int, acct) -> None:
        size, feature_bytes, material_bytes = acct
        self._eval_steps[t] += 1
        self._bucket_slots[t] += size
        self._wire_feature_bytes[t] += feature_bytes
        self._wire_material_bytes[t] += material_bytes

    def _finish_slot(self, t: int, slot: int) -> None:
        lib = self._lib
        nodes = ctypes.c_uint64()
        depth = ctypes.c_int32()
        nlines = ctypes.c_int32()
        bm = ctypes.create_string_buffer(16)
        rc = lib.fc_pool_result_summary(
            self._pool, slot, ctypes.byref(nodes), ctypes.byref(depth),
            bm, len(bm), ctypes.byref(nlines),
        )
        with self._lock:
            pending = self._pending[t].pop(slot, None)
            self._slot_owner.pop(slot, None)
        if pending is None:
            lib.fc_pool_release(self._pool, slot)
            return
        if rc < 0:
            lib.fc_pool_release(self._pool, slot)
            err = NativeCoreError("result extraction failed")
            pending.loop.call_soon_threadsafe(_set_exc, pending.future, err)
            return

        lines: List[PvLineData] = []
        pv_buf = ctypes.create_string_buffer(4096)
        mpv = ctypes.c_int32()
        ldepth = ctypes.c_int32()
        is_mate = ctypes.c_int32()
        value = ctypes.c_int32()
        for i in range(nlines.value):
            if (
                lib.fc_pool_result_line(
                    self._pool, slot, i, ctypes.byref(mpv), ctypes.byref(ldepth),
                    ctypes.byref(is_mate), ctypes.byref(value), pv_buf, len(pv_buf),
                )
                < 0
            ):
                continue
            pv = pv_buf.value.decode()
            lines.append(
                PvLineData(
                    multipv=mpv.value,
                    depth=ldepth.value,
                    is_mate=bool(is_mate.value),
                    value=value.value,
                    pv=pv.split() if pv else [],
                )
            )
        lib.fc_pool_release(self._pool, slot)
        # Bounds-tier harvest: the pool TT is shared by every slot and
        # survives the release, so this reads what the search just
        # wrote. Advisory: an error is counted, never raised.
        if pending.fen and lines and self._bounds_cache is not None:
            try:
                self._harvest_bounds(pending.fen, pending.moves, lines,
                                     pending.children)
            except Exception:  # noqa: BLE001 - never fail a search result
                with self._lock:
                    self._bounds_harvest_errors += 1
                _HARVEST_ERRORS.inc()
        result = SearchResultData(
            lines=lines,
            best_move=bm.value.decode() or None,
            depth=depth.value,
            nodes=nodes.value,
            time_seconds=max(1e-6, time.monotonic() - pending.started),
        )
        pending.loop.call_soon_threadsafe(_set_res, pending.future, result)

    @staticmethod
    def _root_board(fen: str, moves: str) -> Optional[Board]:
        """The search root as a host board whose native calls keep the
        interpreter lock (a walk of many short calls), or None when it
        does not replay."""
        try:
            board = Board(fen, held=True)
            for tok in moves.split():
                board.push_uci(tok)
        except (InvalidFenError, IllegalMoveError, ValueError):
            return None
        return board

    @staticmethod
    def _child_hashes(board: Board) -> List[int]:
        """The Zobrist hashes of every legal child of ``board``, each
        played on a copy of the root as its FEN reads."""
        keys = []
        try:
            root = Board(board.fen(), held=True)
        except InvalidFenError:
            return keys
        for mv in root.legal_moves():
            child = root.copy()
            try:
                child.push_uci(mv)
            except (IllegalMoveError, ValueError):
                continue
            keys.append(child.zobrist_hash())
        return keys

    def _seed_bound_chain(self, fen: str, moves: str) -> Optional[List[int]]:
        """Seed the pool TT from the bounds tier before a search takes
        its first step: every legal root child's record (the previous
        search stored a depth-(d-1) record under each, and those are
        the nodes the re-search's null-window root probes hit first),
        then the cached best-move chain from the root (its PV), at most
        24 hops. The root's own record is followed but never seeded: the
        root's move ordering, window and best-move choice stay the live
        search's. Caller gates on the bounds tier and standard chess;
        a move that does not replay ends the walk. Returns the root
        children's hashes (None when the root does not replay), which
        the harvest at the search's end reuses."""
        bcache = self._bounds_cache
        board = self._root_board(fen, moves)
        if board is None:
            return None
        fill = self._held.fc_pool_tt_fill_bound
        salt = int(self._cache_salt)
        seeded = 0
        done = set()
        child_keys = self._child_hashes(board)
        if child_keys:
            karr = np.array(child_keys, dtype=np.uint64)
            cv, ce, cd, cb, cm = bcache.probe_bounds_block(
                karr ^ np.uint64(salt))
            for i in np.flatnonzero(cb).tolist():
                z = child_keys[i]
                fill(self._pool, z, int(cv[i]), int(ce[i]), int(cd[i]),
                     int(cb[i]), int(cm[i]))
                done.add(z)
                seeded += 1
        for hop in range(24):  # chain cap: PVs past this carry no signal
            z = board.zobrist_hash()
            rec = bcache.probe_bound((z ^ salt) & 0xFFFFFFFFFFFFFFFF)
            if rec is None:
                break
            value, eval_, depth_, bound, move_bits, uci = rec
            if hop > 0 and z not in done:  # root: follow, never seed
                fill(self._pool, z, value, eval_, depth_, bound, move_bits)
                seeded += 1
            if not uci:
                break
            try:
                board.push_uci(uci)
            except (IllegalMoveError, ValueError):
                break
        if seeded:
            with self._lock:
                self._bounds_seeded += seeded
        return child_keys

    def _harvest_bounds(self, fen: str, moves: str,
                        lines: List[PvLineData],
                        children: Optional[List[int]] = None) -> None:
        """Replay the finished search's principal variation (root and
        up to 31 plies) and export each node's bound record from the
        pool TT into the bounds tier, with the PV move that continues
        from it (the chain the next search's seed walks); then every
        legal root child's record (``children``, as the submit-time
        seed found them, or found here), the consumers of the
        submit-time fan-out. PV keys go first: a same-depth child record
        without a move must not displace the PV record that carries
        one."""
        board = self._root_board(fen, moves)
        if board is None:
            return
        keys: List[int] = [board.zobrist_hash()]
        ucis: List[Optional[str]] = []
        root_children = (self._child_hashes(board) if children is None
                         else children)
        for tok in lines[0].pv[:31]:
            try:
                board.push_uci(tok)
            except (IllegalMoveError, ValueError):
                break
            ucis.append(tok)
            keys.append(board.zobrist_hash())
        ucis.append(None)  # PV tip: no known continuation
        seen = set(keys)
        for z in root_children:
            if z not in seen:
                seen.add(z)
                keys.append(z)
                ucis.append(None)
        n = len(keys)
        karr = np.array(keys, dtype=np.uint64)
        values = np.empty(n, dtype=np.int32)
        evals = np.empty(n, dtype=np.int32)
        depths = np.empty(n, dtype=np.int32)
        bounds = np.empty(n, dtype=np.int32)
        mvbits = np.empty(n, dtype=np.uint32)

        def ptr(a, ctype):
            return a.ctypes.data_as(ctypes.POINTER(ctype))

        hits = self._held.fc_pool_tt_export(
            self._pool, ptr(karr, ctypes.c_uint64), n,
            ptr(values, ctypes.c_int32), ptr(evals, ctypes.c_int32),
            ptr(depths, ctypes.c_int32), ptr(bounds, ctypes.c_int32),
            ptr(mvbits, ctypes.c_uint32))
        if hits <= 0:
            return
        rows = np.flatnonzero(bounds)
        self._bounds_cache.insert_bounds_block(
            karr[rows] ^ self._cache_salt, values[rows], evals[rows],
            depths[rows], bounds[rows], mvbits[rows],
            [ucis[i] for i in rows.tolist()])
        with self._lock:
            self._bounds_harvested += int(hits)

    def _fail_all(self, t: int, err: Exception) -> None:
        """Resolve every outstanding future owned by thread ``t``:
        in-flight searches AND queued submissions, or their callers
        hang."""
        with self._lock:
            doomed = list(self._pending[t].values())
            self._pending[t].clear()
            submissions = self._submissions[t]
            self._submissions[t] = []
        if _telemetry.enabled() and (doomed or submissions):
            # Crash forensics: a driver failing live searches dumps the
            # flight recorder (the clean-drain call with nothing pending
            # stays silent — close() makes the one clean-close dump).
            _SPANS.dump(reason=f"fail_all:{err!r}"[:120])
        for pending in doomed:
            pending.loop.call_soon_threadsafe(_set_exc, pending.future, err)
        for item in submissions:
            future, loop = item[5], item[6]
            loop.call_soon_threadsafe(_set_exc, future, err)


def _set_res(future: asyncio.Future, value) -> None:
    if not future.done():
        future.set_result(value)


def _set_exc(future: asyncio.Future, err: Exception) -> None:
    if not future.done():
        future.set_exception(err)
