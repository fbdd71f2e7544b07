"""SearchService: the bridge between asyncio callers and the native
fiber pool + the torch NNUE evaluator.

The port of ``fishnet_tpu/search/service.py`` in its single-device
configuration with the dispatch coalescer and the async pipeline: what
the JAX service does with ``FISHNET_NO_EVAL_CACHE=1
FISHNET_NO_BOUNDS=1`` and no mesh. Every ``search(position)`` is submitted into one shared
native pool (cpp/src/pool.cpp over ctypes). Driver threads run the
pool's step/evaluate/provide cycle: ``fc_pool_step`` advances a slot
group's search fibers to their next leaf evaluations and packs them on
the compact wire, the leaves are evaluated as ONE microbatch on the
device (``evaluate_packed_anchored``), ``fc_pool_provide`` wakes the
fibers. Results resolve asyncio futures back on the event loop.

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

Streams: every ``ft_gather`` launch of a service — solo or fused, from
a driver thread or the pack worker — goes to its device's default
stream (no thread of the service sets another), because the kernel's
entry ticket and ready words are one state per device (ops/ft_gather.py
``_device_state``): two launches at once on two streams would share
them. One stream also keeps a reallocation of the ready words safe
behind a launch in flight: the freed block is reused in stream order.
"""

from __future__ import annotations

import asyncio
import ctypes
import os
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from fishnet_tpu_torch.chess.board import _VARIANT_CODES
from fishnet_tpu_torch.chess.core import NativeCoreError, load
from fishnet_tpu_torch.device import DeviceLike, resolve_device
from fishnet_tpu_torch.nnue import spec
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.ops.ft_gather import (
    derive_segment_offsets_np,
    error_word,
    kernel_errors,
    plan_segment_dedup,
    recode_segment_parents_np,
)
from fishnet_tpu_torch.protocol.types import Variant
from fishnet_tpu_torch.search.coalesce import (
    CoalesceBackend,
    DispatchProbe,
    _AsyncDispatchPipeline,
    _CoalesceTicket,
    _DispatchCoalescer,
    _FusedValues,
    fit_dispatch_cost,
)


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
    offsets, buckets, parents (and material) in; the values and a copy
    of the kernel's error word out. ``lock`` is held from staging until
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
        self.material_t = (
            host((width * size,), torch.int32) if material else None
        )
        self.values_t = host((width * size,), torch.int32)
        self.err_t = host((1,), torch.int32)
        self.lock = threading.Lock()
        self.holder: Optional[_FusedValues] = None


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
        """
        if backend not in ("torch", "scalar"):
            raise ValueError(f"unknown backend: {backend!r}")
        if psqt_path not in (None,) + PSQT_PATHS:
            raise ValueError(f"unknown psqt_path request: {psqt_path!r}")
        self.device = None if backend == "scalar" else resolve_device(device)
        if self.device is None:
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
        self.batch_capacity = batch_capacity = max(
            batch_capacity, MIN_BATCH_CAPACITY
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

        self._pool = self._lib.fc_pool_new(
            pool_slots, tt_bytes, self.net_path.encode(), self._n_groups
        )
        if not self._pool:
            raise NativeCoreError("failed to create search pool")

        cap = batch_capacity
        # Each group steps at most cap/k leaves so the k groups together
        # fill one batch_capacity of in-flight work.
        self._group_capacity = max(
            MIN_BATCH_CAPACITY, cap // self.pipeline_depth
        )
        self._eval_sizes = eval_bucket_sizes(self._group_capacity)

        self._params = None
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
            self._lib.fc_pool_set_anchors(self._pool, 1)
            if on_gpu:
                # Each group's copy of the kernel's error word, read with
                # its values; the count at warm-up is the baseline.
                self._err_t = host((k, 1), torch.int32)
                self._err_base = 0
            if self.psqt_path == "host-material":
                self._material_t = host((k, cap), torch.int32)
                self._material_buf = self._material_t.numpy()

        # DISPATCH COALESCER and ASYNC PIPELINE (search/coalesce.py),
        # under the JAX service's conditions and escape hatches.
        self._coalescer: Optional[_DispatchCoalescer] = None
        self._async_pipes: List[_AsyncDispatchPipeline] = []
        self._dedup_fused = os.environ.get("FISHNET_NO_DEDUP", "0") != "1"
        self._staging: List[_Staging] = []
        self._staging_next = 0
        self._staging_lock = threading.Lock()
        self.dispatch_probe: Optional[DispatchProbe] = None
        self._latency_active = 0
        if (
            self._params is not None and self._n_groups > 1
            and os.environ.get("FISHNET_NO_COALESCE", "0") != "1"
        ):
            pinned = None
            pin_env = os.environ.get("FISHNET_COALESCE_WIDTH")
            if pin_env:
                pinned = max(1, min(int(pin_env), self._n_groups))
            self._coalescer = _DispatchCoalescer(self, pinned_width=pinned)
            # One staging slot per dispatch the pipeline may hold in
            # flight, each sized for the widest fused dispatch.
            width = min(self._n_groups, _DispatchCoalescer.MAX_WIDTH)
            self._staging = [
                _Staging(width, self._eval_sizes[-1], host,
                         self._material_buf is not None)
                for _ in range(_AsyncDispatchPipeline.MAX_DEPTH)
            ]
            if os.environ.get("FISHNET_NO_ASYNC", "0") != "1":
                self._async_pipes = [_AsyncDispatchPipeline(self)]
        T = self.driver_threads
        # Per-thread accounting cells (the owning thread writes its own).
        self._eval_steps = [0] * T
        self._bucket_slots = [0] * T
        self._wire_feature_bytes = [0] * T
        self._wire_material_bytes = [0] * T
        self._pending: List[Dict[int, _Pending]] = [{} for _ in range(T)]
        self._submissions: List[List[Tuple]] = [[] for _ in range(T)]
        self._cancelled_tokens: List[set] = [set() for _ in range(T)]
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
        it is in flight; ``tenant`` is accepted as the JAX service
        accepts it and changes nothing here."""
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        token = object()
        latency = lane == "latency"
        with self._lock:
            if self._stopping:
                raise NativeCoreError("search service is shut down")
            if latency:
                self._latency_active += 1
            t = self._rr % self.driver_threads
            self._rr += 1
            self._submissions[t].append(
                (root_fen, " ".join(moves), nodes, depth, multipv, future, loop,
                 movetime_seconds, variant, token, stop_event, skill_level)
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
        Idempotent; safe from several threads."""
        if self._params is None:
            return
        with self._warmup_lock:
            if self._warmed or self._stopping:
                return
            self._padding_eval(self._eval_sizes[-1])
            if self.device.type == "cuda":
                self._err_base = kernel_errors(self.device)
            co = self._coalescer
            if co is not None and co._pinned is None and not self._stopping:
                self.dispatch_probe = self._probe_dispatch_cost()
                co.set_probe(self.dispatch_probe)
            self._warmed = True

    def _padding_eval(self, size: int) -> None:
        """One blocking solo dispatch of ``size`` all-padding entries on
        group 0's table, uploaded from the host as a step's are. All
        plain fulls: nothing is stored, the tables stay as they were."""
        dev = self.device
        packed = torch.full((4, 2, 8), spec.NUM_FEATURES, dtype=torch.int16)
        zeros = torch.zeros((size,), dtype=torch.int32)
        parents = torch.full((size,), -1, dtype=torch.int32)
        z = zeros.to(dev, non_blocking=True)
        values, _, _ = self._eval_fn(
            self._params, packed.to(dev, non_blocking=True), z,
            parents.to(dev, non_blocking=True),
            z if self._material_buf is not None else None,
            self._anchor_tabs[0], 0, self._psqt_tabs[0], offsets=z,
        )
        values.cpu()

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
        SearchCounters) and this service's dispatch accounting."""
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
        else:
            out["dispatches"] = out["eval_steps"]
            out["fused_dispatches"] = 0
            out["coalesced_steps"] = 0
            out["fused_dedup"] = 0
        # The async pipeline's in-flight count and busy/dual integrals
        # (microseconds; dual / busy is its overlap ratio).
        out["inflight_dispatches"] = 0
        out["overlap_busy_us"] = 0
        out["overlap_dual_us"] = 0
        for pipe in self._async_pipes:
            out["inflight_dispatches"] += pipe.inflight()
            with pipe._lock:
                out["overlap_busy_us"] += int(pipe._busy_s * 1e6)
                out["overlap_dual_us"] += int(pipe._dual_s * 1e6)
        return out

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
        if any(th.is_alive() for th in self._threads):
            # Driver stuck: leak the pool rather than free memory a
            # thread still dereferences.
            return
        if self._pool:
            self._lib.fc_pool_free(self._pool)
            self._pool = None
        if self._tmp is not None:
            Path(self._tmp.name).unlink(missing_ok=True)
            self._tmp = None

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
        dev = self.device
        pk = self._packed_t[group, : rows + 4].to(dev, non_blocking=True)
        of = self._offset_t[group, :size].to(dev, non_blocking=True)
        bk = self._bucket_t[group, :size].to(dev, non_blocking=True)
        pa = self._parent_t[group, :size].to(dev, non_blocking=True)
        mat = (
            None if material is None
            else self._material_t[group, :size].to(dev, non_blocking=True)
        )
        acct = (
            size,
            (rows + 4) * 2 * 8 * 2 + size * 3 * 4,
            0 if mat is None else size * 4,
        )
        values, _, _ = self._eval_fn(
            self._params, pk, bk, pa, mat,
            self._anchor_tabs[group], rows, self._psqt_tabs[group],
            offsets=of,
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
        return (done, out, err), acct

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

        Cross-segment dedup (``plan_segment_dedup``, byte mode; off with
        FISHNET_NO_DEDUP=1): a plain full whose feature block duplicates
        an earlier one ships as a one-row sentinel in-batch delta, and
        its value is restored on the host from its original
        (``_FusedValues``). A dropped entry must store nothing, because
        the kernel stores inside the launch (there is no device fan-in
        before the stores here): checked below."""
        k_segs = len(tickets)
        groups = [tk.group for tk in tickets]
        size = self._eval_sizes[-1]
        for s in self._eval_sizes:
            if max(tk.n for tk in tickets) <= s:
                size = s
                break
        mat_on = self._material_buf is not None
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
        drops = refs = dups = None
        eff_rows = [tk.rows for tk in tickets]
        if self._dedup_fused and self._shares_a_block(tickets):
            drops, refs, pairs = plan_segment_dedup(
                [self._parent_buf[g] for g in groups],
                [self._bucket_buf[g] for g in groups],
                [self._offset_buf[g] for g in groups],
                [tk.n for tk in tickets],
                [self._packed_buf[g] for g in groups],
                [self._material_buf[g] for g in groups] if mat_on else None,
            )
            if pairs:
                for k, tk in enumerate(tickets):
                    parent = self._parent_buf[tk.group]
                    if any(parent[i] != -1 for i in drops[k]):
                        raise NativeCoreError(
                            "dedup dropped an entry other than a plain "
                            "full: its anchor store would be lost")
                    eff_rows[k] = tk.rows - 3 * len(drops[k])  # 4 -> 1 row
                dups = [(dk * size + di, sk * size + si)
                        for dk, di, sk, si in pairs]
                with self._coalescer._lock:
                    self._coalescer.deduped_evals += len(pairs)
        st = self._take_staging()
        try:
            handle = self._stage_and_launch(
                st, tickets, groups, size, eff_rows,
                drops if dups else None, refs)
            shared = _FusedValues(
                handle, lambda h: self._resolve_eval(k_segs * size, h), dups)
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

    def _take_staging(self) -> _Staging:
        """The next staging slot, locked. The dispatch last staged there
        is read back first: until then its uploads may still read the
        slot and its owners not yet have copied its values out."""
        with self._staging_lock:
            st = self._staging[self._staging_next % len(self._staging)]
            self._staging_next += 1
        st.lock.acquire()
        prev, st.holder = st.holder, None
        if prev is not None:
            try:
                prev.materialize()
            except NativeCoreError:
                pass  # its owners raise it when they resolve
        return st

    def _stage_and_launch(self, st: _Staging, tickets, groups, size: int,
                          eff_rows, drops, refs):
        """Write the fused wire into ``st``, upload it, launch, and queue
        the copies of the values and the error word back; returns the
        in-flight handle as ``_dispatch_eval`` does."""
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
            if st.material_t is not None:
                st.material_t.numpy()[k * size: (k + 1) * size] = \
                    self._material_buf[g][:size]
            bases[k] = pos
            span = eff_rows[k] + 4
            if drops is None or not drops[k]:
                st.packed[pos: pos + span] = self._packed_buf[g][:span]
            else:
                self._compact_segment(st.packed[pos: pos + span], g, tk.n,
                                      drops[k])
                parents[k, drops[k]] = np.asarray(refs[k], np.int32) << 1
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
        dev = self.device
        pk = st.packed_t[:pos].to(dev, non_blocking=True)
        of = st.offsets_t[:n_all].to(dev, non_blocking=True)
        bk = st.buckets_t[:n_all].to(dev, non_blocking=True)
        pa = st.parents_t[:n_all].to(dev, non_blocking=True)
        mat = (
            None if st.material_t is None
            else st.material_t[:n_all].to(dev, non_blocking=True)
        )
        n_tab = self._anchor_all.shape[0] * self._anchor_rows
        values, _, _ = self._eval_fn(
            self._params, pk, bk, pa, mat,
            self._anchor_all.view(n_tab, 2, spec.L1), pos,
            self._psqt_all.view(n_tab, 2, spec.NUM_PSQT_BUCKETS),
            offsets=of,
        )
        out = st.values_t[:n_all]
        if dev.type != "cuda":
            out.copy_(values)
            return None, out, None
        out.copy_(values, non_blocking=True)
        st.err_t.copy_(error_word(dev), non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return done, out, st.err_t

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

    def _bind_worker(self) -> None:
        """The pipeline workers' CUDA device is this service's (events
        and launches go to its default stream)."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _resolve_eval(self, n: int, handle) -> np.ndarray:
        """Block until a dispatched eval is done; contiguous int32 [n].
        Raises if the kernel refused an index or reference meanwhile.
        ``handle`` may also be a fused dispatch's slice, already read
        back (``_DispatchCoalescer.demand``)."""
        if isinstance(handle, np.ndarray):
            return np.array(handle[:n], dtype=np.int32)
        done, out, err = handle
        if done is not None:
            done.synchronize()
        if err is not None and int(err[0]) > self._err_base:
            raise NativeCoreError(
                f"ft_gather kernel refused {int(err[0]) - self._err_base} "
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
        # In-flight device evals per group: group -> (n, handle), the
        # handle a coalescer ticket when there is a coalescer. Resolve
        # group g's previous eval, wake its fibers, step them to new
        # leaves, dispatch (or park) the next eval — then move to group
        # g+1 while this one runs on the device.
        inflight: Dict[int, Tuple[int, object]] = {}
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
                 variant, token, stop_event, skill) = item
                if token in cancelled:
                    continue
                use_scalar = 1 if self.backend == "scalar" else 0
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
                p = _Pending(future, loop, time.monotonic(), token,
                             stop_event, t)
                # Under _lock: the event-loop side (watchdog, cancel,
                # poke) identity-checks this map before stopping a slot.
                with self._lock:
                    pending[slot] = p
                if movetime is not None:
                    loop.call_soon_threadsafe(
                        loop.call_later, movetime, self._maybe_stop, slot, p
                    )

            # close() may have raced the submission drain above: re-check
            # before any potentially long native step.
            with self._lock:
                if self._stopping:
                    continue

            stepped = 0
            for g in groups:
                if g in inflight:
                    n_prev, handle = inflight.pop(g)
                    if isinstance(handle, _CoalesceTicket):
                        # Flushes the coalescer if the ticket is still
                        # parked, then waits for its dispatch; the
                        # accounting rides the ticket to its owner.
                        arr = co.demand(handle)
                        self._apply_acct(t, handle.acct)
                    else:
                        arr = handle
                    values = self._resolve_eval(n_prev, arr)
                    rc = lib.fc_pool_provide(
                        self._pool, g,
                        values.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        n_prev,
                    )
                    if rc < 0:
                        raise NativeCoreError(
                            f"fc_pool_provide rejected {n_prev} values for "
                            f"group {g}: full-provide contract violated"
                        )
                # Advance this group's fibers; fill its eval batch.
                rows = ctypes.c_int32()
                n = lib.fc_pool_step(
                    self._pool, g, packed_ptrs[g], offset_ptrs[g],
                    bucket_ptrs[g], slot_ptrs[g],
                    parent_ptrs[g], material_ptrs[g], self._group_capacity,
                    0, ctypes.byref(rows),
                )
                stepped += n
                if n > 0:
                    if self._params is None:
                        raise NativeCoreError("no evaluator")  # pragma: no cover
                    if co is not None:
                        inflight[g] = (n, co.submit(g, n, rows.value))
                    else:
                        handle, acct = self._dispatch_eval(g, n, rows.value)
                        self._apply_acct(t, acct)
                        inflight[g] = (n, handle)

            # Harvest this thread's finished searches.
            for g in groups:
                while True:
                    slot = lib.fc_pool_next_finished(self._pool, g)
                    if slot < 0:
                        break
                    self._finish_slot(t, slot)

            if stepped == 0 and not inflight and all(
                lib.fc_pool_active(self._pool, g) == 0 for g in groups
            ):
                with self._lock:
                    idle = not self._submissions[t] and not self._stopping
                if idle:
                    self._wakes[t].wait(timeout=0.05)
                    self._wakes[t].clear()

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
        result = SearchResultData(
            lines=lines,
            best_move=bm.value.decode() or None,
            depth=depth.value,
            nodes=nodes.value,
            time_seconds=max(1e-6, time.monotonic() - pending.started),
        )
        pending.loop.call_soon_threadsafe(_set_res, pending.future, result)

    def _fail_all(self, t: int, err: Exception) -> None:
        """Resolve every outstanding future owned by thread ``t``:
        in-flight searches AND queued submissions, or their callers
        hang."""
        with self._lock:
            doomed = list(self._pending[t].values())
            self._pending[t].clear()
            submissions = self._submissions[t]
            self._submissions[t] = []
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
