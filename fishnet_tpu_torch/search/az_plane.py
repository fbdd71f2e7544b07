"""Shared AZ dispatch plane: MCTS leaf traffic on the port's coalescer.

The port of ``fishnet_tpu/search/az_plane.py``. The AZ family's leaf
microbatches ride the same scheduling spine the NNUE family uses: the
plane is a ``CoalesceBackend`` (search/coalesce.py) owning one
``_DispatchCoalescer``, lazily started ``_AsyncDispatchPipeline``s and
the tower; each MctsPool registers a COALESCE LANE and pushes its
per-step leaf microbatch through ``evaluate()``. The fleet position tier
is not ported (``FISHNET_POSITION_TIER=1`` raises, as in the NNUE
service).

Shards (``devices=``, parallel/mesh.py ``serving_devices``): a replica
of the tower per shard, a ``ShardRouter`` over the lanes, and per shard
its own rung, async pipeline and staging rings per ``(shard,
bucket)``; every shard's CUDA ladder starts at ``CUDA_MIN_BUCKET``. A
shard past its last rung is drained onto its siblings. One device (the
default) is one shard, as before.

What the tests and ``chip_smoke.py`` pin:

* **Bucketed shapes, batch-shape invariant rows.** Every forward runs at
  a shape from a fixed ladder: powers of two from a floor up to the
  pool capacity. Padding rows are stale staging content, not zeroed:
  the net never mixes batch rows, so row i's logits and value are the
  same bits whatever the other rows hold and whatever the bucket — the
  claim that makes plane == private evaluator, warm == cold and
  speculation == none hold bit for bit. On the CPU that holds from 32
  rows up. On the H100, cuDNN picks its convolution algorithms by shape
  and the rows of a 32-, 64- or 128-row forward differ from the same
  rows at 256 and above (in the last bits of the bf16 logits), so on a
  CUDA device the ladder starts at 256 (``CUDA_MIN_BUCKET``, measured by
  ``chip_smoke.py``'s az phase, which holds every bucket of the ladder
  against the capacity's rows). cuDNN's autotuner stays off and its
  algorithms deterministic (:func:`configure_backends`).
* **fp16 wire, fp32 consumers.** The forward is the private evaluator's
  (uint8 planes in, fp16 logits and float32 values out); the plane
  converts fp16 -> fp32 when its owner reads the rows.
* **Pre-wire eval reuse.** Keys are ``az_position_key(zobrist,
  halfmove) ^ az_net_fingerprint(params)`` into the process-wide
  ``AzEvalCache``. A microbatch whose rows all hit never reaches the
  coalescer (a skipped dispatch); partial hits dispatch only the
  misses. Cached entries are the exact fp16 payload.
* **Its own three-rung ladder.** ``AZ_RUNGS = ("fused", "solo",
  "chunk")``: one fused dispatch -> one dispatch chain per segment ->
  minimum-bucket chunks. Every rung calls the same forward at bucket
  shapes, so degrading never changes results; past the last rung the
  error reaches the pools.
* **Speculative pad rows.** Pad rows the bucket already pays for carry
  queued child positions; their results land only in the cache.
* **Staging.** Per bucket a ring of pinned host slots (uint8 planes in,
  fp16 logits and float32 values out): one upload and one read-back
  (two copies, one event) per forward, and a slot's last forward is read
  back before the slot is written again.

``FISHNET_NO_SHARED_AZ_PLANE=1`` makes MctsPool build its private
evaluator (search/mcts.py) instead. No fallback: on a CUDA device the
forward runs on the card or the error reaches the caller.
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fishnet_tpu_torch import telemetry as _telemetry
from fishnet_tpu_torch.device import on_device, resolve_device
from fishnet_tpu_torch.models.az import params_from_jax, wire_forward
from fishnet_tpu_torch.models.az_encoding import POLICY_SIZE
from fishnet_tpu_torch.search import eval_cache as _eval_cache
from fishnet_tpu_torch.search.coalesce import (
    SHARD_DEGRADATIONS,
    CoalesceBackend,
    _AsyncDispatchPipeline,
    _DispatchCoalescer,
    _FusedValues,
    _SeqAllocator,
)
from fishnet_tpu_torch.telemetry import cost as _cost

__all__ = ["AZ_RUNGS", "AzDispatchPlane"]

#: The AZ degradation ladder; every rung gives the same bits.
AZ_RUNGS = ("fused", "solo", "chunk")

_U64 = (1 << 64) - 1

#: Smallest forward shape of the bucket ladder, by device type (module
#: docstring): the CPU's rows are the same at every shape; on the H100
#: cuDNN's rows agree with the capacity's from 256 rows up.
CPU_MIN_BUCKET = 32
CUDA_MIN_BUCKET = 256

#: Default speculative rows per dispatch when FISHNET_SPECULATION_BUDGET
#: is unset: speculation only rides slots the ladder already paid for.
DEFAULT_SPECULATION_BUDGET = 8


def speculation_disabled() -> bool:
    """``FISHNET_NO_SPECULATION=1``, read per call; also implied by the
    eval-cache hatch, since speculative results land only in the cache.
    With it set no pad row is repurposed."""
    return (
        _eval_cache.cache_disabled()
        or os.environ.get("FISHNET_NO_SPECULATION", "") == "1"
    )


def configure_backends(device=None) -> torch.device:
    """The AZ forward's device (``cuda`` unless asked for the CPU; a
    CUDA request without a GPU raises), with cuDNN's autotuner off, its
    algorithms deterministic and TF32 off: the same shape always runs
    the same algorithm, so a row's bits depend only on its bucket."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def _bucket_ladder(cap: int, floor: int = CPU_MIN_BUCKET) -> List[int]:
    """Forward shapes for a pool capacity: powers of two from ``floor``
    up to ``cap`` (a lone ``cap`` when it is not above the floor), so a
    late-search trickle of a few leaves pays a small forward."""
    buckets: List[int] = []
    b = floor
    while b < cap:
        buckets.append(b)
        b *= 2
    buckets.append(cap)
    return buckets


class _AzRows:
    """Materialised rows of a dispatch: fp16 logits [n, P] and float32
    values [n]. Sliceable, so the coalescer's per-segment slicing and the
    decode worker's eager materialize work on it unchanged."""

    __slots__ = ("logits16", "values")

    def __init__(self, logits16: np.ndarray, values: np.ndarray) -> None:
        self.logits16 = logits16
        self.values = values

    def __getitem__(self, sl: slice) -> "_AzRows":
        return _AzRows(self.logits16[sl], self.values[sl])


class _Slot:
    """One staging slot of a bucket: the planes to upload and, on the
    GPU, pinned host tensors for the read-back and its event."""

    __slots__ = ("planes", "logits", "values", "event", "chunk")

    def __init__(self, bucket: int, device: torch.device) -> None:
        cuda = device.type == "cuda"
        self.planes = torch.zeros((bucket, 8, 8, 19), dtype=torch.uint8,
                                  pin_memory=cuda)
        self.logits = self.values = self.event = None
        if cuda:
            self.logits = torch.empty((bucket, POLICY_SIZE),
                                      dtype=torch.float16, pin_memory=True)
            self.values = torch.empty((bucket,), dtype=torch.float32,
                                      pin_memory=True)
            self.event = torch.cuda.Event()
        self.chunk: Optional["_AzChunk"] = None


class _AzChunk:
    """One forward: ``k`` demand rows and the speculative rows parked
    after them (``spec_keys``). On the GPU its results sit in its slot's
    pinned tensors until ``fetch`` copies them out, which its owner's
    materialize does — or the slot's next user, before the slot is
    written again."""

    __slots__ = ("k", "bucket", "spec_keys", "_slot", "_out", "_lock")

    def __init__(self, k: int, bucket: int, spec_keys: tuple,
                 slot: Optional[_Slot], out=None) -> None:
        self.k = k
        self.bucket = bucket
        self.spec_keys = spec_keys
        self._slot = slot
        self._out = out  # (fp16 logits, float32 values), numpy
        self._lock = threading.Lock()

    def fetch(self) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            if self._out is None:
                slot = self._slot
                m = self.k + len(self.spec_keys)
                slot.event.synchronize()
                self._out = (slot.logits[:m].numpy().copy(),
                             slot.values[:m].numpy().copy())
                slot.chunk = None
                self._slot = None
            return self._out


class AzDispatchPlane(CoalesceBackend):
    """One dispatch spine for AZ leaf microbatches on one device.

    Several MctsPools may share one plane (one coalesce lane each, up to
    ``max_lanes``); each lane has at most one outstanding microbatch,
    because ``MctsPool.step`` is synchronous, so staged rows ride a
    plain per-lane dict.

    ``params`` is the JAX-layout dict of numpy arrays (models/az.py); its
    fingerprint salts the cache keys. ``force_rung`` pins every dispatch
    to one AZ_RUNGS index (the parity tests sweep all three);
    ``coalesce_width`` pins the coalescer's width (drivers of several
    pools set > 1 to see fusion; otherwise ``FISHNET_AZ_COALESCE_WIDTH``,
    else 1). Each lane is one pool on its own driver thread: once a
    second lane registers and the width is above 1, a lane's demand
    lingers up to ``_DispatchCoalescer.MAX_LINGER_S`` for a sibling
    lane's microbatch to join its dispatch, as the NNUE service's driver
    threads do.

    ``devices``: the plane's shards (``serving_devices``: ``"auto"``, an
    int, or a sequence, one device possibly twice); None is ``device``
    alone. Its first device must be ``device``."""

    def __init__(self, params: Dict, cfg, device=None, max_lanes: int = 8,
                 coalesce_width: Optional[int] = None,
                 force_rung: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> None:
        if (not _eval_cache.cache_disabled()
                and os.environ.get("FISHNET_POSITION_TIER", "") == "1"):
            raise NotImplementedError(
                "FISHNET_POSITION_TIER=1: the fleet position tier "
                "(fishnet_tpu/cluster/position_tier.py) is not ported to "
                "fishnet_tpu_torch yet; unset it")
        self.cfg = cfg
        self.device = configure_backends(device)
        self._cap = int(cfg.batch_capacity)
        floor = CUDA_MIN_BUCKET if self.device.type == "cuda" else CPU_MIN_BUCKET
        self._buckets = _bucket_ladder(self._cap, floor)
        self._n_groups = max_lanes
        devs = [self.device]
        if devices is not None:
            from fishnet_tpu_torch.parallel.mesh import serving_devices

            devs = serving_devices(devices, self.device.type)
            if devs[0] != self.device or any(
                    d.type != self.device.type for d in devs):
                raise ValueError(
                    f"plane devices {devs} must start with {self.device}, "
                    "all of its type")
        self._devices = devs
        self._n_shards = len(devs)
        # One tower per shard, built from the caller's numpy dict.
        self._nets = [params_from_jax(params, d) for d in devs]
        self._net = self._nets[0]
        if self._net.cfg != cfg.az:
            raise ValueError(f"params are a {self._net.cfg}, not {cfg.az}")
        self._salt = _eval_cache.az_net_fingerprint(params)
        self._router = None
        if self._n_shards > 1:
            from fishnet_tpu_torch.parallel.mesh import ShardRouter

            self._router = ShardRouter(max_lanes, self._n_shards)
        self._shard_rungs = [0] * self._n_shards
        self._degradations: List[Tuple[int, str, str]] = []
        self._forced_rung = force_rung
        self._no_async = os.environ.get("FISHNET_NO_ASYNC", "") == "1"
        self._async_pipes: List[Optional[_AsyncDispatchPipeline]] = (
            [] if self._no_async else [None] * self._n_shards)
        self._seq_alloc = _SeqAllocator()
        self._pipe_lock = threading.Lock()
        self._lane_lock = threading.Lock()
        self._next_lane = 0
        # lane -> staged uint8 miss rows of its ONE outstanding ticket.
        self._staged: Dict[int, np.ndarray] = {}
        self._staging_lock = threading.Lock()
        self._staging: Dict[Tuple[int, int], Tuple[List[_Slot], int]] = {}
        self._stats_lock = threading.Lock()
        self._prewire_hits = 0
        self._skipped_dispatches = 0
        self._rows_dispatched = 0
        self._slots_dispatched = 0
        self._forwards = 0
        self._bucket_forwards: Dict[int, int] = {b: 0 for b in self._buckets}
        self._pad_rows = 0
        self._spec_rows = 0
        # Speculative pad rows: a bounded FIFO of candidate positions
        # (salted key -> wire planes) parked in slots the ladder would
        # otherwise ship as padding; the budget 0 pins speculation off.
        self._spec_lock = threading.Lock()
        self._spec_queue: "OrderedDict[int, np.ndarray]" = OrderedDict()
        budget = _env_int("FISHNET_SPECULATION_BUDGET")
        self._spec_budget = (
            DEFAULT_SPECULATION_BUDGET if budget is None else max(0, budget))
        self._closed = False
        # Cost-plane tenant tag for this plane's dispatches (telemetry/
        # cost.py): AZ leaf traffic is selfplay by default; a serving
        # deployment mixing tenants can re-tag per plane.
        self.cost_tenant = "selfplay"
        self._coalescer = _DispatchCoalescer(self, pinned_width=(
            coalesce_width if coalesce_width is not None
            else _env_int("FISHNET_AZ_COALESCE_WIDTH")))
        ref = weakref.ref(self)

        def _collect():
            plane = ref()
            if plane is None or plane._closed:
                return None  # self-unregister
            return plane._families()

        self._collector_token = _telemetry.REGISTRY.register_collector(
            _collect, name="az-dispatch-plane")

    # -- lane API (MctsPool side) -----------------------------------------

    def register_lane(self) -> int:
        with self._lane_lock:
            if self._next_lane >= self._n_groups:
                raise ValueError(
                    f"az plane lanes exhausted ({self._n_groups}); "
                    "raise max_lanes or share lanes across fewer pools")
            lane = self._next_lane
            self._next_lane += 1
            self.driver_threads = self._next_lane
            co = self._coalescer
            if self.driver_threads > 1 and co.width > 1:
                co._linger_s = co.MAX_LINGER_S
            return lane

    @property
    def buckets(self) -> List[int]:
        return list(self._buckets)

    # -- speculation --------------------------------------------------------

    def speculation_budget(self) -> int:
        with self._spec_lock:
            return self._spec_budget

    def set_speculation_budget(self, budget: int) -> None:
        """Re-bound the speculative pad-row fill; 0 pins it off."""
        with self._spec_lock:
            self._spec_budget = max(0, int(budget))

    def offer_speculation(self, rows: np.ndarray, keys: Sequence[int]) -> int:
        """Queue candidate positions for future pad rows: ``rows[i]`` is
        the uint8 wire planes of UNSALTED key ``keys[i]``. Cached and
        already queued keys are dropped; the queue keeps the newest 4x
        budget. Returns how many were accepted."""
        if speculation_disabled():
            return 0
        with self._spec_lock:
            budget = self._spec_budget
        if budget <= 0:
            return 0
        cache = _eval_cache.get_az_cache()
        accepted = 0
        for i, key in enumerate(keys):
            salted = (int(key) ^ self._salt) & _U64
            if cache is not None and cache.contains(salted):
                continue
            with self._spec_lock:
                if salted in self._spec_queue:
                    continue
                self._spec_queue[salted] = np.array(rows[i], copy=True)
                accepted += 1
                while len(self._spec_queue) > 4 * budget:
                    self._spec_queue.popitem(last=False)
        return accepted

    def _take_speculation(self, room: int) -> List[Tuple[int, np.ndarray]]:
        """Pop up to ``min(room, budget)`` queued candidates (FIFO)."""
        if room <= 0 or speculation_disabled():
            return []
        out: List[Tuple[int, np.ndarray]] = []
        with self._spec_lock:
            take = min(room, self._spec_budget)
            while take > 0 and self._spec_queue:
                out.append(self._spec_queue.popitem(last=False))
                take -= 1
        return out

    def _land_speculation(self, spec_keys, lg16, vals) -> None:
        """Materialize-time sink: speculative rows' exact fp16 payload
        into the cache, so their next probe is a pre-wire hit."""
        cache = _eval_cache.get_az_cache()
        if cache is None:
            return
        for j, key in enumerate(spec_keys):
            cache.insert(key, (np.array(lg16[j], np.float16),
                               np.float32(vals[j])))

    # -- evaluation -----------------------------------------------------------

    def warmup(self) -> None:
        """Run every bucket's shape once on every shard (cuDNN and the
        allocator warm up before the first real dispatch)."""
        for net, dev in zip(self._nets, self._devices):
            for bucket in self._buckets:
                with on_device(dev):
                    planes = torch.zeros((bucket, 8, 8, 19),
                                         dtype=torch.uint8, device=dev)
                    _logits, values = wire_forward(net, planes)
                    values.cpu()

    def evaluate(self, lane: int, planes_u8: np.ndarray, n: int,
                 keys: Optional[Sequence[int]] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Evaluate ``planes_u8[:n]`` (uint8 wire planes) for ``lane``.
        Returns ``(logits_f32 [n, POLICY_SIZE], values_f32 [n])`` in row
        order. ``keys`` are UNSALTED ``az_position_key`` ints enabling the
        pre-wire cache; None disables reuse for this call."""
        out_logits = np.empty((n, POLICY_SIZE), np.float32)
        out_values = np.empty((n,), np.float32)
        if n == 0:
            return out_logits, out_values
        cache = _eval_cache.get_az_cache() if keys is not None else None
        miss = list(range(n))
        salted: Optional[List[int]] = None
        if cache is not None:
            salted = [(int(k) ^ self._salt) & _U64 for k in keys]
            miss = []
            hits = 0
            for i, ent in enumerate(cache.probe_many(salted)):
                if ent is None:
                    miss.append(i)
                else:
                    lg16, val = ent
                    out_logits[i] = lg16.astype(np.float32)
                    out_values[i] = val
                    hits += 1
            with self._stats_lock:
                self._prewire_hits += hits
                if not miss:
                    self._skipped_dispatches += 1
            if not miss:
                return out_logits, out_values
        if len(miss) == n:
            rows = np.array(planes_u8[:n], copy=True)
        else:
            rows = planes_u8[np.asarray(miss, np.intp)]  # fancy-index copy
        self._ensure_pipe()
        self._staged[lane] = rows
        try:
            # Cost plane (telemetry/cost.py): AZ leaf traffic is all one
            # workload family, owned by the plane's cost_tenant.
            owners = ([((self.cost_tenant, "selfplay"), len(miss))]
                      if _cost.enabled() else None)
            ticket = self._coalescer.submit(lane, len(miss), rows=len(miss),
                                            owners=owners)
            # demand() waits and raises dispatch errors; its slice uses
            # seg_size (0 on solo tickets), so the plane slices by n.
            self._coalescer.demand(ticket)
        finally:
            self._staged.pop(lane, None)
        seg = ticket.values.materialize()[ticket.start: ticket.start + ticket.n]
        idx = np.asarray(miss, np.intp)
        out_logits[idx] = seg.logits16.astype(np.float32)
        out_values[idx] = seg.values
        if cache is not None:
            for j, i in enumerate(miss):
                cache.insert(salted[i], (seg.logits16[j].copy(),
                                         np.float32(seg.values[j])))
        return out_logits, out_values

    # -- CoalesceBackend surface --------------------------------------------

    def _shard_of(self, lane: int) -> int:
        return self._router.shard_of(lane) if self._router else 0

    def _dispatch_eval(self, group: int, n: int, rows: int):
        seg = self._staged.pop(group)
        holder = self._run_rungs(self._shard_of(group), group, [seg])
        return holder, {"n": n, "wire_bytes": int(seg.nbytes)}

    def _dispatch_segmented(self, tickets) -> None:
        segs = [self._staged.pop(tk.group) for tk in tickets]
        group = tickets[0].group
        holder = self._run_rungs(self._shard_of(group), group, segs)
        off = 0
        for tk, seg in zip(tickets, segs):
            tk.values = holder
            tk.start = off
            tk.seg_size = len(seg)
            tk.acct = {"n": tk.n, "wire_bytes": int(seg.nbytes)}
            off += len(seg)

    def _bind_worker(self, shard: int = 0) -> None:
        dev = self._devices[shard]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)

    # -- dispatch internals ---------------------------------------------------

    def _ensure_pipe(self) -> None:
        """Start every shard's pipeline at the first dispatch (a lane the
        router re-homes at its first traffic finds its shard's up)."""
        if self._no_async or self._async_pipes[-1] is not None:
            return
        with self._pipe_lock:
            for s, pipe in enumerate(self._async_pipes):
                if pipe is None and not self._closed:
                    self._async_pipes[s] = _AsyncDispatchPipeline(
                        self, shard=s, seq_alloc=self._seq_alloc)

    def _run_rungs(self, shard: int, group: int,
                   segs: List[np.ndarray]) -> _FusedValues:
        """One dispatch under the AZ ladder of ``shard``: on failure the
        shard steps down a rung (past its last rung it is drained and the
        dispatch moves to ``group``'s new shard) and the dispatch runs
        again — every rung gives the same bits. With a forced rung, or
        with no shard left, the error reaches the owners."""
        while True:
            rung = (self._forced_rung if self._forced_rung is not None
                    else self._shard_rungs[shard])
            try:
                return self._execute_rung(shard, rung, segs)
            except Exception as err:  # noqa: BLE001 - the ladder decides
                if self._forced_rung is not None:
                    raise
                shard = self._degrade(shard, group, err, rung)

    def _degrade(self, shard: int, group: int, err: Exception,
                 failed: int) -> int:
        """Step ``shard`` down its ladder from rung ``failed``, or drain
        it past the last rung; returns the shard the dispatch runs on
        next. Raises ``err`` when nothing is left."""
        with self._pipe_lock:
            rung = self._shard_rungs[shard]
            if rung > failed:
                return shard  # a sibling dispatch stepped it down already
            if rung < len(AZ_RUNGS) - 1:
                self._shard_rungs[shard] = rung + 1
                self._degradations.append(
                    (shard, AZ_RUNGS[rung], AZ_RUNGS[rung + 1]))
                SHARD_DEGRADATIONS.inc(**{
                    "shard": str(shard), "from": AZ_RUNGS[rung],
                    "to": AZ_RUNGS[rung + 1]})
                return shard
            router = self._router
            if router is None or len(router.alive_shards()) <= 1:
                raise err
            moved = router.drain(shard)
            self._degradations.append((shard, AZ_RUNGS[rung], "drained"))
            SHARD_DEGRADATIONS.inc(**{
                "shard": str(shard), "from": AZ_RUNGS[rung], "to": "drained"})
        self._coalescer.migrate(moved)
        return moved.get(group, router.shard_of(group))

    def _execute_rung(self, shard: int, rung: int,
                      segs: List[np.ndarray]) -> _FusedValues:
        if rung == 1 and len(segs) > 1:
            chunks: list = []
            for seg in segs:  # solo: one dispatch chain per segment
                chunks.extend(self._dispatch_chunks(shard, seg, self._cap))
        else:
            rows = segs[0] if len(segs) == 1 else np.concatenate(segs)
            limit = self._buckets[0] if rung == 2 else self._cap
            chunks = self._dispatch_chunks(shard, rows, limit)
        return _FusedValues(tuple(chunks), self._read_chunks)

    def _read_chunks(self, chunks) -> _AzRows:
        """A dispatch's demand rows, read back once; speculative rows go
        to the cache on the way."""
        logits, values = [], []
        for chunk in chunks:
            lg16, vals = chunk.fetch()
            k = chunk.k
            logits.append(lg16[:k])
            values.append(vals[:k])
            if chunk.spec_keys:
                self._land_speculation(chunk.spec_keys, lg16[k:], vals[k:])
        if len(chunks) == 1:
            return _AzRows(logits[0], values[0])
        return _AzRows(np.concatenate(logits), np.concatenate(values))

    def _dispatch_chunks(self, shard: int, rows: np.ndarray,
                         cap_limit: int) -> list:
        out = []
        off, total = 0, len(rows)
        while off < total:
            k = min(cap_limit, total - off)
            bucket = self._bucket_for(k)
            slot = self._slot(shard, bucket)
            buf = slot.planes.numpy()
            buf[:k] = rows[off: off + k]
            # Pad rows the bucket already pays for carry queued
            # speculative candidates at [k : k+s]; demand readers slice
            # [:k], so what rides the padding never changes them.
            spec = self._take_speculation(bucket - k)
            for j, (_skey, srow) in enumerate(spec):
                buf[k + j] = srow
            spec_keys = tuple(skey for skey, _srow in spec)
            out.append(self._forward(shard, slot, bucket, k, spec_keys))
            with self._stats_lock:
                self._forwards += 1
                self._bucket_forwards[bucket] += 1
                self._rows_dispatched += k
                self._slots_dispatched += bucket
                self._spec_rows += len(spec)
                self._pad_rows += bucket - k - len(spec)
            off += k
        return out

    def _forward(self, shard: int, slot: _Slot, bucket: int, k: int,
                 spec_keys: tuple) -> _AzChunk:
        """One forward of a staged slot on ``shard``'s tower: one upload,
        the tower, one read-back into the slot's pinned tensors (GPU); on
        the CPU the results are the forward's own tensors."""
        net, dev = self._nets[shard], self._devices[shard]
        if dev.type != "cuda":
            logits, values = wire_forward(net, slot.planes)
            return _AzChunk(k, bucket, spec_keys, None,
                            (logits.numpy(), values.numpy()))
        with on_device(dev):
            x = slot.planes.to(dev, non_blocking=True)
            logits, values = wire_forward(net, x)
            m = k + len(spec_keys)
            slot.logits[:m].copy_(logits[:m], non_blocking=True)
            slot.values[:m].copy_(values[:m], non_blocking=True)
            slot.event.record()
        chunk = _AzChunk(k, bucket, spec_keys, slot)
        slot.chunk = chunk
        return chunk

    def _bucket_for(self, k: int) -> int:
        for b in self._buckets:
            if b >= k:
                return b
        return self._buckets[-1]

    def _slot(self, shard: int, bucket: int) -> _Slot:
        """The next staging slot of ``(shard, bucket)`` (a ring of
        MAX_DEPTH), its last forward read back first."""
        depth = _AsyncDispatchPipeline.MAX_DEPTH
        key = (shard, bucket)
        with self._staging_lock:
            ring, idx = self._staging.get(key, (None, 0))
            if ring is None:
                dev = self._devices[shard]
                ring = [_Slot(bucket, dev) for _ in range(depth)]
            self._staging[key] = (ring, idx + 1)
        slot = ring[idx % depth]
        prev = slot.chunk
        if prev is not None:
            prev.fetch()
        return slot

    # -- stats ----------------------------------------------------------------

    def counters(self) -> Dict:
        co = self._coalescer
        with self._stats_lock:
            stats = {
                "prewire_hits": self._prewire_hits,
                "skipped_dispatches": self._skipped_dispatches,
                "rows_dispatched": self._rows_dispatched,
                "slots_dispatched": self._slots_dispatched,
                "forwards": self._forwards,
                "bucket_forwards": dict(self._bucket_forwards),
                "pad_rows": self._pad_rows,
                "spec_rows": self._spec_rows,
            }
        stats["speculation_budget"] = self.speculation_budget()
        stats["dispatch_fill"] = (
            stats["rows_dispatched"] / stats["slots_dispatched"]
            if stats["slots_dispatched"] else 0.0)
        with co._lock:
            stats["dispatches"] = co.dispatches
            stats["fused_dispatches"] = co.fused_dispatches
            stats["coalesced_steps"] = co.coalesced_steps
        stats["rung"] = AZ_RUNGS[
            self._forced_rung if self._forced_rung is not None
            else self._shard_rungs[0]]
        if self._router is not None:
            with co._lock:
                stats["shard_dispatches"] = list(co.shard_dispatches)
            with self._pipe_lock:
                stats["shard_rungs"] = [AZ_RUNGS[r]
                                        for r in self._shard_rungs]
                stats["degradations"] = list(self._degradations)
            stats["alive"] = self._router.alive_shards()
        return stats

    def _families(self):
        """The plane's registry families (the JAX plane's): its
        pre-wire cache hits, skipped dispatches, pad and speculative
        rows, and the speculation budget."""
        with self._stats_lock:
            hits = self._prewire_hits
            skipped = self._skipped_dispatches
            pad = self._pad_rows
            spec = self._spec_rows
        return [
            _telemetry.counter_family(
                "fishnet_eval_cache_hits_total",
                "Eval-cache hits by scope.",
                hits,
                labels={"scope": "prewire", "family": "az"},
            ),
            _telemetry.counter_family(
                "fishnet_az_skipped_dispatches_total",
                "AZ microbatches fully satisfied pre-wire (no dispatch).",
                skipped,
            ),
            _telemetry.counter_family(
                "fishnet_dispatch_pad_rows_total",
                "Padding slots shipped in device dispatches (bucket "
                "size minus real entries), by dispatch path.",
                pad,
                labels={"path": "az"},
            ),
            _telemetry.counter_family(
                "fishnet_az_speculative_rows_total",
                "Pad rows repurposed as speculative evals (results "
                "land in the cache/fleet tier).",
                spec,
            ),
            _telemetry.gauge_family(
                "fishnet_az_speculation_budget",
                "Current speculative rows-per-dispatch cap (control-"
                "plane actuator).",
                self.speculation_budget(),
            ),
        ]

    def close(self) -> None:
        """Tear down the pipeline and unregister the collector (under
        the registry's scrape lock: no scrape reads the plane after).
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        _telemetry.REGISTRY.unregister_collector(self._collector_token)
        with self._pipe_lock:
            pipes = [p for p in self._async_pipes if p is not None]
            self._async_pipes = [None] * len(self._async_pipes)
        for pipe in pipes:
            pipe.close()


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else None
    except ValueError:
        return None
