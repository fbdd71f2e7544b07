"""The dispatch coalescer and the async pack/decode pipeline: the port of
the scheduling half of ``fishnet_tpu/search/service.py``.

When several pipeline groups have microbatches ready, the coalescer
fuses them into ONE segmented device dispatch instead of one dispatch
per group, so the fixed per-dispatch cost — on the GPU the host's
launch of the evaluator's kernels and the host-device round trip — is
paid once per fused batch. The async pipeline moves the flushes off
the driver threads onto a pack worker, which stages and launches them,
and a decode worker, which waits for their results; at most ``DEPTH``
dispatches are in flight.

Everything here is family-agnostic scheduling: it touches its owner
only through ``CoalesceBackend``. Left out against the JAX package: the
serving mesh (one shard here; the per-shard dictionaries keep their
shape for it), spans, cost attribution and metric families (the port
has no telemetry plane yet).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from fishnet_tpu_torch.chess.core import NativeCoreError


@dataclass(frozen=True)
class DispatchProbe:
    """Measured cost decomposition of one blocking device dispatch:
    ``fixed_ms`` is the payload-independent term (the host's launches,
    the round trip), ``marginal_ms_per_kslot`` the incremental cost of
    shipping and evaluating 1024 more entries. ``small``/``big`` record
    the probed batch sizes."""

    fixed_ms: float
    marginal_ms_per_kslot: float
    small: int = 0
    big: int = 0


def fit_dispatch_cost(t_small_s: float, t_big_s: float,
                      small_slots: int, big_slots: int) -> DispatchProbe:
    """Fit the two-point dispatch-cost model from two blocking-eval
    timings (seconds). Pure and deterministic."""
    per_slot_ms = (
        max(0.0, t_big_s - t_small_s) * 1e3
        / max(1, big_slots - small_slots)
    )
    fixed_ms = max(0.0, t_small_s * 1e3 - per_slot_ms * small_slots)
    return DispatchProbe(
        fixed_ms=round(fixed_ms, 3),
        marginal_ms_per_kslot=round(per_slot_ms * 1024, 4),
        small=int(small_slots),
        big=int(big_slots),
    )


def choose_coalesce_width(fixed_ms: float, marginal_ms_per_kslot: float,
                          slots_per_step: float, n_groups: int,
                          cap: int = 8) -> int:
    """How many ready group microbatches to fuse into one segmented
    dispatch. Deterministic: probe numbers and observed occupancy in,
    width out.

    Fusing w microbatches turns ``w * (fixed + payload)`` into
    ``fixed + w * payload``; the win per segment collapses once one
    segment's payload rivals the fixed cost, so the policy fuses until
    ``payload * w ~ fixed``: ``w = fixed // payload + 1``, clamped to
    [1, min(n_groups, cap)] and floored to a power of two (the JAX
    package's lattice of compiled segment counts; kept so both packages
    choose the same widths)."""
    limit = max(1, min(int(n_groups), int(cap)))
    if limit == 1 or fixed_ms <= 0:
        return 1
    payload_ms = (
        max(0.0, marginal_ms_per_kslot) * max(1.0, slots_per_step) / 1024.0
    )
    w = limit if payload_ms <= 0 else int(fixed_ms / payload_ms) + 1
    w = max(1, min(limit, w))
    return 1 << (w.bit_length() - 1)  # floor to a power of two


def _to_host(values) -> np.ndarray:
    """A result on the host: waits for a torch tensor on the device."""
    if hasattr(values, "cpu"):
        return values.cpu().numpy()
    return np.asarray(values)


def suggest_pipeline_depth(weights, size: int = 1024, rounds: int = 4,
                           eval_fn=None, return_probe: bool = False,
                           device=None):
    """Probe whether concurrent device dispatches overlap, and suggest a
    pipeline depth for SearchService: 4, 2 or 1 as the ratio of
    ``rounds`` blocking evals to the same evals queued together falls.

    The default evaluator is ``torch_eval.evaluate_batch`` with
    ``weights`` on ``device`` (``cuda`` unless asked for the CPU); an
    ``eval_fn(params, feats, buckets)`` of the caller's gets numpy
    inputs and no params. ``return_probe=True`` also times a SMALL batch and
    returns ``(depth, DispatchProbe)``, the fixed-versus-marginal cost
    that seeds the coalescer's width policy."""
    import torch

    from fishnet_tpu_torch.nnue import spec

    params = on = None
    if eval_fn is None:
        from fishnet_tpu_torch.nnue.torch_eval import (
            evaluate_batch,
            params_from_weights,
        )

        eval_fn = evaluate_batch
        params = params_from_weights(weights, device)
        on = params["ft_w"].device

    def batch(n):
        feats = np.full((n, 2, spec.MAX_ACTIVE_FEATURES), spec.NUM_FEATURES,
                        np.int32)
        buckets = np.zeros((n,), np.int32)
        if on is None:
            return feats, buckets
        return torch.from_numpy(feats).to(on), torch.from_numpy(buckets).to(on)

    feats, buckets = batch(size)
    _to_host(eval_fn(params, feats, buckets))  # warm
    big_times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        _to_host(eval_fn(params, feats, buckets))
        big_times.append(time.perf_counter() - t0)
    sequential = sum(big_times)

    t0 = time.perf_counter()
    outs = [eval_fn(params, feats, buckets) for _ in range(rounds)]
    for out in outs:
        _to_host(out)
    pipelined = time.perf_counter() - t0

    ratio = sequential / max(pipelined, 1e-9)
    depth = 4 if ratio >= 2.5 else 2 if ratio >= 1.6 else 1
    if not return_probe:
        return depth

    small = max(32, size // 16)
    feats_s, buckets_s = batch(small)
    _to_host(eval_fn(params, feats_s, buckets_s))  # warm
    small_times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        _to_host(eval_fn(params, feats_s, buckets_s))
        small_times.append(time.perf_counter() - t0)
    probe = fit_dispatch_cost(
        sorted(small_times)[len(small_times) // 2],
        sorted(big_times)[len(big_times) // 2],
        small, size,
    )
    return depth, probe


class _FusedValues:
    """One fused dispatch's [K * size] values, read back to the host ONCE
    for every segment owner (and the eager decode worker).

    ``handle`` is the backend's in-flight result and ``read`` turns it
    into an int32 numpy array, waiting for the device; ``read`` raises
    when the dispatch failed on the device (the kernel's error word grew),
    and then every owner's ``materialize`` raises. ``dups`` is the
    cross-segment dedup restore plan: each duplicate rode the wire as a
    one-row sentinel delta and computed garbage; its true value is its
    original's, patched here."""

    __slots__ = ("_handle", "_read", "_np", "_error", "_lock", "_dups")

    def __init__(self, handle, read: Callable[[object], np.ndarray],
                 dups=None) -> None:
        self._handle = handle
        self._read = read
        self._np: Optional[np.ndarray] = None
        self._error: Optional[Exception] = None
        self._dups = dups  # [(dst_flat, src_flat)] value overwrites
        self._lock = threading.Lock()

    def materialize(self) -> np.ndarray:
        with self._lock:
            if self._np is None and self._error is None:
                try:
                    arr = self._read(self._handle)
                except Exception as err:  # noqa: BLE001 - every owner re-raises
                    self._error = err
                else:
                    for dst, src in self._dups or ():
                        arr[dst] = arr[src]
                    self._np = arr
                self._handle = None
            if self._error is not None:
                raise NativeCoreError(
                    f"fused dispatch failed: {self._error}"
                ) from self._error
            return self._np


class _CoalesceTicket:
    """One group's ready microbatch, parked in the coalescer until it
    rides a (possibly fused) device dispatch. ``done`` is set by the
    flushing thread after ``values``/``acct`` (or ``error``) are
    assigned — the Event orders them across threads. After a FUSED
    dispatch ``values`` is a ``_FusedValues`` holder and
    ``start``/``seg_size`` locate this segment's slice."""

    __slots__ = ("group", "n", "rows", "values", "start", "seg_size",
                 "acct", "error", "done")

    def __init__(self, group: int, n: int, rows: int) -> None:
        self.group = group
        self.n = n
        self.rows = rows
        self.values = None
        self.start = 0
        self.seg_size = 0
        self.acct = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()


class CoalesceBackend:
    """The dispatch seam: what _DispatchCoalescer and
    _AsyncDispatchPipeline need from their owner (SearchService).

    Attributes
      ``_n_groups``       pipeline-group count
      ``driver_threads``  threads that call ``submit``/``demand``
      ``_latency_active`` > 0 while a best-move search is in flight
                          (suppresses the demand linger)
      ``_async_pipes``    per-shard _AsyncDispatchPipeline list (empty:
                          flushes run inline)
      ``_coalescer``      the _DispatchCoalescer (the pack worker runs
                          its ``_execute``)

    Methods
      ``_dispatch_eval(group, n, rows) -> (values, acct)`` — queue ONE
        group's microbatch on the device, without waiting.
      ``_dispatch_segmented(tickets)`` — queue one FUSED dispatch over
        several groups' microbatches; assigns each ticket's
        ``values``/``start``/``seg_size``/``acct``.
      ``_wait_values(values)`` — block until a solo dispatch's values
        are on the host (the decode worker's eager wait).
      ``_bind_worker()`` — called first on each pipeline worker thread.
    """

    _n_groups = 1
    driver_threads = 1
    _latency_active = 0
    _async_pipes: List["_AsyncDispatchPipeline"] = []

    def _dispatch_eval(self, group: int, n: int, rows: int):
        raise NotImplementedError

    def _dispatch_segmented(self, tickets: List[_CoalesceTicket]) -> None:
        raise NotImplementedError

    def _wait_values(self, values) -> None:
        raise NotImplementedError

    def _bind_worker(self) -> None:
        pass


class _DispatchCoalescer:
    """Fuses ready pipeline-group microbatches into segmented device
    dispatches to amortize the FIXED per-dispatch cost (DispatchProbe)
    across groups.

    Protocol: driver threads ``submit()`` each stepped group's
    microbatch and get a ticket back at once. A flush — one device
    dispatch covering every parked ticket — happens when the parked
    count reaches the policy width, or when an owner ``demand()``s a
    ticket that has not been dispatched yet (its next resolve). Work is
    never delayed past the moment its result is needed, and at width 1
    this is the dispatch-per-group loop.

    The width adapts: ``submit`` keeps an EMA of real entries per
    microbatch and ``choose_coalesce_width`` recomputes the width from
    the startup DispatchProbe. With several driver threads, ``demand``
    lingers a bounded moment (fixed_ms/16, capped at MAX_LINGER_S) so
    sibling threads' microbatches join the dispatch instead of each
    thread flushing its lone group. ``FISHNET_COALESCE_WIDTH`` pins the
    width; ``FISHNET_NO_COALESCE=1`` means SearchService builds none.
    """

    #: Never fuse more groups than this, whatever the probe says.
    MAX_WIDTH = 8

    #: Upper bound on the cross-thread linger (seconds).
    MAX_LINGER_S = 0.005

    def __init__(self, svc: CoalesceBackend,
                 pinned_width: Optional[int] = None) -> None:
        self._svc = svc
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # Per-shard pending state, as the JAX package keeps it for its
        # serving mesh; the port serves one device, shard 0.
        n_shards = 1
        self._n_shards = n_shards
        self._pending: Dict[int, List[_CoalesceTicket]] = {
            s: [] for s in range(n_shards)
        }
        self._pinned = pinned_width
        # Width override per shard (None = the probe policy decides).
        # Precedence: env pin > override > probe.
        self._override: Dict[int, Optional[int]] = {
            s: None for s in range(n_shards)
        }
        self._probe: Optional[DispatchProbe] = None
        self._occ_ema: Dict[int, Optional[float]] = {
            s: None for s in range(n_shards)
        }
        init_w = pinned_width if pinned_width is not None else 1
        self._widths: Dict[int, int] = {s: init_w for s in range(n_shards)}
        self._linger_s = (
            self.MAX_LINGER_S
            if pinned_width is not None and pinned_width > 1 else 0.0
        )
        if svc.driver_threads <= 1:
            self._linger_s = 0.0
        # Dispatch accounting under self._lock (one increment per
        # dispatch; counters() reads them).
        self.dispatches = 0
        self.fused_dispatches = 0
        self.coalesced_steps = 0
        self.deduped_evals = 0

    @property
    def width(self) -> int:
        """The widest per-shard policy width."""
        return max(self._widths.values())

    def set_probe(self, probe: DispatchProbe) -> None:
        with self._lock:
            self._probe = probe
            for s in range(self._n_shards):
                self._recompute_width(s)

    def set_width_override(self, width: Optional[int]) -> None:
        """Force the policy width (None clears back to the probe
        policy). An env pin (FISHNET_COALESCE_WIDTH) still wins."""
        with self._lock:
            for s in range(self._n_shards):
                self._override[s] = None if width is None else int(width)
                self._recompute_width(s)

    def _recompute_width(self, shard: int) -> None:
        # Caller holds self._lock.
        if self._pinned is not None:
            self._widths[shard] = max(1, min(self._pinned, self.MAX_WIDTH))
            return
        override = self._override.get(shard)
        if override is not None:
            self._widths[shard] = max(1, min(override, self.MAX_WIDTH))
            if self._svc.driver_threads > 1 and self._widths[shard] > 1:
                self._linger_s = self.MAX_LINGER_S
            return
        if self._probe is None:
            return  # width stays 1 until the warm-up probe lands
        slots = self._occ_ema[shard]
        if slots is None:
            slots = 1.0
        self._widths[shard] = choose_coalesce_width(
            self._probe.fixed_ms, self._probe.marginal_ms_per_kslot,
            slots, max(1, self._svc._n_groups), cap=self.MAX_WIDTH,
        )
        if self._svc.driver_threads > 1 and self._widths[shard] > 1:
            self._linger_s = min(
                self.MAX_LINGER_S, self._probe.fixed_ms / 1e3 / 16
            )

    def submit(self, group: int, n: int, rows: int) -> _CoalesceTicket:
        """Park a stepped group's microbatch; returns its ticket. Flushes
        (dispatches) on this thread when the policy width is reached."""
        ticket = _CoalesceTicket(group, n, rows)
        s = 0
        flush = None
        with self._lock:
            ema = self._occ_ema[s]
            self._occ_ema[s] = n if ema is None else 0.8 * ema + 0.2 * n
            self._recompute_width(s)
            self._pending[s].append(ticket)
            if len(self._pending[s]) >= self._widths[s]:
                flush, self._pending[s] = self._pending[s], []
            self._cond.notify_all()  # wake lingering demand()s
        if flush:
            self._flush(flush, s)
        return ticket

    def demand(self, ticket: _CoalesceTicket):
        """Block until ``ticket`` has been dispatched; returns its values
        (a solo dispatch's in-flight values, or this segment's slice of a
        fused dispatch's host array). Called by the owning driver when it
        needs the result: after a bounded linger for sibling threads'
        microbatches, flushes the parked list (the ticket included,
        unless another thread's flush already claimed it)."""
        if not ticket.done.is_set():
            s = 0
            # Lane-aware: no linger while a best-move search is in
            # flight (racy read; worst case one lingered dispatch).
            if self._linger_s > 0.0 and self._svc._latency_active == 0:
                deadline = time.monotonic() + self._linger_s
                with self._cond:
                    while (
                        ticket in self._pending[s]
                        and len(self._pending[s]) < self._widths[s]
                    ):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(remaining)
            with self._lock:
                flush, self._pending[s] = self._pending[s], []
            if flush:
                self._flush(flush, s)
        ticket.done.wait()
        if ticket.error is not None:
            raise NativeCoreError(
                f"coalesced dispatch failed: {ticket.error!r}"
            ) from ticket.error
        values = ticket.values
        if isinstance(values, _FusedValues):
            whole = values.materialize()
            return whole[ticket.start: ticket.start + ticket.seg_size]
        return values

    def _flush(self, tickets: List[_CoalesceTicket], shard: int = 0) -> None:
        """Dispatch a flush batch: handed to the shard's pack worker when
        the async pipeline is up, else executed on this thread."""
        pipes = self._svc._async_pipes
        pipe = pipes[shard] if shard < len(pipes) else None
        if pipe is not None and pipe.submit(tickets):
            return
        self._execute(tickets)

    def _execute(self, tickets: List[_CoalesceTicket]) -> None:
        svc = self._svc
        try:
            if len(tickets) == 1:
                tk = tickets[0]
                tk.values, tk.acct = svc._dispatch_eval(tk.group, tk.n,
                                                        tk.rows)
            else:
                svc._dispatch_segmented(tickets)
        except BaseException as err:  # noqa: BLE001 - delivered to every owner
            for tk in tickets:
                tk.error = err
                tk.done.set()
            if not isinstance(err, Exception):
                raise  # KeyboardInterrupt and friends still unwind here
            return
        with self._lock:
            self.dispatches += 1
            if len(tickets) > 1:
                self.fused_dispatches += 1
                self.coalesced_steps += len(tickets)
        for tk in tickets:
            tk.done.set()


class _AsyncDispatchPipeline:
    """Double-buffered async dispatch: a pack worker and a decode worker
    that turn the coalescer's flushes into a pipeline of at most
    ``depth`` dispatches in flight.

    The coalescer stays the scheduling stage (which microbatches fuse
    into which dispatch); executing a flush moves off the driver
    threads onto the PACK worker, which stages the wire (concatenation,
    padding, cross-segment dedup), queues the upload, the launch and the
    copy of the results back, and marks every ticket done. The DECODE
    worker then waits for each dispatch's results in FIFO order, so by
    the time an owner demands its slice the values are on the host.

    Depth: a dispatch stages only after the one ``depth`` places before
    it has been read back (the semaphore). The staging buffers are the
    backend's (SearchService keeps a ring of MAX_DEPTH slots and reads
    a slot's last dispatch back before writing the slot again).

    Merging (the port's, not the JAX package's): when the pack worker
    takes a flush, every flush that queued up behind it joins the same
    dispatch, up to the coalescer's width. On the GPU the fixed cost of
    a dispatch is the host's own work on this one thread, so with many
    driver threads their demand-time flushes arrive faster than it
    issues them, each holding a group or two; a flush that waits in the
    queue could not start any earlier, so merging costs it nothing.
    With an empty queue every flush is dispatched as the coalescer
    formed it.

    Failure semantics are the coalescer's: a flush that raises fails
    every ticket in its batch, and the error reaches each owner at
    demand() time. ``FISHNET_NO_ASYNC=1`` means the service builds none.
    """

    #: Two dispatches in flight unless set_depth re-tunes it.
    DEPTH = 2

    #: Ceiling of the tunable depth, and the size of the staging ring.
    MAX_DEPTH = 4

    def __init__(self, svc: CoalesceBackend) -> None:
        self._svc = svc
        self._lock = threading.Lock()
        self._pack_q: "queue.Queue" = queue.Queue()
        self._decode_q: "queue.Queue" = queue.Queue()
        self._slots = threading.Semaphore(self.DEPTH)
        # The semaphore holds `_depth` permits; deepening releases more,
        # shallowing books a deficit that _release() absorbs.
        self._depth = self.DEPTH
        self._depth_deficit = 0
        self._stopping = False
        self._dead: Optional[BaseException] = None
        # Overlap accounting: busy = wall time with >= 1 dispatch in
        # flight, dual = with >= 2.
        self._inflight = 0
        self._last_ts = 0.0
        self._busy_s = 0.0
        self._dual_s = 0.0
        self._pack_thread = threading.Thread(
            target=self._pack_loop, name="dispatch-pack", daemon=True
        )
        self._decode_thread = threading.Thread(
            target=self._decode_loop, name="dispatch-decode",
            daemon=True,
        )
        self._pack_thread.start()
        self._decode_thread.start()

    # -- scheduling-stage API (driver threads / coalescer) ----------------

    def submit(self, tickets: List[_CoalesceTicket]) -> bool:
        """Enqueue one flush batch for the pack worker. False once the
        pipeline is down (the coalescer then flushes inline, so shutdown
        never strands a ticket)."""
        with self._lock:
            if self._stopping or self._dead is not None:
                return False
        self._pack_q.put(tickets)
        return True

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def depth(self) -> int:
        with self._lock:
            return self._depth

    def set_depth(self, depth: int) -> None:
        """Re-tune the in-flight depth (bounded 1..MAX_DEPTH); nothing
        blocks waiting for the pipeline to shrink."""
        depth = max(1, min(self.MAX_DEPTH, int(depth)))
        with self._lock:
            delta = depth - self._depth
            self._depth = depth
            if delta > 0:
                cancel = min(self._depth_deficit, delta)
                self._depth_deficit -= cancel
                release = delta - cancel
            else:
                self._depth_deficit += -delta
                release = 0
        for _ in range(release):
            self._slots.release()

    def close(self, timeout: float = 10.0) -> None:
        with self._lock:
            self._stopping = True
        self._pack_q.put(None)
        self._pack_thread.join(timeout=timeout)
        self._decode_q.put(None)
        self._decode_thread.join(timeout=timeout)
        self._fail_queued(NativeCoreError("async dispatch pipeline shut down"))

    # -- worker internals --------------------------------------------------

    def _mark(self, delta: int) -> None:
        """Transition the in-flight count, integrating busy/dual time."""
        now = time.monotonic()
        with self._lock:
            if self._inflight > 0:
                dt = now - self._last_ts
                self._busy_s += dt
                if self._inflight > 1:
                    self._dual_s += dt
            self._inflight += delta
            self._last_ts = now

    def _release(self) -> None:
        with self._lock:
            if self._depth_deficit > 0:
                self._depth_deficit -= 1
                return
        self._slots.release()

    def _fail_queued(self, err: BaseException) -> None:
        """Fail every ticket still parked in either queue: demand() must
        raise, never hang, once the workers are gone."""
        for q in (self._pack_q, self._decode_q):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    continue
                for tk in item:
                    if not tk.done.is_set():
                        tk.error = err
                        tk.done.set()

    def _merge_queued(self, tickets: List[_CoalesceTicket], cap: int):
        """``tickets`` plus the flushes queued behind them, up to ``cap``
        tickets; returns (tickets, the first flush left queued or the
        close sentinel, else False)."""
        tickets = list(tickets)
        while len(tickets) < cap:
            try:
                item = self._pack_q.get_nowait()
            except queue.Empty:
                break
            if item is None or len(tickets) + len(item) > cap:
                return tickets, item
            tickets.extend(item)
        return tickets, False

    def _pack_loop(self) -> None:
        co = self._svc._coalescer
        self._svc._bind_worker()
        held = False  # a flush taken off the queue but not yet merged
        while True:
            item = self._pack_q.get() if held is False else held
            if item is None:
                return
            self._slots.acquire()  # wait until fewer than depth in flight
            tickets, held = self._merge_queued(
                item, max(len(item), co.width))
            try:
                co._execute(tickets)
            except BaseException as err:  # noqa: BLE001 - pipeline teardown
                # _execute already failed the batch's tickets; only
                # non-Exception errors unwind to here. Mark the pipeline
                # dead so later flushes run inline, then re-raise.
                self._release()
                with self._lock:
                    self._dead = err
                self._fail_queued(err)
                raise
            if tickets and tickets[0].error is not None:
                self._release()  # nothing went to the device
                continue
            self._mark(+1)
            self._decode_q.put(tickets)

    def _decode_loop(self) -> None:
        self._svc._bind_worker()
        while True:
            tickets = self._decode_q.get()
            if tickets is None:
                return
            try:
                values = tickets[0].values
                if isinstance(values, _FusedValues):
                    values.materialize()
                else:
                    self._svc._wait_values(values)
            except Exception:  # noqa: BLE001 - owners re-raise at resolve
                # The owners' own resolve raises the same device error
                # (a driver crash), so nothing is swallowed here.
                pass
            self._mark(-1)
            self._release()
