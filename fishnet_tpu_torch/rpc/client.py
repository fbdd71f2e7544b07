"""Frontend side of the split plane: a SearchService, and an AZ dispatch
plane, whose evaluator is another process.

The port of ``fishnet_tpu/rpc/client.py``. Two entry points, one per
search family:

:class:`RemoteBackend` IS a ``SearchService`` whose evaluator ships each
group's padded dense microbatch over this frontend's ring link instead
of evaluating it on a device of its own: the service's external-
evaluator seam (``search/service.py _dispatch_eval``) already produces
the self-contained arrays the wire carries, so the engines and the UCI
server ride unchanged. The evaluator returns a LAZY handle; the
service's ``_resolve_eval`` materialises it before the group's next
step, which keeps the per-group pipeline overlap across the process
boundary.

:class:`RemoteAzPlane` implements the AZ dispatch plane's lane API
(``register_lane``, ``warmup``, ``evaluate``, ``counters``, ``close``),
so ``MctsPool``'s ``hasattr(evaluator, "register_lane")`` wrap routes
its leaf microbatches over the same transport (self-play rides it
unchanged). Its rows cross as the plane's exact uint8 plane wire and
come back as its fp16 logits wire, behind the same salted pre-wire
probe of the process's AZ eval cache.

A frontend holds no device: it never resolves one, never creates a CUDA
context and never loads the kernel.

Failure contract: a demand wait survives an evaluator death by watching
the host epoch. When the evaluator is reborn (epoch bump) the client
cancels its groups' device anchors (``fc_pool_cancel_anchors``; a no-op
on this wire, which has none) and RESUBMITS the kept payload; only the
total ``FISHNET_RPC_TIMEOUT`` budget expiring surfaces, as
:class:`EvaluatorLostError`. A record the host refuses (a malformed
microbatch: a bad parent code, bucket or index) comes back as an empty
result and raises :class:`EvaluatorRefusedError` at once. Either error
fails the driver, and with it the service's searches. Results are
deduplicated by ticket id, so an at-least-once transport still yields
exactly-once consumption.

Spans: each answered ``wait`` records ``rpc_wait`` (ticket, family),
as the JAX frontend does — the one span site the JAX package records
without the ``telemetry.enabled()`` gate, kept so.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from fishnet_tpu_torch.chess.core import NativeCoreError
from fishnet_tpu_torch.rpc import rings
from fishnet_tpu_torch.search.service import SearchService
from fishnet_tpu_torch.telemetry.spans import RECORDER as _SPANS

__all__ = ["EvaluatorLostError", "EvaluatorRefusedError", "RemoteAzPlane",
           "RemoteBackend", "RemoteEvaluator"]

_U64 = (1 << 64) - 1


class EvaluatorLostError(NativeCoreError):
    """The evaluator host stayed unreachable past FISHNET_RPC_TIMEOUT."""


class EvaluatorRefusedError(NativeCoreError):
    """The evaluator host refused a submitted microbatch as malformed."""


class _RpcClient:
    """One frontend link: serialized submits, ticket table, demand
    waits. All ring writes go through ``_lock`` (the SPSC single-writer
    contract); results drain under the same lock and park in
    ``_results`` until their owner claims them."""

    def __init__(self, directory: Optional[str] = None,
                 name: Optional[str] = None) -> None:
        self._link = rings.create_frontend_link(directory, name=name)
        self._epoch = self._link.frontend_epoch
        self._tickets = itertools.count(1)
        self._lock = threading.Lock()
        self._results: Dict[int, Tuple[int, int, bytes]] = {}
        self._done: set = set()
        self._closed = False
        rings.set_role("frontend")

    @property
    def link(self) -> rings.RingLink:
        return self._link

    def submit(self, kind: int, n: int, payload: bytes) -> int:
        ticket = next(self._tickets)
        with self._lock:
            self._link.beat()
            self._link.push(kind, ticket, self._epoch, n, payload)
        family = "nnue" if kind == rings.KIND_NNUE_SUBMIT else "az"
        rings.note(f"submits.{family}")
        return ticket

    def _drain_locked(self) -> None:
        for kind, ticket, epoch, n, payload in self._link.drain():
            # Fenced results: a record answering a previous life of this
            # frontend, or a duplicate of one already claimed (a
            # resubmit can be answered twice), must not double-consume.
            if (epoch != self._epoch or ticket in self._results
                    or ticket in self._done):
                continue
            self._results[ticket] = (kind, n, payload)

    def wait(self, ticket: int, n: int, kind: int,
             payload: bytes) -> Tuple[int, int, bytes]:
        """Block until ``ticket``'s result lands. Resubmits the kept
        ``payload`` after an evaluator rebirth (host epoch moved) and
        raises :class:`EvaluatorLostError` only when the total timeout
        budget runs out: a requeue signal, never a silent hang."""
        t0 = time.monotonic()
        deadline = t0 + rings.timeout_s()
        host_epoch = self._link.host_epoch
        while True:
            with self._lock:
                self._link.beat()
                self._drain_locked()
                got = self._results.pop(ticket, None)
                if got is not None:
                    self._done.add(ticket)
                    if len(self._done) > 8192:
                        floor = ticket - 8192
                        self._done = {t for t in self._done if t > floor}
            if got is not None:
                _SPANS.record(
                    "rpc_wait", t0, ticket=ticket,
                    family="nnue" if kind == rings.KIND_NNUE_SUBMIT
                    else "az",
                )
                return got
            now_epoch = self._link.host_epoch
            if now_epoch != host_epoch:
                # The evaluator died and a successor attached: any
                # record it consumed without answering is gone, so fence
                # local device state and re-pay the submit.
                host_epoch = now_epoch
                self._on_evaluator_lost()
                with self._lock:
                    self._link.push(kind, ticket, self._epoch, n, payload)
                rings.note("resubmits")
            if time.monotonic() >= deadline:
                raise EvaluatorLostError(
                    f"rpc demand timeout: no result for ticket {ticket} "
                    f"within {rings.timeout_s():.0f}s "
                    f"(host heartbeat age {self._link.peer_age():.1f}s); "
                    "requeue the batch"
                )
            time.sleep(0.001)

    def _on_evaluator_lost(self) -> None:
        """Hook: RemoteBackend cancels its groups' device anchors."""

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        path = self._link.path
        self._link.close()
        try:
            os.unlink(path)
        except OSError:
            pass


class _PendingEval:
    """Lazy result handle for one in-flight NNUE microbatch: the
    service's ``_resolve_eval`` calls ``np.asarray`` on it before the
    group's next step, so the demand wait overlaps the other groups'
    fiber stepping as a device future would."""

    __slots__ = ("_client", "_ticket", "_n", "_payload", "_arr")

    def __init__(self, client: _RpcClient, ticket: int, n: int,
                 payload: bytes) -> None:
        self._client = client
        self._ticket = ticket
        self._n = n
        self._payload = payload
        self._arr: Optional[np.ndarray] = None

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        if self._arr is None:
            _kind, n, result = self._client.wait(
                self._ticket, self._n, rings.KIND_NNUE_SUBMIT,
                self._payload,
            )
            if n != self._n:
                raise EvaluatorRefusedError(
                    f"the evaluator host refused microbatch ticket "
                    f"{self._ticket} ({self._n} entries) as malformed; "
                    "its log names the fault")
            self._arr = rings.unpack_nnue_result(result, self._n)
            self._payload = b""  # free the kept bytes
        return self._arr if dtype is None else self._arr.astype(dtype)


class RemoteEvaluator:
    """The external-evaluator callable ``(params, feats, buckets,
    parents, material) -> lazy int32 [B]`` the service seam expects:
    packs the full padded microbatch into one self-contained submit
    record and returns a :class:`_PendingEval`."""

    def __init__(self, client: _RpcClient) -> None:
        self._client = client

    def __call__(self, params, feats, buckets, parents, material):
        n = len(buckets)
        payload = rings.pack_nnue_submit(feats, buckets, parents, material)
        ticket = self._client.submit(rings.KIND_NNUE_SUBMIT, n, payload)
        return _PendingEval(self._client, ticket, n, payload)


class RemoteBackend(SearchService):
    """A SearchService whose eval plane lives in another process.

    Construction takes SearchService's arguments (plus ``rpc_dir``, the
    link directory; default ``FISHNET_RPC_DIR``), without ``device``:
    the evaluator host holds the device. Analyses equal a monolith's on
    the host-material wire, because the host evaluates the exact dense
    microbatch through ``evaluate_batch``, and the integer evaluation of
    one entry does not depend on its batch."""

    def __init__(self, *args, rpc_dir: Optional[str] = None,
                 **kwargs) -> None:
        client = _RpcClient(rpc_dir)
        client._on_evaluator_lost = self._cancel_inflight_anchors
        self._rpc = client
        kwargs["evaluator"] = RemoteEvaluator(client)
        try:
            super().__init__(*args, **kwargs)
        except BaseException:
            client.close()
            raise

    def _cancel_inflight_anchors(self) -> None:
        """Evaluator death fences every group's device anchor state
        through the pool's cancellation path. The external-evaluator
        wire never enables persistent anchors (in-batch refs only), so
        this is a no-op today, kept so a future anchor-carrying wire
        inherits the fencing."""
        pool = getattr(self, "_pool", None)
        if not pool:
            return
        for group in range(self._n_groups):
            self._lib.fc_pool_cancel_anchors(pool, group)

    def close(self) -> None:
        try:
            super().close()
        finally:
            self._rpc.close()


class RemoteAzPlane:
    """The AZ dispatch plane's lane API over the ring transport.

    ``MctsPool`` wraps any evaluator exposing ``register_lane`` in its
    ``_PlaneEvaluator`` adapter, so handing this to a pool routes every
    leaf microbatch through the evaluator host, where microbatches from
    ALL frontends fuse into shared forwards. ``params`` (the JAX-layout
    dict, optional) only salts the pre-wire probe of the process's
    ``AzEvalCache``; the wire carries the exact uint8 planes and fp16
    logits the in-process plane uses, so the results are the same bits
    either way (the host runs the plane's forward at the plane's bucket
    shapes).

    A microbatch whose answer would not fit one ring slot (rows x (2 x
    policy + 4) bytes) goes as several records, all submitted before the
    first wait, so the host can still fuse them. Link names are per
    frontend: planes in one process must pass distinct ``link_name``s,
    or the second attach bumps the frontend epoch and fences the first
    plane's in-flight submits as stale."""

    def __init__(self, cfg, params: Optional[Dict] = None,
                 rpc_dir: Optional[str] = None,
                 link_name: Optional[str] = None) -> None:
        from fishnet_tpu_torch.search import eval_cache as _eval_cache

        self.cfg = cfg
        self._policy_size = cfg.az.policy_size
        self._client = _RpcClient(
            rpc_dir, name=link_name or f"link-{os.getpid()}-az.ring"
        )
        self._max_rows = max(1, self._client.link.slot_capacity
                             // (self._policy_size * 2 + 4))
        self._salt = None
        if params is not None and not _eval_cache.cache_disabled():
            self._salt = _eval_cache.az_net_fingerprint(params)
        self._lane_lock = threading.Lock()
        self._next_lane = 0
        self._stats_lock = threading.Lock()
        self._prewire_hits = 0
        self._skipped_dispatches = 0
        self._rows_submitted = 0
        self._records = 0
        self._dispatches = 0

    def register_lane(self) -> int:
        with self._lane_lock:
            lane = self._next_lane
            self._next_lane += 1
            return lane

    def _round_trip(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Ship ``rows`` (uint8 planes) as records of at most
        ``_max_rows``; the fp16 logits and float32 values in row order.
        Raises ``EvaluatorRefusedError`` when the host refused a record."""
        sent = []
        for off in range(0, len(rows), self._max_rows):
            part = rows[off: off + self._max_rows]
            payload = rings.pack_az_submit(part)
            ticket = self._client.submit(rings.KIND_AZ_SUBMIT, len(part),
                                         payload)
            sent.append((ticket, len(part), payload))
        logits, values = [], []
        for ticket, k, payload in sent:
            _kind, n, result = self._client.wait(
                ticket, k, rings.KIND_AZ_SUBMIT, payload)
            if n != k:
                raise EvaluatorRefusedError(
                    f"the evaluator host refused AZ microbatch ticket "
                    f"{ticket} ({k} rows); its log names the fault")
            lg16, vals = rings.unpack_az_result(result, k, self._policy_size)
            logits.append(lg16)
            values.append(vals)
        with self._stats_lock:
            self._rows_submitted += len(rows)
            self._records += len(sent)
            self._dispatches += 1
        if len(sent) == 1:
            return logits[0], values[0]
        return np.concatenate(logits), np.concatenate(values)

    def warmup(self) -> None:
        """One one-row round trip: proves the link is served before real
        traffic."""
        self._round_trip(np.zeros((1,) + rings.AZ_PLANE_SHAPE, np.uint8))

    def evaluate(
        self, lane: int, planes_u8: np.ndarray, n: int, keys=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """``planes_u8[:n]`` for ``lane`` -> ``(logits_f32 [n, P],
        values_f32 [n])`` in row order; with ``keys`` (UNSALTED
        ``az_position_key`` ints) and a salt, cache hits resolve before
        the wire and the misses' exact fp16 payload is inserted."""
        from fishnet_tpu_torch.search import eval_cache as _eval_cache

        out_logits = np.empty((n, self._policy_size), np.float32)
        out_values = np.empty((n,), np.float32)
        if n == 0:
            return out_logits, out_values
        cache = None
        salted = None
        miss = list(range(n))
        if keys is not None and self._salt is not None:
            cache = _eval_cache.get_az_cache()
        if cache is not None:
            salted = [(int(k) ^ self._salt) & _U64 for k in keys]
            miss = []
            hits = 0
            for i, ent in enumerate(cache.probe_many(salted)):
                if ent is None:
                    miss.append(i)
                    continue
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
        idx = np.asarray(miss, np.intp)
        logits16, values = self._round_trip(
            np.ascontiguousarray(planes_u8[idx]))
        out_logits[idx] = logits16.astype(np.float32)
        out_values[idx] = values
        if cache is not None:
            for j, i in enumerate(miss):
                # The exact fp16 wire payload: warm replays reconstruct
                # identical fp32 bits (the plane's contract).
                cache.insert(salted[i], (np.array(logits16[j], np.float16),
                                         np.float32(values[j])))
        return out_logits, out_values

    def counters(self) -> Dict[str, float]:
        """The client side's view: pre-wire hits, skipped dispatches,
        rows shipped, records and round trips (the host keeps the fill)."""
        with self._stats_lock:
            return {
                "prewire_hits": self._prewire_hits,
                "skipped_dispatches": self._skipped_dispatches,
                "rows_dispatched": self._rows_submitted,
                "records": self._records,
                "dispatches": self._dispatches,
            }

    def close(self) -> None:
        self._client.close()
