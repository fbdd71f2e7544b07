"""Shared-memory ring transport: one mmap'd link file per frontend.

The port of ``fishnet_tpu/rpc/rings.py``, pure standard library plus
numpy, and the same link-file format: magic ``FNRPCLK1``,
version 1, a 4096-byte header and 40-byte record headers, so a link
file written by one package reads in the other.

The split boundary is a plain file in ``FISHNET_RPC_DIR``, created by
the frontend and discovered by the evaluator host's directory scan: no
sockets, no broker, no cross-process locks. Each link carries two SPSC
rings of fixed-size slots:

* **submit ring**: the frontend writes, the host reads (position
  microbatches as self-contained records, the full padded dense arrays,
  so a record can be re-executed verbatim after a crash on either side);
* **result ring**: the host writes, the frontend reads (ticket-tagged
  values).

Every record carries a seqlock word (odd = write in progress) and a
checksum over its payload and header fields, so a torn write from a
killed peer, or a record clobbered by a reattaching writer, reads as a
MISS (the reader skips it and counts ``torn``), never as a wrong value.
Flow control is the SPSC head/tail pair in the link header: each word
has exactly one writer, so plain monotonic stores suffice.

Fencing:

* the **frontend epoch** stamps every submit record. A restarted
  frontend reattaching to its predecessor's link file bumps it; the host
  refuses records carrying a stale epoch (``stale_refusals``) and the
  frontend drops result records of an earlier life.
* the **host epoch** bumps on every host attach. A frontend whose
  in-flight ticket outlives the epoch it was submitted under knows the
  evaluator died and resubmits the kept payload: a demand timeout
  surfaces as a requeue, not a hang.
* **heartbeats** (one f64 per side, wall clock) drive the lease: the
  host detaches and unlinks a link whose frontend stopped beating.

Knobs: ``FISHNET_RPC`` gates the split path, ``FISHNET_RPC_DIR`` places
the link files, ``FISHNET_RPC_RING_SLOTS`` and ``FISHNET_RPC_SLOT_BYTES``
size the rings, ``FISHNET_RPC_TIMEOUT`` bounds a frontend's total wait
for one result. The counters (``note``/``stats()``) feed the JAX
package's ``fishnet_rpc_*`` registry families (``_collect_rpc``),
registered at the first link or ``set_role``.
"""

from __future__ import annotations

import mmap
import os
import tempfile
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

#: Master gate: "1" makes build_search_service construct the remote
#: (split-plane) backend; unset/anything else keeps the monolith.
RPC_ENV = "FISHNET_RPC"
#: Directory holding the per-frontend link files; default: one per uid
#: in the system tempdir.
RPC_DIR_ENV = "FISHNET_RPC_DIR"
#: Slots per ring (submit and result each).
RING_SLOTS_ENV = "FISHNET_RPC_RING_SLOTS"
#: Bytes per ring slot (record header + payload must fit).
SLOT_BYTES_ENV = "FISHNET_RPC_SLOT_BYTES"
#: Frontend-side total wait bound (seconds) for one eval result.
TIMEOUT_ENV = "FISHNET_RPC_TIMEOUT"

_MAGIC = 0x46_4E_52_50_43_4C_4B_31  # "FNRPCLK1"
_VERSION = 1
_HEADER_BYTES = 4096
_U64 = (1 << 64) - 1
_MIX = 0x9E3779B97F4A7C15  # splitmix64 odd constant

DEFAULT_RING_SLOTS = 8
DEFAULT_SLOT_BYTES = 4 << 20
DEFAULT_TIMEOUT_S = 120.0
#: A frontend past this many seconds without a heartbeat is dead to the
#: host (lease expiry: staged work dropped, link detached); a host past
#: it is dead to the frontend (resubmit on the next epoch).
LEASE_S = 10.0

_HEADER_DTYPE = np.dtype([
    ("magic", "<u8"),
    ("version", "<u4"),
    ("ring_slots", "<u4"),
    ("slot_bytes", "<u4"),
    ("frontend_pid", "<u4"),
    ("host_pid", "<u4"),
    ("_pad", "<u4"),
    ("frontend_epoch", "<u8"),
    ("host_epoch", "<u8"),
    ("frontend_heartbeat", "<f8"),
    ("host_heartbeat", "<f8"),
    ("submit_head", "<u8"),
    ("submit_tail", "<u8"),
    ("result_head", "<u8"),
    ("result_tail", "<u8"),
])

#: Per-record header inside a slot; payload bytes follow immediately.
_REC_DTYPE = np.dtype([
    ("seq", "<u4"),
    ("kind", "<u4"),
    ("ticket", "<u8"),
    ("epoch", "<u8"),
    ("n", "<u4"),
    ("nbytes", "<u4"),
    ("check", "<u8"),
])
REC_HEADER_BYTES = _REC_DTYPE.itemsize
assert REC_HEADER_BYTES == 40

KIND_NNUE_SUBMIT = 1
KIND_AZ_SUBMIT = 2
KIND_NNUE_RESULT = 3
KIND_AZ_RESULT = 4

#: Bytes one entry takes on the dense NNUE submit record: 64 uint16
#: feature indices, then the bucket, parent and material int32s.
NNUE_ENTRY_BYTES = 2 * 32 * 2 + 3 * 4

#: One AZ submit row: the uint8 input planes of one position.
AZ_PLANE_SHAPE = (8, 8, 19)


def rpc_enabled() -> bool:
    """The master hatch, read per call so tests can monkeypatch env."""
    return os.environ.get(RPC_ENV, "") == "1"


def rpc_dir() -> str:
    uid = getattr(os, "getuid", lambda: 0)()
    return os.environ.get(RPC_DIR_ENV) or os.path.join(
        tempfile.gettempdir(), f"fishnet-rpc-{uid}"
    )


def _env_int(name: str, default: int, floor: int = 1) -> int:
    try:
        return max(floor, int(os.environ.get(name, default)))
    except ValueError:
        return default


def ring_slots() -> int:
    return _env_int(RING_SLOTS_ENV, DEFAULT_RING_SLOTS, floor=2)


def slot_bytes() -> int:
    return _env_int(
        SLOT_BYTES_ENV, DEFAULT_SLOT_BYTES, floor=REC_HEADER_BYTES + 64
    )


def timeout_s() -> float:
    try:
        return max(1.0, float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S)))
    except ValueError:
        return DEFAULT_TIMEOUT_S


def _check_words(payload: np.ndarray) -> int:
    """XOR-fold of the payload viewed as u64 words (zero-padded tail)."""
    words = payload.view(np.uint8)
    pad = (-len(words)) % 8
    if pad:
        words = np.concatenate([words, np.zeros(pad, np.uint8)])
    if len(words) == 0:
        return 0
    return int(np.bitwise_xor.reduce(words.view(np.uint64))) & _U64


def _record_check(kind: int, ticket: int, epoch: int, n: int,
                  nbytes: int, payload: np.ndarray) -> int:
    """Record checksum: header fields mixed with the payload fold, so any
    interleaving of a dead writer's half-published stores fails it with
    overwhelming probability."""
    acc = _check_words(payload)
    acc ^= (kind * _MIX) & _U64
    acc ^= ticket & _U64
    acc ^= (epoch * _MIX) & _U64
    acc ^= ((n << 32) | nbytes) & _U64
    return acc & _U64


class RingFull(RuntimeError):
    """A bounded push found no free slot within its deadline."""


class RecordTooLarge(ValueError):
    """A payload exceeds the link's slot size (raise FISHNET_RPC_SLOT_BYTES)."""


class RingLink:
    """One attached link file: header + submit ring + result ring.

    Exactly one frontend and one host attach a link at a time; each ring
    is SPSC between them (submit: frontend writes / host reads; result:
    host writes / frontend reads). All writes from one side go through
    one thread at a time (the frontend's client lock, the host's sweep),
    matching the single-writer contract the head/tail words require.
    """

    def __init__(self, path: str, mm: mmap.mmap, role: str) -> None:
        assert role in ("frontend", "host")
        self.path = path
        self.role = role
        self._mm = mm
        self._header = np.frombuffer(mm, dtype=_HEADER_DTYPE, count=1)
        self._slots = int(self._header["ring_slots"][0])
        self._slot_bytes = int(self._header["slot_bytes"][0])
        ring_bytes = self._slots * self._slot_bytes
        self._submit = np.frombuffer(
            mm, dtype=np.uint8, count=ring_bytes, offset=_HEADER_BYTES
        )
        self._result = np.frombuffer(
            mm, dtype=np.uint8, count=ring_bytes,
            offset=_HEADER_BYTES + ring_bytes,
        )
        self._closed = False
        _track_link(self)

    # -- header accessors --------------------------------------------------

    def _h(self, field: str) -> int:
        return int(self._header[field][0])

    def depth(self, ring: str) -> int:
        """Records currently queued (written, not yet consumed)."""
        if ring == "submit":
            return self._h("submit_head") - self._h("submit_tail")
        return self._h("result_head") - self._h("result_tail")

    @property
    def frontend_epoch(self) -> int:
        return self._h("frontend_epoch")

    @property
    def host_epoch(self) -> int:
        return self._h("host_epoch")

    @property
    def slot_capacity(self) -> int:
        """Largest payload one slot can carry."""
        return self._slot_bytes - REC_HEADER_BYTES

    def beat(self) -> None:
        """Refresh this side's heartbeat (wall clock: comparable across
        processes, unlike monotonic)."""
        field = (
            "frontend_heartbeat" if self.role == "frontend"
            else "host_heartbeat"
        )
        self._header[field] = time.time()

    def peer_age(self) -> float:
        """Seconds since the peer's last heartbeat (inf if it never
        beat)."""
        field = (
            "host_heartbeat" if self.role == "frontend"
            else "frontend_heartbeat"
        )
        t = float(self._header[field][0])
        return float("inf") if t <= 0.0 else max(0.0, time.time() - t)

    # -- record write ------------------------------------------------------

    def _ring_for(self, writer: bool) -> Tuple[np.ndarray, int, str, str]:
        """(ring bytes, its offset in the file, head field, tail field)
        of this side's outgoing (``writer``) or incoming ring: the
        frontend writes submits and reads results, the host the
        reverse."""
        if (self.role == "frontend") == writer:
            return self._submit, _HEADER_BYTES, "submit_head", "submit_tail"
        return (self._result, _HEADER_BYTES + self._slots * self._slot_bytes,
                "result_head", "result_tail")

    def push(self, kind: int, ticket: int, epoch: int, n: int,
             payload: bytes, deadline_s: float = 5.0) -> None:
        """Publish one record on this side's outgoing ring; blocks (a
        bounded spin) while the ring is full. Raises :class:`RingFull`
        past the deadline and :class:`RecordTooLarge` for a payload no
        slot can hold: sizing errors fail loudly, never truncate."""
        pay = np.frombuffer(payload, dtype=np.uint8)
        if len(pay) > self.slot_capacity:
            raise RecordTooLarge(
                f"{len(pay)}-byte record exceeds the {self.slot_capacity}-"
                f"byte slot payload capacity; raise {SLOT_BYTES_ENV}"
            )
        ring, ring_off, head_f, tail_f = self._ring_for(writer=True)
        deadline = time.monotonic() + deadline_s
        while self._h(head_f) - self._h(tail_f) >= self._slots:
            if time.monotonic() >= deadline:
                raise RingFull(
                    f"{self.path}: {head_f.split('_')[0]} ring full "
                    f"({self._slots} slots) for {deadline_s:.1f}s"
                )
            time.sleep(0.0005)
        head = self._h(head_f)
        base = (head % self._slots) * self._slot_bytes
        rec = np.frombuffer(self._mm, dtype=_REC_DTYPE, count=1,
                            offset=ring_off + base)
        s = int(rec["seq"][0])
        rec["seq"] = ((s + 1) | 1) & 0xFFFFFFFF  # odd: mid-write
        rec["kind"] = kind
        rec["ticket"] = ticket & _U64
        rec["epoch"] = epoch & _U64
        rec["n"] = n
        rec["nbytes"] = len(pay)
        start = base + REC_HEADER_BYTES
        ring[start: start + len(pay)] = pay
        rec["check"] = _record_check(kind, ticket, epoch, n, len(pay), pay)
        rec["seq"] = (((s + 1) | 1) + 1) & 0xFFFFFFFF  # even: published
        del rec
        self._header[head_f] = head + 1
        _count(f"push.{head_f.split('_')[0]}", 1)

    # -- record read -------------------------------------------------------

    def drain(self, limit: int = 64) -> List[Tuple[int, int, int, int, bytes]]:
        """Consume up to ``limit`` validated records from this side's
        incoming ring: ``[(kind, ticket, epoch, n, payload), ...]``.
        Torn or checksum-rejected records are SKIPPED (counted as
        ``torn``: a miss the submitter re-pays, never a wrong value)."""
        ring, ring_off, head_f, tail_f = self._ring_for(writer=False)
        out: List[Tuple[int, int, int, int, bytes]] = []
        while len(out) < limit and self._h(tail_f) < self._h(head_f):
            tail = self._h(tail_f)
            base = (tail % self._slots) * self._slot_bytes
            rec = np.frombuffer(self._mm, dtype=_REC_DTYPE, count=1,
                                offset=ring_off + base)
            s1 = int(rec["seq"][0])
            kind = int(rec["kind"][0])
            ticket = int(rec["ticket"][0])
            epoch = int(rec["epoch"][0])
            n = int(rec["n"][0])
            nbytes = int(rec["nbytes"][0])
            check = int(rec["check"][0])
            valid = (
                s1 % 2 == 0 and s1 != 0
                and 0 <= nbytes <= self.slot_capacity
            )
            payload = b""
            if valid:
                start = base + REC_HEADER_BYTES
                payload = bytes(ring[start: start + nbytes])
                valid = (
                    int(rec["seq"][0]) == s1
                    and check == _record_check(
                        kind, ticket, epoch, n, nbytes,
                        np.frombuffer(payload, dtype=np.uint8),
                    )
                )
            del rec
            # Consume the slot either way: a torn record is a dead
            # writer's tombstone, and leaving it would wedge the ring.
            self._header[tail_f] = tail + 1
            if valid:
                out.append((kind, ticket, epoch, n, payload))
            else:
                _count("torn", 1)
        return out

    def close(self) -> None:
        """Unmap the link. The numpy views over the map are dropped
        first: ``mmap.close()`` refuses (BufferError) while any is
        alive."""
        if self._closed:
            return
        self._closed = True
        _links.discard(self)
        if _collector_token is not None:
            # A scrape reading this link's depths ends before the map
            # goes (the registry's scrape lock), and no later one sees
            # the link.
            from fishnet_tpu_torch.telemetry.registry import REGISTRY

            REGISTRY.scrape_barrier()
        self._header = None
        self._submit = self._result = None
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass


# -- attach / create ---------------------------------------------------------


def _link_size(slots: int, sbytes: int) -> int:
    return _HEADER_BYTES + 2 * slots * sbytes


def create_frontend_link(directory: Optional[str] = None,
                         name: Optional[str] = None) -> RingLink:
    """Create (or reattach) THIS frontend's link file and return the
    frontend-side handle. A fresh file publishes its header with the
    magic LAST; reattaching to an existing file (a restarted frontend)
    bumps the frontend epoch so the host fences every record of the
    previous life."""
    directory = directory or rpc_dir()
    os.makedirs(directory, mode=0o700, exist_ok=True)
    name = name or f"link-{os.getpid()}.ring"
    path = os.path.join(directory, name)
    slots = ring_slots()
    sbytes = slot_bytes()
    size = _link_size(slots, sbytes)
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
    try:
        existing = os.fstat(fd).st_size
        if existing == 0:
            os.ftruncate(fd, size)
            mm = mmap.mmap(fd, size)
            header = np.frombuffer(mm, dtype=_HEADER_DTYPE, count=1)
            header["version"] = _VERSION
            header["ring_slots"] = slots
            header["slot_bytes"] = sbytes
            header["frontend_pid"] = os.getpid() & 0xFFFFFFFF
            header["frontend_epoch"] = 1
            header["frontend_heartbeat"] = time.time()
            header["magic"] = _MAGIC
            _count("attach.create", 1)
        else:
            mm = mmap.mmap(fd, existing)
            _validate_mapped(path, mm, existing)
            header = np.frombuffer(mm, dtype=_HEADER_DTYPE, count=1)
            header["frontend_pid"] = os.getpid() & 0xFFFFFFFF
            header["frontend_epoch"] = int(header["frontend_epoch"][0]) + 1
            header["frontend_heartbeat"] = time.time()
            _count("attach.reattach", 1)
        del header
    finally:
        os.close(fd)
    return RingLink(path, mm, role="frontend")


def attach_host_link(path: str) -> RingLink:
    """Attach the evaluator host to a discovered link file. Raises
    ``ValueError`` on a foreign or torn header: the host's scan skips
    the file rather than serving garbage."""
    fd = os.open(path, os.O_RDWR)
    try:
        existing = os.fstat(fd).st_size
        if existing < _HEADER_BYTES:
            raise ValueError(f"{path}: not an rpc link file")
        mm = mmap.mmap(fd, existing)
        _validate_mapped(path, mm, existing)
        header = np.frombuffer(mm, dtype=_HEADER_DTYPE, count=1)
        header["host_pid"] = os.getpid() & 0xFFFFFFFF
        header["host_heartbeat"] = time.time()
        del header
    finally:
        os.close(fd)
    return RingLink(path, mm, role="host")


def bump_host_epoch(links: List[RingLink]) -> None:
    """One attach-generation tick across every discovered link: the
    fencing signal frontends use to detect an evaluator rebirth."""
    for link in links:
        link._header["host_epoch"] = int(link._header["host_epoch"][0]) + 1


def _validate_mapped(path: str, mm: mmap.mmap, size: int) -> None:
    """``_validate_header`` on a copy of the mapped header; unmaps and
    raises ``ValueError`` when it fails (no view of the map outlives
    the check, or the unmap would refuse)."""
    try:
        _validate_header(
            path, np.frombuffer(mm, dtype=_HEADER_DTYPE, count=1).copy(),
            size)
    except ValueError:
        mm.close()
        raise


def _validate_header(path: str, header: np.ndarray, size: int) -> None:
    if int(header["magic"][0]) != _MAGIC:
        raise ValueError(f"{path}: not an rpc link file")
    if int(header["version"][0]) != _VERSION:
        raise ValueError(f"{path}: rpc link version mismatch")
    slots = int(header["ring_slots"][0])
    sbytes = int(header["slot_bytes"][0])
    if slots < 2 or sbytes <= REC_HEADER_BYTES or (
        size < _link_size(slots, sbytes)
    ):
        raise ValueError(f"{path}: rpc link geometry mismatch")


# -- wire payload codecs -----------------------------------------------------
# NNUE submits carry the exact padded dense arrays the service's
# external-evaluator seam produces (search/service.py _dispatch_eval),
# so the host replays them through evaluate_batch verbatim; AZ records
# carry the exact uint8 plane wire / fp16 logits wire the shared AZ plane
# uses, so a remote round trip reconstructs bit-identical fp32 values.


def pack_nnue_submit(feats: np.ndarray, buckets: np.ndarray,
                     parents: np.ndarray, material: np.ndarray) -> bytes:
    n = len(buckets)
    assert feats.shape == (n, 2, 32)
    return (
        np.ascontiguousarray(feats, np.uint16).tobytes()
        + np.ascontiguousarray(buckets, np.int32).tobytes()
        + np.ascontiguousarray(parents, np.int32).tobytes()
        + np.ascontiguousarray(material, np.int32).tobytes()
    )


def unpack_nnue_submit(
    payload: bytes, n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read-only views of a submit record: feats uint16 [n, 2, 32],
    buckets, parents and material int32 [n]. Raises ``ValueError`` when
    the payload is not ``n`` entries long."""
    if len(payload) != n * NNUE_ENTRY_BYTES:
        raise ValueError(
            f"nnue submit of {n} entries holds {len(payload)} bytes, "
            f"want {n * NNUE_ENTRY_BYTES}")
    fb = n * 2 * 32 * 2
    feats = np.frombuffer(payload, np.uint16, count=n * 64).reshape(n, 2, 32)
    buckets = np.frombuffer(payload, np.int32, count=n, offset=fb)
    parents = np.frombuffer(payload, np.int32, count=n, offset=fb + 4 * n)
    material = np.frombuffer(payload, np.int32, count=n, offset=fb + 8 * n)
    return feats, buckets, parents, material


def pack_nnue_result(values: np.ndarray) -> bytes:
    return np.ascontiguousarray(values, np.int32).tobytes()


def unpack_nnue_result(payload: bytes, n: int) -> np.ndarray:
    return np.frombuffer(payload, np.int32, count=n).copy()


def pack_az_submit(planes_u8: np.ndarray) -> bytes:
    return np.ascontiguousarray(planes_u8, np.uint8).tobytes()


def unpack_az_submit(payload: bytes, n: int) -> np.ndarray:
    """A read-only view of an AZ submit record: uint8 planes [n, 8, 8,
    19]. Raises ``ValueError`` when the payload is not ``n`` rows long."""
    row = int(np.prod(AZ_PLANE_SHAPE))
    if len(payload) != n * row:
        raise ValueError(f"az submit of {n} rows holds {len(payload)} "
                         f"bytes, want {n * row}")
    return np.frombuffer(payload, np.uint8).reshape((n,) + AZ_PLANE_SHAPE)


def pack_az_result(logits_f16: np.ndarray, values_f32: np.ndarray) -> bytes:
    return (
        np.ascontiguousarray(logits_f16, np.float16).tobytes()
        + np.ascontiguousarray(values_f32, np.float32).tobytes()
    )


def unpack_az_result(payload: bytes, n: int,
                     policy_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """fp16 logits [n, policy_size] and float32 values [n] (read-only
    views of ``payload``)."""
    logits = np.frombuffer(
        payload, np.float16, count=n * policy_size
    ).reshape(n, policy_size)
    values = np.frombuffer(
        payload, np.float32, count=n, offset=n * policy_size * 2
    )
    return logits, values


# -- module counters ---------------------------------------------------------
# A process-lifetime counter dict, read through stats() and exported as
# the fishnet_rpc_* families by _collect_rpc.

_count_lock = threading.Lock()
_counts: Dict[str, int] = {}
_role: Optional[str] = None
_links: "weakref.WeakSet[RingLink]" = weakref.WeakSet()
_collector_token: Optional[int] = None


def _count(key: str, n: int) -> None:
    with _count_lock:
        _counts[key] = _counts.get(key, 0) + n


def note(key: str, n: int = 1) -> None:
    """Public counter hook for the client and host layers
    (``submits.nnue``, ``results.az``, ``stale_refusals``,
    ``resubmits``, ``detach.lease``, ``fused.rows.az``, ...)."""
    _count(key, n)


def stats() -> Dict[str, int]:
    with _count_lock:
        return dict(_counts)


def set_role(role: str) -> None:
    """Declare this process's split-plane role (``frontend`` |
    ``evaluator``); the ``fishnet_rpc_role`` gauge reads it."""
    global _role
    _role = role
    _ensure_collector()


def _track_link(link: "RingLink") -> None:
    _links.add(link)
    _ensure_collector()


def _ensure_collector() -> None:
    global _collector_token
    with _count_lock:
        if _collector_token is not None:
            return
        from fishnet_tpu_torch.telemetry.registry import REGISTRY

        _collector_token = REGISTRY.register_collector(
            _collect_rpc, name="rpc-transport"
        )


def _collect_rpc() -> Optional[List]:
    """The ``fishnet_rpc_*`` families over ``stats()`` and the live
    links' ring depths."""
    from fishnet_tpu_torch.telemetry.registry import counter_family, gauge_family

    with _count_lock:
        snap = dict(_counts)
    fams = []
    for family in ("nnue", "az"):
        fams.append(counter_family(
            "fishnet_rpc_submits_total",
            "Eval microbatch records pushed onto submit rings, by "
            "family.",
            snap.get(f"submits.{family}", 0),
            labels={"family": family},
        ))
        fams.append(counter_family(
            "fishnet_rpc_results_total",
            "Eval result records pushed onto result rings, by family.",
            snap.get(f"results.{family}", 0),
            labels={"family": family},
        ))
        fams.append(counter_family(
            "fishnet_rpc_fused_rows_total",
            "Real eval rows the host dispatched, by family (over "
            "fishnet_rpc_fused_slots_total = cross-process batch fill).",
            snap.get(f"fused.rows.{family}", 0),
            labels={"family": family},
        ))
        fams.append(counter_family(
            "fishnet_rpc_fused_slots_total",
            "Padded bucket slots the host dispatched, by family.",
            snap.get(f"fused.slots.{family}", 0),
            labels={"family": family},
        ))
    fams.append(counter_family(
        "fishnet_dispatch_pad_rows_total",
        "Padding slots shipped in device dispatches (bucket size minus "
        "real entries), by dispatch path.",
        snap.get("pad.rows", 0),
        labels={"path": "host"},
    ))
    fams.append(counter_family(
        "fishnet_rpc_torn_total",
        "Ring records skipped by the seqlock/checksum validation (a "
        "SIGKILLed peer's torn write reads as a miss, never a value).",
        snap.get("torn", 0),
    ))
    fams.append(counter_family(
        "fishnet_rpc_stale_refusals_total",
        "Submit records refused for carrying a fenced (pre-restart) "
        "frontend epoch.",
        snap.get("stale_refusals", 0),
    ))
    fams.append(counter_family(
        "fishnet_rpc_reattach_total",
        "Link attach/reattach events (create = fresh link file, "
        "reattach = epoch-bumping rebirth, host = evaluator attach).",
        snap.get("attach.create", 0)
        + snap.get("attach.reattach", 0)
        + snap.get("attach.host", 0),
    ))
    for reason in ("lease", "fault"):
        fams.append(counter_family(
            "fishnet_rpc_detach_total",
            "Links the host dropped, by reason (lease = dead frontend, "
            "fault = injected rpc.detach).",
            snap.get(f"detach.{reason}", 0),
            labels={"reason": reason},
        ))
    fams.append(counter_family(
        "fishnet_rpc_resubmits_total",
        "Microbatches re-submitted after an evaluator epoch change or "
        "stale host heartbeat (the requeue-not-hang contract).",
        snap.get("resubmits", 0),
    ))
    if _role is not None:
        fams.append(gauge_family(
            "fishnet_rpc_role",
            "This process's split-plane role (1 = active role label).",
            1,
            labels={"role": _role},
        ))
    for link in list(_links):
        if link._closed:
            continue
        name = os.path.basename(link.path)
        for ring in ("submit", "result"):
            fams.append(gauge_family(
                "fishnet_rpc_ring_depth",
                "Records queued (written, unconsumed) per link ring.",
                link.depth(ring),
                labels={"link": name, "ring": ring},
            ))
    return fams
