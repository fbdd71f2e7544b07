"""Fleet-wide position-eval tier: one shared segment for every process.

The port's copy of ``fishnet_tpu/cluster/position_tier.py``, numpy and
the standard library only. The segment format is the JAX package's byte
for byte (magic, version, header, slot dtypes, checksums, probe window),
so a segment written by a process of either package is read by the
other, and the salts the callers XOR in are equal for the same net
(``search/eval_cache.py`` ``net_fingerprint`` / ``az_net_fingerprint``).

The process-wide caches (``search/eval_cache.py``) stop at the process
boundary: each client the fleet supervisor spawns re-pays the same
popular-opening evals its siblings already computed. This module lifts
that reuse one level up — a single mmap'd fixed-slot table on the local
filesystem that every process attaches to (``FISHNET_POSITION_TIER=1``)
and probes pre-wire, right after its process-local cache misses. The
fallback ladder per position is strictly local -> fleet -> miss
(doc/eval-cache.md "Fleet tier").

Three keyspaces ride the same segment, mirroring the process caches:

* **NNUE region** — 32-byte slots keyed ``zobrist ^ net_fingerprint``
  holding the EXACT int32 static eval. Values are stored bit-exact (not
  quantized): substituting a fleet hit for a recomputed eval must keep
  analyses byte-identical, the same contract the process cache carries.
* **AZ region** — large slots keyed
  ``az_position_key ^ az_net_fingerprint`` holding the exact fp16
  policy row plus the float32 value — the same fp16 eval round-trip the
  ``AzEvalCache`` stores, so fleet hits reconstruct identical fp32
  bits.
* **Bounds region** (v2) — 48-byte slots keyed like the NNUE region
  holding full TT bound records ``(value, eval, depth, bound,
  best-move)`` in the native representation, so one frontend's search
  facts seed every sibling's pool TT (doc/eval-cache.md "Bounds
  tier"). Same-key replacement is deeper-entry-wins, matching the
  process ``BoundsCache``.

Cross-process safety WITHOUT cross-process locks: plain files have no
shared mutexes, so every slot carries a generation-stamped seqlock
(odd = write in progress) plus a checksum word over its payload.
Writers bump the seq odd, write the payload, write the checksum, bump
the seq even; readers snapshot the seq before and after, reject
odd/odd-changed snapshots, and reject any checksum mismatch — a torn
read (or two racing writers interleaving their stores) surfaces as a
plain miss, never as a wrong value. A writer SIGKILLed mid-write
leaves its slot odd; the next writer reclaims it (the bump-to-odd
always succeeds), so a crash costs one slot until its next insert, not
the segment. In-process, writes are additionally lock-striped
(64 ``threading.Lock`` stripes over the slot index space), matching
the process caches' striping discipline.

Ownership: every slot records the writer's pid, so a hit splits into
``scope="local"`` (this process wrote it — a snapshot-restored or
re-probed entry) vs ``scope="fleet"`` (another process paid the eval),
which is exactly the cross-process reuse the fleet bench gates on.

Attach is graceful: a missing/unwritable path, a foreign magic, a
version or geometry mismatch all fall back to tier-off (the process
keeps its local cache; ``fishnet_postier_attach_total{scope="local"}``
counts the fallback). Nothing here is a liveness dependency.

Callers, as in the JAX package: the search service attaches it with the
eval cache on and probes it for the NNUE and bounds rows the process
caches missed; the AZ dispatch plane attaches it when its policy width
matches; the scheduler's batch completion ticks its generation.
"""

from __future__ import annotations

import mmap
import os
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

#: Master gate (read at ``get_tier`` time): "1" attaches the shared
#: segment; anything else keeps eval reuse process-local.
TIER_ENV = "FISHNET_POSITION_TIER"
#: Segment file path; default: one per uid in the system tempdir.
TIER_PATH_ENV = "FISHNET_POSITION_TIER_PATH"
#: NNUE-region slot count (32 bytes each).
TIER_CAPACITY_ENV = "FISHNET_POSITION_TIER_CAPACITY"
#: AZ-region slot count (~9.4 KB each — fp16 policy payload).
TIER_AZ_CAPACITY_ENV = "FISHNET_POSITION_TIER_AZ_CAPACITY"
#: Bounds-region slot count (48 bytes each — full TT bound records).
TIER_BOUNDS_CAPACITY_ENV = "FISHNET_POSITION_TIER_BOUNDS_CAPACITY"

_MAGIC = 0x46_4E_50_54_49_45_52_31  # "FNPTIER1"
# v2: bounds region appended after the AZ region; header gains
# ``bounds_slots`` (doc/eval-cache.md "Bounds tier"). A v1 segment
# fails the version check and the process falls back tier-off — the
# same graceful-attach contract as any geometry mismatch.
_VERSION = 2
_HEADER_BYTES = 4096
_U64 = (1 << 64) - 1
_MIX = 0x9E3779B97F4A7C15  # splitmix64 odd constant (index mixing)

DEFAULT_NNUE_SLOTS = 1 << 16
DEFAULT_AZ_SLOTS = 256
DEFAULT_BOUNDS_SLOTS = 1 << 14
#: AZ policy width (models/az.py POLICY_SIZE); carried in the header so
#: an attach against a different architecture fails cleanly instead of
#: reading misaligned rows.
AZ_POLICY_SIZE = 4672

_PROBE_WINDOW = 8
_N_STRIPES = 64

_HEADER_DTYPE = np.dtype([
    ("magic", "<u8"),
    ("version", "<u4"),
    ("nnue_slots", "<u4"),
    ("az_slots", "<u4"),
    ("policy_size", "<u4"),
    ("bounds_slots", "<u4"),
    ("generation", "<u8"),
])

_NNUE_SLOT_DTYPE = np.dtype([
    ("key", "<u8"),
    ("value", "<i4"),
    ("owner", "<u4"),
    ("seq", "<u4"),
    ("gen", "<u4"),
    ("check", "<u8"),
])
assert _NNUE_SLOT_DTYPE.itemsize == 32

#: Bounds region: one full TT bound record per slot — value in the
#: native stored (value_to_tt) form, static eval, depth, bound type
#: (1=upper/2=lower/3=exact) and the 21-bit packed best move — the same
#: columns ``fc_pool_tt_fill_bound`` consumes, so a fleet hit seeds a
#: sibling's pool TT without any host-side decode.
_BOUNDS_SLOT_DTYPE = np.dtype([
    ("key", "<u8"),
    ("value", "<i4"),
    ("eval", "<i4"),
    ("depth", "<u4"),
    ("bound", "<u4"),
    ("move", "<u4"),
    ("owner", "<u4"),
    ("seq", "<u4"),
    ("gen", "<u4"),
    ("check", "<u8"),
])
assert _BOUNDS_SLOT_DTYPE.itemsize == 48


def _az_slot_dtype(policy_size: int) -> np.dtype:
    return np.dtype([
        ("key", "<u8"),
        ("owner", "<u4"),
        ("seq", "<u4"),
        ("value", "<f4"),
        ("gen", "<u4"),
        ("check", "<u8"),
        ("policy", "<u2", (policy_size,)),
    ])


def tier_enabled() -> bool:
    """The master hatch, read per call so tests can monkeypatch env."""
    return os.environ.get(TIER_ENV, "") == "1"


def tier_path() -> str:
    uid = getattr(os, "getuid", lambda: 0)()
    return os.environ.get(TIER_PATH_ENV) or os.path.join(
        tempfile.gettempdir(), f"fishnet-postier-{uid}.seg"
    )


def _env_slots(name: str, default: int) -> int:
    try:
        return max(_PROBE_WINDOW, int(os.environ.get(name, default)))
    except ValueError:
        return default


def _nnue_check(key: int, value: int, owner: int) -> int:
    """Payload checksum: any interleaving of two writers' stores (or a
    half-written slot) fails this with overwhelming probability."""
    return (key ^ ((value & 0xFFFFFFFF) | (owner << 32)) ^ _MIX) & _U64


def _az_check(key: int, value_bits: int, owner: int,
              policy_words: np.ndarray) -> int:
    acc = int(np.bitwise_xor.reduce(policy_words)) if len(policy_words) else 0
    return (key ^ value_bits ^ (owner * _MIX) ^ acc) & _U64


def _bounds_check(key: int, value: int, eval_: int, depth: int,
                  bound: int, move: int, owner: int) -> int:
    lo = ((value & 0xFFFFFFFF) | ((eval_ & 0xFFFFFFFF) << 32)) & _U64
    hi = (depth | (bound << 8) | (move << 16)) & _U64
    return (key ^ lo ^ ((hi * _MIX) & _U64) ^ ((owner * _MIX) & _U64)) & _U64


class PositionTier:
    """One attached shared-memory position segment (both keyspaces).

    All probe/insert methods are thread-safe in-process (striped locks)
    and torn-read-safe cross-process (seqlock + checksum). Keys are
    SALTED — callers XOR their net fingerprint in before calling, the
    same keys they use against the process caches."""

    def __init__(self, path: str, mm: mmap.mmap, nnue_slots: int,
                 az_slots: int, policy_size: int,
                 bounds_slots: int = DEFAULT_BOUNDS_SLOTS) -> None:
        self.path = path
        self._mm = mm
        self._owner = os.getpid() & 0xFFFFFFFF
        self._header = np.frombuffer(mm, dtype=_HEADER_DTYPE, count=1)
        self._nnue = np.frombuffer(
            mm, dtype=_NNUE_SLOT_DTYPE, count=nnue_slots,
            offset=_HEADER_BYTES,
        )
        self.az_policy_size = policy_size
        az_dtype = _az_slot_dtype(policy_size)
        self._az = np.frombuffer(
            mm, dtype=az_dtype, count=az_slots,
            offset=_HEADER_BYTES + nnue_slots * _NNUE_SLOT_DTYPE.itemsize,
        )
        self._bounds = np.frombuffer(
            mm, dtype=_BOUNDS_SLOT_DTYPE, count=bounds_slots,
            offset=(
                _HEADER_BYTES
                + nnue_slots * _NNUE_SLOT_DTYPE.itemsize
                + az_slots * az_dtype.itemsize
            ),
        )
        self._nnue_slots = nnue_slots
        self._az_slots = az_slots
        self._bounds_slots = bounds_slots
        self._locks = [threading.Lock() for _ in range(_N_STRIPES)]

    # -- slot addressing ---------------------------------------------------

    @staticmethod
    def _mix(key: int) -> int:
        # splitmix64 finalizer-ish: decorrelate the probe index from the
        # low Zobrist bits the pool TT and cache stripes already use.
        x = (key * _MIX) & _U64
        x ^= x >> 29
        return x

    def _window(self, key: int, n_slots: int) -> range:
        base = self._mix(key) % n_slots
        return range(base, base + min(_PROBE_WINDOW, n_slots))

    # -- NNUE keyspace -----------------------------------------------------

    def _read_nnue(self, idx: int, key: int) -> Optional[Tuple[int, int]]:
        """Validated ``(value, owner)`` for ``key`` at slot ``idx``, or
        None (empty / other key / torn)."""
        slot = self._nnue[idx]
        s1 = int(slot["seq"])
        if s1 & 1:
            return None  # write in progress (or a dead writer's slot)
        k = int(slot["key"])
        if k != key:
            return None
        value = int(slot["value"])
        owner = int(slot["owner"])
        check = int(slot["check"])
        if int(slot["seq"]) != s1:
            return None  # torn: a writer landed mid-read
        if check != _nnue_check(k, value, owner):
            return None  # torn or interleaved write
        return value, owner

    def probe_nnue_block(
        self, keys: np.ndarray, values: np.ndarray, mask: np.ndarray
    ) -> int:
        """Fill the MISS rows of a process-cache probe from the fleet
        segment: for each ``i`` with ``mask[i]`` false, a valid segment
        entry writes ``values[i]`` and sets ``mask[i]``. Returns the
        number of rows filled (counters split self- vs cross-process
        hits by slot owner)."""
        hits_local = hits_fleet = misses = 0
        n = len(keys)
        for i in range(n):
            if mask[i]:
                continue
            key = int(keys[i])
            found = None
            for idx in self._window(key, self._nnue_slots):
                found = self._read_nnue(idx % self._nnue_slots, key)
                if found is not None:
                    break
            if found is None:
                misses += 1
                continue
            value, owner = found
            values[i] = value
            mask[i] = True
            if owner == self._owner:
                hits_local += 1
            else:
                hits_fleet += 1
        _count("nnue", hits_local, hits_fleet, misses)
        return hits_local + hits_fleet

    def insert_nnue_block(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Publish freshly paid evals to the segment (provide-time
        path). Last-writer-wins on slot collisions — it's a cache."""
        gen = int(self._header["generation"][0]) & 0xFFFFFFFF
        n = min(len(keys), len(values))
        evictions = 0
        for i in range(n):
            key = int(keys[i])
            evictions += self._insert_nnue_one(key, int(values[i]), gen)
        if evictions:
            _count_evict("nnue", evictions)

    def _insert_nnue_one(self, key: int, value: int, gen: int) -> int:
        window = self._window(key, self._nnue_slots)
        target = None
        victim = None
        victim_gen = None
        for idx in window:
            idx %= self._nnue_slots
            slot = self._nnue[idx]
            k = int(slot["key"])
            if k == key:
                target = idx
                break
            if k == 0 and int(slot["seq"]) == 0:
                if target is None:
                    target = idx
                continue
            g = int(slot["gen"])
            if victim_gen is None or g < victim_gen:
                victim, victim_gen = idx, g
        evicted = 0
        if target is None:
            target = victim if victim is not None else (
                self._mix(key) % self._nnue_slots
            )
            evicted = 1
        with self._locks[target & (_N_STRIPES - 1)]:
            slot = self._nnue[target]
            s = int(slot["seq"])
            slot["seq"] = ((s + 1) | 1) & 0xFFFFFFFF  # odd: mid-write
            slot["key"] = key
            slot["value"] = value
            slot["owner"] = self._owner
            slot["gen"] = gen
            slot["check"] = _nnue_check(key, value, self._owner)
            slot["seq"] = (((s + 1) | 1) + 1) & 0xFFFFFFFF  # even: published
        return evicted

    # -- AZ keyspace -------------------------------------------------------

    def probe_az(self, key: int) -> Optional[Tuple[np.ndarray, float]]:
        """Validated ``(policy_fp16 [policy_size], value)`` for a salted
        AZ key, or None. The policy row is a COPY (the segment slot may
        be overwritten the instant this returns)."""
        key = int(key) & _U64
        found = None
        owner = 0
        for idx in self._window(key, self._az_slots):
            idx %= self._az_slots
            slot = self._az[idx]
            s1 = int(slot["seq"])
            if s1 & 1:
                continue
            if int(slot["key"]) != key:
                continue
            policy = np.array(slot["policy"], copy=True)
            value = np.float32(slot["value"])
            owner = int(slot["owner"])
            check = int(slot["check"])
            if int(slot["seq"]) != s1:
                continue
            words = policy.view(np.uint8)
            pad = (-len(words)) % 8
            if pad:
                words = np.concatenate([words, np.zeros(pad, np.uint8)])
            if check != _az_check(
                key, int(value.view(np.uint32)), owner,
                words.view(np.uint64),
            ):
                continue
            found = (policy.view(np.float16), float(value))
            break
        if found is None:
            _count("az", 0, 0, 1)
        elif owner == self._owner:
            _count("az", 1, 0, 0)
        else:
            _count("az", 0, 1, 0)
        return found

    def insert_az(self, key: int, policy_fp16: np.ndarray,
                  value: float) -> None:
        key = int(key) & _U64
        policy = np.ascontiguousarray(policy_fp16, dtype=np.float16)
        if policy.shape != (self.az_policy_size,):
            return  # architecture drift; never corrupt the region
        gen = int(self._header["generation"][0]) & 0xFFFFFFFF
        window = self._window(key, self._az_slots)
        target = None
        victim = None
        victim_gen = None
        for idx in window:
            idx %= self._az_slots
            slot = self._az[idx]
            k = int(slot["key"])
            if k == key:
                target = idx
                break
            if k == 0 and int(slot["seq"]) == 0:
                if target is None:
                    target = idx
                continue
            g = int(slot["gen"])
            if victim_gen is None or g < victim_gen:
                victim, victim_gen = idx, g
        evicted = 0
        if target is None:
            target = victim if victim is not None else (
                self._mix(key) % self._az_slots
            )
            evicted = 1
        vbits = int(np.float32(value).view(np.uint32))
        words = policy.view(np.uint8)
        pad = (-len(words)) % 8
        if pad:
            words = np.concatenate([words, np.zeros(pad, np.uint8)])
        check = _az_check(key, vbits, self._owner, words.view(np.uint64))
        with self._locks[target & (_N_STRIPES - 1)]:
            slot = self._az[target]
            s = int(slot["seq"])
            slot["seq"] = ((s + 1) | 1) & 0xFFFFFFFF
            slot["key"] = key
            slot["value"] = np.float32(value)
            slot["owner"] = self._owner
            slot["gen"] = gen
            slot["policy"] = policy.view(np.uint16)
            slot["check"] = check
            slot["seq"] = (((s + 1) | 1) + 1) & 0xFFFFFFFF
        if evicted:
            _count_evict("az", 1)

    # -- bounds keyspace ---------------------------------------------------

    def _read_bound(
        self, idx: int, key: int
    ) -> Optional[Tuple[int, int, int, int, int, int]]:
        """Validated ``(value, eval, depth, bound, move, owner)`` for
        ``key`` at slot ``idx``, or None (empty / other key / torn)."""
        slot = self._bounds[idx]
        s1 = int(slot["seq"])
        if s1 & 1:
            return None  # write in progress (or a dead writer's slot)
        if int(slot["key"]) != key:
            return None
        value = int(np.int32(slot["value"]))
        eval_ = int(np.int32(slot["eval"]))
        depth = int(slot["depth"])
        bound = int(slot["bound"])
        move = int(slot["move"])
        owner = int(slot["owner"])
        check = int(slot["check"])
        if int(slot["seq"]) != s1:
            return None  # torn: a writer landed mid-read
        if bound == 0 or check != _bounds_check(
            key, value, eval_, depth, bound, move, owner
        ):
            return None  # torn or interleaved write
        return value, eval_, depth, bound, move, owner

    def probe_bounds_block(
        self,
        keys: np.ndarray,
        values: np.ndarray,
        evals: np.ndarray,
        depths: np.ndarray,
        bounds: np.ndarray,
        moves: np.ndarray,
    ) -> int:
        """Fill the MISS rows (``bounds[i] == 0``) of a process
        bounds-cache probe from the fleet segment; the column layout
        matches ``BoundsCache.probe_bounds_block``. Returns rows
        filled."""
        hits_local = hits_fleet = misses = 0
        for i in range(len(keys)):
            if bounds[i]:
                continue
            key = int(keys[i])
            found = None
            for idx in self._window(key, self._bounds_slots):
                found = self._read_bound(idx % self._bounds_slots, key)
                if found is not None:
                    break
            if found is None:
                misses += 1
                continue
            values[i], evals[i], depths[i], bounds[i], moves[i], owner = found
            if owner == self._owner:
                hits_local += 1
            else:
                hits_fleet += 1
        _count("bounds", hits_local, hits_fleet, misses)
        return hits_local + hits_fleet

    def insert_bound(self, key: int, value: int, eval_: int, depth: int,
                     bound: int, move: int) -> None:
        """Publish one bound record. Same-key replacement is
        deeper-entry-wins (the :class:`BoundsCache` policy): a live
        same-key slot holding a strictly deeper record is left alone —
        a shallow re-search must never clobber the deep record a
        sibling paid for. Cross-key collisions evict lowest-gen, like
        the other regions."""
        if bound <= 0 or bound > 3:
            return
        key = int(key) & _U64
        gen = int(self._header["generation"][0]) & 0xFFFFFFFF
        window = self._window(key, self._bounds_slots)
        target = None
        victim = None
        victim_gen = None
        for idx in window:
            idx %= self._bounds_slots
            slot = self._bounds[idx]
            k = int(slot["key"])
            if k == key:
                if int(slot["depth"]) > depth and not (int(slot["seq"]) & 1):
                    return  # resident record is deeper; keep it
                target = idx
                break
            if k == 0 and int(slot["seq"]) == 0:
                if target is None:
                    target = idx
                continue
            g = int(slot["gen"])
            if victim_gen is None or g < victim_gen:
                victim, victim_gen = idx, g
        evicted = 0
        if target is None:
            target = victim if victim is not None else (
                self._mix(key) % self._bounds_slots
            )
            evicted = 1
        check = _bounds_check(
            key, value, eval_, depth, bound, move, self._owner
        )
        with self._locks[target & (_N_STRIPES - 1)]:
            slot = self._bounds[target]
            s = int(slot["seq"])
            slot["seq"] = ((s + 1) | 1) & 0xFFFFFFFF  # odd: mid-write
            slot["key"] = key
            slot["value"] = np.int32(value)
            slot["eval"] = np.int32(eval_)
            slot["depth"] = depth & 0xFFFFFFFF
            slot["bound"] = bound
            slot["move"] = move & 0xFFFFFFFF
            slot["owner"] = self._owner
            slot["gen"] = gen
            slot["check"] = check
            slot["seq"] = (((s + 1) | 1) + 1) & 0xFFFFFFFF  # even: published
        if evicted:
            _count_evict("bounds", 1)

    def insert_bounds_block(
        self,
        keys: np.ndarray,
        values: np.ndarray,
        evals: np.ndarray,
        depths: np.ndarray,
        bounds: np.ndarray,
        moves: np.ndarray,
    ) -> None:
        """Publish a harvested batch of bound records (rows with
        ``bounds[i] == 0`` are skipped — the harvest layout marks
        misses that way)."""
        for i in range(len(keys)):
            if not bounds[i]:
                continue
            self.insert_bound(
                int(keys[i]), int(np.int32(values[i])),
                int(np.int32(evals[i])), int(depths[i]), int(bounds[i]),
                int(moves[i]),
            )

    # -- shared clock ------------------------------------------------------

    def advance_generation(self) -> int:
        """Tick the fleet-wide eviction clock (batch completion,
        sched/queue.py). Racy read-modify-write across processes is
        fine — it's a coarse ordering signal, not a counter."""
        g = (int(self._header["generation"][0]) + 1) & _U64
        self._header["generation"][0] = g
        return g

    def generation(self) -> int:
        return int(self._header["generation"][0])

    def close(self) -> None:
        # Release the numpy views before the mmap (else BufferError).
        self._header = self._nnue = self._az = self._bounds = None
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass


# -- module counters + telemetry collector ----------------------------------

_count_lock = threading.Lock()
_counts: Dict[str, int] = {}


def _count(family: str, local: int, fleet: int, misses: int) -> None:
    with _count_lock:
        if local:
            k = f"hits.local.{family}"
            _counts[k] = _counts.get(k, 0) + local
        if fleet:
            k = f"hits.fleet.{family}"
            _counts[k] = _counts.get(k, 0) + fleet
        if misses:
            k = f"misses.fleet.{family}"
            _counts[k] = _counts.get(k, 0) + misses


def _count_evict(family: str, n: int) -> None:
    with _count_lock:
        k = f"evictions.fleet.{family}"
        _counts[k] = _counts.get(k, 0) + n


def _count_attach(scope: str) -> None:
    with _count_lock:
        k = f"attach.{scope}"
        _counts[k] = _counts.get(k, 0) + 1


def stats() -> Dict[str, int]:
    """Process-lifetime tier counters (keys ``hits.local.nnue``,
    ``hits.fleet.az``, ``misses.fleet.nnue``, ``attach.fleet``, ...)."""
    with _count_lock:
        return dict(_counts)


def _collect_postier() -> Optional[List]:
    from fishnet_tpu_torch.telemetry.registry import counter_family

    with _count_lock:
        snap = dict(_counts)
    fams = []
    for fam in ("nnue", "az", "bounds"):
        for scope in ("local", "fleet"):
            fams.append(counter_family(
                "fishnet_postier_hits_total",
                "Fleet position-tier hits by scope (local=slot written "
                "by this process, fleet=cross-process) and family.",
                snap.get(f"hits.{scope}.{fam}", 0),
                labels={"scope": scope, "family": fam},
            ))
        fams.append(counter_family(
            "fishnet_postier_misses_total",
            "Fleet position-tier probes that found no valid slot "
            "(torn/checksum-rejected reads count as misses).",
            snap.get(f"misses.fleet.{fam}", 0),
            labels={"scope": "fleet", "family": fam},
        ))
        fams.append(counter_family(
            "fishnet_postier_evictions_total",
            "Fleet position-tier slots overwritten while holding a "
            "different live key (fixed-slot replacement).",
            snap.get(f"evictions.fleet.{fam}", 0),
            labels={"scope": "fleet", "family": fam},
        ))
    for scope in ("local", "fleet"):
        fams.append(counter_family(
            "fishnet_postier_attach_total",
            "Segment attach outcomes: fleet=attached the shared "
            "segment, local=fell back to process-local reuse.",
            snap.get(f"attach.{scope}", 0),
            labels={"scope": scope},
        ))
    return fams


# -- process-wide singleton --------------------------------------------------

_tier_lock = threading.Lock()
_tier: Optional[PositionTier] = None
_tier_resolved = False
_collector_token: Optional[int] = None


def _attach(path: str) -> PositionTier:
    nnue_slots = _env_slots(TIER_CAPACITY_ENV, DEFAULT_NNUE_SLOTS)
    az_slots = _env_slots(TIER_AZ_CAPACITY_ENV, DEFAULT_AZ_SLOTS)
    bounds_slots = _env_slots(TIER_BOUNDS_CAPACITY_ENV, DEFAULT_BOUNDS_SLOTS)
    az_itemsize = _az_slot_dtype(AZ_POLICY_SIZE).itemsize
    size = (
        _HEADER_BYTES
        + nnue_slots * _NNUE_SLOT_DTYPE.itemsize
        + az_slots * az_itemsize
        + bounds_slots * _BOUNDS_SLOT_DTYPE.itemsize
    )
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
    try:
        existing = os.fstat(fd).st_size
        if existing == 0:
            # Fresh segment: size it, then publish the header with the
            # magic LAST — a concurrent creator writes identical bytes
            # (geometry comes from the same envs), so the race is
            # benign; a reader that loses it sees magic==0 and retries
            # as a failed attach (fallback, not corruption).
            os.ftruncate(fd, size)
            mm = mmap.mmap(fd, size)
            header = np.frombuffer(mm, dtype=_HEADER_DTYPE, count=1)
            header["version"] = _VERSION
            header["nnue_slots"] = nnue_slots
            header["az_slots"] = az_slots
            header["policy_size"] = AZ_POLICY_SIZE
            header["bounds_slots"] = bounds_slots
            header["generation"] = 1
            header["magic"] = _MAGIC
        else:
            mm = mmap.mmap(fd, existing)
            header = np.frombuffer(mm, dtype=_HEADER_DTYPE, count=1)
            if int(header["magic"][0]) != _MAGIC:
                raise ValueError(f"{path}: not a position-tier segment")
            if int(header["version"][0]) != _VERSION:
                raise ValueError(f"{path}: tier version mismatch")
            nnue_slots = int(header["nnue_slots"][0])
            az_slots = int(header["az_slots"][0])
            policy = int(header["policy_size"][0])
            bounds_slots = int(header["bounds_slots"][0])
            expect = (
                _HEADER_BYTES
                + nnue_slots * _NNUE_SLOT_DTYPE.itemsize
                + az_slots * _az_slot_dtype(policy).itemsize
                + bounds_slots * _BOUNDS_SLOT_DTYPE.itemsize
            )
            if (
                policy != AZ_POLICY_SIZE
                or bounds_slots < _PROBE_WINDOW
                or existing < expect
            ):
                raise ValueError(f"{path}: tier geometry mismatch")
        del header  # release the view; PositionTier re-views
    finally:
        os.close(fd)
    return PositionTier(
        path, mm, nnue_slots, az_slots, AZ_POLICY_SIZE, bounds_slots
    )


def get_tier() -> Optional[PositionTier]:
    """The process-wide tier handle, or None (env off, or the attach
    fell back). Resolved once per process; ``reset_tier()`` re-arms."""
    global _tier, _tier_resolved, _collector_token
    with _tier_lock:
        if _tier_resolved:
            return _tier
        _tier_resolved = True
        if not tier_enabled():
            return None
        try:
            _tier = _attach(tier_path())
            _count_attach("fleet")
        except (OSError, ValueError, BufferError):
            _tier = None
            _count_attach("local")
        from fishnet_tpu_torch.telemetry.registry import REGISTRY

        if _collector_token is None:
            _collector_token = REGISTRY.register_collector(
                _collect_postier, name="position-tier"
            )
        return _tier


def reset_tier() -> None:
    """Detach and forget the process tier (tests / bench phase resets).
    Counters survive — they are process-lifetime totals."""
    global _tier, _tier_resolved
    with _tier_lock:
        if _tier is not None:
            _tier.close()
        _tier = None
        _tier_resolved = False
