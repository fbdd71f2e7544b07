"""Process-wide position-keyed eval reuse plane: the port of
``fishnet_tpu/search/eval_cache.py`` for the NNUE family.

One ``EvalCache`` per process maps Zobrist position hash (salted with
the network's fingerprint) -> (static eval, generation). It is shared
across pipeline groups and — because it outlives any single
``SearchService`` — across services, which is exactly where the pool's
own TT (torn down with the pool) loses its history. The service probes
it in the driver loop right after ``fc_pool_step`` hands over a batch
(every entry cached -> the dispatch is skipped entirely) and inside
``plan_segment_dedup`` (per-entry drops inside a fused dispatch), and
inserts at provide time.

Correctness stance: the NNUE static eval is a pure function of the
position, so substituting a cached value for a recomputed one is
bit-identical (modulo 64-bit Zobrist collisions — the risk the native
TT already carries). ``FISHNET_NO_EVAL_CACHE=1`` disables every probe
and insert; cache-off, cold and warm runs give identical analyses.

``BoundsCache`` is the bounds tier: full search facts (value, eval,
depth, bound, best move) keyed like the memo, deeper-entry-wins.

The tables are native (``csrc/eval_cache.cpp``, compiled with the
core's flags at first use): one mutex per table, taken once per call,
and a block call runs without the interpreter lock. Memory is bounded:
the hashes fall into stripes, each holding at most ``capacity //
stripes`` entries, and a full stripe evicts its oldest *generations*
first (a generation advances at batch completion, see
``sched/queue.py``) — the JAX package's striped table, entry for
entry.

``AzEvalCache`` is the AZ family's twin (``search/az_plane.py``): object
values (the fp16 policy row and the value a dispatch returned), keyed
``az_position_key(zobrist, halfmove) ^ az_net_fingerprint(params)``. It
stays a Python store: each entry is 9344 bytes of logits, so a few
thousand of them are the working set and the interpreter's dict costs
nothing beside them.

Snapshots (``FISHNET_EVAL_CACHE_SNAPSHOT``) use the JAX package's
``.npz`` format, AZ section included, so a file written by either
package loads in the other. Each process cache has the JAX package's
registry collector (``fishnet_eval_cache_entries`` and
``fishnet_eval_cache_evictions_total``, tagged ``family="az"`` and
``family="bounds"`` for the AZ and bounds caches; the hit counters are
the service's and the AZ plane's).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from fishnet_tpu_torch.chess import core

#: Default bound on total entries (score + generation per entry; at the
#: default 1M entries the table tops out around ~60 MB of hash-map
#: nodes — host RAM traded for dispatches).
DEFAULT_CAPACITY = 1 << 20

#: Stripe count: enough that 8 driver threads rarely collide, small
#: enough that the per-stripe capacity stays meaningful at tiny test
#: capacities.
DEFAULT_STRIPES = 64

_U64 = (1 << 64) - 1


def cache_disabled() -> bool:
    """The escape hatch, read per call so tests can monkeypatch env."""
    return os.environ.get("FISHNET_NO_EVAL_CACHE", "") == "1"


def bounds_disabled() -> bool:
    """The bounds-tier escape hatch (``FISHNET_NO_BOUNDS=1``), read per
    call like :func:`cache_disabled`. With it set, no bound record is
    ever probed, harvested or seeded. ``FISHNET_NO_EVAL_CACHE=1``
    implies it: bounds ride the same reuse plane."""
    return (
        cache_disabled()
        or os.environ.get("FISHNET_NO_BOUNDS", "") == "1"
    )


#: Warm-restart snapshot file: when set, the client persists the cache
#: here on drain and reloads it at startup, so a restarted process's
#: first batches resolve pre-wire.
SNAPSHOT_ENV = "FISHNET_EVAL_CACHE_SNAPSHOT"

#: Snapshot format version; a mismatch discards the file like a
#: fingerprint mismatch does.
SNAPSHOT_VERSION = 1


def snapshot_path() -> Optional[str]:
    """The configured snapshot file, or None (snapshots off)."""
    return os.environ.get(SNAPSHOT_ENV) or None


def net_fingerprint(path: str) -> int:
    """64-bit blake2b of the ``.nnue`` file — the network-identity salt
    the service XORs into every cache key, so a service with different
    weights keys a disjoint region of the shared cache. Matches
    ``NnueWeights.fingerprint()`` because ``save`` writes the canonical
    form this hashes."""
    h = hashlib.blake2b(digest_size=8)
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return int.from_bytes(h.digest(), "little")


def az_net_fingerprint(params) -> int:
    """64-bit blake2b over an AZ parameter dict's raw array bytes: the
    network-identity salt the AZ dispatch plane XORs into every AZ cache
    key. The JAX package's serialisation exactly (ROADMAP C4): leaves in
    ``jax.tree_util`` order, which for a dict is its sorted keys, each
    prefixed by ``str(shape)`` and the numpy dtype's name, so one
    ``.npz`` keys the same entries in both packages. It hashes the
    JAX-layout numpy arrays, never a torch ``state_dict``."""
    h = hashlib.blake2b(digest_size=8)
    h.update(b"az-params/1")
    for key in sorted(params):
        arr = np.asarray(params[key])
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return int.from_bytes(h.digest(), "little")


#: Odd 64-bit multiplier (golden ratio) mixing the halfmove clock into an
#: AZ position key: the AZ planes see the clock (plane 17), Zobrist does
#: not, so two positions that differ only in clock must not alias.
_HALFMOVE_MIX = 0x9E3779B97F4A7C15


def az_position_key(zobrist: int, halfmove: int) -> int:
    """The UNSALTED AZ cache key of one position: Zobrist hash mixed with
    the halfmove clock. The dispatch plane XORs
    :func:`az_net_fingerprint` on top before probing."""
    return (zobrist ^ ((halfmove * _HALFMOVE_MIX) & _U64)) & _U64


#: The native tables' source (built with the core's flags at first use).
_SOURCE = Path(__file__).resolve().parent / "csrc" / "eval_cache.cpp"
_native: Optional[ctypes.CDLL] = None
_native_lock = threading.Lock()


def _tables() -> ctypes.CDLL:
    """The native tables of ``csrc/eval_cache.cpp``, built on first use
    (``chess/core.py``'s ``build``, into its build directory)."""
    global _native
    with _native_lock:
        if _native is None:
            lib = ctypes.CDLL(str(core.build("libevalcache", [_SOURCE])))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.ect_new.argtypes = [i64, i32, i32]
            lib.ect_new.restype = ptr
            lib.ect_free.argtypes = [ptr]
            lib.ect_probe.argtypes = [ptr, ptr, i32, ptr, ptr]
            lib.ect_probe.restype = i32
            lib.ect_insert.argtypes = [ptr, ptr, ptr, ptr, i32, i32]
            lib.ect_insert_deeper.argtypes = [ptr, ptr, ptr, i32]
            lib.ect_insert_deeper.restype = i32
            lib.ect_generation.argtypes = [ptr, i64]
            lib.ect_generation.restype = i64
            lib.ect_stats.argtypes = [ptr, ptr]
            lib.ect_clear.argtypes = [ptr]
            lib.ect_dump.argtypes = [ptr, ptr, ptr, ptr, i64]
            lib.ect_dump.restype = i64
            _native = lib
        return _native


class EvalCache:
    """Striped hash -> (eval, generation) map with generation-based
    eviction. All methods are thread-safe.

    The table is native (``csrc/eval_cache.cpp``): a block probe or
    insert of a microbatch is one call that holds the table's mutex and
    not the interpreter lock, which the pace-setting pack worker needs.
    What is cached, hit and evicted is the JAX package's per-entry
    semantics exactly."""

    #: Value columns per entry (``BoundsCache`` keeps six).
    _WIDTH = 1

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        stripes: int = DEFAULT_STRIPES,
    ) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        stripes = max(1, min(int(stripes), int(capacity)))
        # Per-stripe cap; rounding up keeps tiny-capacity configs usable.
        self._stripe_cap = max(1, (int(capacity) + stripes - 1) // stripes)
        self._n_stripes = stripes
        self._lib = _tables()
        self._table = self._lib.ect_new(int(capacity), stripes, self._WIDTH)

    def __del__(self) -> None:
        table = getattr(self, "_table", None)
        if table:
            self._lib.ect_free(table)
            self._table = None

    # -- internals --------------------------------------------------------

    def _probe(self, hashes) -> Tuple[np.ndarray, np.ndarray]:
        """``(values [n, width], hit mask)`` of a block probe; hits are
        refreshed to the current generation."""
        keys = np.ascontiguousarray(hashes, dtype=np.uint64)
        n = len(keys)
        vals = np.zeros((n, self._WIDTH), dtype=np.int64)
        hit = np.zeros(n, dtype=np.uint8)
        self._lib.ect_probe(self._table, keys.ctypes.data, n,
                            vals.ctypes.data, hit.ctypes.data)
        return vals, hit.view(bool)

    def _insert(self, hashes, vals: np.ndarray, gens=None,
                count: bool = True) -> None:
        """Store ``vals[i]`` under ``hashes[i]``, in order, at
        generation ``gens[i]`` (None: the current one)."""
        keys = np.ascontiguousarray(hashes, dtype=np.uint64)
        vals = np.ascontiguousarray(vals, dtype=np.int64)
        if gens is not None:
            gens = np.ascontiguousarray(gens, dtype=np.int64).ctypes.data
        self._lib.ect_insert(self._table, keys.ctypes.data, vals.ctypes.data,
                             gens, len(keys), int(count))

    def _record(self, row: np.ndarray):
        return int(row[0])

    # -- core API ---------------------------------------------------------

    def probe(self, h: int) -> Optional[int]:
        """Cached eval for hash `h`, or None. A hit refreshes the
        entry's generation (hot openings outlive eviction sweeps)."""
        vals, hit = self._probe(np.array([h], dtype=np.uint64))
        return self._record(vals[0]) if hit[0] else None

    def insert(self, h: int, value: int) -> None:
        self._insert(np.array([h], dtype=np.uint64),
                     np.array([int(value)], dtype=np.int64))

    def probe_block(
        self, hashes: np.ndarray, out: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Vector probe for one batch: returns ``(values, hit_mask)``
        with ``values[i]`` valid where ``hit_mask[i]``; ``out`` (int32
        [n]) receives the values in place."""
        vals, mask = self._probe(hashes)
        values = out if out is not None else np.zeros(len(mask), np.int32)
        values[mask] = vals[mask, 0]
        return values, mask

    def insert_block(self, hashes: np.ndarray, values: np.ndarray) -> None:
        """Batch insert (the provide-time fill path)."""
        n = min(len(hashes), len(values))
        self._insert(hashes[:n], values[:n])

    # -- generations ------------------------------------------------------

    def advance_generation(self) -> int:
        """Tick the eviction clock (called at batch completion by the
        scheduler, ``sched/queue.py``). Entries keep their insert/touch
        generation; eviction drops oldest-generation entries first."""
        return int(self._lib.ect_generation(self._table, -1))

    # -- introspection ----------------------------------------------------

    def __len__(self) -> int:
        return self.stats()["entries"]

    def stats(self) -> Dict[str, int]:
        out = np.zeros(6, dtype=np.int64)
        self._lib.ect_stats(self._table, out.ctypes.data)
        return dict(zip(("hits", "misses", "insertions", "evictions",
                         "generation", "entries"), out.tolist()))

    def clear(self) -> None:
        """Drop all entries (stats and generation survive)."""
        self._lib.ect_clear(self._table)

    # -- snapshot (warm restart) ------------------------------------------

    def dump_entries(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All entries as ``(hashes, values, generations)`` arrays."""
        room = len(self)
        keys = np.zeros(room, dtype=np.uint64)
        vals = np.zeros((room, self._WIDTH), dtype=np.int64)
        gens = np.zeros(room, dtype=np.int64)
        n = self._lib.ect_dump(self._table, keys.ctypes.data,
                               vals.ctypes.data, gens.ctypes.data, room)
        return keys[:n], vals[:n, 0].astype(np.int32), gens[:n]

    def load_entries(
        self,
        hashes: np.ndarray,
        values: np.ndarray,
        gens: np.ndarray,
    ) -> int:
        """Restore dumped entries (normal eviction applies if they
        exceed capacity). The generation clock advances to at least the
        newest restored generation."""
        n = min(len(hashes), len(values), len(gens))
        self._insert(hashes[:n], values[:n], gens[:n], count=False)
        top = int(np.asarray(gens[:n]).max()) if n else 0
        self._lib.ect_generation(self._table, max(top, 0))
        return n


#: Bound-type codes, matching the native TT's ``TTBound`` enum
#: (cpp/src/search.h): 0 = none/miss, 1 = upper bound (fail-low),
#: 2 = lower bound (fail-high), 3 = exact.
BOUND_NONE = 0
BOUND_UPPER = 1
BOUND_LOWER = 2
BOUND_EXACT = 3

#: The native 21-bit packed-move "no move" sentinel (all ones). Bound
#: records store moves in packed native form — only ever fed back
#: through ``fc_pool_tt_fill_bound``, never decoded on the host.
MOVE_NONE_BITS = 0x1FFFFF

#: Default bound on bounds-tier entries.
DEFAULT_BOUNDS_CAPACITY = 1 << 16


def _pack_uci(uci: Optional[str]) -> int:
    """A best move in UCI form (at most 7 bytes) as one table column:
    its bytes and a terminating 1, little-endian; None is 0."""
    if uci is None:
        return 0
    raw = uci.encode()
    if len(raw) > 7 or b"\0" in raw:
        raise ValueError(f"not a UCI move: {uci!r}")
    return int.from_bytes(raw + b"\x01", "little")


def _unpack_uci(col: int) -> Optional[str]:
    if col == 0:
        return None
    return col.to_bytes(8, "little").rstrip(b"\0")[:-1].decode()


class BoundsCache(EvalCache):
    """Bound-record twin of :class:`EvalCache`: each entry is
    ``(value, eval, depth, bound, move_bits, uci)`` — a search fact in
    the native TT's own representation, keyed ``zobrist ^
    net_fingerprint`` like the memo. Replacement is
    **deeper-entry-wins**: a same-key insert lands only when its depth
    is >= the resident entry's (an exact bound also beats a non-exact
    one at equal depth)."""

    _WIDTH = 6  # value, eval, depth, bound, move bits, uci (_pack_uci)

    def _record(self, row: np.ndarray):
        value, eval_, depth, bound, move_bits, uci = row.tolist()
        return value, eval_, depth, bound, move_bits, _unpack_uci(uci)

    def insert_bound(
        self,
        h: int,
        value: int,
        eval_: int,
        depth: int,
        bound: int,
        move_bits: int,
        uci: Optional[str] = None,
    ) -> bool:
        """Deeper-entry-wins insert; True when the record landed.
        ``uci`` is the best move in UCI form when the harvester knows it
        (PV replay): the submit-time chain walk plays it on a host
        board, while ``move_bits`` seeds the pool TT."""
        if bound <= BOUND_NONE or bound > BOUND_EXACT:
            return False
        return self.insert_bounds_block(
            np.array([h], dtype=np.uint64), [value], [eval_], [depth],
            [bound], [move_bits], [uci]) == 1

    def insert_bounds_block(self, hashes, values, evals, depths, bounds,
                            moves, ucis) -> int:
        """``insert_bound`` for each row, in order (the harvest's one
        call); returns how many landed."""
        keys = np.ascontiguousarray(hashes, dtype=np.uint64)
        rec = np.empty((len(keys), self._WIDTH), dtype=np.int64)
        for col, src in enumerate((values, evals, depths, bounds, moves)):
            rec[:, col] = src
        rec[:, 5] = [_pack_uci(u) for u in ucis]
        return int(self._lib.ect_insert_deeper(
            self._table, keys.ctypes.data, rec.ctypes.data, len(keys)))

    def probe_bound(
        self, h: int
    ) -> Optional[Tuple[int, int, int, int, int, Optional[str]]]:
        """Cached bound record for ``h``, or None. Hits refresh the
        entry's generation."""
        return self.probe(h)

    def probe_bounds_block(
        self, hashes: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Vector probe: ``(values, evals, depths, bounds, moves)``
        int32/uint32 columns with ``bounds[i] == BOUND_NONE`` marking a
        miss — the layout ``fc_pool_tt_fill_bound`` consumes."""
        vals, hit = self._probe(hashes)
        values, evals, depths, bounds = vals[:, :4].T.astype(np.int32)
        moves = np.where(hit, vals[:, 4], MOVE_NONE_BITS).astype(np.uint32)
        return values, evals, depths, bounds, moves


#: Default AZ-cache bound: an entry is a whole fp16 policy row (9344 B)
#: and a value, so 4096 entries hold ~38 MB of logits.
DEFAULT_AZ_CAPACITY = 1 << 12


class AzEvalCache:
    """Object-valued twin of :class:`EvalCache` for the AZ family: each
    entry is ``(policy_logits float16 [4672], value float32)``, the exact
    wire payload a device dispatch returns, so a hit reconstructs the
    same float32 logits bit for bit (``.astype(np.float32)`` of the same
    fp16 bits) and a warm replay equals a cold one.

    The JAX package's striped store entry for entry, in Python: hashes
    fall into stripes (one lock each) of at most ``capacity // stripes``
    entries, and a full stripe evicts its oldest generations first. All
    methods are thread-safe."""

    def __init__(self, capacity: int = DEFAULT_AZ_CAPACITY,
                 stripes: int = DEFAULT_STRIPES) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        stripes = max(1, min(int(stripes), int(capacity)))
        self._stripe_cap = max(1, (int(capacity) + stripes - 1) // stripes)
        self._n_stripes = stripes
        self._locks = [threading.Lock() for _ in range(stripes)]
        self._stripes: List[Dict[int, Tuple[object, int]]] = [
            {} for _ in range(stripes)
        ]
        self._meta_lock = threading.Lock()
        self._generation = 0
        self._hits = 0
        self._misses = 0
        self._insertions = 0
        self._evictions = 0

    def _stripe_of(self, h: int) -> int:
        return ((h >> 48) ^ h) % self._n_stripes

    def _evict_locked(self, s: int) -> None:
        """Drop the oldest generation(s) from stripe ``s`` until it is
        under its cap. The caller holds the stripe's lock."""
        stripe = self._stripes[s]
        dropped = 0
        while len(stripe) >= self._stripe_cap and stripe:
            oldest = min(g for (_, g) in stripe.values())
            stale = [h for h, (_, g) in stripe.items() if g == oldest]
            for h in stale:
                del stripe[h]
            dropped += len(stale)
        if dropped:
            with self._meta_lock:
                self._evictions += dropped

    def _store(self, h: int, value, gen: int) -> None:
        s = self._stripe_of(h)
        with self._locks[s]:
            stripe = self._stripes[s]
            if h not in stripe and len(stripe) >= self._stripe_cap:
                self._evict_locked(s)
            stripe[h] = (value, gen)

    def insert(self, h: int, value) -> None:
        self._store(int(h), value, self._generation)
        with self._meta_lock:
            self._insertions += 1

    def contains(self, h: int) -> bool:
        """Membership without hit/miss accounting or a generation
        refresh (speculation admission)."""
        h = int(h)
        s = self._stripe_of(h)
        with self._locks[s]:
            return h in self._stripes[s]

    def probe_many(self, keys) -> List[Optional[object]]:
        """``out[i]`` is the cached value of ``keys[i]`` or None; hits
        refresh the entry's generation."""
        out: List[Optional[object]] = []
        hits = 0
        gen = self._generation
        for k in keys:
            h = int(k)
            s = self._stripe_of(h)
            with self._locks[s]:
                ent = self._stripes[s].get(h)
                if ent is not None:
                    self._stripes[s][h] = (ent[0], gen)
            out.append(None if ent is None else ent[0])
            hits += ent is not None
        with self._meta_lock:
            self._hits += hits
            self._misses += len(out) - hits
        return out

    def advance_generation(self) -> int:
        with self._meta_lock:
            self._generation += 1
            return self._generation

    def __len__(self) -> int:
        total = 0
        for s in range(self._n_stripes):
            with self._locks[s]:
                total += len(self._stripes[s])
        return total

    def stats(self) -> Dict[str, int]:
        with self._meta_lock:
            st = {"hits": self._hits, "misses": self._misses,
                  "insertions": self._insertions,
                  "evictions": self._evictions,
                  "generation": self._generation}
        st["entries"] = len(self)
        return st

    def clear(self) -> None:
        """Drop all entries (stats and generation survive)."""
        for s in range(self._n_stripes):
            with self._locks[s]:
                self._stripes[s].clear()

    def dump_az_entries(
        self,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """All entries as ``(hashes, logits_fp16 [n, P], values_f32,
        generations)``; rows whose width differs from the first row's
        are skipped (a snapshot holds one architecture)."""
        hashes: List[int] = []
        rows: List[np.ndarray] = []
        values: List[float] = []
        gens: List[int] = []
        width: Optional[int] = None
        for s in range(self._n_stripes):
            with self._locks[s]:
                items = list(self._stripes[s].items())
            for h, (ent, g) in items:
                lg, val = ent
                lg = np.asarray(lg, dtype=np.float16).reshape(-1)
                if width is None:
                    width = len(lg)
                elif len(lg) != width:
                    continue
                hashes.append(h)
                rows.append(lg)
                values.append(float(val))
                gens.append(g)
        logits = np.stack(rows) if rows else np.empty((0, 0), np.float16)
        return (np.array(hashes, dtype=np.uint64),
                logits.astype(np.float16, copy=False),
                np.array(values, dtype=np.float32),
                np.array(gens, dtype=np.int64))

    def load_az_entries(self, hashes: np.ndarray, logits: np.ndarray,
                        values: np.ndarray, gens: np.ndarray) -> int:
        """Restore dumped entries, each as the exact ``(fp16 row,
        float32 value)`` the plane inserts; the generation clock advances
        to at least the newest restored generation."""
        n = min(len(hashes), len(logits), len(values), len(gens))
        top = 0
        for i in range(n):
            g = int(gens[i])
            top = max(top, g)
            self._store(int(hashes[i]), (np.array(logits[i], dtype=np.float16),
                                         np.float32(values[i])), g)
        with self._meta_lock:
            self._generation = max(self._generation, top)
        return n


# -- process-wide singletons ------------------------------------------------

_global_lock = threading.Lock()
_global_cache: Optional[EvalCache] = None
_global_bounds_cache: Optional[BoundsCache] = None
_global_az_cache: Optional[AzEvalCache] = None
#: Registry tokens of the caches' collectors, by family ("" = NNUE).
_collector_tokens: Dict[str, int] = {}


def _collect(family: str):
    """Registry collector of one process cache: its entry count and
    eviction total. Returns None (self-unregisters) once the cache is
    gone (``reset_cache``); the next cache registers anew."""
    with _global_lock:
        cache = {"": _global_cache, "az": _global_az_cache,
                 "bounds": _global_bounds_cache}[family]
        if cache is None:
            _collector_tokens.pop(family, None)
            return None
    from fishnet_tpu_torch.telemetry.registry import counter_family, gauge_family

    st = cache.stats()
    labels = {"family": family} if family else None
    return [
        gauge_family(
            "fishnet_eval_cache_entries",
            "Live entries in the process-wide eval cache.",
            st["entries"], labels=labels,
        ),
        counter_family(
            "fishnet_eval_cache_evictions_total",
            "Entries evicted from the eval cache (generation sweeps).",
            st["evictions"], labels=labels,
        ),
    ]


def _ensure_collector(family: str) -> None:
    """Register ``family``'s collector once (under ``_global_lock``)."""
    if family in _collector_tokens:
        return
    from fishnet_tpu_torch.telemetry.registry import REGISTRY

    name = {"": "eval-cache", "az": "az-eval-cache", "bounds": "bounds-cache"}
    _collector_tokens[family] = REGISTRY.register_collector(
        lambda: _collect(family), name=name[family])


def get_az_cache() -> Optional[AzEvalCache]:
    """The process-wide AZ eval cache, or None when the shared
    ``FISHNET_NO_EVAL_CACHE=1`` hatch is set. Created on first use;
    capacity via ``FISHNET_AZ_EVAL_CACHE_CAPACITY``. Its own instance,
    so AZ rows never evict NNUE's million-entry working set."""
    if cache_disabled():
        return None
    global _global_az_cache
    with _global_lock:
        if _global_az_cache is None:
            cap = int(os.environ.get(
                "FISHNET_AZ_EVAL_CACHE_CAPACITY", DEFAULT_AZ_CAPACITY))
            _global_az_cache = AzEvalCache(capacity=cap)
            _ensure_collector("az")
        return _global_az_cache


def get_bounds_cache() -> Optional[BoundsCache]:
    """The process-wide bounds cache, or None when ``FISHNET_NO_BOUNDS=1``
    (or the shared cache hatch) is set. Created on first use; capacity
    via ``FISHNET_BOUNDS_CACHE_CAPACITY``. A separate instance from
    :func:`get_cache`: the two replacement policies differ."""
    if bounds_disabled():
        return None
    global _global_bounds_cache
    with _global_lock:
        if _global_bounds_cache is None:
            cap = int(os.environ.get(
                "FISHNET_BOUNDS_CACHE_CAPACITY", DEFAULT_BOUNDS_CAPACITY))
            _global_bounds_cache = BoundsCache(capacity=cap)
            _ensure_collector("bounds")
        return _global_bounds_cache


def get_cache() -> Optional[EvalCache]:
    """The process-wide cache, or None when FISHNET_NO_EVAL_CACHE=1.
    Created on first use; capacity via FISHNET_EVAL_CACHE_CAPACITY."""
    if cache_disabled():
        return None
    global _global_cache
    with _global_lock:
        if _global_cache is None:
            cap = int(os.environ.get(
                "FISHNET_EVAL_CACHE_CAPACITY", DEFAULT_CAPACITY))
            _global_cache = EvalCache(capacity=cap)
            _ensure_collector("")
        return _global_cache


def reset_cache() -> None:
    """Tear down the process caches, all three families: a cold start
    is a cold start (tests, cold runs)."""
    global _global_cache, _global_bounds_cache, _global_az_cache
    with _global_lock:
        _global_cache = None
        _global_bounds_cache = None
        _global_az_cache = None


# -- warm-restart snapshot --------------------------------------------------


def save_snapshot(path: Optional[str] = None, fingerprint: int = 0,
                  az_fingerprint: int = 0) -> Optional[str]:
    """Persist the process caches to ``path`` (default: the
    ``FISHNET_EVAL_CACHE_SNAPSHOT`` file; None with neither = no-op).
    ``fingerprint`` is the serving NNUE's identity
    (:func:`net_fingerprint`; 0 for dev-mode random weights): a restart
    onto different weights must not read this snapshot's evals, so
    :func:`load_snapshot` discards on mismatch. The AZ cache rides the
    same file under its own ``az_fingerprint``
    (:func:`az_net_fingerprint`); either family may be empty. Atomic
    (tmp + rename): a kill mid-write leaves the previous snapshot
    intact. Returns the path written, or None."""
    path = path or snapshot_path()
    cache = _global_cache
    az_cache = _global_az_cache
    if path is None or (cache is None and az_cache is None):
        return None
    if cache is not None:
        hashes, values, gens = cache.dump_entries()
        generation = cache.stats()["generation"]
    else:
        hashes = np.empty(0, np.uint64)
        values = np.empty(0, np.int32)
        gens = np.empty(0, np.int64)
        generation = 0
    arrays = {}
    if az_cache is not None:
        az_hashes, az_logits, az_values, az_gens = az_cache.dump_az_entries()
        if len(az_hashes):
            arrays = dict(az_fingerprint=np.uint64(az_fingerprint & _U64),
                          az_hashes=az_hashes, az_logits=az_logits,
                          az_values=az_values, az_gens=az_gens)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # Open explicitly: np.savez appends ".npz" to bare paths, which
        # would break the rename.
        with open(tmp, "wb") as f:
            np.savez(
                f,
                version=np.int64(SNAPSHOT_VERSION),
                fingerprint=np.uint64(fingerprint & _U64),
                generation=np.int64(generation),
                hashes=hashes,
                values=values,
                gens=gens,
                **arrays,
            )
        os.replace(tmp, path)
    except OSError:
        # Snapshotting is an optimization, never a liveness dependency.
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    return path


def load_snapshot(path: Optional[str] = None, fingerprint: int = 0,
                  az_fingerprint: int = 0) -> bool:
    """Restore a snapshot into the process caches. Returns True when
    entries were restored. A version or NNUE fingerprint mismatch (or a
    corrupt file) DISCARDS the snapshot — the file is removed so a
    process that upgraded its net does not retry it on every restart —
    and returns False. The AZ section is checked against
    ``az_fingerprint`` on its own: a mismatch skips just that section,
    and a malformed one is dropped from the AZ cache and discards the
    file."""
    path = path or snapshot_path()
    if path is None or not os.path.exists(path):
        return False
    cache = get_cache()
    if cache is None:
        return False
    restored = False
    try:
        with np.load(path) as data:
            if int(data["version"]) != SNAPSHOT_VERSION or int(
                data["fingerprint"]
            ) != (fingerprint & _U64):
                raise ValueError("snapshot version/fingerprint mismatch")
            cache.load_entries(data["hashes"], data["values"], data["gens"])
            restored = True
            if "az_hashes" in data.files and int(
                    data["az_fingerprint"]) == (az_fingerprint & _U64):
                az_cache = get_az_cache()
                if az_cache is not None:
                    try:
                        az_cache.load_az_entries(
                            data["az_hashes"], data["az_logits"],
                            data["az_values"], data["az_gens"])
                    except (TypeError, ValueError, KeyError):
                        az_cache.clear()
                        raise
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        try:
            os.remove(path)
        except OSError:
            pass
        return restored
    return True


class MissHistory:
    """Per-group cache-miss history window, feeding the prefetch-budget
    steering policy (``SearchService._steer_prefetch``). Driver threads
    record; any thread may read a rate — one leaf lock, cold path."""

    def __init__(self, window: int = 2048) -> None:
        self._lock = threading.Lock()
        self._window = max(1, int(window))
        self._probes: Dict[int, int] = {}
        self._hits: Dict[int, int] = {}

    def record(self, group: int, hits: int, probes: int) -> None:
        with self._lock:
            p = self._probes.get(group, 0) + probes
            h = self._hits.get(group, 0) + hits
            if p > self._window:
                # Exponential forget: halve the window when it fills so
                # the rate tracks the current traffic mix, not history.
                p //= 2
                h //= 2
            self._probes[group] = p
            self._hits[group] = h

    def hit_rate(self, group: int) -> Optional[float]:
        """Hit rate over the window, or None below a minimum sample."""
        with self._lock:
            p = self._probes.get(group, 0)
            if p < 64:
                return None
            return self._hits.get(group, 0) / p
