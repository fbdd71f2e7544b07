"""NNUE feature-transformer gather-accumulate: the hand-written Hopper
kernel and its plain PyTorch version.

The feature transformer is the NNUE hot op: for every position and both
perspectives, sum up to 32 rows of a [22529, 1024] int16 table and add
the bias; the same index stream also sums the 8-bucket PSQT columns.
The wire's parent codes (``decode_parent``) make most entries DELTAS:
they carry a few added and removed rows and resolve against an anchor —
another entry of the batch, or a row of the persistent per-slot anchor
table that lives on the device across steps.

Two modes, one kernel (``csrc/ft_gather.cu``, the port of the Pallas
TPU kernel ``fishnet_tpu/ops/ft_gather.py:_kernel``), one launch per
call:

* dense — ``ft_accumulate``: int32 [B, 2, 32] indices in, accumulators
  out, the anchor tables only read;
* packed — ``ft_accumulate_packed``: the compact wire in (rows at each
  entry's offset, see ``expand_packed``), accumulators out, and every
  anchor entry's result stored back to its table rows in place. This is
  the serving path; on the TPU the expansion and the store were XLA ops
  around the kernel.

Each mode has three functions: ``*_cuda`` launches the kernel and counts
its launches in ``*_cuda.launches``; ``*_plain`` is the plain version
(the JAX package's XLA twin: ``_xla_ft_accumulate``,
``_xla_psqt_accumulate``, ``_xla_resolve_parents``, then
``expand_packed`` and the table scatter around it); the undecorated
name picks by the device of its inputs: the kernel for CUDA tensors (it
launches or raises; there is no fallback) and the plain version for CPU
tensors.

Segmented (coalesced) dispatches: ``derive_segment_offsets``,
``recode_segment_parents`` and their host twins turn K groups' wire
streams into one stream that meets the single-group contract, so one
launch of the same packed mode evaluates them all;
``plan_segment_dedup`` plans the cross-segment duplicates a fused
dispatch may leave off the wire.

Poison versus raise: the JAX package poisons persistent codes that
arrive without a table when they are traced (``_POISON_ACC``) and
raises when they are concrete. Torch is eager, so the port always
raises, and the traced-poison branches have no counterpart.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from fishnet_tpu_torch.nnue.spec import (
    DELTA_BASE,
    MAX_ACTIVE_FEATURES,
    NUM_FEATURES,
)

__all__ = [
    "decode_parent",
    "derive_segment_offsets",
    "derive_segment_offsets_np",
    "error_word",
    "expand_packed",
    "ft_accumulate",
    "ft_accumulate_cuda",
    "ft_accumulate_packed",
    "ft_accumulate_packed_cuda",
    "ft_accumulate_packed_plain",
    "ft_accumulate_plain",
    "is_delta",
    "kernel_errors",
    "plan_segment_dedup",
    "recode_segment_parents",
    "recode_segment_parents_np",
    "store_anchors",
]

_PERSISTENT_NO_TABLE = (
    "parent contains persistent anchor codes but no anchor_tab was given"
)


def _plain_slot_sum(table: torch.Tensor, indices: torch.Tensor,
                    delta_base: Optional[int]) -> torch.Tensor:
    """Signed sum of ``table`` rows over the slot axis: int32
    [B, 2, width]. Removal encodings (delta_base + f) subtract row f;
    their pads decode to the zero sentinel, so the sign is irrelevant
    there."""
    idx = indices.long()
    if delta_base is not None:
        rem = idx >= delta_base
        idx = torch.where(rem, idx - delta_base, idx)
    rows = table[idx].to(torch.int32)  # [B, 2, slots, width]
    if delta_base is not None:
        rows = torch.where(rem[..., None], -rows, rows)
    return rows.sum(dim=2, dtype=torch.int32)


def _plain_ft_rows(ft_w: torch.Tensor, ft_b: torch.Tensor,
                   indices: torch.Tensor,
                   delta_base: Optional[int] = None) -> torch.Tensor:
    """Port of ``_xla_ft_accumulate``: bias + signed row sum, int32
    [B, 2, L1]."""
    return ft_b.to(torch.int32) + _plain_slot_sum(ft_w, indices, delta_base)


def _plain_psqt_rows(ft_psqt: torch.Tensor, indices: torch.Tensor,
                     delta_base: Optional[int] = None) -> torch.Tensor:
    """Port of ``_xla_psqt_accumulate``: int32 [B, 2, 8], no bias."""
    return _plain_slot_sum(ft_psqt, indices, delta_base)


def _swap_persp(a: torch.Tensor, swap: torch.Tensor) -> torch.Tensor:
    """Swap the perspective axis (axis 1 of [B, 2, ...]) where ``swap``."""
    return torch.where(swap[:, None, None], a.flip(1), a)


def decode_parent(parent: torch.Tensor):
    """Split the wire's parent codes (cpp/src/pool.cpp emit_block) into
    masks: -1 plain full; >= 0 in-batch delta (ref << 1 | swap); <= -2
    anchor-entry codes -(2 + v), v = (table_row << 2) | (is_delta << 1)
    | swap — the entry resolves against (is_delta) and/or refreshes
    (always) its device anchor-table row. Plain fulls decode swap=0.
    Returns (in_batch, persistent, stores, ref, swap, aid)."""
    parent = parent.to(torch.int32)
    v = -parent - 2
    stores = parent <= -2
    persistent = stores & ((v & 2) != 0)
    in_batch = parent >= 0
    ref = torch.where(in_batch, parent >> 1, 0)
    swap = torch.where(
        in_batch, parent & 1, torch.where(stores, v & 1, 0)
    ).bool()
    aid = torch.where(stores, v >> 2, 0)
    return in_batch, persistent, stores, ref, swap, aid


def is_delta(parent: torch.Tensor) -> torch.Tensor:
    """True for one-row (delta) entries under the wire's parent codes:
    in-batch refs (>= 0) and persistent anchor deltas (<= -2 with the
    delta bit); plain fulls (-1) and full anchor (re)seeds own 4 rows."""
    in_batch, persistent, _, _, _, _ = decode_parent(parent)
    return in_batch | persistent


def derive_segment_offsets(parent: torch.Tensor, seg_rows: torch.Tensor,
                           tier: int) -> torch.Tensor:
    """Row offsets of a SEGMENTED dispatch whose K streams each take
    ``tier`` rows of the concatenated stream (the JAX package's layout).

    ``parent`` int32 [K, size] holds each segment's wire parent codes,
    ``seg_rows`` int [K] each segment's emitted row count. Per segment
    the offsets are the exclusive cumsum (4 rows per full entry, 1 per
    delta); each segment's padding clamps into ITS OWN sentinel block at
    ``seg_rows[k]`` and the whole segment shifts by ``k * tier``, so no
    offset crosses a segment boundary. Returns flat int32 [K * size]."""
    parent = parent.to(torch.int32)
    k_segs = parent.shape[0]
    rows_per = torch.where(is_delta(parent.reshape(-1)), 1, 4).to(
        torch.int32).reshape(parent.shape)
    local = torch.cumsum(rows_per, dim=1, dtype=torch.int32) - rows_per
    local = torch.minimum(
        local, seg_rows.to(device=parent.device, dtype=torch.int32)[:, None])
    base = torch.arange(k_segs, dtype=torch.int32,
                        device=parent.device)[:, None] * int(tier)
    return (local + base).reshape(-1)


def derive_segment_offsets_np(parent, seg_rows, bases) -> np.ndarray:
    """Host twin of ``derive_segment_offsets`` for streams laid out at
    any row ``bases`` (int [K], segment k's first row; the JAX layout is
    ``k * tier``). The service packs each segment at its exact span
    (its rows plus its sentinel block) and derives the offsets here."""
    parent = np.asarray(parent, dtype=np.int32)
    v = -parent - 2
    delta = (parent >= 0) | ((parent <= -2) & ((v & 2) != 0))
    rows_per = np.where(delta, 1, 4).astype(np.int32)
    local = np.cumsum(rows_per, axis=1, dtype=np.int32) - rows_per
    local = np.minimum(local, np.asarray(seg_rows, np.int32)[:, None])
    return (local + np.asarray(bases, np.int32)[:, None]).reshape(-1)


def recode_segment_parents(parent: torch.Tensor, anchor_rows: int,
                           groups: Optional[Sequence[int]] = None
                           ) -> torch.Tensor:
    """Rebase segment-local wire parent codes into the fused frame.

    ``parent`` int32 [K, size]; ``anchor_rows`` is one group's table row
    count A. In-batch refs (``ref << 1 | swap``) shift by the segment's
    entry base ``k * size``; persistent anchor codes (``-(2 + v)``,
    ``v = (row << 2) | bits``) shift their table row by the segment's
    table base ``groups[k] * A`` (default ``k * A``, the JAX package's
    stacked tables): the service keeps every group's table as block g
    of one [n_groups * A, ...] table, so a segment addresses its own
    group's rows wherever it sits in the dispatch. Plain fulls (-1)
    pass through. Every group batch STARTS with an anchor entry, so no
    in-batch chain crosses a segment boundary: the result meets the
    single-group contract of the kernel and of the plain version.
    Returns flat int32 [K * size]."""
    parent = parent.to(torch.int32)
    k_segs, size = parent.shape
    dev = parent.device
    entry_base = (torch.arange(k_segs, dtype=torch.int32, device=dev)
                  * size)[:, None]
    blocks = (torch.arange(k_segs, dtype=torch.int32, device=dev)
              if groups is None
              else torch.as_tensor(list(groups), dtype=torch.int32,
                                   device=dev))
    tab_base = (blocks * int(anchor_rows))[:, None]
    out = torch.where(parent >= 0, parent + (entry_base << 1), parent)
    out = torch.where(parent <= -2, parent - (tab_base << 2), out)
    return out.reshape(-1)


def recode_segment_parents_np(parent, anchor_rows: int,
                              groups: Sequence[int]) -> np.ndarray:
    """Host twin of ``recode_segment_parents`` (explicit ``groups``)."""
    parent = np.asarray(parent, dtype=np.int32)
    k_segs, size = parent.shape
    entry_base = (np.arange(k_segs, dtype=np.int32) * size)[:, None]
    tab_base = (np.asarray(groups, np.int32) * int(anchor_rows))[:, None]
    out = np.where(parent >= 0, parent + (entry_base << 1), parent)
    out = np.where(parent <= -2, parent - (tab_base << 2), out)
    return out.reshape(-1).astype(np.int32)


def plan_segment_dedup(parents, buckets, offsets, ns, packed, material=None,
                       hashes=None, cache_hits=None):
    """Plan cross-segment eval-dedup for ONE fused (coalesced) dispatch:
    deterministic, pure host-side planning (numpy in, plain lists out);
    a copy of the JAX package's planner.

    Within one group the in-step dedup retired too few evals to pay
    for itself, but ACROSS the segments of one fused dispatch sibling
    groups searching adjacent plies of the same game evaluate the same
    positions in the same step. The planning rides the pack worker.

    Inputs are per-segment host views (only the first ``ns[k]`` entries
    of each are read): ``parents`` int32 [size] segment-local wire
    parent codes; ``buckets`` int32 [size] layer-stack bucket ids;
    ``offsets`` int32 [size] each entry's row offset into its segment's
    ``packed`` uint16 [rows_k, 2, 8] stream; ``ns`` real entry counts;
    ``material`` optional int32 [size] host-material columns.

    BYTE MODE (``hashes`` None): a DUPLICATE is a plain full (code -1)
    whose 4-row feature block — keyed with its bucket (and material
    when shipped) — matches an earlier 4-row entry anywhere in the
    dispatch, provided it has no in-batch consumer and is not its
    segment's first entry. Such a full is followed by another anchor
    entry (or padding), so re-encoding it as a one-row sentinel in-batch
    delta disturbs no other entry; its device result is garbage and its
    true value is restored on the host from its original.

    POSITION-KEYED MODE (``hashes``: per-segment uint64 Zobrist arrays):
    the key is the position hash, a duplicate matches ANY earlier kept
    entry of the same position, and every encoding may be dropped:
    plain fulls and in-batch deltas become the sentinel in-batch delta;
    PERSISTENT codes become a sentinel persistent DELTA that keeps the
    original table row and store bit, whose stored bytes the eval's
    ``copy_src`` fan-in must make correct (so a persistent drop needs an
    in-dispatch source). ``cache_hits`` (per-segment ``(mask, values)``)
    also drops droppable entries whose eval a cache already knows.

    Returns ``(drops, refs, pairs)``: per-segment lists of dropped entry
    indices, the replacement codes' metadata, and global ``(dst_seg,
    dst_idx, src_seg, src_idx)`` value overwrites (each duplicate maps
    to the FIRST occurrence, never itself dropped). ``refs`` in byte
    mode are in-batch anchor indices (the caller writes ``ref << 1``,
    swap 0: the most recent preceding KEPT anchor); in position-keyed
    mode they are ready wire parent codes, and a fourth element
    ``fills`` lists ``(seg, idx, value)`` drops answered by the cache."""
    n_segs = len(parents)
    seen = {}
    fill_vals = {}  # hash -> cached value (position-keyed mode)
    drops = [[] for _ in range(n_segs)]
    refs = [[] for _ in range(n_segs)]
    pairs = []
    fills = []
    for k in range(n_segs):
        n = int(ns[k])
        if n <= 0:
            continue
        p = np.asarray(parents[k][:n])
        consumed = np.zeros(n, dtype=bool)
        inb = p >= 0
        if inb.any():
            consumed[p[inb] >> 1] = True
        # Anchor entries (fulls and persistent codes) vs 4-row entries
        # (fulls and persistent FULLS; persistent deltas ship 1 row).
        is_anchor = (p == -1) | (p <= -2)
        is_full4 = (p == -1) | ((p <= -2) & ((((-p - 2) >> 1) & 1) == 0))
        off = np.asarray(offsets[k][:n])
        rows = packed[k]
        hseg = None if hashes is None else hashes[k]
        cmask = cvals = None
        if cache_hits is not None and cache_hits[k] is not None:
            cmask, cvals = cache_hits[k]
        last_anchor = 0
        for i in range(n):
            dropped = False
            if hseg is not None:
                h = int(hseg[i])
                pers = bool(p[i] <= -2)
                droppable = not consumed[i] and i > 0
                # A persistent drop still stores its anchor row: its
                # sentinel keeps aid + store bit (delta form, swap 0).
                sentinel = (
                    -(2 + ((((-int(p[i]) - 2) >> 2) << 2) | 2))
                    if pers else (last_anchor << 1)
                )
                src = seen.get(h)
                if droppable and src is not None:
                    drops[k].append(i)
                    refs[k].append(sentinel)
                    pairs.append((k, i, src[0], src[1]))
                    dropped = True
                elif droppable and not pers and cmask is not None \
                        and cmask[i]:
                    drops[k].append(i)
                    refs[k].append(sentinel)
                    fills.append((k, i, int(cvals[i])))
                    fill_vals.setdefault(h, int(cvals[i]))
                    dropped = True
                elif droppable and not pers and h in fill_vals:
                    # Duplicate of an entry that itself left the wire on
                    # a cache hit: same cached value, no device source.
                    drops[k].append(i)
                    refs[k].append(sentinel)
                    fills.append((k, i, fill_vals[h]))
                    dropped = True
                elif src is None:
                    seen[h] = (k, i)
            elif is_full4[i]:
                key = (int(buckets[k][i]),
                       rows[off[i]: off[i] + 4].tobytes())
                if material is not None:
                    key = key + (int(material[k][i]),)
                src = seen.get(key)
                if (src is not None and p[i] == -1
                        and not consumed[i] and i > 0):
                    drops[k].append(i)
                    refs[k].append(last_anchor)
                    pairs.append((k, i, src[0], src[1]))
                    dropped = True
                elif src is None:
                    seen[key] = (k, i)
            if not dropped and is_anchor[i]:
                last_anchor = i
    if hashes is not None:
        return drops, refs, pairs, fills
    return drops, refs, pairs


def _widen_wire(packed: torch.Tensor) -> torch.Tensor:
    """int32 view of a wire row stream. The wire is uint16; torch has few
    uint16 kernels, so it may arrive as int16 carrying the same bits,
    which widen with a 16-bit mask."""
    if packed.dtype == torch.int16:
        return packed.to(torch.int32) & 0xFFFF
    return packed.to(torch.int32)


def expand_packed(packed: torch.Tensor, offsets: torch.Tensor,
                  parent: torch.Tensor) -> torch.Tensor:
    """Expand the COMPACT WIRE FORMAT back to dense [B, 2, 32] indices.

    ``packed`` [R, 2, 8] rows (uint16 bits, see _widen_wire),
    ``offsets`` int [B] row offsets: a full entry owns 4 consecutive
    rows — its 32 slots per perspective, 8 at a time; a delta entry owns
    ONE row (its 2*DELTA_SLOTS live slots) and its slots [8, 32) are the
    sentinel by wire contract."""
    packed = _widen_wire(packed)
    rows = offsets.long()[:, None] + torch.arange(4, device=packed.device)
    rows = rows.clamp(0, packed.shape[0] - 1)
    g = packed[rows]  # [B, 4, 2, 8]
    dense = g.permute(0, 2, 1, 3).reshape(-1, 2, 4 * 8)  # [B, 2, 32]
    tail = torch.where(
        is_delta(parent)[:, None, None],
        torch.full_like(dense[:, :, 8:], NUM_FEATURES),
        dense[:, :, 8:],
    )
    return torch.cat([dense[:, :, :8], tail], dim=2)


def store_anchors(tab: torch.Tensor, acc: torch.Tensor,
                  parent: torch.Tensor) -> None:
    """``tab[aid[b]] = acc[b]`` for every anchor entry b, in place. Rows
    are unique within a batch (one block per pool slot per step). Non-
    anchor entries aim at a sink index past the table, so no boolean
    mask — and no device-to-host sync on the GPU — is needed to find
    the store rows; rows past the table drop, as JAX's ``mode="drop"``
    does."""
    _, _, stores, _, _, aid = decode_parent(parent)
    n_tab = tab.shape[0]
    row = torch.where(stores & (aid < n_tab), aid, n_tab).long()
    has = torch.zeros(n_tab + 1, dtype=torch.bool, device=tab.device)
    has.scatter_(0, row, True)
    owner = torch.zeros(n_tab + 1, dtype=torch.long, device=tab.device)
    owner.scatter_(0, row, torch.arange(row.shape[0], device=tab.device))
    has, owner = has[:n_tab], owner[:n_tab]
    tab.copy_(torch.where(has[:, None, None], acc[owner], tab))


def _plain_resolve_parents(acc: torch.Tensor, bias,
                           parent: torch.Tensor,
                           anchor_tab: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Port of ``_xla_resolve_parents``. Two passes: persistent deltas
    resolve against their anchor-table rows first (anchor entries are
    never in-batch deltas, so that resolution is final), then in-batch
    deltas gather their — now resolved — anchor entries. ``bias`` is
    what the partials already include (the FT bias, or 0 for PSQT)."""
    in_batch, persistent, _, ref, swap, aid = decode_parent(parent)
    if anchor_tab is not None:
        tab_acc = _swap_persp(anchor_tab.to(torch.int32)[aid.long()], swap)
        acc = torch.where(
            persistent[:, None, None], acc + tab_acc - bias, acc
        )
    ref_acc = _swap_persp(acc[ref.long()], swap)
    return torch.where(in_batch[:, None, None], acc + ref_acc - bias, acc)


def ft_accumulate_plain(
    ft_w: torch.Tensor,
    ft_b: torch.Tensor,
    indices: torch.Tensor,
    *,
    delta_base: Optional[int] = None,
    parent: Optional[torch.Tensor] = None,
    anchor_tab: Optional[torch.Tensor] = None,
    ft_psqt: Optional[torch.Tensor] = None,
    psqt_tab: Optional[torch.Tensor] = None,
):
    """The plain PyTorch version of the kernel's dense mode (the JAX
    package's XLA twin), on any device. Same arguments and result as
    ``ft_accumulate``, whose checks it assumes were made."""
    acc = _plain_ft_rows(ft_w, ft_b, indices, delta_base)
    if parent is not None:
        acc = _plain_resolve_parents(
            acc, ft_b.to(torch.int32), parent, anchor_tab
        )
    if ft_psqt is None:
        return acc
    psqt = _plain_psqt_rows(ft_psqt, indices, delta_base)
    if parent is not None:
        psqt = _plain_resolve_parents(psqt, 0, parent, psqt_tab)
    return acc, psqt


def ft_accumulate_packed_plain(
    ft_w: torch.Tensor,
    ft_b: torch.Tensor,
    packed: torch.Tensor,
    offsets: torch.Tensor,
    parent: torch.Tensor,
    anchor_tab: torch.Tensor,
    *,
    ft_psqt: Optional[torch.Tensor] = None,
    psqt_tab: Optional[torch.Tensor] = None,
):
    """The plain version of the kernel's packed mode, on any device:
    ``expand_packed`` -> ``ft_accumulate_plain`` -> the anchor stores
    (``store_anchors``, in place). Same arguments and result as
    ``ft_accumulate_packed``, whose checks it assumes were made."""
    parent = parent.to(torch.int32)
    dense = expand_packed(packed, offsets, parent)
    out = ft_accumulate_plain(
        ft_w, ft_b, dense, delta_base=DELTA_BASE, parent=parent,
        anchor_tab=anchor_tab, ft_psqt=ft_psqt, psqt_tab=psqt_tab,
    )
    acc, psqt = out if ft_psqt is not None else (out, None)
    store_anchors(anchor_tab, acc, parent)
    if psqt is not None:
        store_anchors(psqt_tab, psqt, parent)
    return out


# -- the hand kernel --------------------------------------------------------

_launch_lock = threading.Lock()
#: Per-device kernel state: int32 [4] (a 64-bit ticket — next entry and
#: launch epoch —, an unused word, and the error count the kernel bumps
#: for every out-of-range index and malformed parent reference it
#: refuses to follow) and the int32 ready words of the in-batch
#: resolution, one per entry.
_states: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from fishnet_tpu_torch.ops import _build

        lib = _build.load("ft_gather")
        lib.fc_ft_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # ft_w, rows, l1
            ctypes.c_void_p, ctypes.c_void_p,  # ft_b, ft_psqt
            ctypes.c_void_p,  # idx
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # wire, R, offs
            ctypes.c_int, ctypes.c_void_p,  # B, parent
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # tables, A
            ctypes.c_int,  # delta_base
            ctypes.c_void_p, ctypes.c_void_p,  # acc, psqt
            ctypes.c_void_p, ctypes.c_void_p,  # state, ready
            ctypes.c_void_p,  # stream
        ]
        lib.fc_ft_gather.restype = ctypes.c_int
        _lib = lib
    return _lib


def _device_state(device: torch.device, batch: int):
    """The device's kernel state and ready words (at least ``batch``).
    Allocated zeroed on first use; the kernel keeps them consistent from
    launch to launch without a reset of its own."""
    index = device.index if device.index is not None else 0
    with _launch_lock:
        state, ready = _states.get(index, (None, None))
        if state is None:
            state = torch.zeros(4, dtype=torch.int32, device=device)
        if ready is None or ready.shape[0] < batch:
            # Zeros never equal a launch epoch (epochs count from 1).
            ready = torch.zeros(max(batch, 4096), dtype=torch.int32,
                                device=device)
        _states[index] = (state, ready)
        return state, ready


def error_word(device) -> torch.Tensor:
    """The device's int32 [1] count of out-of-range indices and malformed
    references the kernel refused, as a view that a caller may copy
    without synchronising."""
    state, _ = _device_state(torch.device(device), 0)
    return state[3:4]


def kernel_errors(device=None, reset: bool = False) -> int:
    """Out-of-range indices and malformed references the kernel refused
    on ``device`` since the last reset (synchronises the device)."""
    word = error_word(torch.device("cuda" if device is None else device))
    count = int(word.item())
    if reset:
        word.zero_()
    return count


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: Tuple[Optional[int], ...], device: torch.device) -> None:
    """Refuse what the kernel does not take: wrong dtype, shape, layout
    or alignment, then a tensor on another device (so the checks run the
    same on CPU tensors, which the wrappers refuse last)."""
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_tables(ft_w, ft_b, anchor_tab, ft_psqt, psqt_tab, device):
    """Shared checks of the weights and tables; returns (R, L1, A)."""
    n_rows, l1 = ft_w.shape
    if l1 % 256 or not 256 <= l1 <= 4096:
        raise ValueError(f"L1={l1} must be a multiple of 256 in [256, 4096]")
    _check(ft_w, "ft_w", torch.int16, (n_rows, l1), device)
    _check(ft_b, "ft_b", torch.int16, (l1,), device)
    n_anchor = 0
    if anchor_tab is not None:
        n_anchor = anchor_tab.shape[0]
        _check(anchor_tab, "anchor_tab", torch.int32, (n_anchor, 2, l1),
               device)
    if ft_psqt is not None:
        _check(ft_psqt, "ft_psqt", torch.int32, (n_rows, 8), device)
        if psqt_tab is not None:
            rows = n_anchor if anchor_tab is not None else None
            _check(psqt_tab, "psqt_tab", torch.int32, (rows, 2, 8), device)
    return n_rows, l1, n_anchor


def _launch(ft_w, ft_b, *, n_rows, l1, batch, idx, wire, offsets, parent,
            anchor_tab, psqt_tab, n_anchor, delta_base, ft_psqt, device):
    """One kernel launch on the current stream (packed mode when ``wire``
    is given: it also stores the anchor entries); returns (acc, psqt)."""
    acc = torch.empty((batch, 2, l1), dtype=torch.int32, device=device)
    psqt = (
        torch.empty((batch, 2, 8), dtype=torch.int32, device=device)
        if ft_psqt is not None else None
    )
    if batch == 0:
        return acc, psqt
    state, ready = _device_state(device, batch)
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.fc_ft_gather(
        ft_w.data_ptr(), n_rows, l1, ft_b.data_ptr(), _ptr(ft_psqt),
        _ptr(idx), _ptr(wire), 0 if wire is None else wire.shape[0],
        _ptr(offsets), batch, _ptr(parent),
        _ptr(anchor_tab), _ptr(psqt_tab), n_anchor,
        -1 if delta_base is None else int(delta_base),
        acc.data_ptr(), _ptr(psqt), state.data_ptr(), ready.data_ptr(),
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"ft_gather kernel launch failed: CUDA error {rc}")
    return acc, psqt


def ft_accumulate_cuda(
    ft_w: torch.Tensor,
    ft_b: torch.Tensor,
    indices: torch.Tensor,
    *,
    delta_base: Optional[int] = None,
    parent: Optional[torch.Tensor] = None,
    anchor_tab: Optional[torch.Tensor] = None,
    ft_psqt: Optional[torch.Tensor] = None,
    psqt_tab: Optional[torch.Tensor] = None,
):
    """Launch the hand kernel's dense mode (``csrc/ft_gather.cu``) on the
    current stream. All inputs on one CUDA device, contiguous: ``ft_w``
    int16 [R, L1] (L1 a multiple of 256, at most 4096), ``ft_b`` int16
    [L1], ``indices`` int32 [B, 2, 32], ``parent`` int32 [B], tables
    int32 (read only), ``ft_psqt`` int32 [R, 8]. Raises on anything
    else, and when the launch is refused. Same result as
    ``ft_accumulate_plain``."""
    device = indices.device
    batch = indices.shape[0]
    n_rows, l1, n_anchor = _check_tables(
        ft_w, ft_b, anchor_tab, ft_psqt, psqt_tab, device)
    _check(indices, "indices", torch.int32,
           (batch, 2, MAX_ACTIVE_FEATURES), device)
    if parent is not None:
        _check(parent, "parent", torch.int32, (batch,), device)
    if device.type != "cuda":
        raise ValueError(f"ft_accumulate_cuda needs CUDA tensors, got {device}")
    acc, psqt = _launch(
        ft_w, ft_b, n_rows=n_rows, l1=l1, batch=batch, idx=indices,
        wire=None, offsets=None, parent=parent, anchor_tab=anchor_tab,
        psqt_tab=psqt_tab if ft_psqt is not None else None,
        n_anchor=n_anchor, delta_base=delta_base, ft_psqt=ft_psqt,
        device=device,
    )
    if batch > 0:
        with _launch_lock:
            ft_accumulate_cuda.launches += 1
    return (acc, psqt) if ft_psqt is not None else acc


#: Kernel launches by this wrapper (one per call with a non-empty batch).
ft_accumulate_cuda.launches = 0


def ft_accumulate_packed_cuda(
    ft_w: torch.Tensor,
    ft_b: torch.Tensor,
    packed: torch.Tensor,
    offsets: torch.Tensor,
    parent: torch.Tensor,
    anchor_tab: torch.Tensor,
    *,
    ft_psqt: Optional[torch.Tensor] = None,
    psqt_tab: Optional[torch.Tensor] = None,
):
    """Launch the hand kernel's packed mode on the current stream: the
    wire ``packed`` (int16 [R, 2, 8] carrying the uint16 bits), the row
    ``offsets`` (int32 [B]) and ``parent`` (int32 [B]) in; the
    accumulators out, and every anchor entry's result stored to its
    ``anchor_tab`` row (int32 [A, 2, L1]) and, with ``ft_psqt``, its
    ``psqt_tab`` row (int32 [A, 2, 8]), in place. Weights as in
    ``ft_accumulate_cuda``. Raises on anything else, and when the launch
    is refused. Same result as ``ft_accumulate_packed_plain``."""
    device = packed.device
    if ft_psqt is not None and psqt_tab is None:
        raise ValueError("ft_psqt needs psqt_tab in packed mode")
    n_rows, l1, n_anchor = _check_tables(
        ft_w, ft_b, anchor_tab, ft_psqt, psqt_tab, device)
    _check(packed, "packed", torch.int16, (None, 2, 8), device)
    if packed.shape[0] == 0:
        raise ValueError("packed holds no rows")
    _check(parent, "parent", torch.int32, (None,), device)
    batch = parent.shape[0]
    _check(offsets, "offsets", torch.int32, (batch,), device)
    if device.type != "cuda":
        raise ValueError(
            f"ft_accumulate_packed_cuda needs CUDA tensors, got {device}")
    acc, psqt = _launch(
        ft_w, ft_b, n_rows=n_rows, l1=l1, batch=batch, idx=None,
        wire=packed, offsets=offsets, parent=parent, anchor_tab=anchor_tab,
        psqt_tab=psqt_tab if ft_psqt is not None else None,
        n_anchor=n_anchor, delta_base=DELTA_BASE, ft_psqt=ft_psqt,
        device=device,
    )
    if batch > 0:
        with _launch_lock:
            ft_accumulate_packed_cuda.launches += 1
    return (acc, psqt) if ft_psqt is not None else acc


#: Kernel launches by this wrapper (one per call with a non-empty batch).
ft_accumulate_packed_cuda.launches = 0


def ft_accumulate(
    ft_w: torch.Tensor,
    ft_b: torch.Tensor,
    indices: torch.Tensor,
    *,
    delta_base: Optional[int] = None,
    parent: Optional[torch.Tensor] = None,
    anchor_tab: Optional[torch.Tensor] = None,
    ft_psqt: Optional[torch.Tensor] = None,
    psqt_tab: Optional[torch.Tensor] = None,
):
    """Feature-transformer accumulators, bias included: int32 [B, 2, L1].

    ``ft_w`` [rows, L1] int16 whose LAST row is the zero sentinel;
    ``ft_b`` [L1] int16; ``indices`` integer [B, 2, 32] padded with the
    sentinel index. With ``delta_base`` set, delta entries follow the
    spec.DELTA_SLOTS wire contract: adds in the first slots, removals
    (encoded delta_base + f) after them, the rest sentinel.

    ``parent`` (int32 [B]; see decode_parent) resolves delta entries:
    the result is every entry's complete accumulator. In-batch deltas
    resolve against the entry they reference, persistent codes against
    row ``aid`` of ``anchor_tab`` ([A, 2, L1] int32, read-only here;
    ``ft_accumulate_packed`` stores anchor entries back). With
    ``ft_psqt`` ([rows, 8] int32, same sentinel last row) the result is
    ``(acc, psqt)``: the [B, 2, 8] PSQT accumulator from the same index
    stream, persistent codes resolving against ``psqt_tab`` [A, 2, 8].

    CUDA inputs run the hand kernel, CPU inputs the plain version; both
    give the same integers. Persistent codes without a table raise
    ``ValueError`` before anything runs (on a CUDA ``parent`` that check
    reads the codes back to the host)."""
    indices = indices.to(torch.int32).contiguous()
    if parent is not None:
        parent = parent.to(torch.int32).contiguous()
        if anchor_tab is None or (ft_psqt is not None and psqt_tab is None):
            if bool((parent <= -2).any()):
                raise ValueError(
                    _PERSISTENT_NO_TABLE if anchor_tab is None else
                    "parent contains persistent anchor codes but no "
                    "psqt_tab was given with ft_psqt"
                )
    kwargs = dict(delta_base=delta_base, parent=parent,
                  anchor_tab=anchor_tab, ft_psqt=ft_psqt, psqt_tab=psqt_tab)
    if indices.device.type == "cuda":
        return ft_accumulate_cuda(ft_w, ft_b, indices, **kwargs)
    if indices.device.type != "cpu":
        raise ValueError(f"unsupported device: {indices.device}")
    return ft_accumulate_plain(ft_w, ft_b, indices, **kwargs)


def ft_accumulate_packed(
    ft_w: torch.Tensor,
    ft_b: torch.Tensor,
    packed: torch.Tensor,
    offsets: torch.Tensor,
    parent: torch.Tensor,
    anchor_tab: torch.Tensor,
    *,
    ft_psqt: Optional[torch.Tensor] = None,
    psqt_tab: Optional[torch.Tensor] = None,
):
    """``ft_accumulate`` over the compact wire, with the anchor stores:
    ``packed`` [R, 2, 8] wire rows (uint16 bits; the kernel takes them as
    int16, the plain version either),
    ``offsets`` int [B] each entry's first row (see ``expand_packed``;
    entries past the emitted stream must point into a sentinel block),
    ``parent`` int32 [B] with removals at spec.DELTA_BASE. Persistent
    codes resolve against ``anchor_tab`` [A, 2, L1] int32 (and, with
    ``ft_psqt``, ``psqt_tab`` [A, 2, 8] int32, then required), and every
    anchor entry's resolved result is stored to its rows of both tables
    IN PLACE. Returns ``acc``, or ``(acc, psqt)`` with ``ft_psqt``.

    CUDA inputs run the hand kernel (one launch), CPU inputs the plain
    version; both give the same integers and the same tables."""
    if ft_psqt is not None and psqt_tab is None:
        raise ValueError("ft_psqt needs psqt_tab in packed mode")
    parent = parent.to(torch.int32).contiguous()
    offsets = offsets.to(torch.int32).contiguous()
    kwargs = dict(ft_psqt=ft_psqt, psqt_tab=psqt_tab)
    args = (ft_w, ft_b, packed.contiguous(), offsets, parent, anchor_tab)
    if packed.device.type == "cuda":
        return ft_accumulate_packed_cuda(*args, **kwargs)
    if packed.device.type != "cpu":
        raise ValueError(f"unsupported device: {packed.device}")
    return ft_accumulate_packed_plain(*args, **kwargs)
