"""Batched NNUE evaluation in PyTorch: the port of
``fishnet_tpu/nnue/jax_eval.py``.

Exact integer semantics, bit-identical to the JAX evaluator and to the
C++ scalar oracle (cpp/src/nnue.cpp). The feature-transformer gather
runs in the hand CUDA kernel on the GPU (ops/ft_gather.py); everything
else here — wire expansion, parent decoding, the anchor-table scatter,
the int8 head — is plain torch, as it was XLA code in the JAX package.

Input convention: ``indices`` is integer [B, 2, MAX_ACTIVE] of
HalfKAv2_hm feature indices — perspective 0 is the side to move —
padded with ``NUM_FEATURES`` (a zero row appended to the weights).

Two arithmetic hazards of the port:

* Truncating division: ``/`` in the spec truncates toward zero;
  ``_trunc_div`` uses ``rounding_mode="trunc"``, never ``//`` (floors).
* Integer products: CUDA has no int32 ``matmul``, so the head's three
  int8 x int8 -> int32 products run in float32, which is exact here:
  every operand is an integer and every partial sum stays below
  126 * 128 * 1024 < 2**24, float32's exact-integer range — provided
  TF32 is off (TF32 keeps 10 mantissa bits and rounds these sums;
  ``params_from_numpy`` turns it off for the process). The same float path runs on the CPU, so the CPU tests exercise the
  arithmetic the card runs.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from fishnet_tpu_torch.device import DeviceLike, resolve_device
from fishnet_tpu_torch.nnue import spec
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.ops.ft_gather import decode_parent, ft_accumulate

Params = Dict[str, torch.Tensor]

#: The parameter dict's keys, in the JAX package's order.
PARAM_KEYS = (
    "ft_w", "ft_b", "ft_psqt", "l1_w", "l1_b", "l2_w", "l2_b", "out_w", "out_b",
)


def params_from_numpy(arrays: Mapping[str, np.ndarray],
                      device: DeviceLike = None) -> Params:
    """Device-ready parameters from host arrays keyed like the JAX
    package's parameter pytree — the weight carry-over: pass
    ``{k: np.asarray(v) for k, v in jax_params.items()}`` and get the
    same tensors, bit for bit, on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    # The head's integer products run as float32 matmuls (_int8_products),
    # exact only at full float32 precision: TF32 would round their sums.
    # Every evaluator's parameters pass through here, so pin it once.
    torch.backends.cuda.matmul.allow_tf32 = False
    missing = [k for k in PARAM_KEYS if k not in arrays]
    if missing:
        raise ValueError(f"missing parameters: {missing}")
    # Copied: the tensors own their memory, whatever (read-only, shared)
    # buffer the host arrays view.
    return {
        k: torch.from_numpy(np.array(arrays[k], order="C", copy=True)).to(dev)
        for k in PARAM_KEYS
    }


def params_from_weights(weights: NnueWeights,
                        device: DeviceLike = None) -> Params:
    """Device-ready parameters. The FT tables get a zero sentinel row at
    index NUM_FEATURES so padded feature slots are no-ops (removed-
    feature indices DELTA_BASE+f are decoded by subtraction at eval
    time — the table stays single copy)."""
    ft_w = np.vstack([weights.ft_weight, np.zeros((1, spec.L1), np.int16)])
    ft_psqt = np.vstack(
        [weights.ft_psqt, np.zeros((1, spec.NUM_PSQT_BUCKETS), np.int32)]
    )
    return params_from_numpy({
        "ft_w": ft_w,
        "ft_b": weights.ft_bias,
        "ft_psqt": ft_psqt,
        "l1_w": weights.l1_weight,
        "l1_b": weights.l1_bias,
        "l2_w": weights.l2_weight,
        "l2_b": weights.l2_bias,
        "out_w": weights.out_weight,
        "out_b": weights.out_bias,
    }, device)


def _trunc_div(a: torch.Tensor, d: int) -> torch.Tensor:
    """C-style truncating integer division by a positive constant."""
    return torch.div(a, d, rounding_mode="trunc")


def _int8_products(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bi,koi->bko")`` of int8-range integers with an exact
    int32 result, through a float32 matmul (see the module docstring
    for why that is exact). x [B, I] in 0..127, w [K, O, I] int8."""
    k, o, i = w.shape
    y = x.to(torch.float32) @ w.reshape(k * o, i).to(torch.float32).T
    return y.to(torch.int32).reshape(-1, k, o)


def evaluate_batch(
    params: Params,
    indices: torch.Tensor,
    buckets: torch.Tensor,
    parent: Optional[torch.Tensor] = None,
    material: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Evaluate a batch. ``indices`` integer [B, 2, 32] (stm perspective
    first, padded with NUM_FEATURES); ``buckets`` int [B]. Returns int32
    [B] centipawn scores from the side to move's point of view.

    ``parent`` (optional int32 [B]) enables incremental evaluation:
    -1 marks a standalone full entry; code >= 0 makes the entry a DELTA
    (removals via spec.DELTA_BASE + f) against batch entry
    ``code >> 1``, perspectives swapped when ``code & 1``. Persistent
    anchor codes need the anchored packed path's tables
    (evaluate_packed_anchored) and raise here.

    ``material`` (optional int32 [B]): the host-computed PSQT material
    term. When None the PSQT accumulator comes from the same gather pass
    (full entries) or from this module's in-batch resolution (deltas)."""
    indices = indices.to(torch.int32)
    psqt = None
    if parent is None:
        if material is None:
            acc, psqt = ft_accumulate(
                params["ft_w"], params["ft_b"], indices,
                ft_psqt=params["ft_psqt"],
            )
        else:
            acc = ft_accumulate(params["ft_w"], params["ft_b"], indices)
    else:
        acc = ft_accumulate(
            params["ft_w"], params["ft_b"], indices,
            delta_base=spec.DELTA_BASE, parent=parent,
        )
    return _evaluate_from_acc(
        params, acc, indices, buckets, parent, material, psqt=psqt
    )


def _evaluate_from_acc(
    params: Params,
    acc: torch.Tensor,
    indices: torch.Tensor,
    buckets: torch.Tensor,
    parent: Optional[torch.Tensor],
    material: Optional[torch.Tensor],
    psqt: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The network head past the feature transformer: clipped pairwise
    multiply, bucketed dense stack, PSQT/material blend. ``psqt`` (int32
    [B, 2, 8], fully resolved) short-circuits this function's own PSQT
    gather; without it the gather here resolves IN-BATCH refs only, so
    persistent anchor codes must arrive with ``psqt`` or ``material``
    (they raise otherwise)."""
    buckets = buckets.long()
    rows = torch.arange(acc.shape[0], device=acc.device)
    if material is None and psqt is None:
        if parent is not None and bool((parent <= -2).any()):
            raise ValueError(
                "persistent anchor codes require host-side material "
                "or a device-resolved psqt"
            )
        idx = indices.long()
        if parent is None:
            psqt = params["ft_psqt"][idx].sum(dim=2, dtype=torch.int32)
        else:
            # Removal encodings (DELTA_BASE + f) subtract feature f's
            # row (pads decode to the sentinel), then in-batch deltas add
            # their referenced entry's PSQT, perspective-swapped.
            is_rem = idx >= spec.DELTA_BASE
            base = torch.where(is_rem, idx - spec.DELTA_BASE, idx)
            sign = torch.where(is_rem, -1, 1).to(torch.int32)
            psqt = (params["ft_psqt"][base] * sign[..., None]).sum(
                dim=2, dtype=torch.int32
            )
            parent = parent.to(torch.int32)
            valid = parent >= 0
            ref = torch.where(valid, parent >> 1, 0).long()
            swap = (parent & 1).bool()
            ref_psqt = torch.where(
                swap[:, None, None], psqt[ref].flip(1), psqt[ref]
            )
            psqt = torch.where(valid[:, None, None], psqt + ref_psqt, psqt)

    # Clipped pairwise multiply; stm half first.
    c = acc.clamp(0, spec.FT_CLIP)
    pair = (c[..., : spec.L1_HALF] * c[..., spec.L1_HALF:]) >> spec.PAIRWISE_SHIFT
    x = pair.reshape(pair.shape[0], spec.L1)  # [B, 1024] in 0..126

    # l1 over all 8 buckets, then per-position select.
    y_all = _int8_products(x, params["l1_w"]) + params["l1_b"][None]
    y = y_all[rows, buckets]  # [B, 16]
    skip = y[:, spec.L2]
    h = y[:, : spec.L2]

    # sqr-clipped: clamp |h| first so h*h stays in int32; values past the
    # clamp square to >= 127 anyway (see nnue.cpp for the same identity).
    hs = h.clamp(-8192, 8192)
    sq = torch.clamp((hs * hs) >> spec.SQR_SHIFT, max=spec.FT_CLIP)
    ca = (h >> spec.WEIGHT_SCALE_BITS).clamp(0, spec.FT_CLIP)
    act = torch.cat([sq, ca], dim=1)  # [B, 30] in 0..127

    z_all = _int8_products(act, params["l2_w"]) + params["l2_b"][None]
    z = z_all[rows, buckets]
    z = (z >> spec.WEIGHT_SCALE_BITS).clamp(0, spec.FT_CLIP)

    v_all = _int8_products(z, params["out_w"]) + params["out_b"][None]
    v = v_all[rows, buckets][:, 0]

    if material is None:
        psqt_sel = psqt[rows, :, buckets]  # [B, 2]
        material = _trunc_div(psqt_sel[:, 0] - psqt_sel[:, 1], 2)
    else:
        material = material.to(torch.int32)
    positional = v + skip + _trunc_div(skip * 23, 127)
    return _trunc_div(positional + material, spec.FV_SCALE).to(torch.int32)


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
        _is_delta(parent)[:, None, None],
        torch.full_like(dense[:, :, 8:], spec.NUM_FEATURES),
        dense[:, :, 8:],
    )
    return torch.cat([dense[:, :, :8], tail], dim=2)


def _is_delta(parent: torch.Tensor) -> torch.Tensor:
    """True for one-row (delta) entries under the wire's parent codes:
    in-batch refs (>= 0) and persistent anchor deltas (<= -2 with the
    delta bit); plain fulls (-1) and full anchor (re)seeds own 4 rows."""
    in_batch, persistent, _, _, _, _ = decode_parent(parent)
    return in_batch | persistent


def evaluate_packed_anchored(
    params: Params,
    packed: torch.Tensor,
    buckets: torch.Tensor,
    parent: torch.Tensor,
    material: Optional[torch.Tensor],
    anchor_tab: torch.Tensor,
    n_rows: int,
    psqt_tab: torch.Tensor,
):
    """evaluate_batch over the compact wire with PERSISTENT device-
    resident anchors: ``anchor_tab`` [A, 2, L1] int32 holds one feature-
    transformer accumulator per pool slot of the dispatching group;
    persistent parent codes resolve against it, and every anchor entry's
    resolved accumulator is stored back to its row. ``psqt_tab``
    [A, 2, 8] int32 is its PSQT twin: with ``material=None`` the PSQT
    accumulator comes from the same gather pass and anchor entries'
    resolved PSQT is stored alongside; with ``material`` given (the
    host-material wire) the PSQT path is skipped and ``psqt_tab`` is
    left as it is.

    Both tables are updated IN PLACE (the JAX package donates them to
    the same effect); the return value is still the JAX triple
    ``(values, anchor_tab, psqt_tab)``, with the tables being the very
    tensors passed in.

    Row offsets are derived here (4 rows per full entry, 1 per delta:
    the exclusive cumsum) and clamped to ``n_rows``, the emitted row
    count, where the caller writes one sentinel block: padding entries'
    cumsum runs past the stream into stale rows whose contents can
    exceed the table bounds."""
    parent = parent.to(torch.int32)
    rows_per = torch.where(_is_delta(parent), 1, 4).to(torch.int32)
    offsets = torch.cumsum(rows_per, 0, dtype=torch.int32) - rows_per
    offsets = offsets.clamp(max=int(n_rows))
    return _packed_anchored_core(
        params, packed, offsets, buckets, parent, material,
        anchor_tab, psqt_tab,
    )


def _packed_anchored_core(
    params: Params,
    packed: torch.Tensor,
    offsets: torch.Tensor,
    buckets: torch.Tensor,
    parent: torch.Tensor,
    material: Optional[torch.Tensor],
    anchor_tab: torch.Tensor,
    psqt_tab: torch.Tensor,
):
    """Expand the row stream, accumulate with table resolution, evaluate
    the head, and store anchor entries' resolved accumulators (and PSQT
    twins) to their table rows, in place."""
    dense = expand_packed(packed, offsets, parent)
    psqt = None
    if material is None:
        acc, psqt = ft_accumulate(
            params["ft_w"], params["ft_b"], dense,
            delta_base=spec.DELTA_BASE, parent=parent,
            anchor_tab=anchor_tab, ft_psqt=params["ft_psqt"],
            psqt_tab=psqt_tab,
        )
    else:
        acc = ft_accumulate(
            params["ft_w"], params["ft_b"], dense,
            delta_base=spec.DELTA_BASE, parent=parent,
            anchor_tab=anchor_tab,
        )
    values = _evaluate_from_acc(
        params, acc, dense, buckets, parent, material, psqt=psqt
    )
    _store_anchors(anchor_tab, acc, parent)
    if psqt is not None:
        _store_anchors(psqt_tab, psqt, parent)
    return values, anchor_tab, psqt_tab


def _store_anchors(tab: torch.Tensor, acc: torch.Tensor,
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


def expand_packed_np(packed, offsets, parent):
    """NumPy twin of expand_packed, for hosts that hand a DENSE batch to
    an external evaluator."""
    packed = np.ascontiguousarray(packed)
    rows = offsets[:, None].astype(np.int64) + np.arange(4)
    np.clip(rows, 0, len(packed) - 1, out=rows)
    g = packed[rows]  # [B, 4, 2, 8]
    dense = np.transpose(g, (0, 2, 1, 3)).reshape(-1, 2, 32).copy()
    dense[is_delta_np(parent), :, 8:] = spec.NUM_FEATURES
    return dense


def is_delta_np(parent) -> "np.ndarray":
    """NumPy twin of _is_delta (one-row entries under the wire codes)."""
    parent = np.asarray(parent)
    v = -parent - 2
    return (parent >= 0) | ((parent <= -2) & ((v & 2) != 0))


def anchor_ids_np(parent) -> "np.ndarray":
    """NumPy twin of decode_parent's table-row extraction: the anchor
    row for entries with anchor codes (<= -2), 0 elsewhere."""
    parent = np.asarray(parent)
    v = -parent - 2
    return np.where(parent <= -2, v >> 2, 0)


def derive_offsets_np(parent, n_rows: int) -> "np.ndarray":
    """Host-side twin of the offset derivation: exclusive cumsum of
    rows-per-entry (4 full / 1 delta), padding clamped to the sentinel
    block at ``n_rows``."""
    rows_per = np.where(is_delta_np(parent), 1, 4)
    offsets = np.cumsum(rows_per) - rows_per
    return np.minimum(offsets, n_rows).astype(np.int32)
