"""Batched NNUE evaluation in PyTorch: the port of
``fishnet_tpu/nnue/jax_eval.py``.

Exact integer semantics, bit-identical to the JAX evaluator and to the
C++ scalar oracle (cpp/src/nnue.cpp). The feature-transformer gather
runs in the hand CUDA kernel on the GPU (ops/ft_gather.py); on the
anchored packed path that one launch also reads the wire and stores the
anchor tables (on the CPU: expand_packed and store_anchors, the plain
versions). The int8 head is plain torch, as it was XLA code in the JAX
package.

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

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from fishnet_tpu_torch.device import DeviceLike, resolve_device
from fishnet_tpu_torch.nnue import spec
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.ops.ft_gather import (  # noqa: F401 - re-exported
    check_copy_src,
    derive_segment_offsets,
    expand_packed,
    ft_accumulate,
    ft_accumulate_packed,
    is_delta as _is_delta,
    recode_segment_parents,
)

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
    indices: Optional[torch.Tensor],
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


def evaluate_packed(
    params: Params,
    packed: torch.Tensor,
    offsets: torch.Tensor,
    buckets: torch.Tensor,
    parent: torch.Tensor,
    material: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """evaluate_batch over the compact wire without anchor tables (the
    legacy sharded evaluator's shard call): ``expand_packed`` on the
    inputs' device, then the kernel's dense mode with in-batch
    parents."""
    dense = expand_packed(packed, offsets, parent)
    return evaluate_batch(params, dense, buckets, parent, material)


def evaluate_packed_anchored(
    params: Params,
    packed: torch.Tensor,
    buckets: torch.Tensor,
    parent: torch.Tensor,
    material: Optional[torch.Tensor],
    anchor_tab: torch.Tensor,
    n_rows: int,
    psqt_tab: torch.Tensor,
    *,
    offsets: Optional[torch.Tensor] = None,
    copy_src=None,
    parent_host=None,
    store_psqt: bool = False,
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

    Row offsets are derived here when ``offsets`` is None (4 rows per
    full entry, 1 per delta: the exclusive cumsum) and clamped to
    ``n_rows``, the emitted row count, where the caller writes one
    sentinel block: padding entries' cumsum runs past the stream into
    stale rows whose contents can exceed the table bounds. A caller that
    has the pool's offsets (int32 [B], padding entries already pointing
    at ``n_rows``) passes them instead and saves the derivation.
    ``copy_src``, ``parent_host``: the fan-in of
    ``_packed_anchored_core``. ``store_psqt`` (the serving mesh's
    host-material rung): with ``material`` given, still compute and
    store the PSQT of anchor entries, so ``psqt_tab`` stays exact for a
    later dispatch on a device-PSQT rung; the head reads ``material``."""
    parent = parent.to(torch.int32)
    if offsets is None:
        rows_per = torch.where(_is_delta(parent), 1, 4).to(torch.int32)
        offsets = torch.cumsum(rows_per, 0, dtype=torch.int32) - rows_per
        offsets = offsets.clamp(max=int(n_rows))
    return _packed_anchored_core(
        params, packed, offsets, buckets, parent, material,
        anchor_tab, psqt_tab, copy_src=copy_src, parent_host=parent_host,
        store_psqt=store_psqt,
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
    copy_src: Optional[torch.Tensor] = None,
    parent_host=None,
    store_psqt: bool = False,
):
    """Accumulate over the row stream with table resolution and the
    anchor stores (one kernel launch on CUDA; expand_packed,
    ft_accumulate_plain and store_anchors on the CPU), then evaluate the
    head.

    ``copy_src`` (optional int [B] on the host — numpy or a CPU tensor,
    pinned for an asynchronous upload — the position-dedup fan-in of
    ``plan_segment_dedup``) gives entry i the accumulator (and PSQT) of
    entry ``copy_src[i]``, identity for kept entries, as the JAX package
    does before its head and its table scatter: a redirected store
    entry stores its source's bytes to its table rows. On the card that
    is the kernel's copy-source mode (the fan-in inside the launch,
    before its stores), on the CPU the plain version's. Its contract
    (``check_copy_src``: each source in range, earlier in wire order and
    not itself redirected, and no redirected entry the anchor of an
    in-batch delta) is checked here, before the upload, and raises
    ``ValueError``. It reads the parent codes on the host:
    ``parent_host`` (numpy [B], the codes ``parent`` holds) when the
    caller has them, as the service does, else ``parent`` itself — a
    copy from the card, which waits for it."""
    if copy_src is not None and parent_host is None:
        parent_host = parent.cpu()
    checked = check_copy_src(copy_src, parent.shape[0], parent_host)
    if checked is None:
        copy_src = None
    else:
        if not isinstance(copy_src, torch.Tensor):
            copy_src = torch.from_numpy(checked)
        copy_src = copy_src.to(device=parent.device, dtype=torch.int32,
                               non_blocking=True)
    psqt = None
    if material is None or store_psqt:
        acc, psqt = ft_accumulate_packed(
            params["ft_w"], params["ft_b"], packed, offsets, parent,
            anchor_tab, ft_psqt=params["ft_psqt"], psqt_tab=psqt_tab,
            copy_src=copy_src,
        )
        if material is not None:
            psqt = None  # the head reads the wire's material
    else:
        acc = ft_accumulate_packed(
            params["ft_w"], params["ft_b"], packed, offsets, parent,
            anchor_tab, copy_src=copy_src,
        )
    values = _evaluate_from_acc(
        params, acc, None, buckets, parent, material, psqt=psqt
    )
    return values, anchor_tab, psqt_tab


def evaluate_packed_anchored_segmented(
    params: Params,
    packed: torch.Tensor,
    buckets: torch.Tensor,
    parent: torch.Tensor,
    material: Optional[torch.Tensor],
    anchor_tabs: torch.Tensor,
    seg_rows: torch.Tensor,
    psqt_tabs: torch.Tensor,
    copy_src: Optional[torch.Tensor] = None,
    *,
    groups: Optional[Sequence[int]] = None,
):
    """K groups' packed row streams evaluated in ONE dispatch: the port
    of the JAX package's ``evaluate_packed_anchored_segmented``.

    Layout as in the JAX package: ``packed`` [K * tier, 2, 8] is K
    streams, each padded to the common row tier with its OWN sentinel
    block at its emitted-row count ``seg_rows[k]``; ``buckets`` and
    ``parent`` (and ``material`` on the host-material rung) are
    [K * size] with segment-local parent codes. ``anchor_tabs``
    [G, A, 2, L1] and ``psqt_tabs`` [G, A, 2, 8] hold the tables of G
    groups, contiguous; segment k is group ``groups[k]`` (default k, the
    JAX package's stacked tables, G = K). The offsets are derived, the
    parents rebased into the fused frame (``recode_segment_parents``:
    persistent codes address block ``groups[k]`` of the flat
    [G * A, ...] table), and one ``_packed_anchored_core`` call — one
    kernel launch on CUDA — evaluates every segment and stores every
    anchor entry to its own group's rows, IN PLACE.

    Returns ``(values [K * size], anchor_tabs, psqt_tabs)``; segment k's
    real entries are ``values[k * size : k * size + n_k]``, equal to a
    solo ``evaluate_packed_anchored`` of that stream on that group's
    table. ``copy_src`` (flat int [K * size]): see
    ``_packed_anchored_core``."""
    k_segs = len(groups) if groups is not None else anchor_tabs.shape[0]
    anchor_rows = anchor_tabs.shape[1]
    size = buckets.shape[0] // k_segs
    tier = packed.shape[0] // k_segs
    parent = parent.to(torch.int32).reshape(k_segs, size)
    offsets = derive_segment_offsets(parent, seg_rows, tier)
    gparent = recode_segment_parents(parent, anchor_rows, groups)
    n_tab = anchor_tabs.shape[0] * anchor_rows
    values, _, _ = _packed_anchored_core(
        params, packed, offsets, buckets, gparent, material,
        anchor_tabs.view(n_tab, 2, -1), psqt_tabs.view(n_tab, 2, -1),
        copy_src=copy_src,
    )
    return values, anchor_tabs, psqt_tabs


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
