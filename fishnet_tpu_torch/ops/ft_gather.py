"""NNUE feature-transformer gather-accumulate: the hand-written Hopper
kernel and its plain PyTorch version.

The feature transformer is the NNUE hot op: for every position and both
perspectives, sum up to 32 rows of a [22529, 1024] int16 table and add
the bias; the same index stream also sums the 8-bucket PSQT columns.
The wire's parent codes (``decode_parent``) make most entries DELTAS:
they carry a few added and removed rows and resolve against an anchor —
another entry of the batch, or a row of the persistent per-slot anchor
table that lives on the device across steps.

Two executors compute the same integers:

* ``ft_accumulate_cuda`` launches the hand kernel
  (``csrc/ft_gather.cu``), the port of the Pallas TPU kernel
  ``fishnet_tpu/ops/ft_gather.py:_kernel``. It counts its launches in
  ``ft_accumulate_cuda.launches``.
* ``ft_accumulate_plain`` is the port of the JAX package's XLA twin
  (``_xla_ft_accumulate``, ``_xla_psqt_accumulate``,
  ``_xla_resolve_parents``): gather, sum, resolve by explicit reference.

``ft_accumulate`` picks by the device of its inputs: the kernel for
CUDA tensors (it launches or raises; there is no fallback) and the plain
version for CPU tensors.

Poison versus raise: the JAX package poisons persistent codes that
arrive without a table when they are traced (``_POISON_ACC``) and
raises when they are concrete. Torch is eager, so the port always
raises, and the traced-poison branches have no counterpart.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from fishnet_tpu_torch.nnue.spec import MAX_ACTIVE_FEATURES

__all__ = [
    "decode_parent",
    "ft_accumulate",
    "ft_accumulate_cuda",
    "ft_accumulate_plain",
    "kernel_errors",
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
    """The plain PyTorch version of the kernel (the JAX package's XLA
    twin), on any device. Same arguments and result as
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


# -- the hand kernel --------------------------------------------------------

_launch_lock = threading.Lock()
#: Per-device int32 error word the kernel bumps for every out-of-range
#: index and malformed parent reference it refuses to follow.
_error_words: Dict[int, torch.Tensor] = {}
_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from fishnet_tpu_torch.ops import _build

        lib = _build.load("ft_gather")
        lib.fc_ft_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # ft_w, rows, l1
            ctypes.c_void_p, ctypes.c_void_p,  # ft_b, ft_psqt
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # idx, B, parent
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # tables, A
            ctypes.c_int,  # delta_base
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # outs, err
            ctypes.c_void_p,  # stream
        ]
        lib.fc_ft_gather.restype = ctypes.c_int
        _lib = lib
    return _lib


def _error_word(device: torch.device) -> torch.Tensor:
    index = device.index if device.index is not None else 0
    with _launch_lock:
        word = _error_words.get(index)
        if word is None:
            word = torch.zeros(1, dtype=torch.int32, device=device)
            _error_words[index] = word
        return word


def kernel_errors(device=None, reset: bool = False) -> int:
    """Out-of-range indices and malformed references the kernel refused
    on ``device`` since the last reset (synchronises the device)."""
    word = _error_word(torch.device("cuda" if device is None else device))
    count = int(word.item())
    if reset:
        word.zero_()
    return count


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: Tuple[Optional[int], ...], device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


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
    """Launch the hand kernel (``csrc/ft_gather.cu``) on the current
    stream. All inputs on one CUDA device, contiguous: ``ft_w`` int16
    [R, L1] (L1 a multiple of 8, 256..8192), ``ft_b`` int16 [L1],
    ``indices`` int32 [B, 2, 32], ``parent`` int32 [B], tables int32,
    ``ft_psqt`` int32 [R, 8]. Raises on anything else, and when the
    launch is refused. Same result as ``ft_accumulate_plain``."""
    device = indices.device
    if device.type != "cuda":
        raise ValueError(f"ft_accumulate_cuda needs CUDA tensors, got {device}")
    n_rows, l1 = ft_w.shape
    batch = indices.shape[0]
    if l1 % 8 or not 256 <= l1 <= 8192:
        raise ValueError(f"L1={l1} must be a multiple of 8 in [256, 8192]")
    _check(ft_w, "ft_w", torch.int16, (n_rows, l1), device)
    _check(ft_b, "ft_b", torch.int16, (l1,), device)
    _check(indices, "indices", torch.int32,
           (batch, 2, MAX_ACTIVE_FEATURES), device)
    if parent is not None:
        _check(parent, "parent", torch.int32, (batch,), device)
    n_anchor = 0
    if anchor_tab is not None:
        n_anchor = anchor_tab.shape[0]
        _check(anchor_tab, "anchor_tab", torch.int32, (n_anchor, 2, l1), device)
    with_psqt = ft_psqt is not None
    if with_psqt:
        _check(ft_psqt, "ft_psqt", torch.int32, (n_rows, 8), device)
        if psqt_tab is not None:
            rows = n_anchor if anchor_tab is not None else None
            _check(psqt_tab, "psqt_tab", torch.int32, (rows, 2, 8), device)
    acc = torch.empty((batch, 2, l1), dtype=torch.int32, device=device)
    psqt = (
        torch.empty((batch, 2, 8), dtype=torch.int32, device=device)
        if with_psqt else None
    )
    err = _error_word(device)
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.fc_ft_gather(
        ft_w.data_ptr(), n_rows, l1, ft_b.data_ptr(), _ptr(ft_psqt),
        indices.data_ptr(), batch, _ptr(parent),
        _ptr(anchor_tab), _ptr(psqt_tab), n_anchor,
        -1 if delta_base is None else int(delta_base),
        acc.data_ptr(), _ptr(psqt), err.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"ft_gather kernel launch failed: CUDA error {rc}")
    with _launch_lock:
        ft_accumulate_cuda.launches += 1
    return (acc, psqt) if with_psqt else acc


#: Wrapper calls that launched the kernel (one per call; the call's
#: gather and in-batch resolve launches count together).
ft_accumulate_cuda.launches = 0


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
    callers store anchor entries back). With ``ft_psqt`` ([rows, 8]
    int32, same sentinel last row) the result is ``(acc, psqt)``: the
    [B, 2, 8] PSQT accumulator from the same index stream, persistent
    codes resolving against ``psqt_tab`` [A, 2, 8].

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
