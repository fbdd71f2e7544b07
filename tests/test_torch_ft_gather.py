"""The port's feature-transformer gather (fishnet_tpu_torch.ops.ft_gather)
against the JAX package's (fishnet_tpu.ops.ft_gather), bit for bit.

The port's CPU path is the plain version of its hand CUDA kernel; it is
held against both JAX executors: the XLA twin and the Pallas kernel in
interpret mode (the JAX package's own CPU venue for that kernel). The
kernel itself runs only on the card (chip_smoke.py holds it against the
plain version there).

Divergence from the reference, by design: JAX poisons persistent codes
that arrive without a table while TRACED (``_POISON_ACC``) and raises
when they are concrete. Torch is always eager, so the port always
raises; the traced-poison branches have no counterpart to test.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fishnet_tpu.ops import ft_gather as jax_ft
from fishnet_tpu_torch.nnue.spec import DELTA_SLOTS
from fishnet_tpu_torch.ops import ft_gather as port_ft

N_FEATURES, L1 = 512, 1024  # interpret mode needs L1 % 1024 == 0


def _pers_code(aid, is_delta, swap=0):
    """Wire anchor-entry codes (cpp/src/pool.cpp emit_block)."""
    return -(2 + ((aid << 2) | (2 if is_delta else 0) | swap))


def _tables(rng):
    ft_w = np.vstack(
        [rng.integers(-200, 200, (N_FEATURES, L1)), np.zeros((1, L1))]
    ).astype(np.int16)
    ft_b = rng.integers(-100, 100, (L1,)).astype(np.int16)
    ft_psqt = np.vstack(
        [rng.integers(-3000, 3000, (N_FEATURES, 8)), np.zeros((1, 8))]
    ).astype(np.int32)
    return ft_w, ft_b, ft_psqt


def _all_kinds_batch(rng, n_blocks=4, block=4, n_tab=8, active=32):
    """Every wire entry kind: plain fulls (-1), anchor full (re)seeds,
    persistent anchor deltas (with swap), in-batch deltas (with swap),
    removal encodings and per-region sentinel padding; in-batch refs
    point at the most recent preceding anchor entry, as the pool emits."""
    delta_base = N_FEATURES + 1
    batch = n_blocks * block
    idx = np.full((batch, 2, active), N_FEATURES, np.int32)
    parent = np.full((batch,), -1, np.int32)

    def fill_full(e):
        idx[e, :, : active - 3] = rng.integers(0, N_FEATURES, (2, active - 3))

    def fill_delta(e):
        for p in range(2):
            n_add = int(rng.integers(0, DELTA_SLOTS + 1))
            n_rem = int(rng.integers(0, DELTA_SLOTS + 1))
            idx[e, p, :n_add] = rng.integers(0, N_FEATURES, n_add)
            idx[e, p, DELTA_SLOTS: DELTA_SLOTS + n_rem] = (
                delta_base + rng.integers(0, N_FEATURES, n_rem)
            )
            idx[e, p, DELTA_SLOTS + n_rem: 2 * DELTA_SLOTS] = (
                delta_base + N_FEATURES
            )

    for k, s in enumerate(range(0, batch, block)):
        kind = k % 3
        if kind == 0 and k > 0:
            fill_full(s)
        elif kind == 2 and k > 0:
            parent[s] = _pers_code(k % n_tab, True, swap=int(rng.integers(0, 2)))
            fill_delta(s)
        else:
            parent[s] = _pers_code(k % n_tab, False)
            fill_full(s)
        for j in range(1, block):
            parent[s + j] = (s << 1) | int(rng.integers(0, 2))
            fill_delta(s + j)
    return idx, parent, delta_base


def _port(ft_w, ft_b, idx, **kw):
    t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in kw.items()}
    out = port_ft.ft_accumulate(
        torch.from_numpy(ft_w), torch.from_numpy(ft_b), torch.from_numpy(idx),
        **t,
    )
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _jax(ft_w, ft_b, idx, **kw):
    j = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
         for k, v in kw.items()}
    out = jax_ft.ft_accumulate(
        jnp.asarray(ft_w), jnp.asarray(ft_b), jnp.asarray(idx), **j
    )
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _assert_same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == np.int32 and np.array_equal(x, y)
    else:
        assert a.dtype == np.int32 and np.array_equal(a, b)


def _full_batch(rng, active=32, batch=5):
    idx = rng.integers(0, N_FEATURES, (batch, 2, active)).astype(np.int32)
    idx[:, :, active - 3:] = N_FEATURES  # sentinel padding
    idx[-1] = N_FEATURES  # an all-padding entry: bias only
    return idx


@pytest.mark.parametrize("with_psqt", [False, True])
def test_full_entries_match_xla(with_psqt):
    rng = np.random.default_rng(1)
    ft_w, ft_b, ft_psqt = _tables(rng)
    idx = _full_batch(rng)
    kw = {"ft_psqt": ft_psqt} if with_psqt else {}
    _assert_same(
        _port(ft_w, ft_b, idx, **kw),
        _jax(ft_w, ft_b, idx, use_pallas=False, **kw),
    )


def test_full_entries_match_pallas_interpret():
    # 16 slots halve the interpreter's unrolled trace (its cost is
    # trace-bound, as in tests/test_ops.py); the XLA cases keep 32.
    rng = np.random.default_rng(2)
    ft_w, ft_b, ft_psqt = _tables(rng)
    idx = _full_batch(rng, active=16, batch=3)
    _assert_same(
        _port(ft_w, ft_b, idx, ft_psqt=ft_psqt),
        _jax(ft_w, ft_b, idx, interpret=True, ft_psqt=ft_psqt),
    )


def test_in_batch_deltas_without_tables_match_xla():
    rng = np.random.default_rng(11)
    ft_w, ft_b, _ = _tables(rng)
    idx, parent, delta_base = _all_kinds_batch(rng, n_blocks=3, block=5)
    # No tables: strip the anchor codes to plain fulls / drop persistent
    # deltas to fulls, keeping the in-batch structure.
    parent = np.where(parent <= -2, -1, parent).astype(np.int32)
    for s in np.nonzero(parent == -1)[0]:
        if (idx[s, :, 8:] == N_FEATURES).all():
            idx[s, :, :29] = rng.integers(0, N_FEATURES, (2, 29))
    kw = dict(delta_base=delta_base, parent=parent)
    _assert_same(
        _port(ft_w, ft_b, idx, **kw),
        _jax(ft_w, ft_b, idx, use_pallas=False, **kw),
    )


def _all_kinds_args(rng, with_psqt, active=32, n_blocks=4):
    ft_w, ft_b, ft_psqt = _tables(rng)
    idx, parent, delta_base = _all_kinds_batch(
        rng, n_blocks=n_blocks, active=active
    )
    tab = rng.integers(-5000, 5000, (8, 2, L1)).astype(np.int32)
    kw = dict(delta_base=delta_base, parent=parent, anchor_tab=tab)
    if with_psqt:
        kw.update(ft_psqt=ft_psqt,
                  psqt_tab=rng.integers(-4000, 4000, (8, 2, 8)).astype(np.int32))
    return ft_w, ft_b, idx, kw


@pytest.mark.parametrize("with_psqt", [False, True])
def test_all_entry_kinds_with_tables_match_xla(with_psqt):
    ft_w, ft_b, idx, kw = _all_kinds_args(np.random.default_rng(77), with_psqt)
    _assert_same(
        _port(ft_w, ft_b, idx, **kw),
        _jax(ft_w, ft_b, idx, use_pallas=False, **kw),
    )


def test_all_entry_kinds_with_tables_match_pallas_interpret():
    # Three blocks of four: two anchor stores and a persistent delta,
    # each followed by in-batch deltas (plain fulls: the XLA cases).
    ft_w, ft_b, idx, kw = _all_kinds_args(
        np.random.default_rng(78), True, active=16, n_blocks=3
    )
    _assert_same(
        _port(ft_w, ft_b, idx, **kw),
        _jax(ft_w, ft_b, idx, interpret=True, **kw),
    )


def test_plain_version_matches_independent_int64_walk():
    """The plain version against a hand walk of the wire contract in
    int64 (no kernel machinery, explicit references)."""
    rng = np.random.default_rng(5)
    ft_w, ft_b, ft_psqt = _tables(rng)
    idx, parent, delta_base = _all_kinds_batch(rng, n_blocks=3, block=3)
    tab = rng.integers(-5000, 5000, (8, 2, L1)).astype(np.int32)
    ptab = rng.integers(-4000, 4000, (8, 2, 8)).astype(np.int32)
    acc, psqt = _port(ft_w, ft_b, idx, delta_base=delta_base, parent=parent,
                      anchor_tab=tab, ft_psqt=ft_psqt, psqt_tab=ptab)
    w64, p64 = ft_w.astype(np.int64), ft_psqt.astype(np.int64)
    exp = np.zeros((len(parent), 2, L1), np.int64)
    pexp = np.zeros((len(parent), 2, 8), np.int64)
    for b, code in enumerate(parent.tolist()):
        v = -code - 2
        if code >= 0:
            base, pbase, swap = exp[code >> 1], pexp[code >> 1], code & 1
        elif code <= -2 and v & 2:
            base, pbase, swap = tab[v >> 2], ptab[v >> 2], v & 1
        else:
            base, pbase, swap = None, None, 0
        for p in range(2):
            if base is None:
                exp[b, p] = ft_b
            else:
                exp[b, p] = base[p ^ swap]
                pexp[b, p] = pbase[p ^ swap]
            for f in idx[b, p].tolist():
                sign = -1 if f >= delta_base else 1
                f = f - delta_base if f >= delta_base else f
                exp[b, p] += sign * w64[f]
                pexp[b, p] += sign * p64[f]
    assert np.array_equal(acc.astype(np.int64), exp)
    assert np.array_equal(psqt.astype(np.int64), pexp)


def test_decode_parent_matches_jax():
    codes = np.array(
        [-1, 5, 4, 0, -(2 + (3 << 2) + 2 + 1), -(2 + (7 << 2)),
         -(2 + (1 << 2) + 1), -(2 + (9 << 2) + 2)],
        np.int32,
    )
    port = port_ft.decode_parent(torch.from_numpy(codes))
    ref = jax_ft.decode_parent(jnp.asarray(codes))
    for a, b in zip(port, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_persistent_codes_without_table_raise_eagerly():
    rng = np.random.default_rng(3)
    ft_w, ft_b, ft_psqt = _tables(rng)
    idx = np.full((3, 2, 32), N_FEATURES, np.int32)
    parent = np.array([-1, -4, -1], np.int32)  # -4: persistent delta code
    kw = dict(delta_base=N_FEATURES + 1, parent=parent)
    with pytest.raises(ValueError, match="anchor_tab"):
        _port(ft_w, ft_b, idx, **kw)
    with pytest.raises(ValueError, match="anchor_tab"):
        _jax(ft_w, ft_b, idx, use_pallas=False, **kw)
    # With ft_psqt the PSQT twin table is required too (JAX would
    # poison the PSQT of those entries; eager torch raises).
    tab = np.zeros((2, 2, L1), np.int32)
    with pytest.raises(ValueError, match="psqt_tab"):
        _port(ft_w, ft_b, idx, anchor_tab=tab, ft_psqt=ft_psqt, **kw)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never runs the plain version: it launches
    on CUDA tensors or raises."""
    rng = np.random.default_rng(4)
    ft_w, ft_b, _ = _tables(rng)
    idx = np.full((2, 2, 32), N_FEATURES, np.int32)
    with pytest.raises(ValueError, match="CUDA"):
        port_ft.ft_accumulate_cuda(
            torch.from_numpy(ft_w), torch.from_numpy(ft_b),
            torch.from_numpy(idx),
        )
    assert port_ft.ft_accumulate_cuda.launches == 0


def test_kernel_build_needs_nvcc_and_is_keyed_by_source(monkeypatch, tmp_path):
    """Nothing is built at import; a build without nvcc fails loudly
    (never a silent plain-version run), and the library name hashes the
    source, so an edited kernel never loads a stale build."""
    from fishnet_tpu_torch.ops import _build

    assert (_build.CSRC_DIR / "ft_gather.cu").is_file()
    name = _build.library_path("ft_gather").name
    assert name.startswith("libft_gather-") and name.endswith(".so")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.nvcc_path()


# -- packed mode: the wire in, the anchor tables stored -----------------------

from fishnet_tpu.nnue import jax_eval  # noqa: E402
from fishnet_tpu_torch.nnue import spec  # noqa: E402

#: Features of the packed cases: the wire's sentinel and removal base are
#: the spec's, so the tables keep the spec's row count; only the first
#: rows are non-zero, which keeps them cheap to make.
PACKED_LIVE = 512


def _packed_tables(rng):
    ft_w = np.zeros((spec.NUM_FEATURES + 1, L1), np.int16)
    ft_w[:PACKED_LIVE] = rng.integers(-200, 200, (PACKED_LIVE, L1))
    ft_b = rng.integers(-100, 100, (L1,)).astype(np.int16)
    ft_psqt = np.zeros((spec.NUM_FEATURES + 1, 8), np.int32)
    ft_psqt[:PACKED_LIVE] = rng.integers(-3000, 3000, (PACKED_LIVE, 8))
    return ft_w, ft_b, ft_psqt


def _packed_wire(rng, n_tab=6):
    """A wire batch with every entry kind, as cpp/src/pool.cpp emits it:
    a plain full, full anchor stores, persistent deltas with and without
    swap, in-batch deltas (swapped and not) against the most recent
    anchor, two padding entries that point at the sentinel block, and
    out-of-table garbage in the stale rows past it. Returns (packed
    uint16, offsets, parent, n_rows, anchor_tab, psqt_tab)."""
    nf, db = spec.NUM_FEATURES, spec.DELTA_BASE
    kinds = [("store", 0), ("in_batch", 0), ("in_batch", 0),
             ("persistent", 3, 1), ("in_batch", 3), ("full",),
             ("in_batch", 5), ("persistent", 2, 0), ("in_batch", 7),
             ("persistent", 5, 1)]
    size = len(kinds) + 2
    packed = np.full((4 * size + 8, 2, 8), nf, np.uint16)
    parent = np.full((size,), -1, np.int32)
    rows = 0
    for e, kind in enumerate(kinds):
        if kind[0] in ("store", "full"):
            live = int(rng.integers(20, 33))
            slots = np.full((2, 32), nf, np.int64)
            slots[:, :live] = rng.integers(0, PACKED_LIVE, (2, live))
            packed[rows: rows + 4] = slots.reshape(2, 4, 8).transpose(1, 0, 2)
            parent[e] = _pers_code(kind[1], False) if kind[0] == "store" else -1
            rows += 4
            continue
        for p in range(2):
            n_add, n_rem = int(rng.integers(0, 5)), int(rng.integers(0, 5))
            packed[rows, p, :n_add] = rng.integers(0, PACKED_LIVE, n_add)
            packed[rows, p, 4:4 + n_rem] = db + rng.integers(
                0, PACKED_LIVE, n_rem)
            packed[rows, p, 4 + n_rem:] = db + nf
        if kind[0] == "in_batch":
            parent[e] = (kind[1] << 1) | int(rng.integers(0, 2))
        else:
            parent[e] = _pers_code(kind[1], True, swap=kind[2])
        rows += 1
    packed[rows + 4:] = 60000  # stale rows past the sentinel block
    offsets = jax_eval.derive_offsets_np(parent, rows)
    tab = rng.integers(-5000, 5000, (n_tab, 2, L1)).astype(np.int32)
    ptab = rng.integers(-4000, 4000, (n_tab, 2, 8)).astype(np.int32)
    return packed, offsets, parent, rows, tab, ptab


def _jax_packed(ft_w, ft_b, ft_psqt, packed, offsets, parent, tab, ptab,
                with_psqt, **executor):
    """The JAX package's packed path: expand_packed -> ft_accumulate ->
    the table update of evaluate_packed_anchored."""
    dense = jax_eval.expand_packed(
        jnp.asarray(packed), jnp.asarray(offsets), jnp.asarray(parent))
    kw = dict(delta_base=spec.DELTA_BASE, parent=jnp.asarray(parent),
              anchor_tab=jnp.asarray(tab))
    if with_psqt:
        kw.update(ft_psqt=jnp.asarray(ft_psqt), psqt_tab=jnp.asarray(ptab))
    out = jax_ft.ft_accumulate(
        jnp.asarray(ft_w), jnp.asarray(ft_b), dense, **kw, **executor)
    acc, psqt = out if with_psqt else (out, None)
    _, _, stores, _, _, aid = jax_ft.decode_parent(jnp.asarray(parent))
    row = jnp.where(stores, aid, tab.shape[0])
    new_tab = jnp.asarray(tab).at[row].set(acc, mode="drop")
    new_ptab = (jnp.asarray(ptab).at[row].set(psqt, mode="drop")
                if with_psqt else jnp.asarray(ptab))
    return [np.asarray(acc)] + ([np.asarray(psqt)] if with_psqt else []) + [
        np.asarray(new_tab), np.asarray(new_ptab)]


@pytest.mark.parametrize("executor,with_psqt", [
    ("xla", False), ("xla", True),
    ("pallas-interpret", False), ("pallas-interpret", True),
])
def test_packed_matches_jax(executor, with_psqt):
    """ft_accumulate_packed on the CPU (the plain version: expand_packed,
    ft_accumulate_plain, store_anchors) against the JAX package's packed
    path, bit for bit on the accumulators and both tables, over every
    entry kind including swapped persistent deltas."""
    rng = np.random.default_rng(21 + with_psqt)
    ft_w, ft_b, ft_psqt = _packed_tables(rng)
    packed, offsets, parent, _, tab, ptab = _packed_wire(rng)
    assert ((parent <= -2) & (((-parent - 2) & 3) == 3)).any()  # swapped
    jkw = ({"use_pallas": False} if executor == "xla"
           else {"interpret": True})
    ref = _jax_packed(ft_w, ft_b, ft_psqt, packed, offsets, parent, tab,
                      ptab, with_psqt, **jkw)
    ttab, tptab = torch.from_numpy(tab.copy()), torch.from_numpy(ptab.copy())
    out = port_ft.ft_accumulate_packed(
        torch.from_numpy(ft_w), torch.from_numpy(ft_b),
        torch.from_numpy(packed.view(np.int16)), torch.from_numpy(offsets),
        torch.from_numpy(parent), ttab,
        **({"ft_psqt": torch.from_numpy(ft_psqt), "psqt_tab": tptab}
           if with_psqt else {}),
    )
    got = (list(out) if with_psqt else [out]) + [ttab, tptab]
    _assert_same(tuple(g.numpy() for g in got), tuple(ref))
    # The stores happened (rows 0, 3, 2 and 5) and the rest stayed.
    assert not np.array_equal(ttab.numpy()[3], tab[3])
    assert np.array_equal(ttab.numpy()[1], tab[1])
    assert np.array_equal(tptab.numpy(), ptab) != with_psqt


def _packed_cuda_args(rng):
    ft_w, ft_b, ft_psqt = _packed_tables(rng)
    packed, offsets, parent, _, tab, ptab = _packed_wire(rng)
    return dict(
        ft_w=torch.from_numpy(ft_w), ft_b=torch.from_numpy(ft_b),
        packed=torch.from_numpy(packed.view(np.int16)),
        offsets=torch.from_numpy(offsets), parent=torch.from_numpy(parent),
        anchor_tab=torch.from_numpy(tab), ft_psqt=torch.from_numpy(ft_psqt),
        psqt_tab=torch.from_numpy(ptab),
    )


def _misaligned(t):
    """The same values, contiguous, starting 2 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype)
    view = flat[1: 1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"),
    ("packed_dtype", "packed must be"),
    ("packed_shape", "packed has shape"),
    ("offsets_length", "offsets has shape"),
    ("parent_dtype", "parent must be"),
    ("misaligned_bias", "16-byte aligned"),
    ("psqt_without_table", "psqt_tab"),
])
def test_packed_cuda_wrapper_refuses(case, match):
    """The packed kernel's wrapper never runs the plain version: it
    launches on CUDA tensors or raises, before any launch, on CPU
    tensors and on the dtypes, shapes and layouts the kernel does not
    take."""
    kw = _packed_cuda_args(np.random.default_rng(6))
    if case == "packed_dtype":
        kw["packed"] = kw["packed"].to(torch.int32)
    elif case == "packed_shape":
        kw["packed"] = kw["packed"].reshape(-1, 4, 4)
    elif case == "offsets_length":
        kw["offsets"] = kw["offsets"][:-1].contiguous()
    elif case == "parent_dtype":
        kw["parent"] = kw["parent"].long()
    elif case == "misaligned_bias":
        kw["ft_b"] = _misaligned(kw["ft_b"])
    elif case == "psqt_without_table":
        kw["psqt_tab"] = None
    with pytest.raises(ValueError, match=match):
        port_ft.ft_accumulate_packed_cuda(**kw)
    assert port_ft.ft_accumulate_packed_cuda.launches == 0
    assert port_ft.ft_accumulate_cuda.launches == 0
