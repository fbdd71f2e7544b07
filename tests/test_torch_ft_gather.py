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
