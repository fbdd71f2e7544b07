"""The port's dispatch coalescer (fishnet_tpu_torch.search.coalesce and
the segmented dispatch of its SearchService) against the JAX package's,
on the CPU, bit for bit.

Seeded numpy inputs go through both packages: the segment helpers
(offsets, parent recoding), the segmented evaluator (values and every
group's anchor and PSQT tables, on the "xla" and "host-material"
rungs, with a ``copy_src`` fan-in and with the port's flat table
addressed by group), the cross-segment dedup planner (byte and
position-keyed mode), the width policy. Then the coalescer's protocol
and the async pipeline on stub backends, each escape hatch, a fused
dispatch against the groups' solo dispatches, and gated searches whose
results must not depend on coalescing, and equal the JAX service's.
The evaluator is integer arithmetic: no tolerance."""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fishnet_tpu.nnue import jax_eval
from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
from fishnet_tpu.ops import ft_gather as jax_ft
from fishnet_tpu.search import service as jax_service
from fishnet_tpu_torch.chess.core import NativeCoreError
from fishnet_tpu_torch.nnue import spec, torch_eval
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.ops import ft_gather
from fishnet_tpu_torch.search import coalesce
from fishnet_tpu_torch.search.coalesce import (
    _AsyncDispatchPipeline,
    _CoalesceTicket,
    _DispatchCoalescer,
    _FusedValues,
)
from fishnet_tpu_torch.search.service import SearchService

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small gathers: torch's intra-op threads cost more than they give,
    most of all beside other test processes (ROADMAP C8)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def nets():
    """The same seed through both packages' NnueWeights.random."""
    return (torch_eval.params_from_weights(NnueWeights.random(seed=5), CPU),
            jax_eval.params_from_weights(JaxWeights.random(seed=5)))


def _pers_code(aid, is_delta, swap=0):
    """Wire anchor-entry codes (cpp/src/pool.cpp emit_block)."""
    return -(2 + ((aid << 2) | (2 if is_delta else 0) | swap))


# -- segment helpers ----------------------------------------------------------

#: Segment parent columns: the JAX package's hand case
#: (tests/test_coalesce.py), then seeded wire batches.
_HAND = np.array(
    [[-1, (0 << 1) | 1, -1],
     [_pers_code(1, False), _pers_code(2, True, 1), -1]], np.int32)


def _random_parents(rng, k_segs, size, n_tab):
    out = np.full((k_segs, size), -1, np.int32)
    for k in range(k_segs):
        n = int(rng.integers(1, size + 1))
        e = 0
        while e < n:
            kind = int(rng.integers(0, 3))
            out[k, e] = (-1 if kind == 0 else
                         _pers_code(int(rng.integers(0, n_tab)), kind == 2,
                                    int(rng.integers(0, 2))))
            first = e
            e += 1
            for _ in range(int(rng.integers(0, 4))):
                if e < n:
                    out[k, e] = (first << 1) | int(rng.integers(0, 2))
                    e += 1
    return out


@pytest.mark.parametrize("case", ["hand", "random-3x9", "random-8x16"])
def test_segment_offsets_and_recode_match_jax(case):
    rng = np.random.default_rng(17)
    if case == "hand":
        parent, seg_rows, tier, a_rows = _HAND, np.array([5, 5]), 12, 4
    else:
        k_segs, size = map(int, case.split("-")[1].split("x"))
        parent = _random_parents(rng, k_segs, size, 6)
        seg_rows = rng.integers(size, 4 * size, k_segs).astype(np.int32)
        tier, a_rows = 4 * size + 4, 6
    k_segs = parent.shape[0]
    ref_off = np.asarray(jax_ft.derive_segment_offsets(
        jnp.asarray(parent), jnp.asarray(seg_rows), tier))
    got = ft_gather.derive_segment_offsets(
        torch.from_numpy(parent), torch.from_numpy(seg_rows), tier)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref_off)
    assert np.array_equal(ft_gather.derive_segment_offsets_np(
        parent, seg_rows, np.arange(k_segs) * tier), ref_off)
    if case == "hand":
        assert ref_off.tolist() == [0, 4, 5, 12, 16, 17]

    ref_rec = np.asarray(jax_ft.recode_segment_parents(
        jnp.asarray(parent), a_rows))
    got = ft_gather.recode_segment_parents(torch.from_numpy(parent), a_rows)
    assert np.array_equal(got.numpy(), ref_rec)
    assert np.array_equal(ft_gather.recode_segment_parents_np(
        parent, a_rows, range(k_segs)), ref_rec)
    # Addressed by group: segment k is group groups[k], so its table
    # base is groups[k] * A — JAX's k * A on the segments' own stacking.
    groups = list(rng.permutation(k_segs + 2)[:k_segs])
    rec = ft_gather.recode_segment_parents_np(parent, a_rows, groups)
    shifted = np.where(parent <= -2,
                       parent - ((np.array(groups)[:, None] * a_rows) << 2),
                       ref_rec.reshape(k_segs, -1))
    assert np.array_equal(rec, shifted.reshape(-1))
    assert np.array_equal(ft_gather.recode_segment_parents(
        torch.from_numpy(parent), a_rows, groups).numpy(), rec)


# -- the segmented evaluator --------------------------------------------------


def _delta_row(packed, rows, rng):
    packed[rows, :, :2] = rng.integers(0, spec.NUM_FEATURES, (2, 2))
    packed[rows, :, 2:4] = spec.NUM_FEATURES
    packed[rows, :, 4] = spec.DELTA_BASE + rng.integers(
        0, spec.NUM_FEATURES, (2,))
    packed[rows, :, 5:8] = spec.DELTA_BASE + spec.NUM_FEATURES


def _make_segment(plan, size, tab_rows, rng):
    """One group's stream (tests/test_coalesce.py's builder). Plan items:
    ("full",) plain full; ("store", aid) full anchor seed; ("pers", aid,
    swap) persistent delta; ("inbatch", ref, swap) in-batch delta."""
    tier = 4 * size + 4
    packed = np.full((tier, 2, 8), spec.NUM_FEATURES, np.uint16)
    parent = np.full((size,), -1, np.int32)
    rows = 0
    for e, item in enumerate(plan):
        kind = item[0]
        if kind in ("full", "store"):
            for r in range(4):
                packed[rows + r] = rng.integers(0, spec.NUM_FEATURES, (2, 8))
            parent[e] = -1 if kind == "full" else _pers_code(item[1], False)
            rows += 4
        elif kind == "pers":
            _delta_row(packed, rows, rng)
            parent[e] = _pers_code(item[1], True, swap=item[2])
            rows += 1
        else:
            _delta_row(packed, rows, rng)
            parent[e] = (item[1] << 1) | item[2]
            rows += 1
    packed[rows + 4:] = 60000  # stale rows past the sentinel block
    buckets = rng.integers(0, 8, (size,)).astype(np.int32)
    buckets[len(plan):] = 0
    return {
        "n": len(plan), "rows": rows, "packed": packed, "parent": parent,
        "buckets": buckets,
        "tab": rng.integers(-3000, 3000, (tab_rows, 2, spec.L1)).astype(
            np.int32),
        "ptab": rng.integers(-2000, 2000, (tab_rows, 2, 8)).astype(np.int32),
        "mat": rng.integers(-400, 400, (size,)).astype(np.int32),
    }


_PLANS = [
    [("store", 0), ("inbatch", 0, 1), ("inbatch", 0, 0), ("full",)],
    [("pers", 2, 1), ("inbatch", 0, 0), ("full",), ("store", 1),
     ("inbatch", 3, 1)],
    [("full",), ("pers", 3, 0), ("inbatch", 1, 1), ("full",)],
]


@pytest.mark.parametrize("variant", ["stacked", "copy_src", "by-group"])
@pytest.mark.parametrize("rung", ["xla", "host-material"])
def test_segmented_eval_matches_jax(nets, rung, variant):
    """The port's evaluate_packed_anchored_segmented against the JAX
    package's (its XLA twin): values, and every group's anchor and PSQT
    table. "copy_src" fans two plain fulls in from other segments;
    "by-group" hands the port all four groups' tables and names the
    segments' groups (2, 0, 3), so its flat table is addressed by
    g * A, not k * A: the JAX call gets those three tables stacked, and
    group 1's table must not move."""
    params, jparams = nets
    rng = np.random.default_rng(31)
    size, tab_rows = 6, 4
    tier = 4 * size + 4
    segs = [_make_segment(p, size, tab_rows, rng) for p in _PLANS]
    material = rung == "host-material"
    cat = {key: np.concatenate([s[key][:tier] if key == "packed" else s[key]
                                for s in segs])
           for key in ("packed", "buckets", "parent", "mat")}
    seg_rows = np.array([s["rows"] for s in segs], np.int32)
    copy_src = None
    if variant == "copy_src":
        copy_src = np.arange(len(segs) * size, dtype=np.int32)
        copy_src[1 * size + 2] = 0 * size + 3  # plain full <- plain full
        copy_src[2 * size + 0] = 1 * size + 2
    groups = [2, 0, 3] if variant == "by-group" else None

    ref_v, ref_t, ref_pt = map(np.asarray, jax_eval.evaluate_packed_anchored_segmented(
        jparams, jnp.asarray(cat["packed"]), jnp.asarray(cat["buckets"]),
        jnp.asarray(cat["parent"]),
        jnp.asarray(cat["mat"]) if material else None,
        jnp.asarray(np.stack([s["tab"] for s in segs])),
        jnp.asarray(seg_rows),
        jnp.asarray(np.stack([s["ptab"] for s in segs])),
        use_pallas=False,
        copy_src=None if copy_src is None else jnp.asarray(copy_src),
    ))

    tabs = [s["tab"] for s in segs]
    ptabs = [s["ptab"] for s in segs]
    if groups is not None:
        spare = _make_segment([("full",)], size, tab_rows, rng)
        order = {g: k for k, g in enumerate(groups)}
        tabs = [tabs[order[g]] if g in order else spare["tab"]
                for g in range(4)]
        ptabs = [ptabs[order[g]] if g in order else spare["ptab"]
                 for g in range(4)]
    tab_t = torch.from_numpy(np.stack(tabs))
    ptab_t = torch.from_numpy(np.stack(ptabs))
    before = tab_t.clone(), ptab_t.clone()
    values, out_t, out_pt = torch_eval.evaluate_packed_anchored_segmented(
        params, torch.from_numpy(cat["packed"].view(np.int16)),
        torch.from_numpy(cat["buckets"]), torch.from_numpy(cat["parent"]),
        torch.from_numpy(cat["mat"]) if material else None,
        tab_t, torch.from_numpy(seg_rows), ptab_t,
        None if copy_src is None else torch.from_numpy(copy_src),
        groups=groups,
    )
    assert out_t is tab_t and out_pt is ptab_t  # updated in place
    assert np.array_equal(values.numpy(), ref_v)
    for k in range(len(segs)):
        g = k if groups is None else groups[k]
        assert np.array_equal(tab_t[g].numpy(), ref_t[k]), (k, "anchor")
        assert np.array_equal(ptab_t[g].numpy(), ref_pt[k]), (k, "psqt")
    if groups is not None:
        assert torch.equal(tab_t[1], before[0][1])
        assert torch.equal(ptab_t[1], before[1][1])
    if not material:
        # Device PSQT: the stores moved the PSQT tables too.
        assert not torch.equal(ptab_t, before[1])


def test_copy_src_refuses_to_redirect_an_anchor_store(nets):
    """The kernel stores inside its launch, before the fan-in: a fan-in
    into an anchor-store entry would leave its table row holding its own
    (garbage) accumulator, so it raises (ROADMAP: the position-keyed
    planner needs the fan-in to reach the stores)."""
    params, _ = nets
    rng = np.random.default_rng(3)
    seg = _make_segment(_PLANS[0], 6, 4, rng)
    copy_src = np.arange(6, dtype=np.int32)
    copy_src[0] = 3  # entry 0 stores its anchor row
    with pytest.raises(ValueError, match="anchor-store entry"):
        torch_eval.evaluate_packed_anchored_segmented(
            params, torch.from_numpy(seg["packed"].view(np.int16)),
            torch.from_numpy(seg["buckets"]), torch.from_numpy(seg["parent"]),
            None, torch.from_numpy(seg["tab"][None].copy()),
            torch.tensor([seg["rows"]]), torch.from_numpy(seg["ptab"][None]),
            torch.from_numpy(copy_src))


# -- the cross-segment dedup planner -------------------------------------------


def _payload(pid):
    rng = np.random.default_rng(1000 + pid)
    return rng.integers(0, spec.NUM_FEATURES, (4, 2, 8)).astype(np.uint16)


def _delta_payload(pid):
    rng = np.random.default_rng(2000 + pid)
    row = np.full((1, 2, 8), spec.NUM_FEATURES, np.uint16)
    row[0, :, :2] = rng.integers(0, spec.NUM_FEATURES, (2, 2))
    row[0, :, 4] = spec.DELTA_BASE + rng.integers(0, spec.NUM_FEATURES, (2,))
    row[0, :, 5:] = spec.DELTA_BASE + spec.NUM_FEATURES
    return row


def _dedup_seg(plan, size=8):
    """tests/test_async_dispatch.py's planner inputs. Items: ("full",
    payload); ("store", aid, payload); ("pers", aid, payload);
    ("inbatch", ref). Equal payload ids give equal feature blocks."""
    parent = np.full(size, -1, np.int32)
    buckets = np.zeros(size, np.int32)
    offsets = np.zeros(size, np.int32)
    chunks, rows = [], 0
    for i, item in enumerate(plan):
        offsets[i] = rows
        kind = item[0]
        if kind in ("full", "store"):
            parent[i] = -1 if kind == "full" else _pers_code(item[1], False)
            chunks.append(_payload(item[-1]))
            rows += 4
        elif kind == "pers":
            parent[i] = _pers_code(item[1], True)
            chunks.append(_delta_payload(item[2]))
            rows += 1
        else:
            parent[i] = item[1] << 1
            chunks.append(_delta_payload(99))
            rows += 1
    return parent, buckets, offsets, np.concatenate(chunks), len(plan)


#: The planner cases of tests/test_async_dispatch.py, and the drops each
#: must yield.
_PLANNER_CASES = {
    "cross-segment": ([("full", 1), ("full", 2)],
                      [("full", 3), ("full", 2), ("full", 4)], [[], [1]]),
    "consumed-full-kept": ([("full", 2)],
                           [("full", 3), ("full", 2), ("inbatch", 1)],
                           [[], []]),
    "first-entry-kept": ([("full", 2)], [("full", 2), ("full", 5)], [[], []]),
    "persistent-kept": ([("full", 7)], [("full", 3), ("store", 1, 7)],
                        [[], []]),
    "store-original": ([("store", 0, 7)], [("full", 8), ("full", 7)],
                       [[], [1]]),
    "refs-skip-dropped": ([("full", 2)],
                          [("full", 5), ("full", 2), ("full", 2)],
                          [[], [1, 2]]),
    "mixed": ([("full", 1), ("full", 2), ("inbatch", 0)],
              [("full", 2), ("full", 1), ("full", 2), ("pers", 0, 3)],
              None),
}


def _planner_args(segs, bucket_of=None):
    args = [[s[0] for s in segs], [s[1].copy() for s in segs],
            [s[2] for s in segs], [s[4] for s in segs],
            [s[3] for s in segs]]
    if bucket_of is not None:
        args[1][bucket_of[0]][bucket_of[1]] = 5
    return args


@pytest.mark.parametrize("case", sorted(_PLANNER_CASES) + ["bucket-differs"])
def test_dedup_planner_byte_mode_matches_jax(case):
    if case == "bucket-differs":
        plans = ([("full", 2)], [("full", 3), ("full", 2)], [[], []])
        bucket_of = (1, 1)  # same rows, another layer-stack bucket
    else:
        plans, bucket_of = _PLANNER_CASES[case], None
    segs = [_dedup_seg(p) for p in plans[:2]]
    args = _planner_args(segs, bucket_of)
    got = ft_gather.plan_segment_dedup(*args)
    assert got == jax_ft.plan_segment_dedup(*args)
    if plans[2] is not None:
        assert got[0] == plans[2]
    # Material, when shipped, joins the key.
    mats = [np.arange(8, dtype=np.int32) for _ in segs]
    assert ft_gather.plan_segment_dedup(*args, material=mats) == \
        jax_ft.plan_segment_dedup(*args, material=mats)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_planner_position_keyed_matches_jax(seed):
    """Position-keyed mode (hashes, cache hits): the port's copy gives
    the JAX planner's drops, codes, pairs and fills."""
    rng = np.random.default_rng(seed)
    plans = []
    for _ in range(3):
        plan = [("full", int(rng.integers(0, 4)))]
        for _ in range(int(rng.integers(2, 7))):
            kind = int(rng.integers(0, 4))
            plan.append(
                ("full", int(rng.integers(0, 4))) if kind == 0 else
                ("store", int(rng.integers(0, 8)), int(rng.integers(0, 4)))
                if kind == 1 else
                ("pers", int(rng.integers(0, 8)), int(rng.integers(0, 4)))
                if kind == 2 else ("inbatch", 0))
        plans.append(plan)
    segs = [_dedup_seg(p) for p in plans]
    args = _planner_args(segs)
    hashes = [rng.integers(0, 5, 8).astype(np.uint64) for _ in segs]
    hits = [(rng.integers(0, 2, 8).astype(bool),
             rng.integers(-300, 300, 8).astype(np.int32)) for _ in segs]
    for cache_hits in (None, hits):
        got = ft_gather.plan_segment_dedup(*args, hashes=hashes,
                                           cache_hits=cache_hits)
        assert got == jax_ft.plan_segment_dedup(*args, hashes=hashes,
                                                cache_hits=cache_hits)
        assert len(got) == 4


# -- the width policy ---------------------------------------------------------


@pytest.mark.parametrize("times", [(0.104, 0.399, 256, 16384),
                                   (0.100, 0.080, 256, 16384),
                                   (0.0006, 0.0007, 64, 512)])
def test_fit_dispatch_cost_matches_jax(times):
    got = coalesce.fit_dispatch_cost(*times)
    ref = jax_service.fit_dispatch_cost(*times)
    assert (got.fixed_ms, got.marginal_ms_per_kslot, got.small, got.big) == \
        (ref.fixed_ms, ref.marginal_ms_per_kslot, ref.small, ref.big)


@pytest.mark.parametrize(
    "fixed,marginal,slots,n_groups,expected",
    [
        (99.0, 18.7, 800, 8, 4),
        (99.0, 18.7, 100, 8, 8),
        (99.0, 18.7, 16384, 8, 1),
        (99.0, 18.7, 4096, 8, 2),
        (0.0, 18.7, 100, 8, 1),
        (3.0, 0.0, 500, 4, 4),
        (99.0, 18.7, 100, 1, 1),
        (1000.0, 0.1, 10, 32, 8),
        (0.6, 0.11, 100, 14, 8),
    ],
)
def test_choose_coalesce_width_matches_jax(fixed, marginal, slots, n_groups,
                                           expected):
    got = coalesce.choose_coalesce_width(fixed, marginal, slots, n_groups)
    assert got == expected == jax_service.choose_coalesce_width(
        fixed, marginal, slots, n_groups)


def test_suggest_pipeline_depth_returns_probe():
    """return_probe=True reports the fixed/marginal decomposition beside
    the depth, over the same sizes as the JAX package's probe."""
    calls = []

    def instant_eval(params, feats, buckets):
        calls.append(len(buckets))
        return np.zeros((len(buckets),), np.int32)

    depth, probe = coalesce.suggest_pipeline_depth(
        None, size=1024, rounds=3, eval_fn=instant_eval, return_probe=True)
    jdepth, jprobe = jax_service.suggest_pipeline_depth(
        None, size=1024, rounds=3, eval_fn=instant_eval, return_probe=True)
    assert depth in (1, 2, 4) and jdepth in (1, 2, 4)
    assert (probe.small, probe.big) == (jprobe.small, jprobe.big) == (64, 1024)
    assert probe.fixed_ms >= 0 and probe.marginal_ms_per_kslot >= 0
    assert 64 in calls and 1024 in calls


def test_suggest_pipeline_depth_times_the_port_evaluator():
    """Without an eval_fn the probe runs the port's evaluate_batch on the
    device it is given (here the CPU)."""
    depth = coalesce.suggest_pipeline_depth(
        NnueWeights.random(seed=1), size=64, rounds=2, device="cpu")
    assert depth in (1, 2, 4)


# -- the coalescer's protocol on a stub backend -------------------------------


class _StubBackend(coalesce.CoalesceBackend):
    """Records dispatches; values are the groups' ids."""

    def __init__(self, n_groups=4, threads=1, fail=False):
        self._n_groups = n_groups
        self.driver_threads = threads
        self._async_pipes = []
        self.solo, self.fused, self.fail = [], [], fail

    def _dispatch_eval(self, group, n, rows):
        if self.fail:
            raise RuntimeError("injected dispatch failure")
        self.solo.append(group)
        return np.full(n, group, np.int32), (n, 0, 0)

    def _dispatch_segmented(self, tickets):
        if self.fail:
            raise RuntimeError("injected segmented-dispatch failure")
        self.fused.append([tk.group for tk in tickets])
        size = max(tk.n for tk in tickets)
        arr = np.concatenate([np.full(size, tk.group, np.int32)
                              for tk in tickets])
        shared = _FusedValues(arr, lambda a: a.copy())
        for k, tk in enumerate(tickets):
            tk.values, tk.start, tk.seg_size = shared, k * size, size
            tk.acct = (size, 0, 0)


def test_coalescer_flushes_at_the_width_and_on_demand():
    svc = _StubBackend()
    co = _DispatchCoalescer(svc, pinned_width=3)
    svc._coalescer = co
    tks = [co.submit(g, 2, 8) for g in range(3)]  # the third flushes
    assert svc.fused == [[0, 1, 2]] and all(tk.done.is_set() for tk in tks)
    assert [co.demand(tk).tolist() for tk in tks] == [[0, 0], [1, 1], [2, 2]]
    lone = co.submit(3, 2, 8)  # parked: below the width
    assert not lone.done.is_set() and svc.solo == []
    assert co.demand(lone).tolist() == [3, 3]  # demand flushes it solo
    assert svc.solo == [3]
    assert (co.dispatches, co.fused_dispatches, co.coalesced_steps) == \
        (2, 1, 3)


@pytest.mark.parametrize("width", [1, 3])
def test_failed_flush_reaches_every_owner(width):
    svc = _StubBackend(fail=True)
    co = _DispatchCoalescer(svc, pinned_width=width)
    tks = [co.submit(g, 2, 8) for g in range(3)]
    for tk in tks:
        with pytest.raises(NativeCoreError, match="injected"):
            co.demand(tk)
    assert co.dispatches == 0


def test_fused_values_failure_raises_for_every_owner():
    """A fused dispatch whose read-back raises (the kernel's error word
    grew) raises for each owner, and reads the device only once."""
    reads = []

    def read(handle):
        reads.append(handle)
        raise NativeCoreError("ft_gather kernel refused 1 index")

    shared = _FusedValues("handle", read)
    for _ in range(3):
        with pytest.raises(NativeCoreError, match="refused 1"):
            shared.materialize()
    assert reads == ["handle"]


def test_width_follows_probe_and_occupancy():
    svc = _StubBackend(n_groups=14, threads=7)
    co = _DispatchCoalescer(svc)
    assert co.width == 1  # until the warm-up probe lands
    co.set_probe(coalesce.DispatchProbe(0.6, 0.11, 64, 512))
    co.submit(0, 100, 400)
    assert co.width == 8 and co._linger_s == pytest.approx(0.6e-3 / 16)
    co.set_width_override(2)
    assert co.width == 2
    co.set_width_override(None)
    assert co.width == 8


# -- the async pipeline --------------------------------------------------------


class _StubCoalescer:
    def __init__(self, width=1):
        self._lock = threading.Lock()
        self.executed = []
        self.width = width

    def _execute(self, tickets):
        with self._lock:
            self.executed.append(tickets)
        for tk in tickets:
            tk.done.set()


class _PipeSvc(coalesce.CoalesceBackend):
    def __init__(self, width=1):
        self._coalescer = _StubCoalescer(width)


def test_pipeline_depth_bounds_the_dispatches_in_flight():
    """Dispatch N+2 must not stage until dispatch N has been read back."""
    svc = _PipeSvc()
    pipe = _AsyncDispatchPipeline(svc)
    gates = [threading.Event() for _ in range(3)]
    entered = threading.Event()

    def reader(gate):
        def read(_):
            entered.set()
            gate.wait(10)
            return np.zeros(4, np.int32)
        return read

    def n_exec():
        with svc._coalescer._lock:
            return len(svc._coalescer.executed)

    def wait_exec(n):
        deadline = time.monotonic() + 5
        while n_exec() < n and time.monotonic() < deadline:
            time.sleep(0.005)
        return n_exec()

    tks = []
    try:
        for gate in gates:
            tk = _CoalesceTicket(0, 1, 4)
            tk.values = _FusedValues(None, reader(gate))
            tks.append(tk)
            assert pipe.submit([tk])
        assert wait_exec(2) == 2
        assert entered.wait(5)
        time.sleep(0.2)  # every chance for the pack worker to misbehave
        assert n_exec() == 2, "third dispatch staged while two in flight"
        assert pipe.inflight() == 2
        gates[0].set()  # dispatch 0 is read back, its slot frees
        assert wait_exec(3) == 3
        for gate in gates:
            gate.set()
        for tk in tks:
            assert tk.done.wait(5) and tk.error is None
    finally:
        for gate in gates:
            gate.set()
        pipe.close()
    assert not pipe._pack_thread.is_alive()
    assert not pipe._decode_thread.is_alive()


def test_pipeline_merges_the_flushes_queued_behind_a_busy_worker():
    """With two dispatches in flight the pack worker waits; the
    single-group flushes that queue up meanwhile go out as ONE dispatch,
    up to the coalescer's width (3 here), the rest in the next one."""
    svc = _PipeSvc(width=3)
    pipe = _AsyncDispatchPipeline(svc)
    gates = [threading.Event() for _ in range(2)]
    tks = []
    try:
        for i in range(7):
            tk = _CoalesceTicket(i, 1, 4)
            gate = gates[i] if i < 2 else None
            tk.values = _FusedValues(
                None, lambda _, gate=gate: (gate.wait(10) if gate else None)
                or np.zeros(1, np.int32))
            tks.append(tk)
        for i, tk in enumerate(tks[:2]):
            assert pipe.submit([tk])
            deadline = time.monotonic() + 5
            while pipe.inflight() <= i and time.monotonic() < deadline:
                time.sleep(0.005)
        for tk in tks[2:]:
            assert pipe.submit([tk])
        time.sleep(0.1)
        for gate in gates:
            gate.set()
        for tk in tks:
            assert tk.done.wait(5) and tk.error is None
        with svc._coalescer._lock:
            groups = [[tk.group for tk in batch]
                      for batch in svc._coalescer.executed]
        assert groups == [[0], [1], [2, 3, 4], [5, 6]]
    finally:
        for gate in gates:
            gate.set()
        pipe.close()


def test_submit_after_close_reports_down():
    pipe = _AsyncDispatchPipeline(_PipeSvc())
    pipe.close()
    assert not pipe.submit([_CoalesceTicket(0, 1, 4)])


def test_pipeline_set_depth_is_bounded():
    pipe = _AsyncDispatchPipeline(_PipeSvc())
    try:
        pipe.set_depth(99)
        assert pipe.depth() == _AsyncDispatchPipeline.MAX_DEPTH
        pipe.set_depth(0)
        assert pipe.depth() == 1
    finally:
        pipe.close()


# -- the service: escape hatches, the fused dispatch, gated searches ----------

SVC_KW = dict(pool_slots=8, batch_capacity=256, tt_bytes=4 << 20,
              device="cpu")


@pytest.mark.parametrize("hatch,groups", [
    (None, (2, 1)), (None, (1, 1)), ("FISHNET_NO_COALESCE", (2, 2)),
    ("FISHNET_NO_ASYNC", (4, 1)), ("FISHNET_NO_DEDUP", (4, 1)),
    ("FISHNET_COALESCE_WIDTH", (4, 1)),
])
def test_escape_hatches(monkeypatch, hatch, groups):
    """What the service builds, by pipeline groups and escape hatch: a
    coalescer and the async pipeline whenever there is more than one
    group, none with one group or FISHNET_NO_COALESCE=1; no pipeline
    with FISHNET_NO_ASYNC=1; no dedup with FISHNET_NO_DEDUP=1; a pinned
    width, clamped to the groups, with FISHNET_COALESCE_WIDTH."""
    if hatch == "FISHNET_COALESCE_WIDTH":
        monkeypatch.setenv(hatch, "99")
    elif hatch is not None:
        monkeypatch.setenv(hatch, "1")
    depth, threads = groups
    svc = SearchService(weights=NnueWeights.random(seed=3),
                        pipeline_depth=depth, driver_threads=threads,
                        **SVC_KW)
    try:
        multi = depth * threads > 1 and hatch != "FISHNET_NO_COALESCE"
        assert (svc._coalescer is not None) == multi
        assert (svc.async_depth() is not None) == (
            multi and hatch != "FISHNET_NO_ASYNC")
        assert svc._dedup_fused == (hatch != "FISHNET_NO_DEDUP")
        if hatch == "FISHNET_COALESCE_WIDTH":
            assert svc.coalesce_width() == 4 == svc._coalescer._pinned
        if multi:
            # The scheduling knobs; an env pin outranks the override.
            svc.set_coalesce_width(2)
            assert svc.coalesce_width() == (
                4 if hatch == "FISHNET_COALESCE_WIDTH" else 2)
            svc.set_async_depth(3)
            assert svc.async_depth() == (
                None if hatch == "FISHNET_NO_ASYNC" else 3)
            svc.set_async_depth(None)
            assert svc.async_depth() in (None, 2)
        if not multi:
            assert svc.coalesce_width() is None
            c = svc.counters()
            assert c["dispatches"] == c["eval_steps"]
            assert c["fused_dispatches"] == 0
    finally:
        svc.close()
    assert not any(th.is_alive() for th in svc._threads)
    assert not any(p._pack_thread.is_alive() for p in svc._async_pipes)


def _fill(svc, g, plan):
    """Group ``g``'s host buffers as fc_pool_step would leave them."""
    rows = 0
    for i, item in enumerate(plan):
        svc._offset_buf[g][i] = rows
        if item[0] == "full":
            svc._parent_buf[g][i] = -1
            svc._packed_buf[g][rows: rows + 4] = _payload(item[1])
            rows += 4
        elif item[0] == "store":
            svc._parent_buf[g][i] = _pers_code(item[1], False)
            svc._packed_buf[g][rows: rows + 4] = _payload(item[2])
            rows += 4
        elif item[0] == "pers":
            svc._parent_buf[g][i] = _pers_code(item[1], True, item[2])
            svc._packed_buf[g][rows: rows + 1] = _delta_payload(item[1])
            rows += 1
        else:
            svc._parent_buf[g][i] = item[1] << 1
            svc._packed_buf[g][rows: rows + 1] = _delta_payload(99)
            rows += 1
    # Bucket and material are functions of the position: equal feature
    # blocks get equal ones (so the planner may match them).
    svc._bucket_buf[g][:len(plan)] = [3 + (it[0] == "full") for it in plan]
    if svc._material_buf is not None:
        svc._material_buf[g][:len(plan)] = [
            -20 + 7 * (it[0] == "full") for it in plan]
    return len(plan), rows


#: Three groups' steps: anchor seeds and persistent deltas on their own
#: tables, in-batch chains, and plain fulls that duplicate one another
#: across segments (group 2's entries 1 and 3 repeat group 0's entry 2).
_GROUP_PLANS = {
    0: [("store", 1, 4), ("inbatch", 0), ("full", 2), ("pers", 0, 1)],
    2: [("pers", 1, 0), ("full", 2), ("inbatch", 0), ("full", 2),
        ("store", 0, 6)],
    3: [("full", 7), ("store", 1, 2), ("inbatch", 1)],
}


@pytest.mark.parametrize("psqt_path", ["xla", "host-material"])
def test_fused_dispatch_equals_solo_dispatches(monkeypatch, psqt_path):
    """One fused dispatch of three groups' steps (groups 2, 0, 3 of four:
    the flat table addressed by group) gives, segment by segment, the
    values and tables of the groups' solo dispatches on copies of the
    same tables — with cross-segment dedup on (two plain fulls leave the
    wire, their values restored on the host) and off."""
    monkeypatch.setenv("FISHNET_COALESCE_WIDTH", "4")
    svc = SearchService(weights=NnueWeights.random(seed=5), pipeline_depth=4,
                        driver_threads=1, psqt_path=psqt_path, **SVC_KW)
    try:
        svc.warmup()
        rng = np.random.default_rng(9)
        seed_tabs = (
            torch.from_numpy(rng.integers(-3000, 3000,
                                          svc._anchor_all.shape,
                                          dtype=np.int32)),
            torch.from_numpy(rng.integers(-2000, 2000, svc._psqt_all.shape,
                                          dtype=np.int32)))
        order = [2, 0, 3]
        filled = {g: _fill(svc, g, _GROUP_PLANS[g]) for g in order}
        host = {g: tuple(b[g].copy() for b in (
            svc._packed_buf, svc._offset_buf, svc._bucket_buf,
            svc._parent_buf)) for g in order}

        def restore():
            for g in order:
                for buf, saved in zip((svc._packed_buf, svc._offset_buf,
                                       svc._bucket_buf, svc._parent_buf),
                                      host[g]):
                    buf[g][:] = saved
            svc._anchor_all.copy_(seed_tabs[0])
            svc._psqt_all.copy_(seed_tabs[1])

        solo = {}
        restore()
        for g in order:
            handle, _ = svc._dispatch_eval(g, *filled[g])
            solo[g] = svc._resolve_eval(filled[g][0], handle)
        solo_tabs = (svc._anchor_all.clone(), svc._psqt_all.clone())

        for dedup in (True, False):
            restore()
            svc._dedup_fused = dedup
            co = svc._coalescer
            deduped = co.deduped_evals
            tks = [_CoalesceTicket(g, *filled[g]) for g in order]
            svc._dispatch_segmented(tks)
            whole = tks[0].values.materialize()
            for tk in tks:
                seg = whole[tk.start: tk.start + tk.n]
                assert np.array_equal(seg, solo[tk.group]), (dedup, tk.group)
            assert torch.equal(svc._anchor_all, solo_tabs[0])
            assert torch.equal(svc._psqt_all, solo_tabs[1])
            assert co.deduped_evals - deduped == (2 if dedup else 0)
            if dedup:
                # The duplicates carry their original's value.
                size = tks[0].seg_size
                assert whole[0 * size + 1] == whole[1 * size + 2] == \
                    whole[0 * size + 3]
    finally:
        svc.close()


def test_fused_dispatch_skips_the_planner_without_shared_blocks(monkeypatch):
    """When no two 4-row entries share a feature block the byte-mode
    planner can drop nothing: the service does not run it."""
    from fishnet_tpu_torch.search import service as service_mod

    monkeypatch.setenv("FISHNET_COALESCE_WIDTH", "2")
    svc = SearchService(weights=NnueWeights.random(seed=5), pipeline_depth=2,
                        driver_threads=1, **SVC_KW)
    try:
        svc.warmup()
        plans = {0: [("store", 1, 4), ("inbatch", 0), ("full", 2)],
                 1: [("full", 3), ("full", 5), ("inbatch", 1)]}
        tks = [_CoalesceTicket(g, *_fill(svc, g, plans[g])) for g in (0, 1)]
        assert not svc._shares_a_block(tks)

        def no_planner(*args, **kwargs):
            raise AssertionError("the planner ran")

        monkeypatch.setattr(service_mod, "plan_segment_dedup", no_planner)
        svc._dispatch_segmented(tks)
        assert len(tks[0].values.materialize()) == 2 * tks[0].seg_size
        _fill(svc, 1, [("full", 3), ("full", 2), ("inbatch", 1)])
        assert svc._shares_a_block(tks)  # group 0's entry 2, group 1's 1
    finally:
        svc.close()


def test_fused_dispatch_refuses_an_anchor_code_past_its_group(monkeypatch):
    """A persistent code past its group's rows would reach another
    group's rows of the flat table, where the kernel's range check
    cannot see it: the fused dispatch refuses it on the host."""
    monkeypatch.setenv("FISHNET_COALESCE_WIDTH", "2")
    svc = SearchService(weights=NnueWeights.random(seed=5), pipeline_depth=2,
                        driver_threads=1, **SVC_KW)
    try:
        svc.warmup()
        past = svc._anchor_rows  # one past group 0's last row
        tks = [_CoalesceTicket(g, *_fill(svc, g, [("store", past, 1)]))
               for g in (0, 1)]
        with pytest.raises(NativeCoreError, match="past its group"):
            svc._dispatch_segmented(tks)
    finally:
        svc.close()


_SMOKE_FENS = [
    "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1",
    "r1bqkbnr/pppp1ppp/2n5/4p3/4P3/5N2/PPPP1PPP/RNBQKB1R w KQkq - 2 3",
    "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1",
    "4rrk1/pp1n3p/3q2pQ/2p1pb2/2PP4/2P3N1/P2B2PP/4RRK1 b - - 7 19",
]


def _gated(base):
    class Gated(base):
        """A service whose driver parks after its warm-up until the gate
        opens, so every submission lands in one drain pass and the whole
        schedule is a function of the submission sequence
        (tests/test_coalesce.py's discipline)."""

        def __init__(self, *args, **kwargs):
            self.gate = threading.Event()
            super().__init__(*args, **kwargs)

        def warmup(self):
            super().warmup()
            self.gate.wait()

    return Gated


def _gated_run(svc, nodes=200):
    try:
        svc.set_prefetch(0, adaptive=False)

        async def go():
            tasks = [asyncio.ensure_future(svc.search(fen, [], nodes=nodes))
                     for fen in _SMOKE_FENS]
            await asyncio.sleep(0.3)
            svc.gate.set()
            return await asyncio.gather(*tasks, return_exceptions=True)

        results = asyncio.run(go())
        return results, svc.counters()
    finally:
        svc.gate.set()
        svc.close()


def _analyses(results):
    return [(r.best_move, r.depth, r.nodes,
             tuple((l.multipv, l.depth, l.is_mate, l.value, tuple(l.pv))
                   for l in r.lines)) for r in results]


GATED_KW = dict(pool_slots=8, batch_capacity=256, tt_bytes=8 << 20,
                pipeline_depth=4, driver_threads=1)


def test_coalesced_searches_match_uncoalesced_and_jax(monkeypatch):
    """The acceptance smoke of tests/test_coalesce.py on the port: four
    groups, width pinned to 4, fewer dispatches than steps and at least
    one fused — and the same analyses as FISHNET_NO_COALESCE=1 and as
    the JAX service's coalesced run (eval cache off)."""
    monkeypatch.setenv("FISHNET_NO_EVAL_CACHE", "1")
    monkeypatch.setenv("FISHNET_COALESCE_WIDTH", "4")
    port = _gated(SearchService)(weights=NnueWeights.random(seed=7),
                                 device="cpu", **GATED_KW)
    coalesced, c1 = _gated_run(port)
    jax_svc = _gated(jax_service.SearchService)(
        weights=JaxWeights.random(seed=7), backend="jax", **GATED_KW)
    ref, _ = _gated_run(jax_svc)
    monkeypatch.delenv("FISHNET_COALESCE_WIDTH")
    monkeypatch.setenv("FISHNET_NO_COALESCE", "1")
    plain, c2 = _gated_run(_gated(SearchService)(
        weights=NnueWeights.random(seed=7), device="cpu", **GATED_KW))

    assert _analyses(coalesced) == _analyses(plain) == _analyses(ref)
    assert c1["eval_steps"] == c2["eval_steps"]
    assert c1["dispatches"] < c1["eval_steps"]
    assert c1["fused_dispatches"] >= 1
    assert c1["coalesced_steps"] + (c1["dispatches"]
                                    - c1["fused_dispatches"]) \
        == c1["eval_steps"]
    assert c2["dispatches"] == c2["eval_steps"]
    assert c2["fused_dispatches"] == 0


def test_fused_flush_failure_fails_every_search(monkeypatch):
    """A failure inside a coalesced flush reaches every owning driver as
    a solo dispatch failure does: the searches fail and the service
    reads dead."""
    monkeypatch.setenv("FISHNET_COALESCE_WIDTH", "4")
    svc = _gated(SearchService)(weights=NnueWeights.random(seed=7),
                                device="cpu", **GATED_KW)

    def boom(*args, **kwargs):
        raise RuntimeError("injected segmented-dispatch failure")

    svc._dispatch_segmented = boom
    svc._dispatch_eval = boom
    results, _ = _gated_run(svc)
    assert all(isinstance(r, NativeCoreError) for r in results)
    assert not svc.is_alive()
