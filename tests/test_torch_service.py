"""The port's SearchService (fishnet_tpu_torch.search.service) on the CPU
against the JAX package's SearchService and the native scalar evaluator.

Same net (NnueWeights.random(seed=21) in both packages), positions
searched one at a time with the prefetch budget pinned, so the pool's
TT evolution is a deterministic function of the sequence. The JAX
service runs its single-device per-group path (coalescer, eval cache
and bounds tier off), which is the configuration the port reproduces:
against it the port must match (value, is_mate, best_move, pv, nodes);
against the scalar evaluator (value, is_mate, best_move)."""

import asyncio
import random

import numpy as np
import pytest

from fishnet_tpu.chess import Board
from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
from fishnet_tpu.search.service import SearchService as JaxService
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.search.service import SearchService

#: Depth-4 positions with small trees (endings and forcing lines), so
#: three services search them well inside the test budget.
DEPTH4_FENS = [
    "6k1/5ppp/8/8/8/8/5PPP/3R2K1 w - - 0 1",
    "8/8/8/4k3/8/8/4P3/4K3 w - - 0 1",
    "6k1/5ppp/8/8/8/8/5PPP/6K1 w - - 0 1",
    "8/8/3k4/8/3P4/3K4/8/8 w - - 0 1",
    "4k3/8/8/8/8/8/8/4K2R w K - 0 1",
]


def _random_fens(n, seed):
    random.seed(seed)
    fens = []
    while len(fens) < n:
        b = Board()
        for _ in range(random.randrange(2, 60)):
            if b.outcome() != 0:
                break
            b.push_uci(random.choice(b.legal_moves()))
        if b.outcome() == 0:
            fens.append(b.fen())
    return fens


async def _results(svc, fens, depth):
    svc.set_prefetch(8, adaptive=False)
    try:
        out = []
        for fen in fens:
            r = await svc.search(fen, [], depth=depth)
            line = [l for l in r.lines if l.multipv == 1][-1]
            out.append((line.value, line.is_mate, r.best_move,
                        tuple(line.pv), r.nodes))
        return out
    finally:
        svc.close()


KW = dict(pool_slots=16, batch_capacity=64, tt_bytes=64 << 20)


@pytest.mark.parametrize("depth", [1, 4], ids=["depth1-random20",
                                                "depth4-endings5"])
def test_port_matches_jax_service_and_scalar(monkeypatch, depth):
    fens = _random_fens(20, seed=99) if depth == 1 else DEPTH4_FENS
    for hatch in ("FISHNET_NO_COALESCE", "FISHNET_NO_EVAL_CACHE",
                  "FISHNET_NO_BOUNDS"):
        monkeypatch.setenv(hatch, "1")
    port_svc = SearchService(weights=NnueWeights.random(seed=21),
                             device="cpu", **KW)
    ref_svc = JaxService(weights=JaxWeights.random(seed=21), **KW)
    # The same entry-bucket ladder, so the same padded step shapes.
    assert port_svc._eval_sizes == ref_svc._eval_sizes
    port = asyncio.run(_results(port_svc, fens, depth))
    ref = asyncio.run(_results(ref_svc, fens, depth))
    scalar = asyncio.run(_results(
        SearchService(weights=NnueWeights.random(seed=21), backend="scalar",
                      **KW), fens, depth))
    assert port == ref
    assert [r[:3] for r in port] == [r[:3] for r in scalar]
    assert sum(r[4] for r in port) > len(fens)  # the searches searched


def test_host_material_rung_matches_device_psqt():
    fens = DEPTH4_FENS[:3]
    device_psqt = asyncio.run(_results(
        SearchService(weights=NnueWeights.random(seed=21), device="cpu",
                      **KW), fens, 3))
    host = SearchService(weights=NnueWeights.random(seed=21), device="cpu",
                         psqt_path="host-material", **KW)
    assert host.psqt_path == "host-material"
    assert asyncio.run(_results(host, fens, 3)) == device_psqt


def test_pipelined_groups_and_counters():
    """Two pipeline groups and concurrent searches: every search
    answers, and the counters account the dispatched steps."""
    svc = SearchService(weights=NnueWeights.random(seed=21), device="cpu",
                        pool_slots=16, batch_capacity=128, pipeline_depth=2)

    async def run():
        return await asyncio.gather(*[
            svc.search(fen, [], depth=2) for fen in DEPTH4_FENS
        ])

    try:
        results = asyncio.run(run())
        c = svc.counters()
    finally:
        svc.close()
    assert all(r.best_move for r in results)
    assert results[0].best_move == "d1d8"
    assert c["eval_steps"] > 0 and c["bucket_slots"] >= c["eval_steps"]
    assert c["wire_bytes"] == c["wire_feature_bytes"] > 0
    assert svc.psqt_path == "xla"


def test_device_and_rung_requests_are_checked():
    w = NnueWeights.random(seed=21)
    # The device picks "fused" or "xla"; only "host-material" is a request.
    for rung in ("fused", "xla", "bogus"):
        with pytest.raises(ValueError, match="unknown psqt_path"):
            SearchService(weights=w, device="cpu", psqt_path=rung, **KW)
    with pytest.raises(ValueError, match="unknown backend"):
        SearchService(weights=w, backend="jax", device="cpu", **KW)


def test_shipped_offsets_equal_the_derived_ones():
    """The service ships the pool's row offsets (fc_pool_step writes
    them; padding entries point at the sentinel block at n_rows) in
    place of the device-side derivation: on every step they equal
    derive_offsets_np of the same parent codes, padding clamp included."""
    from fishnet_tpu.nnue import jax_eval

    svc = SearchService(weights=NnueWeights.random(seed=21), device="cpu",
                        **KW)
    seen = []
    evaluate = svc._eval_fn

    def recorder(params, packed, buckets, parent, material, tab, n_rows,
                 ptab, *, offsets):
        seen.append((parent.numpy().copy(), int(n_rows),
                     offsets.numpy().copy()))
        return evaluate(params, packed, buckets, parent, material, tab,
                        n_rows, ptab, offsets=offsets)

    svc._eval_fn = recorder
    results = asyncio.run(_results(svc, DEPTH4_FENS[:2], 3))
    assert all(r[2] for r in results)
    steps = [s for s in seen if s[1] > 0]  # past the warm-up's empty wire
    assert steps
    padded = 0
    for parent, n_rows, offsets in steps:
        assert np.array_equal(
            offsets, jax_eval.derive_offsets_np(parent, n_rows))
        padded += int((offsets == n_rows).sum())
    assert padded > 0  # padding entries were shipped and clamped


@pytest.mark.parametrize("word,raises", [(3, False), (4, True)])
def test_resolve_raises_when_the_kernel_error_word_grew(word, raises):
    """Each dispatch on the card copies the kernel's error word beside its
    values; resolving the step raises once the word has grown past the
    count seen at warm-up (an index or reference the kernel refused)."""
    import torch

    from fishnet_tpu_torch.chess.core import NativeCoreError

    svc = SearchService.__new__(SearchService)  # no pool: the check alone
    svc._err_base = 3
    out = torch.arange(4, dtype=torch.int32)
    handle = (None, out, torch.tensor([word], dtype=torch.int32))
    if raises:
        with pytest.raises(NativeCoreError, match="refused 1"):
            svc._resolve_eval(2, handle)
    else:
        assert svc._resolve_eval(2, handle).tolist() == [0, 1]
