#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fishnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA GPU (written
for the H100). It builds the port's CUDA kernel from the sources in the
checkout, holds it bit for bit against its plain PyTorch version on
every wire entry kind, serves UCI requests through the port's
SearchService on the GPU, checks search parity with the native C++
scalar evaluator, and times the kernel at the serving path's shape.

It prints, in order: the card (``nvidia-smi`` name and power limit,
torch and CUDA versions), the kernel build, the parity checks, the UCI
answers with the kernel's launch count, the scalar parity, then on the
last three lines the card again, one JSON object ``{"kernels": [...]}``
and ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
without the last line. It refuses to run without a GPU, and outside a
checkout (it needs the package beside it).

``--phases`` (comma-separated: kernel, serve, parity, timing; default
all four) limits a run to some phases while iterating on one of them.
Two extra phases run only on request: ``profile`` traces a loaded burst
with torch.profiler, and ``ladder`` times the UCI session and the burst
with the entry-bucket ladder starting at 64 and at 8.
"""

from __future__ import annotations

import argparse
import asyncio
import ctypes
import faulthandler
import json
import random
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
PHASES = ("kernel", "serve", "parity", "timing")  # "profile": on request
#: H100 SXM HBM3 bandwidth and its peak for 32-bit integer/float
#: arithmetic outside the tensor cores (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
MATE_FEN = "6k1/5ppp/8/8/8/8/5PPP/3R2K1 w - - 0 1"
STARTPOS = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(line: str) -> None:
    print(line, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi reported no GPU")
    return out[0]


# -- inputs -----------------------------------------------------------------

def pers_code(aid: int, is_delta: bool, swap: int = 0) -> int:
    """Wire anchor-entry code (cpp/src/pool.cpp emit_block)."""
    return -(2 + ((aid << 2) | (2 if is_delta else 0) | swap))


def wire_batch(rng, size: int, n_tab: int, all_full: bool = False):
    """A packed-wire batch of ``size`` entries over every entry kind:
    plain fulls, full anchor stores, persistent deltas (swapped or not),
    in-batch deltas (swapped or not) against their block's anchor, and
    padding entries that clamp into the sentinel block at ``n_rows``;
    the rows past that block hold out-of-table garbage (stale buffer
    rows). Returns numpy (packed uint16, buckets, parent, n_rows)."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec

    nf, db = spec.NUM_FEATURES, spec.DELTA_BASE
    real = size if size < 4 else size - max(1, size // 10)
    packed = np.full((4 * size + 8, 2, 8), nf, np.uint16)
    parent = np.full((size,), -1, np.int32)
    aids = list(rng.permutation(n_tab))
    rows = e = 0

    def full(e, code):
        nonlocal rows
        live = int(rng.integers(20, 33))
        slots = np.full((2, 32), nf, np.int64)
        slots[:, :live] = rng.integers(0, nf, (2, live))
        packed[rows: rows + 4] = slots.reshape(2, 4, 8).transpose(1, 0, 2)
        parent[e] = code
        rows += 4

    def delta(e, code):
        nonlocal rows
        row = np.full((2, 8), nf, np.int64)
        for p in range(2):
            n_add, n_rem = int(rng.integers(0, 5)), int(rng.integers(0, 5))
            row[p, :n_add] = rng.integers(0, nf, n_add)
            row[p, 4:4 + n_rem] = db + rng.integers(0, nf, n_rem)
            row[p, 4 + n_rem:] = db + nf
        packed[rows] = row
        parent[e] = code
        rows += 1

    while e < real:
        kind = int(rng.integers(0, 3)) if aids else 0
        if all_full:
            full(e, -1)
            e += 1
            continue
        if kind == 0:
            full(e, -1)
        elif kind == 1:
            full(e, pers_code(int(aids.pop()), False))
        else:
            delta(e, pers_code(int(aids.pop()), True, int(rng.integers(0, 2))))
        anchor = e
        e += 1
        for _ in range(int(rng.integers(0, 8))):
            if e >= real:
                break
            delta(e, (anchor << 1) | int(rng.integers(0, 2)))
            e += 1
    packed[rows: rows + 4] = nf  # the sentinel block padding clamps into
    packed[rows + 4:] = 60000  # stale rows: out of table bounds
    buckets = rng.integers(0, spec.NUM_PSQT_BUCKETS, (size,)).astype(np.int32)
    return packed, buckets, parent, rows


def random_lines(n: int, seed: int):
    """``n`` positions as move lists from the start position: seeded
    random walks played by the native core, ongoing games only. (Move
    lists, not FENs: on the GPU host the core's FEN formatter, which
    goes through std::ostringstream, crashes once torch is loaded.)"""
    from fishnet_tpu_torch.chess.core import load

    lib = load()
    rnd = random.Random(seed)
    lines = []
    err = ctypes.create_string_buffer(256)
    buf = ctypes.create_string_buffer(8192)
    start = STARTPOS.encode()
    while len(lines) < n:
        pos = lib.fc_pos_new(start, 0, err, len(err))
        moves = []
        try:
            for _ in range(rnd.randrange(2, 60)):
                if lib.fc_pos_outcome(pos) != 0:
                    break
                lib.fc_pos_legal_moves(pos, buf, len(buf))
                move = rnd.choice(buf.value.split())
                lib.fc_pos_play_uci(pos, move)
                moves.append(move.decode())
            if lib.fc_pos_outcome(pos) == 0:
                lines.append(moves)
        finally:
            lib.fc_pos_free(pos)
    return lines


# -- phases -------------------------------------------------------------------

def phase_kernel(torch, params, dev) -> int:
    """Kernel against plain on the card, bit for bit, on every entry
    kind, B in {1, 64, 512, 4096}, with and without PSQT; then the whole
    evaluate_packed_anchored (values and both tables) and evaluate_batch
    on the GPU against the same functions on the CPU (the plain path).
    Returns the largest absolute difference seen (must be 0)."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec, torch_eval
    from fishnet_tpu_torch.ops import ft_gather

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the head's float32 integer products would round")
    rng = np.random.default_rng(7)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    worst = 0
    ft_gather.kernel_errors(dev, reset=True)
    n_tab = 128
    for size in (1, 64, 512, 4096):
        packed, buckets, parent, n_rows = wire_batch(rng, size, n_tab)
        tab = rng.integers(-3000, 3000, (n_tab, 2, spec.L1)).astype(np.int32)
        ptab = rng.integers(-9000, 9000, (n_tab, 2, 8)).astype(np.int32)
        pk = torch.from_numpy(packed.view(np.int16))
        par = torch.from_numpy(parent)
        offsets = torch_eval.derive_offsets_np(parent, n_rows)
        dense = torch_eval.expand_packed(
            pk, torch.from_numpy(offsets), par).to(dev)
        kinds = {
            "full": int((parent == -1).sum()),
            "store": int(((parent <= -2) & ~torch_eval.is_delta_np(parent)).sum()),
            "persistent": int(((parent <= -2) & torch_eval.is_delta_np(parent)).sum()),
            "in_batch": int((parent >= 0).sum()),
            "swapped": int(((parent >= 0) & (parent & 1 == 1)).sum()),
        }
        for with_psqt in (False, True):
            kw = dict(delta_base=spec.DELTA_BASE, parent=par.to(dev),
                      anchor_tab=torch.from_numpy(tab).to(dev))
            if with_psqt:
                kw.update(ft_psqt=params["ft_psqt"],
                          psqt_tab=torch.from_numpy(ptab).to(dev))
            got = ft_gather.ft_accumulate_cuda(
                params["ft_w"], params["ft_b"], dense, **kw)
            ref = ft_gather.ft_accumulate_plain(
                params["ft_w"], params["ft_b"], dense, **kw)
            got = got if with_psqt else (got,)
            ref = ref if with_psqt else (ref,)
            for g, r in zip(got, ref):
                diff = int((g.long() - r.long()).abs().max())
                worst = max(worst, diff)
                check(diff == 0, f"ft_gather B={size} psqt={with_psqt}: "
                                 f"max |kernel - plain| = {diff}")
        # The whole anchored eval, device-PSQT and host-material wires.
        for host_material in (False, True):
            material = (rng.integers(-500, 500, (size,)).astype(np.int32)
                        if host_material else None)
            outs = []
            for where, prm in ((dev, params), ("cpu", cpu_params)):
                t_tab = torch.from_numpy(tab.copy()).to(where)
                t_ptab = torch.from_numpy(ptab.copy()).to(where)
                vals, _, _ = torch_eval.evaluate_packed_anchored(
                    prm, pk.to(where), torch.from_numpy(buckets).to(where),
                    par.to(where),
                    None if material is None
                    else torch.from_numpy(material).to(where),
                    t_tab, n_rows, t_ptab,
                )
                outs.append([vals.cpu(), t_tab.cpu(), t_ptab.cpu()])
            for name, g, r in zip(("values", "anchor_tab", "psqt_tab"), *outs):
                diff = int((g.long() - r.long()).abs().max())
                worst = max(worst, diff)
                check(diff == 0, f"evaluate_packed_anchored B={size} "
                                 f"host_material={host_material} {name}: {diff}")
        log(f"  B={size:5d} entries {kinds}: kernel == plain, "
            "evaluate_packed_anchored(cuda) == (cpu) on values and tables")
    torch.cuda.synchronize()
    errors = ft_gather.kernel_errors(dev, reset=True)
    check(errors == 0, f"kernel error word is {errors}, expected 0")
    worst = max(worst, planted_out_of_range(torch, params, dev, rng, n_tab))
    # Full entries without parents (evaluate_batch, the no-parent mode).
    idx = rng.integers(0, spec.NUM_FEATURES, (256, 2, 32)).astype(np.int32)
    idx[:, :, 28:] = spec.NUM_FEATURES
    bk = rng.integers(0, 8, (256,)).astype(np.int32)
    got = torch_eval.evaluate_batch(
        params, torch.from_numpy(idx).to(dev), torch.from_numpy(bk).to(dev))
    ref = torch_eval.evaluate_batch(
        cpu_params, torch.from_numpy(idx), torch.from_numpy(bk))
    diff = int((got.cpu().long() - ref.long()).abs().max())
    worst = max(worst, diff)
    check(diff == 0, f"evaluate_batch cuda vs cpu: {diff}")
    torch.cuda.synchronize()
    errors = ft_gather.kernel_errors(dev, reset=True)
    check(errors == 0, f"kernel error word is {errors}, expected 0")
    log(f"  evaluate_batch(cuda) == (cpu) at B=256; kernel error word: {errors}")
    return worst


def planted_out_of_range(torch, params, dev, rng, n_tab: int) -> int:
    """The kernel's range guard (ROADMAP hazard C5): a B=64 batch with
    two out-of-table indices planted — slot 0 of a full entry and the
    first removal slot of an in-batch delta. The kernel must read
    neither row and count each once in its error word; every entry must
    still equal the plain version given the zero sentinel in their
    place (the plain version would index out of bounds). Returns the
    largest absolute difference seen (must be 0)."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec, torch_eval
    from fishnet_tpu_torch.ops import ft_gather

    nf, db = spec.NUM_FEATURES, spec.DELTA_BASE
    packed, _, parent, n_rows = wire_batch(rng, 64, n_tab)
    dense = torch_eval.expand_packed_np(
        packed, torch_eval.derive_offsets_np(parent, n_rows), parent
    ).astype(np.int32)
    full_e = int(np.flatnonzero(parent == -1)[0])
    delta_e = int(np.flatnonzero(parent >= 0)[0])
    planted = dense.copy()
    planted[full_e, 0, 0] = db + nf + 5  # decodes to row nf + 5
    planted[delta_e, 1, 4] = db + nf + 7  # a removal of row nf + 7
    sentinel = dense.copy()
    sentinel[full_e, 0, 0] = nf
    sentinel[delta_e, 1, 4] = nf
    tab = rng.integers(-3000, 3000, (n_tab, 2, spec.L1)).astype(np.int32)
    ptab = rng.integers(-9000, 9000, (n_tab, 2, 8)).astype(np.int32)
    kw = dict(delta_base=db, parent=torch.from_numpy(parent).to(dev),
              anchor_tab=torch.from_numpy(tab).to(dev),
              ft_psqt=params["ft_psqt"], psqt_tab=torch.from_numpy(ptab).to(dev))
    worst = 0
    for with_psqt in (False, True):
        args = kw if with_psqt else {k: v for k, v in kw.items()
                                     if k not in ("ft_psqt", "psqt_tab")}
        got = ft_gather.ft_accumulate_cuda(
            params["ft_w"], params["ft_b"],
            torch.from_numpy(planted).to(dev), **args)
        torch.cuda.synchronize()
        errors = ft_gather.kernel_errors(dev, reset=True)
        check(errors == 2, f"planted out-of-range indices (psqt={with_psqt}):"
                           f" error word {errors}, expected 2")
        ref = ft_gather.ft_accumulate_plain(
            params["ft_w"], params["ft_b"],
            torch.from_numpy(sentinel).to(dev), **args)
        got = got if with_psqt else (got,)
        ref = ref if with_psqt else (ref,)
        for g, r in zip(got, ref):
            diff = int((g.long() - r.long()).abs().max())
            worst = max(worst, diff)
            check(diff == 0, f"planted out-of-range indices (psqt="
                             f"{with_psqt}): max |kernel - plain| = {diff}")
    log(f"  B=64 with 2 planted out-of-range indices: the error word counted "
        "2 per launch, every entry == plain (sentinel in their place)")
    return worst


async def drive_uci(service, lines_in, out):
    """Feed ``lines_in`` to a UciServer; after each ``go`` wait for its
    ``bestmove`` before sending the next command."""
    from fishnet_tpu_torch.uci_server import UciServer

    server = UciServer(service, out=out)
    queue = list(lines_in)
    seen = 0

    async def reader():
        nonlocal seen
        if not queue:
            return None
        line = queue.pop(0)
        if line.startswith("go"):
            queue.insert(0, "__wait__")
        elif line == "__wait__":
            deadline = time.monotonic() + 300
            while out.text().count("bestmove") <= seen:
                check(time.monotonic() < deadline, "search did not answer")
                await asyncio.sleep(0.01)
            seen += 1
            return ""
        return line

    await server.run(reader)


class Transcript:
    """The UCI server's output stream (written and read on the event
    loop's thread)."""

    def __init__(self):
        self._lines = []

    def write(self, s):
        self._lines.append(s)

    def flush(self):
        pass

    def text(self):
        return "".join(self._lines)


def uci_session(service, echo: bool) -> float:
    """The UCI requests of the main path, answered one search at a time:
    handshake, the mate-in-1 position at depth 4, ``go nodes 20000``
    after 1. e4 e5, and three random positions at depth 4. Checks the
    answers; returns the session's wall seconds."""
    out = Transcript()
    walks = random_lines(3, seed=5)
    commands = [
        "uci", "isready",
        f"position fen {MATE_FEN}", "go depth 4",
        "position startpos moves e2e4 e7e5", "go nodes 20000",
    ]
    for moves in walks:
        commands += [f"position startpos moves {' '.join(moves)}",
                     "go depth 4"]
    steps0 = service.counters()["eval_steps"]
    t0 = time.perf_counter()
    asyncio.run(drive_uci(service, commands, out))
    t_uci = time.perf_counter() - t0
    text = out.text()
    if echo:
        for line in text.splitlines():
            log(f"  < {line}")
    answers = [l for l in text.splitlines() if l.startswith("bestmove")]
    check("uciok" in text and "readyok" in text, "UCI handshake failed")
    check(len(answers) == 2 + len(walks),
          f"expected {2 + len(walks)} answers")
    check(answers[0] == "bestmove d1d8", f"mate position: {answers[0]}")
    mate_block = text.split("bestmove d1d8")[0]
    check("score mate 1" in mate_block, "mate position: no 'score mate 1'")
    check(all(a != "bestmove 0000" for a in answers), "a search failed")
    steps = service.counters()["eval_steps"] - steps0
    log(f"  UCI session: {len(answers)} answers in {t_uci:.3f} s, "
        f"{steps} device steps ({t_uci / max(1, steps) * 1e3:.3f} ms "
        "per step, one search at a time)")
    return t_uci


def load_burst(service) -> float:
    """256 concurrent ``go nodes 3000`` searches through the service;
    returns nodes per second."""
    walks = random_lines(256, seed=11)
    c0 = service.counters()

    async def burst():
        return await asyncio.gather(*[
            service.search(STARTPOS, moves, nodes=3000) for moves in walks
        ])

    t0 = time.perf_counter()
    results = asyncio.run(burst())
    t_burst = time.perf_counter() - t0
    check(all(r.best_move for r in results), "burst: a search failed")
    nodes = sum(r.nodes for r in results)
    c = {k: v - c0[k] for k, v in service.counters().items()}
    log(f"  burst: {len(results)} concurrent searches, {nodes} nodes in "
        f"{t_burst:.3f} s ({nodes / t_burst:.0f} nodes/s); eval_steps "
        f"{c['eval_steps']}, evals_shipped {c['evals_shipped']}, "
        f"bucket_slots {c['bucket_slots']}")
    return nodes / t_burst


def phase_serve(torch, weights, dev):
    """The main path: UCI requests answered by the port's SearchService
    on the GPU (microbatch 1024, pipeline 2), then a load burst of
    concurrent searches through the same service. Returns the captured
    inputs of one 512-entry device step for the timing phase."""
    from fishnet_tpu_torch.search.service import SearchService

    service = SearchService(weights=weights, batch_capacity=1024,
                            pipeline_depth=2, device=dev)
    captured = {}
    evaluate = service._eval_fn
    calls = [0]

    def recorder(params, packed, buckets, parent, material, tab, n_rows, ptab):
        if parent.shape[0] == 512:
            calls[0] += 1
            if calls[0] == 8:  # past the first steps: anchors are warm
                captured.update(
                    packed=packed.clone(), parent=parent.clone(),
                    n_rows=n_rows, tab=tab.clone(), ptab=ptab.clone(),
                )
        return evaluate(params, packed, buckets, parent, material, tab,
                        n_rows, ptab)

    service._eval_fn = recorder
    try:
        uci_session(service, echo=True)
        load_burst(service)
        check("parent" in captured, "no 512-entry step was captured")
        return captured
    finally:
        service.close()


def phase_ladder(weights, dev) -> None:
    """The entry-bucket ladder's first rung, 64 (the default, the JAX
    package's) against 8, in the order 64, 8, 8, 64: the UCI session and
    the load burst on a fresh service each time. Not part of the
    default run."""
    from fishnet_tpu_torch.search.service import (
        SearchService,
        eval_bucket_sizes,
    )

    for first in (64, 8, 8, 64):
        service = SearchService(weights=weights, batch_capacity=1024,
                                pipeline_depth=2, device=dev)
        service._eval_sizes = eval_bucket_sizes(service._group_capacity, first)
        try:
            log(f"  ladder from {first}: {service._eval_sizes}")
            uci_session(service, echo=False)
            load_burst(service)
        finally:
            service.close()


def phase_profile(torch, weights, dev) -> None:
    """Where a loaded step's time goes: 256 concurrent searches through
    the service under torch.profiler (CPU and CUDA activity); prints the
    wall time, the device kernel time by name and the device busy
    share. Not part of the default run."""
    from torch.profiler import ProfilerActivity, profile

    from fishnet_tpu_torch.search.service import SearchService

    service = SearchService(weights=weights, batch_capacity=1024,
                            pipeline_depth=2, device=dev)
    walks = random_lines(256, seed=12)

    async def burst():
        return await asyncio.gather(*[
            service.search(STARTPOS, moves, nodes=1000) for moves in walks
        ])

    try:
        service.warmup()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            results = asyncio.run(burst())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps = service.counters()["eval_steps"]
    finally:
        service.close()
    check(all(r.best_move for r in results), "profile burst: a search failed")
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages() if e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    kernels = [r for r in rows if not r[0].startswith(("aten::", "Memcpy",
                                                       "Memset", "cuda"))]
    device_us = sum(r[1] for r in kernels)
    log(f"  {len(results)} searches, {steps} steps in {wall:.3f} s "
        f"({wall / max(1, steps) * 1e3:.3f} ms per step); device kernel "
        f"time {device_us / 1e3:.3f} ms = {device_us / 1e4 / wall:.2f}% busy")
    for key, us, count in rows[:14]:
        log(f"    {us / 1e3:10.3f} ms  {count:7d}x  {key[:90]}")


def phase_parity(weights, dev) -> None:
    """20 positions, one at a time at fixed depth with pipeline 1, one
    driver thread and the prefetch budget pinned: the GPU service and
    the native scalar evaluator must agree on (value, is_mate, move)."""
    from fishnet_tpu_torch.search.service import SearchService

    walks = random_lines(20, seed=99)

    async def run(backend):
        svc = SearchService(weights=weights, pool_slots=16, batch_capacity=64,
                            tt_bytes=256 << 20, backend=backend, device=dev)
        svc.set_prefetch(8, adaptive=False)
        try:
            out = []
            for moves in walks:
                r = await svc.search(STARTPOS, moves, depth=4)
                line = [l for l in r.lines if l.multipv == 1][-1]
                out.append((line.value, line.is_mate, r.best_move, r.nodes))
            return out
        finally:
            svc.close()

    gpu = asyncio.run(run("torch"))
    scalar = asyncio.run(run("scalar"))
    bad = [(w, g, s) for w, g, s in zip(walks, gpu, scalar) if g[:3] != s[:3]]
    check(not bad, f"{len(bad)} of {len(walks)} positions diverged: {bad[:2]}")
    log(f"  {len(walks)} positions at depth 4: GPU service == scalar on "
        f"(value, is_mate, best_move); nodes {sum(g[3] for g in gpu)} "
        f"(GPU) vs {sum(s[3] for s in scalar)} (scalar)")


def graph_time_ms(torch, fn, reps: int = 10, replays: int = 20) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a
    CUDA graph, replayed ``replays`` times between CUDA events, after a
    warm-up (so host launch overhead is not in the number)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound(idx, parent, anchored: bool, with_psqt: bool, l1: int):
    """Least HBM bytes and operations of one call on these inputs: each
    distinct live table row read once (2 B x L1, plus 32 B of PSQT),
    each persistent anchor row once, the indices, parents and bias, and
    the outputs written once; one add per live slot and lane."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec

    idx = np.asarray(idx)
    parent = np.asarray(parent)
    v = -parent - 2
    sparse = (parent >= 0) | ((parent <= -2) & ((v & 2) != 0))
    slots = np.where(sparse[:, None, None],
                     np.arange(32)[None, None, :] < 8, True)
    f = np.where(idx >= spec.DELTA_BASE, idx - spec.DELTA_BASE, idx)
    live = slots & (f < spec.NUM_FEATURES)
    rows = np.unique(f[live])
    pers = (parent <= -2) & ((v & 2) != 0)
    tab_rows = np.unique(v[pers] >> 2) if anchored else np.array([])
    b = len(parent)
    psqt_b = 8 * 4 if with_psqt else 0
    nbytes = (
        len(rows) * (l1 * 2 + psqt_b)
        + len(tab_rows) * 2 * (l1 * 4 + psqt_b)
        + idx.size * 4 + b * 4 + l1 * 2
        + b * 2 * (l1 * 4 + psqt_b)
    )
    ops = int(live.sum()) * (l1 + (8 if with_psqt else 0)) + \
        int((parent >= 0).sum()) * 2 * l1
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, ops


def phase_timing(torch, params, dev, step, launches: int,
                 worst: Optional[int]):
    """Kernel, plain and library times at the serving path's shape:
    B = 512 from a captured search step, and an all-full batch.
    ``worst`` is the kernel phase's largest difference (None when that
    phase did not run)."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec, torch_eval
    from fishnet_tpu_torch.ops import ft_gather

    parent = step["parent"]
    rows_per = torch.where(torch_eval._is_delta(parent), 1, 4).to(torch.int32)
    offsets = (torch.cumsum(rows_per, 0, dtype=torch.int32) - rows_per).clamp(
        max=int(step["n_rows"]))
    dense = torch_eval.expand_packed(step["packed"], offsets, parent)
    kw = dict(delta_base=spec.DELTA_BASE, parent=parent, anchor_tab=step["tab"],
              ft_psqt=params["ft_psqt"], psqt_tab=step["ptab"])
    w, b = params["ft_w"], params["ft_b"]
    got = ft_gather.ft_accumulate_cuda(w, b, dense, **kw)
    ref = ft_gather.ft_accumulate_plain(w, b, dense, **kw)
    diff = max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))
    check(diff == 0, f"captured step: kernel != plain ({diff})")
    diffs = [diff] if worst is None else [diff, worst]
    p = parent.cpu().numpy()
    mix = {"entries": len(p), "full": int((p == -1).sum()),
           "anchor_codes": int((p <= -2).sum()), "in_batch": int((p >= 0).sum())}
    ms = graph_time_ms(torch, lambda: ft_gather.ft_accumulate_cuda(w, b, dense, **kw))
    plain_ms = graph_time_ms(
        torch, lambda: ft_gather.ft_accumulate_plain(w, b, dense, **kw))
    bound_ms, bound_by, nbytes, ops = bound(
        dense.cpu().numpy(), p, True, True, spec.L1)

    # All-full batch: the same rows as a plain gather-sum, which one
    # library call (embedding_bag) also computes — the yardstick.
    rng = np.random.default_rng(3)
    packed, _, full_parent, full_rows = wire_batch(rng, 512, 1, all_full=True)
    fidx = torch_eval.expand_packed_np(
        packed, torch_eval.derive_offsets_np(full_parent, full_rows),
        full_parent)
    fidx = torch.from_numpy(fidx.astype(np.int32)).to(dev)
    fkw = dict(ft_psqt=params["ft_psqt"])
    fgot = ft_gather.ft_accumulate_cuda(w, b, fidx, **fkw)
    fref = ft_gather.ft_accumulate_plain(w, b, fidx, **fkw)
    diffs.append(max(int((g.long() - r.long()).abs().max())
                     for g, r in zip(fgot, fref)))
    check(diffs[-1] == 0, f"all-full batch: kernel != plain ({diffs[-1]})")
    w_f = w.float()
    flat = fidx.view(-1, 32).long()
    lib_out = torch.nn.functional.embedding_bag(flat, w_f, mode="sum")
    check(torch.equal(lib_out.view(512, 2, -1).to(torch.int32) + b.to(torch.int32),
                      fref[0]), "embedding_bag does not compute the same sums")
    full_ms = graph_time_ms(
        torch, lambda: ft_gather.ft_accumulate_cuda(w, b, fidx, **fkw))
    full_plain_ms = graph_time_ms(
        torch, lambda: ft_gather.ft_accumulate_plain(w, b, fidx, **fkw))
    library_ms = graph_time_ms(
        torch,
        lambda: torch.nn.functional.embedding_bag(flat, w_f, mode="sum"))
    full_bound_ms, full_bound_by, full_bytes, full_ops = bound(
        fidx.cpu().numpy(), full_parent, False, True, spec.L1)
    torch.cuda.synchronize()
    check(ft_gather.kernel_errors(dev) == 0, "kernel error word is not 0")
    entry = {
        "name": "ft_gather",
        "route": "cuda",
        "source": "fishnet_tpu_torch/ops/csrc/ft_gather.cu",
        "replaces": "fishnet_tpu/ops/ft_gather.py:402",
        "launches": launches,
        # Over every kernel-versus-plain comparison of this run; "exact"
        # claims every entry kind only when the kernel phase ran.
        "max_abs_err": max(diffs),
        "exact": None if worst is None else max(diffs) == 0,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_bytes": nbytes,
        "bound_ops": ops,
        "library_ms": library_ms,
        "library_on": "all-full B=512 batch (embedding_bag, float32 table)",
        "step_mix": mix,
        "all_full": {
            "entries": 512, "ms": full_ms, "plain_ms": full_plain_ms,
            "library_ms": library_ms, "bound_ms": full_bound_ms,
            "bound_by": full_bound_by, "bound_bytes": full_bytes,
            "bound_ops": full_ops,
        },
    }
    log(f"  captured step {mix}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({nbytes} B)")
    log(f"  all-full B=512: kernel {full_ms:.4f} ms, plain {full_plain_ms:.4f} "
        f"ms, embedding_bag {library_ms:.4f} ms, bound {full_bound_ms:.4f} ms "
        f"({full_bytes} B)")
    return entry


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES))
    args = parser.parse_args()
    phases = set(args.phases.split(","))
    faulthandler.enable()  # a native crash still names its Python frame
    if not (ROOT / "fishnet_tpu_torch" / "ops" / "csrc").is_dir():
        sys.stderr.write(
            "chip_smoke.py must run from a checkout of the repository "
            "(fishnet_tpu_torch/ not found beside it)\n")
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("no CUDA device is visible: nothing to smoke-test\n")
        return 2
    dev = torch.device("cuda", 0)
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from fishnet_tpu_torch.chess.core import load as load_core
    from fishnet_tpu_torch.nnue.torch_eval import params_from_weights
    from fishnet_tpu_torch.nnue.weights import NnueWeights
    from fishnet_tpu_torch.ops import _build, ft_gather

    log("[build] nvcc (sm_90a) and the native core, in parallel")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        kernels = pool.submit(_build.build, ["ft_gather"])
        load_core()  # make -C cpp
        paths = kernels.result()
    log(f"  built {[p.name for p in paths]} in {time.perf_counter() - t0:.3f} s")
    for name, text in _build.build_logs.items():
        for line in text.strip().splitlines():
            log(f"  {name}: {line}")

    t0 = time.perf_counter()
    weights = NnueWeights.random(seed=0)
    params = params_from_weights(weights, dev)
    log(f"  random net (seed 0) on the card in {time.perf_counter() - t0:.3f} s")

    worst = None
    if "kernel" in phases:
        log("[kernel] hand kernel vs plain version, every entry kind")
        worst = phase_kernel(torch, params, dev)
    step = None
    launches = 0
    if "serve" in phases:
        log("[serve] UCI over SearchService(device='cuda'), microbatch 1024")
        ft_gather.ft_accumulate_cuda.launches = 0
        step = phase_serve(torch, weights, dev)
        launches = ft_gather.ft_accumulate_cuda.launches
        log(f"  ft_gather kernel launches on the main path: {launches}")
        check(launches > 0, "the main path never launched the kernel")
    if "parity" in phases:
        log("[parity] GPU service vs native scalar evaluator")
        phase_parity(weights, dev)
    entries = []
    if "timing" in phases and step is not None:
        log("[timing] ft_gather at the serving shape (B = 512)")
        entries.append(phase_timing(torch, params, dev, step, launches, worst))
    if "profile" in phases:
        log("[profile] a loaded burst under torch.profiler")
        phase_profile(torch, weights, dev)
    if "ladder" in phases:
        log("[ladder] entry buckets from 64 vs from 8, one call")
        phase_ladder(weights, dev)
    log(f"card: {card_line()}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        sys.exit(1)
