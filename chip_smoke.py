#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fishnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA GPU (written
for the H100). It builds the port's CUDA kernel from the sources in the
checkout, holds both of its modes (dense indices; the packed wire with
the anchor-table stores) bit for bit against their plain PyTorch
versions on every wire entry kind, serves UCI requests through the
port's SearchService on the GPU (one kernel launch per dispatched
step), checks search parity with the native C++ scalar evaluator, and
times the kernel at the serving path's shape.

It prints, in order: the card (``nvidia-smi`` name and power limit,
torch and CUDA versions), the kernel build, the parity checks, the UCI
answers with the kernel's launch count, the scalar parity, then on the
last three lines the card again, one JSON object ``{"kernels": [...]}``
and ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
without the last line. It refuses to run without a GPU, and outside a
checkout (it needs the package beside it).

``--phases`` (comma-separated: kernel, serve, parity, timing; default
all four) limits a run to some phases while iterating on one of them.
Three extra phases run only on request: ``profile`` traces a loaded
burst with torch.profiler, ``anatomy`` (after ``serve``) times the
kernel with one part of its work removed at a time, and ``ladder``
times the UCI session and the burst with the entry-bucket ladder
starting at 64 and at 8.
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


def wire_batch(rng, size: int, n_tab: int, all_full: bool = False,
               far: bool = False):
    """A packed-wire batch of ``size`` entries over every entry kind:
    plain fulls, full anchor stores, persistent deltas (swapped or not;
    the first entry is always a swapped one, the case where an entry
    reads the table row its own perspective-swapped twin overwrites),
    in-batch deltas (swapped or not) against their block's anchor, and
    padding entries that clamp into the sentinel block at ``n_rows``;
    the rows past that block hold out-of-table garbage (stale buffer
    rows). With ``far`` the anchors come first and every in-batch delta
    after them, each referencing a random anchor, up to thousands of
    entries back. Returns numpy (packed uint16, buckets, parent,
    n_rows)."""
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

    def anchor(e):
        kind = int(rng.integers(0, 3)) if aids else 0
        if e == 0 and aids:
            delta(e, pers_code(int(aids.pop()), True, 1))
        elif kind == 0:
            full(e, -1)
        elif kind == 1:
            full(e, pers_code(int(aids.pop()), False))
        else:
            delta(e, pers_code(int(aids.pop()), True, int(rng.integers(0, 2))))

    if all_full:
        for e in range(real):
            if aids:
                rng.integers(0, 3)  # the draw of an anchor's kind, unused
            full(e, -1)
    elif far:
        n_anchor = max(1, real // 4)
        for e in range(n_anchor):
            anchor(e)
        for e in range(n_anchor, real):
            delta(e, (int(rng.integers(0, n_anchor)) << 1)
                  | int(rng.integers(0, 2)))
    else:
        while e < real:
            anchor(e)
            first = e
            e += 1
            for _ in range(int(rng.integers(0, 8))):
                if e >= real:
                    break
                delta(e, (first << 1) | int(rng.integers(0, 2)))
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

def max_diff(got, ref) -> int:
    """Largest absolute difference over paired int tensors."""
    return max(int((g.long() - r.long()).abs().max()) if g.numel() else 0
               for g, r in zip(got, ref))


def packed_outputs(torch, fn, params, wire, with_psqt: bool):
    """``fn`` (the packed kernel or its plain version) on copies of the
    wire's tables: [acc, (psqt,) anchor_tab, psqt_tab] after the call."""
    pk, off, par, tab, ptab = wire
    tab, ptab = tab.clone(), ptab.clone()
    kw = dict(ft_psqt=params["ft_psqt"], psqt_tab=ptab) if with_psqt else {}
    out = fn(params["ft_w"], params["ft_b"], pk, off, par, tab, **kw)
    return (list(out) if with_psqt else [out]) + [tab, ptab]


def device_wire(torch, rng, dev, size: int, n_tab: int, **kind):
    """A ``wire_batch`` on the card with random tables: (packed, offsets,
    parent, anchor_tab, psqt_tab), plus the numpy parent and n_rows."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec, torch_eval

    packed, _, parent, n_rows = wire_batch(rng, size, n_tab, **kind)
    offsets = torch_eval.derive_offsets_np(parent, n_rows)
    tab = rng.integers(-3000, 3000, (n_tab, 2, spec.L1)).astype(np.int32)
    ptab = rng.integers(-9000, 9000, (n_tab, 2, 8)).astype(np.int32)
    wire = tuple(torch.from_numpy(a).to(dev) for a in (
        packed.view(np.int16), offsets, parent, tab, ptab))
    return wire, parent, n_rows


def phase_kernel(torch, params, dev) -> int:
    """Kernel against plain on the card, bit for bit, on every entry
    kind, B in {1, 64, 512, 4096}, with and without PSQT: the dense mode
    against ft_accumulate_plain, the packed mode against
    ft_accumulate_packed_plain on the accumulators and both stored
    tables; then a B=4096 batch whose in-batch deltas sit far from their
    anchors, the same packed launch 200 times (an ordering race would
    show as a difference between runs), and the whole
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
        wire, parent, n_rows = device_wire(torch, rng, dev, size, n_tab)
        pk, off, par, tab, ptab = wire
        buckets = rng.integers(0, 8, (len(parent),)).astype(np.int32)
        dense = ft_gather.expand_packed(pk, off, par)
        delta = torch_eval.is_delta_np(parent)
        kinds = {
            "full": int((parent == -1).sum()),
            "store": int(((parent <= -2) & ~delta).sum()),
            "persistent": int(((parent <= -2) & delta).sum()),
            "persistent_swapped": int(
                ((parent <= -2) & (((-parent - 2) & 3) == 3)).sum()),
            "in_batch": int((parent >= 0).sum()),
            "swapped": int(((parent >= 0) & (parent & 1 == 1)).sum()),
        }
        check(kinds["persistent_swapped"] > 0, "no swapped persistent delta")
        for with_psqt in (False, True):
            kw = dict(delta_base=spec.DELTA_BASE, parent=par, anchor_tab=tab)
            if with_psqt:
                kw.update(ft_psqt=params["ft_psqt"], psqt_tab=ptab)
            got = ft_gather.ft_accumulate_cuda(
                params["ft_w"], params["ft_b"], dense, **kw)
            ref = ft_gather.ft_accumulate_plain(
                params["ft_w"], params["ft_b"], dense, **kw)
            diff = max_diff(got if with_psqt else (got,),
                            ref if with_psqt else (ref,))
            worst = max(worst, diff)
            check(diff == 0, f"dense B={size} psqt={with_psqt}: "
                             f"max |kernel - plain| = {diff}")
            got = packed_outputs(torch, ft_gather.ft_accumulate_packed_cuda,
                                 params, wire, with_psqt)
            ref = packed_outputs(torch, ft_gather.ft_accumulate_packed_plain,
                                 params, wire, with_psqt)
            diff = max_diff(got, ref)
            worst = max(worst, diff)
            check(diff == 0, f"packed B={size} psqt={with_psqt}: max "
                             f"|kernel - plain| = {diff} (acc, psqt, tables)")
        # The whole anchored eval, device-PSQT and host-material wires.
        for host_material in (False, True):
            material = (rng.integers(-500, 500, (len(parent),)).astype(np.int32)
                        if host_material else None)
            outs = []
            for where, prm in ((dev, params), ("cpu", cpu_params)):
                t_tab, t_ptab = tab.clone().to(where), ptab.clone().to(where)
                vals, _, _ = torch_eval.evaluate_packed_anchored(
                    prm, pk.to(where), torch.from_numpy(buckets).to(where),
                    par.to(where),
                    None if material is None
                    else torch.from_numpy(material).to(where),
                    t_tab, n_rows, t_ptab,
                )
                outs.append([vals.cpu(), t_tab.cpu(), t_ptab.cpu()])
            for name, g, r in zip(("values", "anchor_tab", "psqt_tab"), *outs):
                diff = max_diff([g], [r])
                worst = max(worst, diff)
                check(diff == 0, f"evaluate_packed_anchored B={size} "
                                 f"host_material={host_material} {name}: {diff}")
        log(f"  B={size:5d} entries {kinds}: dense and packed kernel == "
            "plain (acc, psqt, both tables), evaluate_packed_anchored(cuda) "
            "== (cpu) on values and tables")
    torch.cuda.synchronize()
    errors = ft_gather.kernel_errors(dev, reset=True)
    check(errors == 0, f"kernel error word is {errors}, expected 0")

    # In-batch deltas far from their anchors, then 200 identical launches.
    wire, parent, _ = device_wire(torch, rng, dev, 4096, n_tab, far=True)
    refs = np.flatnonzero(parent >= 0)
    reach = int((refs - (parent[refs] >> 1)).max())
    first = packed_outputs(torch, ft_gather.ft_accumulate_packed_cuda,
                           params, wire, True)
    ref = packed_outputs(torch, ft_gather.ft_accumulate_packed_plain,
                         params, wire, True)
    diff = max_diff(first, ref)
    worst = max(worst, diff)
    check(diff == 0, f"packed B=4096 far anchors: |kernel - plain| = {diff}")
    differing = 0
    for _ in range(200):
        again = packed_outputs(torch, ft_gather.ft_accumulate_packed_cuda,
                               params, wire, True)
        differing += int(any(not torch.equal(a, b)
                             for a, b in zip(again, first)))
    check(differing == 0, f"{differing} of 200 repeated launches differ")
    torch.cuda.synchronize()
    errors = ft_gather.kernel_errors(dev, reset=True)
    check(errors == 0, f"kernel error word is {errors}, expected 0")
    log(f"  B=4096, {len(refs)} in-batch deltas up to {reach} entries from "
        "their anchor: packed kernel == plain; 200 repeated launches "
        "identical")
    worst = max(worst, planted_out_of_range(torch, params, dev, rng, n_tab))
    # Full entries without parents (evaluate_batch, the no-parent mode).
    idx = rng.integers(0, spec.NUM_FEATURES, (256, 2, 32)).astype(np.int32)
    idx[:, :, 28:] = spec.NUM_FEATURES
    bk = rng.integers(0, 8, (256,)).astype(np.int32)
    got = torch_eval.evaluate_batch(
        params, torch.from_numpy(idx).to(dev), torch.from_numpy(bk).to(dev))
    ref = torch_eval.evaluate_batch(
        cpu_params, torch.from_numpy(idx), torch.from_numpy(bk))
    diff = max_diff([got.cpu()], [ref])
    worst = max(worst, diff)
    check(diff == 0, f"evaluate_batch cuda vs cpu: {diff}")
    torch.cuda.synchronize()
    errors = ft_gather.kernel_errors(dev, reset=True)
    check(errors == 0, f"kernel error word is {errors}, expected 0")
    log(f"  evaluate_batch(cuda) == (cpu) at B=256; kernel error word: {errors}")
    return worst


def planted_out_of_range(torch, params, dev, rng, n_tab: int) -> int:
    """The kernel's guards (ROADMAP hazard C5 and the wire contract): a
    B=64 batch with two out-of-table indices planted — slot 0 of a full
    entry and the first removal slot of an in-batch delta — and two
    malformed references: an in-batch delta pointing at a LATER entry
    and one pointing at another delta. The kernel must read neither row
    and follow neither reference, count each once in its error word,
    and return (a wait on a reference it may not follow could hang).
    Every other entry must equal the plain version given the zero
    sentinel in place of the planted indices (the plain version would
    index out of bounds); the two malformed entries hold their own rows
    only. Checked in dense and packed mode. Returns the largest absolute
    difference seen (must be 0)."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec, torch_eval
    from fishnet_tpu_torch.ops import ft_gather

    nf, db = spec.NUM_FEATURES, spec.DELTA_BASE
    packed, _, parent, n_rows = wire_batch(rng, 64, n_tab)
    offsets = torch_eval.derive_offsets_np(parent, n_rows)
    dense = torch_eval.expand_packed_np(packed, offsets, parent).astype(
        np.int32)
    full_e = int(np.flatnonzero(parent == -1)[0])
    deltas = np.flatnonzero(parent >= 0)
    delta_e = int(deltas[0])
    planted = dense.copy()
    planted[full_e, 0, 0] = db + nf + 5  # decodes to row nf + 5
    planted[delta_e, 1, 4] = db + nf + 7  # a removal of row nf + 7
    sentinel = dense.copy()
    sentinel[full_e, 0, 0] = nf
    sentinel[delta_e, 1, 4] = nf
    # Malformed references, on two deltas other than delta_e.
    later_e, to_delta_e = int(deltas[1]), int(deltas[2])
    bad_parent = parent.copy()
    bad_parent[later_e] = (int(parent.shape[0]) - 1) << 1 | 1
    bad_parent[to_delta_e] = delta_e << 1
    tab = rng.integers(-3000, 3000, (n_tab, 2, spec.L1)).astype(np.int32)
    ptab = rng.integers(-9000, 9000, (n_tab, 2, 8)).astype(np.int32)
    t = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        planted=planted, sentinel=sentinel, parent=parent,
        bad_parent=bad_parent, tab=tab, ptab=ptab, offsets=offsets,
        packed=packed.view(np.int16)).items()}
    w, b = params["ft_w"], params["ft_b"]
    malformed = [later_e, to_delta_e]
    worst = 0

    def compare(got, ref, own, what):
        # ``own``: the malformed entries' own rows (acc, psqt), no anchor.
        nonlocal worst
        for g, r, o in zip(got, ref, own):
            r = r.clone()
            r[malformed] = o
            diff = max_diff([g], [r])
            worst = max(worst, diff)
            check(diff == 0, f"{what}: max |kernel - expected| = {diff}")

    own = [ft_gather._plain_slot_sum(w, t["sentinel"][malformed], db),
           ft_gather._plain_slot_sum(params["ft_psqt"],
                                     t["sentinel"][malformed], db)]
    for with_psqt in (False, True):
        kw = dict(delta_base=db, anchor_tab=t["tab"])
        if with_psqt:
            kw.update(ft_psqt=params["ft_psqt"], psqt_tab=t["ptab"])
        got = ft_gather.ft_accumulate_cuda(
            w, b, t["planted"], parent=t["bad_parent"], **kw)
        torch.cuda.synchronize()
        errors = ft_gather.kernel_errors(dev, reset=True)
        check(errors == 4, f"dense, 2 planted indices and 2 malformed refs "
                           f"(psqt={with_psqt}): error word {errors}, "
                           "expected 4")
        ref = ft_gather.ft_accumulate_plain(
            w, b, t["sentinel"], parent=t["parent"], **kw)
        compare(got if with_psqt else (got,), ref if with_psqt else (ref,),
                own, f"dense planted (psqt={with_psqt})")
        # Packed: the same malformed references on a clean wire.
        wire = (t["packed"], t["offsets"], t["bad_parent"], t["tab"],
                t["ptab"])
        got = packed_outputs(torch, ft_gather.ft_accumulate_packed_cuda,
                             params, wire, with_psqt)
        torch.cuda.synchronize()
        errors = ft_gather.kernel_errors(dev, reset=True)
        check(errors == 2, f"packed, 2 malformed refs (psqt={with_psqt}): "
                           f"error word {errors}, expected 2")
        ref = packed_outputs(torch, ft_gather.ft_accumulate_packed_plain,
                             params, wire[:2] + (t["parent"],) + wire[3:],
                             with_psqt)
        n_out = 2 if with_psqt else 1
        compare(got[:n_out], ref[:n_out], own,
                f"packed malformed refs (psqt={with_psqt})")
        diff = max_diff(got[n_out:], ref[n_out:])
        worst = max(worst, diff)
        check(diff == 0, f"packed malformed refs (psqt={with_psqt}): "
                         f"tables differ by {diff}")
    log("  B=64 with 2 planted out-of-range indices and 2 malformed refs "
        "(to a later entry, to a delta): each counted once per launch "
        "(dense 4, packed 2), the kernel returned, every other entry == "
        "plain, the malformed ones hold their own rows")
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
    concurrent searches through the same service. The kernel's launch
    counts are zeroed just before (after the service's warm-up) and
    read just after: the packed wrapper must have launched exactly once
    per dispatched step, and neither the wire expansion nor the table
    store of the plain version may have run. Returns the counts, the
    session's seconds, the burst's nodes/s and the captured inputs of
    one 512-entry device step for the timing phase."""
    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.search.service import SearchService

    service = SearchService(weights=weights, batch_capacity=1024,
                            pipeline_depth=2, device=dev)
    captured = {}
    evaluate = service._eval_fn
    calls = [0]

    def recorder(params, packed, buckets, parent, material, tab, n_rows,
                 ptab, *, offsets):
        if parent.shape[0] == 512:
            calls[0] += 1
            if calls[0] == 8:  # past the first steps: anchors are warm
                captured.update(
                    packed=packed.clone(), offsets=offsets.clone(),
                    parent=parent.clone(), n_rows=n_rows, tab=tab.clone(),
                    ptab=ptab.clone(),
                )
        return evaluate(params, packed, buckets, parent, material, tab,
                        n_rows, ptab, offsets=offsets)

    plain_calls = {"expand_packed": 0, "store_anchors": 0}

    def counted(name):
        fn = getattr(ft_gather, name)

        def wrapper(*args, **kwargs):
            plain_calls[name] += 1
            return fn(*args, **kwargs)
        return fn, wrapper

    saved = {}
    service._eval_fn = recorder
    try:
        service.warmup()
        for name in plain_calls:
            saved[name], wrapper = counted(name)
            setattr(ft_gather, name, wrapper)
        steps0 = service.counters()["eval_steps"]
        ft_gather.ft_accumulate_cuda.launches = 0
        ft_gather.ft_accumulate_packed_cuda.launches = 0
        t_uci = uci_session(service, echo=True)
        nps = load_burst(service)
        launches = {
            "packed": ft_gather.ft_accumulate_packed_cuda.launches,
            "dense": ft_gather.ft_accumulate_cuda.launches,
        }
        steps = service.counters()["eval_steps"] - steps0
    finally:
        for name, fn in saved.items():
            setattr(ft_gather, name, fn)
        service.close()
    log(f"  ft_gather launches on the main path: {launches}; dispatched "
        f"steps {steps}; plain-version calls {plain_calls}")
    check(launches["packed"] == steps,
          f"{launches['packed']} packed launches for {steps} steps: "
          "expected one per dispatch")
    check(launches["dense"] == 0, "the main path launched the dense mode")
    check(not any(plain_calls.values()),
          f"the main path ran the plain version's pieces: {plain_calls}")
    check("parent" in captured, "no 512-entry step was captured")
    return {"launches": sum(launches.values()), "steps": steps,
            "uci_s": t_uci, "burst_nps": nps, "step": captured}


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
    copies = [r for r in rows if r[0].startswith(("Memcpy", "Memset"))]
    device_us = sum(r[1] for r in kernels)
    per_step = sum(r[2] for r in kernels) / max(1, steps)
    log(f"  {len(results)} searches, {steps} steps in {wall:.3f} s "
        f"({wall / max(1, steps) * 1e3:.3f} ms per step); device kernel "
        f"time {device_us / 1e3:.3f} ms = {device_us / 1e4 / wall:.2f}% busy")
    log(f"  device kernels per step: {per_step:.2f} ({len(kernels)} "
        f"distinct); copies and fills per step: "
        f"{sum(r[2] for r in copies) / max(1, steps):.2f}")
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


def _graph(torch, fn, reps: int):
    """``reps`` calls of ``fn`` captured in a CUDA graph, after a warm-up
    on a side stream."""
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
    return graph


def graph_time_ms(torch, fn, reps: int = 10, replays: int = 20) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a
    CUDA graph, replayed ``replays`` times between CUDA events, after a
    warm-up (so host launch overhead is not in the number)."""
    graph = _graph(torch, fn, reps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def single_call_ms(torch, fn, flush=None, reps: int = 50) -> float:
    """Device time of one ``fn()`` call, timed alone between CUDA events
    (one call captured in a graph, so the launch is one quick replay),
    the mean over ``reps``. Before each call the device is kept busy for
    some 50 us, so the events do not time the host's launch. With
    ``flush`` (a buffer larger than the 50 MB L2) the buffer is also
    written before each call, outside the graph, so the call finds its
    table cold in HBM."""
    graph = _graph(torch, fn, 1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.fill_(1)
        torch.cuda._sleep(100_000)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _gather_work(idx, parent, with_psqt: bool, l1: int):
    """The table traffic of one call on dense indices: (distinct live
    rows, bytes of those rows, adds)."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec

    v = -parent - 2
    sparse = (parent >= 0) | ((parent <= -2) & ((v & 2) != 0))
    slots = np.where(sparse[:, None, None],
                     np.arange(32)[None, None, :] < 8, True)
    f = np.where(idx >= spec.DELTA_BASE, idx - spec.DELTA_BASE, idx)
    live = slots & (f < spec.NUM_FEATURES)
    rows = np.unique(f[live])
    psqt_b = 8 * 4 if with_psqt else 0
    ops = int(live.sum()) * (l1 + (8 if with_psqt else 0)) + \
        int((parent >= 0).sum()) * 2 * l1
    return len(rows), len(rows) * (l1 * 2 + psqt_b), ops


def _bound_of(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, ops


def bound(idx, parent, anchored: bool, with_psqt: bool, l1: int):
    """Least HBM bytes and operations of one dense-mode call on these
    inputs: each distinct live table row read once (2 B x L1, plus 32 B
    of PSQT), each persistent anchor row once, the indices, parents and
    bias, and the outputs written once; one add per live slot and
    lane."""
    import numpy as np

    idx = np.asarray(idx)
    parent = np.asarray(parent)
    v = -parent - 2
    _, row_bytes, ops = _gather_work(idx, parent, with_psqt, l1)
    pers = (parent <= -2) & ((v & 2) != 0)
    tab_rows = np.unique(v[pers] >> 2) if anchored else np.array([])
    b = len(parent)
    psqt_b = 8 * 4 if with_psqt else 0
    nbytes = (
        row_bytes
        + len(tab_rows) * 2 * (l1 * 4 + psqt_b)
        + idx.size * 4 + b * 4 + l1 * 2
        + b * 2 * (l1 * 4 + psqt_b)
    )
    return _bound_of(nbytes, ops)


def packed_bound(packed, offsets, parent, n_tab: int, with_psqt: bool,
                 l1: int):
    """Least HBM bytes and operations of one packed-mode call: the wire
    rows it reads (each distinct row once, 32 B), the offsets and
    parents, the bias, each distinct live table row, each persistent
    anchor row read, the accumulator and PSQT outputs, and the anchor
    rows it writes; one add per live slot and lane."""
    import numpy as np

    from fishnet_tpu_torch.nnue import torch_eval

    packed, offsets, parent = (np.asarray(a) for a in (packed, offsets,
                                                       parent))
    delta = torch_eval.is_delta_np(parent)
    span = np.where(delta[:, None], np.arange(4)[None, :] < 1, True)
    wire_rows = np.clip(offsets[:, None] + np.arange(4)[None, :], 0,
                        len(packed) - 1)
    n_wire = len(np.unique(wire_rows[span]))
    dense = torch_eval.expand_packed_np(packed, offsets, parent)
    _, row_bytes, ops = _gather_work(dense.astype(np.int64), parent,
                                     with_psqt, l1)
    v = -parent - 2
    aid = v >> 2
    stores = (parent <= -2) & (aid < n_tab)
    tab_read = np.unique(aid[stores & ((v & 2) != 0)])
    tab_written = np.unique(aid[stores])
    b = len(parent)
    psqt_b = 8 * 4 if with_psqt else 0
    nbytes = (
        n_wire * 2 * 8 * 2 + b * 4 * 2 + l1 * 2
        + row_bytes
        + (len(tab_read) + len(tab_written)) * 2 * (l1 * 4 + psqt_b)
        + b * 2 * (l1 * 4 + psqt_b)
    )
    return _bound_of(nbytes, ops)


def phase_timing(torch, params, dev, serve, worst: Optional[int]):
    """Kernel, plain and library times at the serving path's shape, in
    both modes: B = 512 from a captured search step (packed: the main
    path; dense: its expanded indices, comparable with the earlier
    dense-only kernel) warm in L2 and, for the packed mode, with the L2
    flushed before each call; and an all-full batch, which one library
    call (embedding_bag) also computes. ``worst`` is the kernel phase's
    largest difference (None when that phase did not run)."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec, torch_eval
    from fishnet_tpu_torch.ops import ft_gather

    step = serve["step"]
    pk, off, par = step["packed"], step["offsets"], step["parent"]
    w, b, fp = params["ft_w"], params["ft_b"], params["ft_psqt"]
    n_tab = step["tab"].shape[0]
    wire = (pk, off, par, step["tab"], step["ptab"])
    dense = ft_gather.expand_packed(pk, off, par)
    dkw = dict(delta_base=spec.DELTA_BASE, parent=par,
               anchor_tab=step["tab"], ft_psqt=fp, psqt_tab=step["ptab"])

    got = ft_gather.ft_accumulate_cuda(w, b, dense, **dkw)
    ref = ft_gather.ft_accumulate_plain(w, b, dense, **dkw)
    diffs = [max_diff(got, ref), max_diff(
        packed_outputs(torch, ft_gather.ft_accumulate_packed_cuda,
                       params, wire, True),
        packed_outputs(torch, ft_gather.ft_accumulate_packed_plain,
                       params, wire, True))]
    check(max(diffs) == 0, f"captured step: kernel != plain {diffs} "
                           "(dense, packed)")
    diffs += [] if worst is None else [worst]
    p = par.cpu().numpy()
    mix = {"entries": len(p), "full": int((p == -1).sum()),
           "anchor_codes": int((p <= -2).sum()), "in_batch": int((p >= 0).sum())}
    tab, ptab = step["tab"].clone(), step["ptab"].clone()

    def packed_call():
        return ft_gather.ft_accumulate_packed_cuda(
            w, b, pk, off, par, tab, ft_psqt=fp, psqt_tab=ptab)

    def dense_call():
        return ft_gather.ft_accumulate_cuda(w, b, dense, **dkw)

    ptab_plain, pptab_plain = step["tab"].clone(), step["ptab"].clone()
    times = {
        "dense": graph_time_ms(torch, dense_call),
        "packed": graph_time_ms(torch, packed_call),
    }
    again = {"dense": graph_time_ms(torch, dense_call),
             "packed": graph_time_ms(torch, packed_call)}
    plain_ms = graph_time_ms(torch, lambda: ft_gather.ft_accumulate_plain(
        w, b, dense, **dkw))
    packed_plain_ms = graph_time_ms(
        torch, lambda: ft_gather.ft_accumulate_packed_plain(
            w, b, pk, off, par, ptab_plain, ft_psqt=fp,
            psqt_tab=pptab_plain))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    cold_ms = single_call_ms(torch, packed_call, flush)
    single_ms = single_call_ms(torch, packed_call)
    del flush
    bound_ms, bound_by, nbytes, ops = bound(
        dense.cpu().numpy(), p, True, True, spec.L1)
    pbound_ms, pbound_by, pbytes, pops = packed_bound(
        pk.cpu().numpy().view(np.uint16), off.cpu().numpy(), p, n_tab, True,
        spec.L1)

    # All-full batch: the same rows as a plain gather-sum, which one
    # library call (embedding_bag) also computes — the yardstick.
    rng = np.random.default_rng(3)
    packed, _, full_parent, full_rows = wire_batch(rng, 512, 1, all_full=True)
    full_offsets = torch_eval.derive_offsets_np(full_parent, full_rows)
    fidx = torch_eval.expand_packed_np(packed, full_offsets, full_parent)
    fidx = torch.from_numpy(fidx.astype(np.int32)).to(dev)
    fkw = dict(ft_psqt=fp)
    fgot = ft_gather.ft_accumulate_cuda(w, b, fidx, **fkw)
    fref = ft_gather.ft_accumulate_plain(w, b, fidx, **fkw)
    diffs.append(max_diff(fgot, fref))
    check(diffs[-1] == 0, f"all-full batch: kernel != plain ({diffs[-1]})")
    fwire = tuple(torch.from_numpy(a).to(dev) for a in (
        packed.view(np.int16), full_offsets, full_parent,
        np.zeros((1, 2, spec.L1), np.int32), np.zeros((1, 2, 8), np.int32)))
    diffs.append(max_diff(
        packed_outputs(torch, ft_gather.ft_accumulate_packed_cuda, params,
                       fwire, True),
        packed_outputs(torch, ft_gather.ft_accumulate_packed_plain, params,
                       fwire, True)))
    check(diffs[-1] == 0, f"all-full wire: packed kernel != plain "
                          f"({diffs[-1]})")
    w_f = w.float()
    flat = fidx.view(-1, 32).long()
    lib_out = torch.nn.functional.embedding_bag(flat, w_f, mode="sum")
    check(torch.equal(lib_out.view(len(full_parent), 2, -1).to(torch.int32)
                      + b.to(torch.int32),
                      fref[0]), "embedding_bag does not compute the same sums")
    full_ms = graph_time_ms(
        torch, lambda: ft_gather.ft_accumulate_cuda(w, b, fidx, **fkw))
    full_plain_ms = graph_time_ms(
        torch, lambda: ft_gather.ft_accumulate_plain(w, b, fidx, **fkw))
    library_ms = graph_time_ms(
        torch,
        lambda: torch.nn.functional.embedding_bag(flat, w_f, mode="sum"))
    fpk, foff, fpar, ftab, fptab = fwire
    full_packed_ms = graph_time_ms(
        torch, lambda: ft_gather.ft_accumulate_packed_cuda(
            w, b, fpk, foff, fpar, ftab, ft_psqt=fp, psqt_tab=fptab))
    full_packed_plain_ms = graph_time_ms(
        torch, lambda: ft_gather.ft_accumulate_packed_plain(
            w, b, fpk, foff, fpar, ftab, ft_psqt=fp, psqt_tab=fptab))
    full_bound_ms, full_bound_by, full_bytes, full_ops = bound(
        fidx.cpu().numpy(), full_parent, False, True, spec.L1)
    fpb_ms, fpb_by, fpb_bytes, fpb_ops = packed_bound(
        packed, full_offsets, full_parent, 1, True, spec.L1)
    torch.cuda.synchronize()
    check(ft_gather.kernel_errors(dev) == 0, "kernel error word is not 0")
    entry = {
        "name": "ft_gather",
        "route": "cuda",
        "source": "fishnet_tpu_torch/ops/csrc/ft_gather.cu",
        "replaces": "fishnet_tpu/ops/ft_gather.py:402",
        "launches": serve["launches"],
        # Over every kernel-versus-plain comparison of this run; "exact"
        # claims every entry kind only when the kernel phase ran.
        "max_abs_err": max(diffs),
        "exact": None if worst is None else max(diffs) == 0,
        # The main path's mode (packed) on the captured step.
        "ms": times["packed"],
        "kernel_ms": times["packed"],
        "plain_ms": packed_plain_ms,
        "bound_ms": pbound_ms,
        "bound_by": pbound_by,
        "bound_bytes": pbytes,
        "bound_ops": pops,
        "library_ms": library_ms,
        "library_on": "all-full B=512 batch (embedding_bag, float32 table)",
        "step_mix": mix,
        "repeat_ms": again["packed"],
        "cold_l2_ms": cold_ms,
        "single_call_warm_ms": single_ms,
        "dense": {
            "ms": times["dense"], "repeat_ms": again["dense"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": nbytes, "bound_ops": ops,
        },
        "all_full": {
            "entries": 512, "ms": full_ms, "plain_ms": full_plain_ms,
            "library_ms": library_ms, "bound_ms": full_bound_ms,
            "bound_by": full_bound_by, "bound_bytes": full_bytes,
            "bound_ops": full_ops, "packed_ms": full_packed_ms,
            "packed_plain_ms": full_packed_plain_ms,
            "packed_bound_ms": fpb_ms, "packed_bound_by": fpb_by,
            "packed_bound_bytes": fpb_bytes,
        },
    }
    log(f"  captured step {mix}: packed kernel {times['packed']:.6f} / "
        f"{again['packed']:.6f} ms, plain "
        f"{packed_plain_ms:.6f} ms, bound {pbound_ms:.6f} ms ({pbytes} B); "
        f"cold L2 {cold_ms:.6f} ms, warm alone {single_ms:.6f} ms")
    log(f"  captured step, dense: kernel {times['dense']:.6f} / "
        f"{again['dense']:.6f} ms, plain "
        f"{plain_ms:.6f} ms, bound {bound_ms:.6f} ms ({nbytes} B)")
    log(f"  all-full B=512: dense kernel {full_ms:.6f} ms, plain "
        f"{full_plain_ms:.6f} ms, embedding_bag {library_ms:.6f} ms, bound "
        f"{full_bound_ms:.6f} ms ({full_bytes} B); packed kernel "
        f"{full_packed_ms:.6f} ms, plain {full_packed_plain_ms:.6f} ms, "
        f"bound {fpb_ms:.6f} ms ({fpb_bytes} B)")
    return entry


#: Timing-only variants of the kernel source for the anatomy phase:
#: (name, [(text in csrc/ft_gather.cu, replacement)]). Each removes one
#: part of the work; its results are wrong by design and never checked.
ANATOMY = [
    ("as shipped", []),
    ("no ticket (blockIdx order; deltas do not wait)", [
        ("atomicAdd(ticket, 1ull);",
         "(static_cast<unsigned long long>(__ldcg(a.state + 1)) << 32)"
         " | blockIdx.x;"),
        ("    if (s_b == a.batch - 1)  // the last claimant: (epoch + 1, 0)",
         "    if (false)"),
    ]),
    ("no anchor wait", [("    if (follow) {", "    if (false) {")]),
    ("rows capped at one batch of 8", [
        ("    for (int k0 = 0; k0 < n_live; k0 += kInFlight) {",
         "    for (int k0 = 0; k0 < min(n_live, kInFlight); k0 += kInFlight) {")]),
    ("no table rows", [
        ("    for (int k0 = 0; k0 < n_live; k0 += kInFlight) {",
         "    for (int k0 = 0; k0 < 0; k0 += kInFlight) {")]),
    ("no table rows, no anchor wait", [
        ("    for (int k0 = 0; k0 < n_live; k0 += kInFlight) {",
         "    for (int k0 = 0; k0 < 0; k0 += kInFlight) {"),
        ("    if (follow) {", "    if (false) {")]),
]


def phase_anatomy(torch, params, dev, serve) -> None:
    """Where the kernel's time goes on the captured step: the kernel
    source built again with one part of the work removed at a time
    (ANATOMY), all variants compiled in parallel, each timed in both
    modes as the timing phase times the kernel. Not part of the default
    run."""
    import subprocess as sp

    from fishnet_tpu_torch.nnue import spec
    from fishnet_tpu_torch.ops import _build, ft_gather

    step = serve["step"]
    pk, off, par = step["packed"], step["offsets"], step["parent"]
    w, b, fp = params["ft_w"], params["ft_b"], params["ft_psqt"]
    dense = ft_gather.expand_packed(pk, off, par)
    dkw = dict(delta_base=spec.DELTA_BASE, parent=par,
               anchor_tab=step["tab"], ft_psqt=fp, psqt_tab=step["ptab"])
    tab, ptab = step["tab"].clone(), step["ptab"].clone()
    source = (_build.CSRC_DIR / "ft_gather.cu").read_text()
    out_dir = _build.BUILD_DIR / "anatomy"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = []
    for i, (name, patches) in enumerate(ANATOMY):
        text = source
        for old, new in patches:
            check(text.count(old) == 1, f"anatomy {name!r}: patch site moved")
            text = text.replace(old, new)
        cu, so = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        builds.append((name, so, sp.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=sp.PIPE, stderr=sp.STDOUT, text=True)))
    shipped = ft_gather._kernel_lib()
    try:
        for name, so, proc in builds:
            text, _ = proc.communicate()
            check(proc.returncode == 0, f"anatomy {name!r}: nvcc failed\n{text}")
            lib = ctypes.CDLL(str(so))
            lib.fc_ft_gather.argtypes = shipped.fc_ft_gather.argtypes
            lib.fc_ft_gather.restype = ctypes.c_int
            ft_gather._lib = lib
            dense_ms = graph_time_ms(torch, lambda: ft_gather.ft_accumulate_cuda(
                w, b, dense, **dkw))
            packed_ms = graph_time_ms(
                torch, lambda: ft_gather.ft_accumulate_packed_cuda(
                    w, b, pk, off, par, tab, ft_psqt=fp, psqt_tab=ptab))
            log(f"  {name:48s} dense {dense_ms:.6f} ms, packed "
                f"{packed_ms:.6f} ms")
    finally:
        ft_gather._lib = shipped


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
    from fishnet_tpu_torch.ops import _build

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
    serve = None
    if "serve" in phases:
        log("[serve] UCI over SearchService(device='cuda'), microbatch 1024")
        serve = phase_serve(torch, weights, dev)
        check(serve["launches"] > 0, "the main path never launched the kernel")
    if "parity" in phases:
        log("[parity] GPU service vs native scalar evaluator")
        phase_parity(weights, dev)
    entries = []
    if "timing" in phases and serve is not None:
        log("[timing] ft_gather at the serving shape (B = 512)")
        entries.append(phase_timing(torch, params, dev, serve, worst))
    if "profile" in phases:
        log("[profile] a loaded burst under torch.profiler")
        phase_profile(torch, weights, dev)
    if "anatomy" in phases and serve is not None:
        log("[anatomy] the kernel with one part of its work removed at a time")
        phase_anatomy(torch, params, dev, serve)
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
