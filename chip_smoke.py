#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fishnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA GPU (written
for the H100). It builds the port's CUDA kernel and native core from the
sources in the checkout, checks the core's FEN formatter next to torch,
holds both of the kernel's modes (dense indices; the packed wire with
the anchor-table stores) bit for bit against their plain PyTorch
versions on every wire entry kind, serves UCI requests through the
port's SearchService on the GPU (one kernel launch per device
dispatch, the dispatch coalescer fusing the groups' steps), checks
search parity with the native C++ scalar evaluator, times the kernel at
the serving path's shape, holds fused segmented dispatches against solo
ones and the plain version and runs the service at the new defaults
(one driver thread per core), and runs the fishnet client —
in process, then ``python -m fishnet_tpu_torch run`` as a subprocess —
against a fake lichess server built on the standard library.

It prints, in order: the card (``nvidia-smi`` name and power limit,
torch and CUDA versions), the builds, the FEN check, the parity checks,
the UCI answers with the kernel's launch count, the scalar parity, the
kernel's times, the coalescer's checks and the fused launch's times,
the client runs' throughput and latencies, then on the
last three lines the card again, one JSON object ``{"kernels": [...]}``
and ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
without the last line. It refuses to run without a GPU, and outside a
checkout (it needs the package beside it).

``--phases`` (comma-separated: kernel, serve, parity, timing, coalesce,
run, cli; default all seven) limits a run to some phases while
iterating on one of them. ``coalesce`` holds the fused segmented
dispatch of K in {2, 4, 8} real group steps against K solo dispatches
and the plain segmented version, times the fused launch, and runs the
service with the new defaults (one driver thread per core, coalescer
and async pipeline on). Four extra phases run only on request:
``profile`` traces a loaded burst with torch.profiler, ``anatomy``
(after ``serve``) times the kernel with one part of its work removed at
a time, ``ladder`` times the UCI session and the burst with the
entry-bucket ladder starting at 64 and at 8, and ``sweep`` times the
burst at 1, 2, 4 and 7 driver threads with and without the
coalescer.

The module imports only the standard library, so its fake lichess
(``FakeLichess``, ``FakeServer``) also serves the CPU tests.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import ctypes
import faulthandler
import itertools
import json
import os
import random
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
PHASES = ("kernel", "serve", "parity", "timing", "coalesce", "run", "cli")
#: H100 SXM HBM3 bandwidth and its peak for 32-bit integer/float
#: arithmetic outside the tensor cores (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
MATE_FEN = "6k1/5ppp/8/8/8/8/5PPP/3R2K1 w - - 0 1"
STARTPOS = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"


#: (FEN, variant, what the native core's FEN formatter gives back) — the
#: ``fen`` check (ROADMAP C7): castling rights in both notations and
#: X-FEN file letters, an en-passant square kept and one dropped, move
#: counters, crazyhouse pockets and a promoted piece, every variant.
FEN_CHECKS = [
    (STARTPOS, "standard", STARTPOS),
    ("rnbqkbnr/pppp1ppp/8/4p3/4P3/8/PPPP1PPP/RNBQKBNR w KQkq e6 0 2",
     "standard", "rnbqkbnr/pppp1ppp/8/4p3/4P3/8/PPPP1PPP/RNBQKBNR w KQkq - 0 2"),
    ("rnbqkbnr/ppp1p1pp/8/3pPp2/8/8/PPPP1PPP/RNBQKBNR w KQkq f6 0 3",
     "standard", "rnbqkbnr/ppp1p1pp/8/3pPp2/8/8/PPPP1PPP/RNBQKBNR w KQkq f6 0 3"),
    ("r3k2r/8/8/8/8/8/8/R3K2R b Kq - 17 42", "standard",
     "r3k2r/8/8/8/8/8/8/R3K2R b Kq - 17 42"),
    ("4k3/8/8/8/8/8/8/RR2K2R w BK - 5 30", "standard",
     "4k3/8/8/8/8/8/8/RR2K2R w KB - 5 30"),
    ("8/2k5/8/8/8/8/5K2/8 w - - 99 150", "standard",
     "8/2k5/8/8/8/8/5K2/8 w - - 99 150"),
    ("bqnb1rkr/pp3ppp/3ppn2/2p5/5P2/P2P4/NPP1P1PP/BQ1BNRKR w HFhf - 2 9",
     "chess960", "bqnb1rkr/pp3ppp/3ppn2/2p5/5P2/P2P4/NPP1P1PP/BQ1BNRKR w KQkq - 2 9"),
    ("rr2k3/8/8/8/8/8/8/RR2K2R w BKb - 0 1", "chess960",
     "rr2k3/8/8/8/8/8/8/RR2K2R w KBb - 0 1"),
    ("rnbqkb1r/pp1p1ppp/4pn2/2p5/2PP4/2N5/PP2PPPP/R1BQKBNR[Pp] w KQkq - 0 5",
     "crazyhouse",
     "rnbqkb1r/pp1p1ppp/4pn2/2p5/2PP4/2N5/PP2PPPP/R1BQKBNR[Pp] w KQkq - 0 5"),
    ("r2q1rk1/ppp2ppp/2n1bN~2/3p4/3P4/2P5/PP3PPP/R1BQKB1R[PNb] b KQ - 0 11",
     "crazyhouse",
     "r2q1rk1/ppp2ppp/2n1bN~2/3p4/3P4/2P5/PP3PPP/R1BQKB1R[NPb] b KQ - 0 11"),
    ("rnbqkbnr/pppppppp/8/1PP2PP1/PPPPPPPP/PPPPPPPP/PPPPPPPP/PPPPPPPP w kq - 0 1",
     "horde",
     "rnbqkbnr/pppppppp/8/1PP2PP1/PPPPPPPP/PPPPPPPP/PPPPPPPP/PPPPPPPP w kq - 0 1"),
    ("8/8/8/8/8/8/krbnNBRK/qrbnNBRQ w - - 0 1", "racingkings",
     "8/8/8/8/8/8/krbnNBRK/qrbnNBRQ w - - 0 1"),
    ("rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 3+3 0 1", "3check",
     "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 3+3 0 1"),
    ("rnbqkbnr/pppp1ppp/8/4p3/4P3/8/PPPP1PPP/RNBQKBNR w KQkq - 0 2",
     "kingofthehill",
     "rnbqkbnr/pppp1ppp/8/4p3/4P3/8/PPPP1PPP/RNBQKBNR w KQkq - 0 2"),
    ("rnbqkbnr/pppp1ppp/8/4p3/4P3/8/PPPP1PPP/RNBQKBNR w KQkq - 0 2", "atomic",
     "rnbqkbnr/pppp1ppp/8/4p3/4P3/8/PPPP1PPP/RNBQKBNR w KQkq - 0 2"),
    ("rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w - - 0 1", "antichess",
     "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w - - 0 1"),
]


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
    random walks played by the native core, ongoing games only."""
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


# -- a fake lichess server on the standard library ----------------------------

VALID_KEY = "TESTKEY"


class FakeLichess:
    """In-memory fishnet job queue with the semantics of the handlers of
    ``tests/fake_server.py`` (which needs aiohttp; this one needs only
    the standard library, so it runs beside the port on the card):
    acquire answers 202 with the first unacquired job or 204; a
    submitted analysis whose first part is null is a progress report,
    any other completes the job; a move submission chains the next
    unacquired move job (202) or answers 204; an abort puts the job
    back in the queue; the key is checked against ``VALID_KEY``. Every
    handler runs under one lock; timestamps are ``time.monotonic()``.
    ``acquire_delay`` holds each acquire for that many seconds before it
    is answered (a long poll), outside the lock."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.jobs = []  # [{"body": ..., "user_queue": bool, "acquired": bool}]
        self.analyses = {}
        self.progress_reports = {}
        self.moves = {}
        self.aborted = []
        self.acquire_count = 0
        self.reject_with = None  # force an HTTP status on acquire
        self.acquire_delay = 0.0
        self.connections = 0  # TCP connections accepted
        self.handed_at = {}
        self.completed_at = {}
        self.move_done_at = {}
        self.bodies = {}  # work id -> the job as added, kept after it is done
        self._ids = itertools.count()

    def add_analysis_job(self, moves: str = "e2e4 e7e5", position: str = STARTPOS,
                         variant: str = "standard", skip_positions=None,
                         nodes: int = 5000, multipv=None, depth=None,
                         game_id: str = "", user_queue: bool = False) -> str:
        work_id = f"wk{next(self._ids):06d}"
        work = {"type": "analysis", "id": work_id,
                "nodes": {"sf15": nodes, "sf14": nodes, "classical": nodes * 2},
                "timeout": 7000}
        if multipv is not None:
            work["multipv"] = multipv
        if depth is not None:
            work["depth"] = depth
        self._add({"work": work, "game_id": game_id, "position": position,
                   "variant": variant, "moves": moves,
                   "skipPositions": skip_positions or []}, user_queue)
        return work_id

    def add_move_job(self, moves: str = "", position: str = STARTPOS,
                     level: int = 5, clock=None, variant: str = "standard") -> str:
        work_id = f"wk{next(self._ids):06d}"
        work = {"type": "move", "id": work_id, "level": level}
        if clock:
            work["clock"] = clock
        self._add({"work": work, "game_id": "", "position": position,
                   "variant": variant, "moves": moves}, False)
        return work_id

    def _add(self, body, user_queue: bool) -> None:
        with self.lock:
            self.bodies[body["work"]["id"]] = body
            self.jobs.append({"body": body, "user_queue": user_queue,
                              "acquired": False})

    def _hand_out(self, kind=None, slow: bool = False):
        for job in self.jobs:
            work = job["body"]["work"]
            if job["acquired"] or (slow and job["user_queue"]):
                continue
            if kind is None or work["type"] == kind:
                job["acquired"] = True
                self.handed_at.setdefault(work["id"], time.monotonic())
                return 202, job["body"]
        return 204, None

    def _done(self, work_id: str) -> None:
        self.jobs = [j for j in self.jobs if j["body"]["work"]["id"] != work_id]

    def handle(self, method: str, path: str, query: dict, headers, body):
        """(status, JSON payload or None) for one request."""
        key = (body or {}).get("fishnet", {}).get("apikey")
        authed = (headers.get("Authorization") == f"Bearer {VALID_KEY}"
                  or key == VALID_KEY)
        parts = path.strip("/").split("/")
        if parts[:1] != ["fishnet"] or len(parts) < 2:
            return 404, None
        route, arg = parts[1], (parts[2] if len(parts) > 2 else None)
        if method == "POST" and route == "acquire" and self.acquire_delay:
            time.sleep(self.acquire_delay)
        with self.lock:
            if method == "GET" and route == "key":
                ok = arg == VALID_KEY if arg is not None else authed
                return (200 if ok else (404 if arg is not None else 401)), None
            if method == "GET" and route == "status":
                queued = {q: sum(1 for j in self.jobs if not j["acquired"]
                                 and j["user_queue"] == (q == "user"))
                          for q in ("user", "system")}
                return 200, {"analysis": {q: {"acquired": 0, "queued": n,
                                              "oldest": 0}
                                          for q, n in queued.items()}}
            if method != "POST":
                return 404, None
            if route == "acquire":
                self.acquire_count += 1
                if self.reject_with:
                    return self.reject_with, None
                if not authed:
                    return 401, None
                return self._hand_out(slow=query.get("slow") == ["true"])
            if not authed:
                return 401, None
            if route == "analysis":
                analysis = (body or {}).get("analysis") or []
                if analysis and analysis[0] is None:
                    self.progress_reports.setdefault(arg, []).append(body)
                else:
                    self.analyses[arg] = body
                    self.completed_at.setdefault(arg, time.monotonic())
                    self._done(arg)
                return 204, None
            if route == "move":
                self.moves[arg] = body
                self.move_done_at.setdefault(arg, time.monotonic())
                self._done(arg)
                return self._hand_out(kind="move")
            if route == "abort":
                self.aborted.append(arg)
                for job in self.jobs:
                    if job["body"]["work"]["id"] == arg:
                        job["acquired"] = False
                return 204, None
        return 404, None


class FakeServer:
    """A FakeLichess behind ``http.server.ThreadingHTTPServer`` on a
    thread, on an ephemeral localhost port, speaking HTTP/1.1 with
    keep-alive. Use as a context manager; ``endpoint`` is the fishnet
    URL to point a client at."""

    def __init__(self, lichess: Optional[FakeLichess] = None) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlsplit

        self.lichess = lichess = lichess or FakeLichess()

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # Headers and body go out as two writes: without TCP_NODELAY
            # a kept-alive connection waits ~40 ms (Nagle against the
            # client's delayed ACK) before each body.
            disable_nagle_algorithm = True

            def setup(self):
                super().setup()
                with lichess.lock:
                    lichess.connections += 1

            def _serve(self):
                url = urlsplit(self.path)
                raw = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                try:
                    body = json.loads(raw) if raw else None
                except ValueError:
                    body = None
                status, payload = lichess.handle(
                    self.command, url.path, parse_qs(url.query), self.headers,
                    body)
                data = b"" if payload is None else json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = _serve

            def log_message(self, *args):
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        port = self._httpd.server_address[1]
        self.endpoint = f"http://127.0.0.1:{port}/fishnet"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="fake-lichess", daemon=True)

    def __enter__(self) -> "FakeServer":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)


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
        f"{c['eval_steps']}, dispatches {c['dispatches']} "
        f"({c['fused_dispatches']} fused), evals_shipped "
        f"{c['evals_shipped']}, bucket_slots {c['bucket_slots']}, "
        f"fused_dedup {c['fused_dedup']}")
    return nodes / t_burst


def phase_serve(torch, weights, dev):
    """The main path: UCI requests answered by the port's SearchService
    on the GPU (microbatch 1024, pipeline 2: two groups, so the
    coalescer fuses their steps), then a load burst of concurrent
    searches through the same service. The kernel's launch counts are
    zeroed just before (after the service's warm-up) and read just
    after: the packed wrapper must have launched exactly once per device
    dispatch (solo or fused), and neither the wire expansion nor the table
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
                # Solo (one group's table) or fused (the flat table of
                # every group, segments rebased into it).
                captured.update(
                    packed=packed.clone(), offsets=offsets.clone(),
                    parent=parent.clone(), n_rows=n_rows, tab=tab.clone(),
                    ptab=ptab.clone(),
                    fused=tab.shape[0] > service._anchor_rows,
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
        c0 = service.counters()
        ft_gather.ft_accumulate_cuda.launches = 0
        ft_gather.ft_accumulate_packed_cuda.launches = 0
        t_uci = uci_session(service, echo=True)
        nps = load_burst(service)
        launches = {
            "packed": ft_gather.ft_accumulate_packed_cuda.launches,
            "dense": ft_gather.ft_accumulate_cuda.launches,
        }
        c = {k: v - c0[k] for k, v in service.counters().items()}
    finally:
        for name, fn in saved.items():
            setattr(ft_gather, name, fn)
        service.close()
    steps = c["eval_steps"]
    log(f"  ft_gather launches on the main path: {launches}; dispatched "
        f"steps {steps} in {c['dispatches']} device dispatches "
        f"({c['fused_dispatches']} fused, of {c['coalesced_steps']} steps; "
        f"{c['fused_dedup']} evals deduped; width policy "
        f"{service.coalesce_width()}, probe {service.dispatch_probe}); "
        f"plain-version calls {plain_calls}")
    check(launches["packed"] == c["dispatches"],
          f"{launches['packed']} packed launches for {c['dispatches']} "
          "dispatches: expected one per dispatch")
    check(launches["dense"] == 0, "the main path launched the dense mode")
    check(not any(plain_calls.values()),
          f"the main path ran the plain version's pieces: {plain_calls}")
    check("parent" in captured, "no 512-entry step was captured")
    return {"launches": sum(launches.values()), "steps": steps,
            "dispatches": c["dispatches"],
            "fused_dispatches": c["fused_dispatches"],
            "coalesced_steps": c["coalesced_steps"],
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


def phase_profile(torch, weights, dev, threads: int = 1) -> None:
    """Where a loaded step's time goes: 256 concurrent searches through
    the service (``threads`` driver threads, pipeline 2) under
    torch.profiler (CPU and CUDA activity); prints the wall time, the
    device kernel time by name and the device busy share, per step and
    per device dispatch. Not part of the default run."""
    from torch.profiler import ProfilerActivity, profile

    from fishnet_tpu_torch.search.service import SearchService

    service = SearchService(weights=weights, batch_capacity=1024,
                            pipeline_depth=2, driver_threads=threads,
                            device=dev)
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
        counters = service.counters()
        steps, dispatches = counters["eval_steps"], counters["dispatches"]
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
    nodes = sum(r.nodes for r in results)
    log(f"  {threads} driver threads: {len(results)} searches, {nodes} "
        f"nodes, {steps} steps in {dispatches} dispatches in {wall:.3f} s "
        f"({wall / max(1, steps) * 1e3:.3f} ms per step, "
        f"{wall / max(1, dispatches) * 1e3:.3f} ms per dispatch); device "
        f"kernel time {device_us / 1e3:.3f} ms = "
        f"{device_us / 1e4 / wall:.2f}% busy")
    log(f"  device kernels per step: {per_step:.2f}, per dispatch "
        f"{per_step * steps / max(1, dispatches):.2f} ({len(kernels)} "
        f"distinct); copies and fills per dispatch: "
        f"{sum(r[2] for r in copies) / max(1, dispatches):.2f}")
    for key, us, count in rows[:14]:
        log(f"    {us / 1e3:10.3f} ms  {count:7d}x  {key[:90]}")


def phase_parity(weights, dev, **gpu_kw) -> dict:
    """20 positions, one at a time at fixed depth with the prefetch
    budget pinned: the GPU service (pipeline 1 and one driver thread
    unless ``gpu_kw`` says otherwise) and the native scalar evaluator
    must agree on (value, is_mate, move). Returns the GPU service's
    counters."""
    from fishnet_tpu_torch.search.service import SearchService

    walks = random_lines(20, seed=99)
    counters = {}

    async def run(backend, **kw):
        svc = SearchService(weights=weights, pool_slots=16, batch_capacity=64,
                            tt_bytes=256 << 20, backend=backend, device=dev,
                            **kw)
        svc.set_prefetch(8, adaptive=False)
        try:
            out = []
            for moves in walks:
                r = await svc.search(STARTPOS, moves, depth=4)
                line = [l for l in r.lines if l.multipv == 1][-1]
                out.append((line.value, line.is_mate, r.best_move, r.nodes))
            if backend == "torch":
                counters.update(svc.counters(),
                                coalescer=svc._coalescer is not None)
            return out
        finally:
            svc.close()

    gpu = asyncio.run(run("torch", **gpu_kw))
    scalar = asyncio.run(run("scalar"))
    bad = [(w, g, s) for w, g, s in zip(walks, gpu, scalar) if g[:3] != s[:3]]
    check(not bad, f"{len(bad)} of {len(walks)} positions diverged: {bad[:2]}")
    log(f"  {len(walks)} positions at depth 4: GPU service {gpu_kw or ''} "
        f"== scalar on (value, is_mate, best_move); nodes "
        f"{sum(g[3] for g in gpu)} (GPU) vs {sum(s[3] for s in scalar)} "
        f"(scalar); GPU dispatches {counters['dispatches']} of "
        f"{counters['eval_steps']} steps, coalescer {counters['coalescer']}")
    return counters


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
    log(f"  captured step {mix} ({'fused' if step['fused'] else 'solo'}): "
        f"packed kernel {times['packed']:.6f} / "
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


#: The coalesce phase's fused widths, and the pipeline groups its
#: captured burst runs (the widest fused dispatch takes every group).
FUSE_WIDTHS = (2, 4, 8)
CAPTURE_GROUPS = 8


@contextlib.contextmanager
def env_vars(**values):
    """Set environment variables (None: unset) for the block."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def capture_group_steps(weights, dev, rounds: int = 6, pool_slots: int = 256,
                        nodes: int = 1000):
    """One real step of each of CAPTURE_GROUPS pipeline groups, from a
    loaded burst (``pool_slots`` searches at ``nodes`` nodes, which
    fill every group's slots) on a service that
    dispatches per group (FISHNET_NO_COALESCE=1, one driver thread,
    microbatch 1024): each group's host wire at its ``rounds``-th
    dispatch (rows, offsets, buckets, parents), a seeded material column
    for the host-material wire, and copies of the group's anchor and
    PSQT tables as they stood just before that dispatch. Returns (steps
    by group, the rows of one group's table)."""
    import numpy as np

    from fishnet_tpu_torch.search.service import SearchService

    with env_vars(FISHNET_NO_COALESCE="1"):
        svc = SearchService(weights=weights, pool_slots=pool_slots,
                            batch_capacity=1024,
                            pipeline_depth=CAPTURE_GROUPS, device=dev)
    rng = np.random.default_rng(41)
    seen, steps = {}, {}
    dispatch = svc._dispatch_eval

    def recorder(group, n, rows):
        seen[group] = seen.get(group, 0) + 1
        if seen[group] == rounds:
            steps[group] = dict(
                n=n, rows=rows,
                packed=svc._packed_buf[group][:rows].copy(),
                offsets=svc._offset_buf[group][:n].copy(),
                buckets=svc._bucket_buf[group][:n].copy(),
                parent=svc._parent_buf[group][:n].copy(),
                material=rng.integers(-500, 500, n).astype(np.int32),
                tab=svc._anchor_tabs[group].clone(),
                ptab=svc._psqt_tabs[group].clone())
        return dispatch(group, n, rows)

    svc._dispatch_eval = recorder
    walks = random_lines(pool_slots, seed=13)

    async def burst():
        return await asyncio.gather(*[
            svc.search(STARTPOS, moves, nodes=nodes) for moves in walks])

    try:
        svc.warmup()
        asyncio.run(burst())
    finally:
        svc.close()
    check(len(steps) == CAPTURE_GROUPS,
          f"captured steps of {sorted(steps)}, not of every group")
    return steps, svc._anchor_rows


class FusedHarness:
    """A SearchService (CAPTURE_GROUPS groups, width pinned to all of
    them) whose group buffers and tables are loaded with captured steps,
    so its real solo and fused dispatch paths run on them; records the
    evaluator calls (the kernel's inputs)."""

    def __init__(self, weights, dev, psqt_path: Optional[str],
                 pool_slots: int = 256) -> None:
        from fishnet_tpu_torch.search.service import SearchService

        with env_vars(FISHNET_COALESCE_WIDTH=str(CAPTURE_GROUPS),
                      FISHNET_NO_COALESCE=None):
            self.svc = SearchService(
                weights=weights, pool_slots=pool_slots, batch_capacity=1024,
                pipeline_depth=CAPTURE_GROUPS, device=dev,
                psqt_path=psqt_path)
        self.svc.warmup()
        self.calls = []
        evaluate = self.svc._eval_fn

        def recorder(params, packed, buckets, parent, material, tab, n_rows,
                     ptab, *, offsets):
            self.calls.append(dict(packed=packed, offsets=offsets,
                                   parent=parent, tab=tab, ptab=ptab,
                                   material=material))
            return evaluate(params, packed, buckets, parent, material, tab,
                            n_rows, ptab, offsets=offsets)

        self.svc._eval_fn = recorder

    def load(self, steps, groups) -> None:
        svc = self.svc
        for g in groups:
            st = steps[g]
            n, rows = st["n"], st["rows"]
            svc._packed_buf[g][:rows] = st["packed"]
            svc._offset_buf[g][:n] = st["offsets"]
            svc._bucket_buf[g][:n] = st["buckets"]
            svc._parent_buf[g][:n] = st["parent"]
            if svc._material_buf is not None:
                svc._material_buf[g][:n] = st["material"]
            svc._anchor_tabs[g].copy_(st["tab"])
            svc._psqt_tabs[g].copy_(st["ptab"])

    def solo(self, steps, groups):
        """Each group's solo dispatch: (values by group, tables after)."""
        svc = self.svc
        self.load(steps, groups)
        self.calls.clear()
        values = {}
        for g in groups:
            handle, _ = svc._dispatch_eval(g, steps[g]["n"], steps[g]["rows"])
            values[g] = svc._resolve_eval(steps[g]["n"], handle)
        return values, (svc._anchor_all.clone(), svc._psqt_all.clone())

    def fused(self, torch, steps, groups):
        """One fused dispatch of ``groups``' steps, in that order: (the
        host values, the tickets, the tables before and after); checks
        that it launched the kernel once."""
        from fishnet_tpu_torch.ops import ft_gather
        from fishnet_tpu_torch.search.coalesce import _CoalesceTicket

        svc = self.svc
        self.load(steps, groups)
        before = (svc._anchor_all.cpu().clone(), svc._psqt_all.cpu().clone())
        self.calls.clear()
        launches = ft_gather.ft_accumulate_packed_cuda.launches
        tickets = [_CoalesceTicket(g, steps[g]["n"], steps[g]["rows"])
                   for g in groups]
        svc._dispatch_segmented(tickets)
        whole = tickets[0].values.materialize()
        torch.cuda.synchronize()
        check(ft_gather.ft_accumulate_packed_cuda.launches - launches == 1,
              "a fused dispatch did not launch the kernel exactly once")
        return whole, tickets, before, (svc._anchor_all.clone(),
                                        svc._psqt_all.clone())

    def close(self) -> None:
        self.svc.close()


def plain_segmented(torch, cpu_params, steps, groups, size, before,
                    host_material: bool):
    """The plain segmented version on the CPU (the JAX package's layout:
    each segment padded to 4 * size + 4 rows) on copies of the tables as
    they stood before the dispatch: (values, anchor tables, PSQT
    tables)."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec, torch_eval

    k_segs, tier = len(groups), 4 * size + 4
    packed = np.full((k_segs * tier, 2, 8), spec.NUM_FEATURES, np.uint16)
    buckets = np.zeros(k_segs * size, np.int32)
    parent = np.full(k_segs * size, -1, np.int32)
    material = np.zeros(k_segs * size, np.int32)
    for k, g in enumerate(groups):
        st = steps[g]
        packed[k * tier: k * tier + st["rows"]] = st["packed"]
        buckets[k * size: k * size + st["n"]] = st["buckets"]
        parent[k * size: k * size + st["n"]] = st["parent"]
        material[k * size: k * size + st["n"]] = st["material"]
    tab, ptab = before[0].clone(), before[1].clone()
    values, _, _ = torch_eval.evaluate_packed_anchored_segmented(
        cpu_params, torch.from_numpy(packed.view(np.int16)),
        torch.from_numpy(buckets), torch.from_numpy(parent),
        torch.from_numpy(material) if host_material else None, tab,
        torch.tensor([steps[g]["rows"] for g in groups]), ptab,
        groups=groups)
    return values.numpy(), tab, ptab


def with_duplicate(steps, groups):
    """``steps`` with one cross-segment duplicate planted: the first
    plain full of ``groups[0]``'s step appended, rows, bucket and
    material, as a new last entry of the next group's step that has room
    — a plain full with no consumer, not its segment's first entry, the
    case the byte-mode planner drops."""
    import numpy as np

    src = steps[groups[0]]
    fulls = np.flatnonzero(src["parent"] == -1)
    check(len(fulls) > 0, f"group {groups[0]}'s step has no plain full")
    i = int(fulls[0])
    off = int(src["offsets"][i])
    for g in groups[1:]:
        st = steps[g]
        if st["n"] < 128:  # the group's entry capacity at microbatch 1024
            break
    else:
        check(False, "no step has room for a duplicate")
    dup = dict(st)
    dup.update(
        n=st["n"] + 1, rows=st["rows"] + 4,
        packed=np.concatenate([st["packed"], src["packed"][off: off + 4]]),
        offsets=np.append(st["offsets"], st["rows"]).astype(np.int32),
        buckets=np.append(st["buckets"], src["buckets"][i]).astype(np.int32),
        parent=np.append(st["parent"], -1).astype(np.int32),
        material=np.append(st["material"], src["material"][i]).astype(
            np.int32))
    out = dict(steps)
    out[g] = dup
    return out


def time_fused(torch, params, harness, k_segs: int) -> dict:
    """The fused launch of the harness's last fused dispatch against its
    segments' K solo launches (the last ``solo`` call's), on copies of
    the tables, as the timing phase times the kernel; and its bound."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec
    from fishnet_tpu_torch.ops import ft_gather

    w, b, fp = params["ft_w"], params["ft_b"], params["ft_psqt"]
    fc = harness.fused_call
    tab, ptab = fc["tab"].clone(), fc["ptab"].clone()
    solo = [(c, c["tab"].clone(), c["ptab"].clone())
            for c in harness.solo_calls]
    check(len(solo) == k_segs, f"{len(solo)} solo launches for K={k_segs}")

    def fused_call():
        return ft_gather.ft_accumulate_packed_cuda(
            w, b, fc["packed"], fc["offsets"], fc["parent"], tab,
            ft_psqt=fp, psqt_tab=ptab)

    def solo_calls():
        for c, t, pt in solo:
            ft_gather.ft_accumulate_packed_cuda(
                w, b, c["packed"], c["offsets"], c["parent"], t,
                ft_psqt=fp, psqt_tab=pt)

    ptab_plain, pptab_plain = fc["tab"].clone(), fc["ptab"].clone()
    ms = graph_time_ms(torch, fused_call)
    solo_ms = graph_time_ms(torch, solo_calls)
    plain_ms = graph_time_ms(torch, lambda: ft_gather.ft_accumulate_packed_plain(
        w, b, fc["packed"], fc["offsets"], fc["parent"], ptab_plain,
        ft_psqt=fp, psqt_tab=pptab_plain))
    again = graph_time_ms(torch, fused_call)
    parent = fc["parent"].cpu().numpy()
    bound_ms, bound_by, nbytes, ops = packed_bound(
        fc["packed"].cpu().numpy().view(np.uint16),
        fc["offsets"].cpu().numpy(), parent, fc["tab"].shape[0], True,
        spec.L1)
    return {"k": k_segs, "entries": len(parent), "ms": ms,
            "repeat_ms": again, "solo_ms": solo_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
            "bound_ops": ops}


def gated_searches(weights, dev, coalesce: bool):
    """Eight searches of 3000 nodes on one service (4 groups, one driver
    thread, prefetch pinned) whose driver parks after its warm-up until
    all are submitted, so the schedule is a function of the submission
    sequence: with the coalescer (width pinned to 4) or without. Returns
    the analyses and the counters."""
    from fishnet_tpu_torch.search.service import SearchService

    class Gated(SearchService):
        def __init__(self, *args, **kwargs):
            self.gate = threading.Event()
            super().__init__(*args, **kwargs)

        def warmup(self):
            super().warmup()
            self.gate.wait()

    hatch = (dict(FISHNET_COALESCE_WIDTH="4", FISHNET_NO_COALESCE=None)
             if coalesce else dict(FISHNET_NO_COALESCE="1"))
    with env_vars(**hatch):
        svc = Gated(weights=weights, pool_slots=8, batch_capacity=256,
                    tt_bytes=8 << 20, pipeline_depth=4, driver_threads=1,
                    device=dev)
    walks = random_lines(8, seed=3)
    try:
        svc.set_prefetch(0, adaptive=False)

        async def go():
            tasks = [asyncio.ensure_future(svc.search(STARTPOS, m,
                                                      nodes=3000))
                     for m in walks]
            await asyncio.sleep(0.5)
            svc.gate.set()
            return await asyncio.gather(*tasks)

        results = asyncio.run(go())
        counters = svc.counters()
    finally:
        svc.gate.set()
        svc.close()
    analyses = [(r.best_move, r.depth, r.nodes,
                 [(l.multipv, l.depth, l.is_mate, l.value, l.pv)
                  for l in r.lines]) for r in results]
    return analyses, counters


def phase_coalesce(torch, weights, params, dev) -> dict:
    """The dispatch coalescer on the card, bit for bit.

    Kernel level: real steps of 8 pipeline groups from a loaded burst;
    for K in FUSE_WIDTHS, K of them (groups chosen out of order, so the
    flat table is addressed by group) go through the service's fused
    dispatch — one launch — and through K solo dispatches on the same
    tables: the values and every group's anchor and PSQT rows must be
    equal, and equal the plain segmented version on CPU copies; with
    PSQT on the card and on the host-material wire. A planted
    cross-segment duplicate must leave the wire (dedup on) and give the
    values and tables of the dispatch with dedup off. The fused launch
    is timed against its K solo launches.

    Service level, with the new defaults (one driver thread per core,
    pipeline 2, coalescer and async pipeline on): a load burst must
    fuse dispatches, launch the packed kernel once per device dispatch
    and the dense mode never, and leave the kernel's error word as it
    was; 20 positions at depth 4 one at a time must equal the native
    scalar search; and eight gated concurrent searches must give the
    same analyses coalesced (width 4, fused dispatches) as per group."""
    import numpy as np

    from fishnet_tpu_torch.configure import parse_and_configure
    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.search.service import SearchService

    cpu_params = {k: v.cpu() for k, v in params.items()}
    steps, a_rows = capture_group_steps(weights, dev)
    log("  captured steps (group: entries, rows): " + ", ".join(
        f"{g}: {st['n']}, {st['rows']}" for g, st in sorted(steps.items())))
    worst = 0
    timings = []
    for psqt_path in (None, "host-material"):
        harness = FusedHarness(weights, dev, psqt_path)
        check(harness.svc._anchor_rows == a_rows, "table rows differ")
        host_material = psqt_path == "host-material"
        try:
            for k_segs in FUSE_WIDTHS:
                groups = [(3 * k + 1) % CAPTURE_GROUPS for k in range(k_segs)]
                solo, solo_tabs = harness.solo(steps, groups)
                harness.solo_calls = list(harness.calls)
                whole, tickets, before, tabs = harness.fused(torch, steps,
                                                             groups)
                harness.fused_call = harness.calls[0]
                size = tickets[0].seg_size
                diffs = [max_diff([torch.from_numpy(
                    whole[tk.start: tk.start + tk.n])],
                    [torch.from_numpy(solo[tk.group])]) for tk in tickets]
                diffs.append(max_diff(tabs, solo_tabs))
                pv, ptab, pptab = plain_segmented(
                    torch, cpu_params, steps, groups, size, before,
                    host_material)
                diffs.append(max_diff([torch.from_numpy(pv[tk.start:
                                                           tk.start + tk.n])
                                       for tk in tickets],
                                      [torch.from_numpy(whole[tk.start:
                                                              tk.start + tk.n])
                                       for tk in tickets]))
                diffs.append(max_diff([ptab, pptab],
                                      [t.cpu() for t in tabs]))
                worst = max(worst, *diffs)
                check(max(diffs) == 0,
                      f"K={k_segs} {psqt_path or 'fused'}: fused != solo "
                      f"or plain: {diffs}")
                line = (f"  K={k_segs} groups {groups} "
                        f"({'host-material' if host_material else 'PSQT on the card'}): "
                        f"{sum(tk.n for tk in tickets)} entries, one launch "
                        f"== {k_segs} solo launches == plain on CPU "
                        "(values, every group's anchor and PSQT rows)")
                if not host_material:
                    t = time_fused(torch, params, harness, k_segs)
                    timings.append(t)
                    line += (f"; fused launch {t['ms']:.6f} / "
                             f"{t['repeat_ms']:.6f} ms, {k_segs} solo "
                             f"launches {t['solo_ms']:.6f} ms, plain "
                             f"{t['plain_ms']:.6f} ms, bound "
                             f"{t['bound_ms']:.6f} ms ({t['bound_by']}, "
                             f"{t['bound_bytes']} B)")
                log(line)
            # Dedup: a planted duplicate leaves the wire, nothing moves.
            groups = [(3 * k + 1) % CAPTURE_GROUPS for k in range(4)]
            dup_steps = with_duplicate(steps, groups)
            co = harness.svc._coalescer
            results = []
            for dedup in (True, False):
                harness.svc._dedup_fused = dedup
                before_dedup = co.deduped_evals
                whole, tickets, _, tabs = harness.fused(torch, dup_steps,
                                                        groups)
                results.append((np.concatenate([
                    whole[tk.start: tk.start + tk.n] for tk in tickets]),
                    tabs, co.deduped_evals - before_dedup))
            harness.svc._dedup_fused = True
            (v_on, t_on, n_on), (v_off, t_off, n_off) = results
            diff = max(max_diff([torch.from_numpy(v_on)],
                                [torch.from_numpy(v_off)]),
                       max_diff(t_on, t_off))
            worst = max(worst, diff)
            check(n_on >= 1 and n_off == 0,
                  f"dedup dropped {n_on} (on) / {n_off} (off) entries")
            check(diff == 0, f"dedup on != off by {diff}")
            log(f"  K=4 with a planted cross-segment duplicate: dedup "
                f"dropped {n_on} entries, values and tables == dedup off")
        finally:
            harness.close()

    # The service with the new defaults.
    threads = parse_and_configure(["run", "--no-conf"]).resolved_search_threads()
    service = SearchService(weights=weights, batch_capacity=1024,
                            pipeline_depth=2, driver_threads=threads,
                            device=dev)
    try:
        service.warmup()
        check(service._coalescer is not None and service.async_depth() == 2,
              "the default service built no coalescer or pipeline")
        errors0 = ft_gather.kernel_errors(dev)
        ft_gather.ft_accumulate_packed_cuda.launches = 0
        ft_gather.ft_accumulate_cuda.launches = 0
        c0 = service.counters()
        nps = load_burst(service)
        packed = ft_gather.ft_accumulate_packed_cuda.launches
        dense = ft_gather.ft_accumulate_cuda.launches
        c = {k: v - c0[k] for k, v in service.counters().items()}
        torch.cuda.synchronize()
        errors = ft_gather.kernel_errors(dev)
        probe, width = service.dispatch_probe, service.coalesce_width()
    finally:
        service.close()
    log(f"  defaults ({threads} driver threads x pipeline 2, probe {probe}, "
        f"width {width}): {nps:.0f} nodes/s, {c['eval_steps']} steps in "
        f"{c['dispatches']} dispatches ({c['fused_dispatches']} fused, mean "
        f"width {c['eval_steps'] / max(1, c['dispatches']):.3f}), "
        f"{c['fused_dedup']} evals deduped; ft_gather launches {packed} "
        f"(packed), {dense} (dense); error word {errors0} -> {errors}")
    check(c["fused_dispatches"] > 0, "the default service fused nothing")
    check(packed == c["dispatches"],
          f"{packed} packed launches for {c['dispatches']} dispatches")
    check(dense == 0, "the default service launched the dense mode")
    check(errors == errors0, f"the kernel's error word moved: {errors0} -> "
                             f"{errors}")
    parity = phase_parity(weights, dev, driver_threads=threads,
                          pipeline_depth=2)
    check(parity["coalescer"], "the parity service built no coalescer")
    fused_runs = [gated_searches(weights, dev, coalesce=True)
                  for _ in range(2)]
    plain_run = gated_searches(weights, dev, coalesce=False)
    check(all(r[0] == plain_run[0] for r in fused_runs),
          "gated searches: coalesced != per-group analyses")
    check(all(r[1]["fused_dispatches"] > 0 for r in fused_runs),
          "gated searches: no fused dispatch")
    log(f"  8 gated searches of 3000 nodes, twice coalesced (width 4: "
        f"{[r[1]['dispatches'] for r in fused_runs]} dispatches, "
        f"{[r[1]['fused_dispatches'] for r in fused_runs]} fused, of "
        f"{fused_runs[0][1]['eval_steps']} steps) == per group "
        f"({plain_run[1]['dispatches']} dispatches): the same analyses")
    return {"timings": timings, "worst": worst, "burst_nps": nps,
            "fused_dispatches": c["fused_dispatches"],
            "dispatches": c["dispatches"], "eval_steps": c["eval_steps"]}


def phase_sweep(weights, dev) -> None:
    """The burst at 1, 2, 4 and 7 driver threads (pipeline 2), with the
    coalescer and with FISHNET_NO_COALESCE=1, in turns; the mean
    coalesce width and the deduped evals; and the pipeline depth the
    JAX package's probe would pick here. A measurement, checked
    nothing beyond the burst's own checks. Not part of the default
    run."""
    from fishnet_tpu_torch.search.coalesce import suggest_pipeline_depth
    from fishnet_tpu_torch.search.service import SearchService

    depth, probe = suggest_pipeline_depth(weights, size=1024,
                                          return_probe=True, device=dev)
    log(f"  suggest_pipeline_depth at 1024: depth {depth}, {probe}")
    for threads in (1, 2, 4, 7):
        for coalesce in (True, False):
            with env_vars(FISHNET_NO_COALESCE=None if coalesce else "1"):
                svc = SearchService(weights=weights, batch_capacity=1024,
                                    pipeline_depth=2, driver_threads=threads,
                                    device=dev)
            try:
                svc.warmup()
                c0 = svc.counters()
                nps = load_burst(svc)
                c = {k: v - c0[k] for k, v in svc.counters().items()}
                probe, width = svc.dispatch_probe, svc.coalesce_width()
            finally:
                svc.close()
            busy = max(1, c["overlap_busy_us"])
            log(f"  sweep: {threads} threads, coalescer "
                f"{'on' if coalesce else 'off'}: {nps:.0f} nodes/s, mean "
                f"width {c['eval_steps'] / max(1, c['dispatches']):.3f}, "
                f"fused_dedup {c['fused_dedup']}, width {width}, probe "
                f"{probe}, overlap {c['overlap_dual_us'] / busy:.3f}")


def phase_fen() -> None:
    """ROADMAP C7, in this process (torch imported, the core loaded):
    the port's Board gives back the expected FEN of every FEN_CHECKS
    entry, and of a crazyhouse game replayed move by move."""
    from fishnet_tpu_torch.chess import Board
    from fishnet_tpu_torch.protocol.types import Variant

    for fen, variant, want in FEN_CHECKS:
        got = Board(fen, Variant.parse(variant)).fen()
        check(got == want, f"Board({fen!r}, {variant}).fen() = {got!r}, "
                           f"expected {want!r}")
    board = Board(STARTPOS, Variant.CRAZYHOUSE)
    for move in "e2e4 d7d5 e4d5 d8d5 b1c3 d5a5".split():
        board.push_uci(move)
    want = "rnb1kbnr/ppp1pppp/8/q7/8/2N5/PPPP1PPP/R1BQKBNR[Pp] w KQkq - 2 4"
    check(board.fen() == want, f"crazyhouse replay: {board.fen()!r}")
    log(f"  {len(FEN_CHECKS) + 1} FENs (castling, X-FEN letters, en "
        "passant, counters, pockets, promoted pieces, every variant) == "
        "expected, with torch imported")


def random_games(n: int, plies: int, seed: int):
    """``n`` games of exactly ``plies`` seeded random legal moves from
    the start position, as move lists; a walk that ends the game early
    is drawn again."""
    from fishnet_tpu_torch.chess import Board

    rnd = random.Random(seed)
    games = []
    while len(games) < n:
        board, moves = Board(), []
        while len(moves) < plies and board.outcome() == Board.ONGOING:
            move = rnd.choice(board.legal_moves())
            board.push_uci(move)
            moves.append(move)
        if len(moves) == plies and board.outcome() == Board.ONGOING:
            games.append(moves)
    return games


def add_run_jobs(lichess, games: int, moves: int, seed: int,
                 nodes: int = 3000):
    """The run phases' jobs: ``games`` analysis games of 40 plies at
    ``nodes`` nodes, each with one skipped ply, and ``moves`` best-move jobs
    at levels 1, 4 and 8 (the first with a clock). Returns (analysis
    ids, move ids)."""
    rnd = random.Random(seed)
    lines = random_games(games + moves, 40, seed)
    analysis = [lichess.add_analysis_job(moves=" ".join(line), nodes=nodes,
                                         skip_positions=[rnd.randrange(41)])
                for line in lines[:games]]
    move_ids = []
    for i, line in enumerate(lines[games:]):
        clock = {"wtime": 6000, "btime": 6000, "inc": 1} if i == 0 else None
        move_ids.append(lichess.add_move_job(
            moves=" ".join(line[:rnd.randrange(8, 30)]),
            level=(1, 4, 8)[i % 3], clock=clock))
    return analysis, move_ids


def run_report(lichess, analysis_ids, move_ids, what: str) -> dict:
    """Check the submissions of a run phase and print its numbers: every
    job submitted, every analysis well formed (41 parts, the skipped
    one skipped, the others a finite score with a legal-looking pv),
    every best move a legal move; games, positions, nodes, wall seconds
    from the first acquire to the last submission, positions/s,
    nodes/s, per game the median and maximum seconds from acquire to
    its final submission, per move job the seconds from acquire to
    move."""
    import statistics

    from fishnet_tpu_torch.chess import Board

    check(all(i in lichess.analyses for i in analysis_ids),
          f"{what}: {sum(i not in lichess.analyses for i in analysis_ids)} "
          "analyses not submitted")
    check(all(i in lichess.moves for i in move_ids),
          f"{what}: {sum(i not in lichess.moves for i in move_ids)} move "
          "jobs not submitted")
    positions = nodes = 0
    for work_id in analysis_ids:
        parts = lichess.analyses[work_id]["analysis"]
        check(len(parts) == 41, f"{what}: {work_id} has {len(parts)} parts")
        for part in parts:
            if part == {"skipped": True}:
                continue
            score = part["score"]
            check(set(score) <= {"cp", "mate"} and len(score) == 1
                  and isinstance(next(iter(score.values())), int),
                  f"{what}: {work_id} score {score}")
            check(part["nodes"] > 0 and part["depth"] >= 1
                  and len(part.get("pv", "")) >= 4,
                  f"{what}: {work_id} part {part}")
            positions += 1
            nodes += part["nodes"]
        check(sum(p == {"skipped": True} for p in parts) == 1,
              f"{what}: {work_id} skipped parts")
    for work_id in move_ids:
        body = lichess.bodies[work_id]
        board = Board(body["position"])
        for move in body["moves"].split():
            board.push_uci(move)
        best = lichess.moves[work_id]["move"]["bestmove"]
        check(best in board.legal_moves(),
              f"{what}: move job {work_id}: {best!r} is not a legal move")
    done = [lichess.completed_at[i] for i in analysis_ids] + \
        [lichess.move_done_at[i] for i in move_ids]
    first = min(lichess.handed_at[i] for i in analysis_ids + move_ids)
    wall = max(done) - first
    per_game = [lichess.completed_at[i] - lichess.handed_at[i]
                for i in analysis_ids]
    per_move = [lichess.move_done_at[i] - lichess.handed_at[i]
                for i in move_ids]
    out = {"games": len(analysis_ids), "positions": positions,
           "nodes": nodes, "wall_s": wall, "positions_per_s": positions / wall,
           "nodes_per_s": nodes / wall,
           "game_s_median": statistics.median(per_game),
           "game_s_max": max(per_game), "move_s": per_move}
    log(f"  {what}: {len(analysis_ids)} games, {positions} positions, "
        f"{nodes} nodes in {wall:.3f} s from the first acquire to the last "
        f"submission: {positions / wall:.1f} positions/s, "
        f"{nodes / wall:.0f} nodes/s")
    log(f"  {what}: acquire -> final submit per game: median "
        f"{out['game_s_median']:.3f} s, max {out['game_s_max']:.3f} s; "
        f"acquire -> move per move job: "
        f"{', '.join(f'{s:.3f}' for s in per_move)} s")
    return out


async def drive_client(client, lichess, ids, timeout: float) -> None:
    """Run ``client`` until every job of ``ids`` is submitted."""
    await client.start()
    try:
        deadline = time.monotonic() + timeout
        while not all(i in lichess.analyses or i in lichess.moves
                      for i in ids):
            check(time.monotonic() < deadline, "the client did not finish "
                                               f"in {timeout:.0f} s")
            await asyncio.sleep(0.05)
    finally:
        await client.stop()


def client_parity(weights, dev, games: int, plies: int, depth: int,
                  threads: int = 1) -> None:
    """The ``run`` path's parity check: ``games`` seeded games of
    ``plies`` plies, analysed at ``depth`` through the port's Client
    (one worker, prefetch pinned) on a SearchService over ``dev`` (with
    ``threads`` driver threads and two pipeline groups each: with more
    than one group the coalescer's ticket path) and on the native scalar
    service, must submit the same score, best move and depth per ply. The worker's engine budget is lifted for the
    check, and it fails on any engine timeout, requeued or abandoned
    position, or abort: a search run again over a TT it already filled
    may differ without any fault of the evaluator."""
    from fishnet_tpu_torch import client as client_mod
    from fishnet_tpu_torch.client import Client
    from fishnet_tpu_torch.engine.tpu_engine import TpuNnueEngineFactory
    from fishnet_tpu_torch.search.service import SearchService
    from fishnet_tpu_torch.utils.logger import Logger

    class Recorder(Logger):
        def __init__(self):
            super().__init__(verbose=0)
            self.complaints = []

        def debug(self, msg):
            if msg.startswith("Requeued"):
                self.complaints.append(msg)
            super().debug(msg)

        def warn(self, msg):
            self.complaints.append(msg)
            super().warn(msg)

        error = warn

    lines = random_games(games, plies, seed=29)
    submitted = []
    budget = client_mod.DEFAULT_BUDGET_SECONDS
    client_mod.DEFAULT_BUDGET_SECONDS = 3600.0
    try:
        for backend in ("torch", "scalar"):
            torch_kw = (dict(driver_threads=threads, pipeline_depth=2)
                        if backend == "torch" else {})
            svc = SearchService(weights=weights, pool_slots=16,
                                batch_capacity=64, tt_bytes=256 << 20,
                                backend=backend, device=dev, **torch_kw)
            svc.set_prefetch(8, adaptive=False)
            logger = Recorder()
            with FakeServer() as server:
                ids = [server.lichess.add_analysis_job(
                    moves=" ".join(g), nodes=10_000_000, depth=depth)
                    for g in lines]
                client = Client(endpoint=server.endpoint, key=VALID_KEY,
                                cores=1, workers=1,
                                engine_factory=TpuNnueEngineFactory(svc),
                                logger=logger, max_backoff=0.2)
                try:
                    asyncio.run(drive_client(client, server.lichess, ids, 600))
                finally:
                    svc.close()
            check(not logger.complaints and not server.lichess.aborted,
                  f"parity ({backend}): the run was not clean: "
                  f"{logger.complaints[:3]}, aborts {server.lichess.aborted}")
            submitted.append([server.lichess.analyses[i]["analysis"]
                              for i in ids])
    finally:
        client_mod.DEFAULT_BUDGET_SECONDS = budget
    ours, scalar = ([(p["score"], p.get("pv", "").split(" ")[0], p["depth"])
                     for game in side for p in game] for side in submitted)
    bad = [(i, g, s) for i, (g, s) in enumerate(zip(ours, scalar)) if g != s]
    n = games * (plies + 1)
    check(len(ours) == len(scalar) == n and not bad,
          f"{dev} vs scalar: {len(bad)} of {len(ours)} plies differ: {bad[:3]}")
    log(f"  parity: {games} games, {n} plies at depth {depth} through the "
        f"client, no timeout, requeue or abort: the service on {dev} == the "
        "native scalar service on (score, best move, depth) per ply")


def phase_run(weights, dev):
    """The main path through the entry points a user calls: the port's
    ``Client`` over the ``tpu-nnue`` engine factory that ``python -m
    fishnet_tpu_torch run`` builds (microbatch 1024, pipeline 2, one
    driver thread per core, the supervisor's ladder), against the stdlib
    fake lichess with 16 analysis games and 4 move jobs. The packed
    kernel's launch count is zeroed after the service's warm-up and read
    after the run: one launch per device dispatch; the rung must stay
    "fused". Then the parity sub-run (``client_parity``): 3 games at
    depth 4 on a GPU service (as many driver threads) and on the native
    scalar service must submit the same score, best move and depth per
    ply."""
    from fishnet_tpu_torch.__main__ import build_engine_factory
    from fishnet_tpu_torch.client import Client
    from fishnet_tpu_torch.configure import parse_and_configure
    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.protocol.types import EngineFlavor
    from fishnet_tpu_torch.utils.logger import Logger

    logger = Logger(verbose=0)
    opt = parse_and_configure(["run", "--no-conf", "--no-stats-file",
                               "--microbatch", "1024", "--pipeline", "2"])
    factory = build_engine_factory(opt, logger)
    supervisor = factory.supervisor
    with FakeServer() as server:
        lichess = server.lichess
        analysis_ids, move_ids = add_run_jobs(lichess, 16, 4, seed=23)
        client = Client(endpoint=server.endpoint, key=VALID_KEY,
                        cores=opt.resolved_cores(), engine_factory=factory,
                        logger=logger, max_backoff=1.0,
                        workers=opt.resolved_workers())

        async def run():
            # The user's path builds and warms the service before the
            # first acquire (run_client); so does this.
            await factory.create(EngineFlavor.OFFICIAL)
            ft_gather.ft_accumulate_packed_cuda.launches = 0
            ft_gather.ft_accumulate_cuda.launches = 0
            c0 = factory.service.counters()
            await drive_client(client, lichess, analysis_ids + move_ids, 600)
            return {k: v - c0[k]
                    for k, v in factory.service.counters().items()}

        try:
            c = asyncio.run(run())
            steps = c["eval_steps"]
            launches = ft_gather.ft_accumulate_packed_cuda.launches
            dense = ft_gather.ft_accumulate_cuda.launches
            service = factory.service
            rung = (supervisor.rung, service.psqt_path, supervisor.respawns,
                    service.is_alive())
        finally:
            factory.close()
    log(f"  {opt.resolved_workers()} workers, {opt.resolved_search_threads()} "
        f"driver threads; ft_gather launches {launches} (packed), {dense} "
        f"(dense) for {steps} dispatched steps in {c['dispatches']} device "
        f"dispatches ({c['fused_dispatches']} fused, {c['fused_dedup']} "
        f"evals deduped); rung {rung[0]} (service {rung[1]}), respawns "
        f"{rung[2]}")
    check(launches > 0, "the run path never launched the kernel")
    check(launches == c["dispatches"],
          f"{launches} packed launches for {c['dispatches']} dispatches")
    check(dense == 0, "the run path launched the dense mode")
    check(rung == ("fused", "fused", 0, True),
          f"the service left the fused rung or died: {rung}")
    report = run_report(lichess, analysis_ids, move_ids, "run")
    report["launches"] = launches
    report["fused_dispatches"] = c["fused_dispatches"]

    client_parity(weights, dev, games=3, plies=10, depth=4,
                  threads=opt.resolved_search_threads())
    return report


def teardown_counts(out: str):
    """(dispatched steps, device dispatches, packed launches, dense
    launches, rung) from the teardown log line of ``python -m
    fishnet_tpu_torch run -v``, counted from after the service's
    warm-up."""
    import re

    found = re.search(r"since warm-up: eval_steps (-?\d+), dispatches "
                      r"(-?\d+), ft_gather launches: packed (-?\d+), dense "
                      r"(-?\d+); rung (\S+)", out)
    check(found is not None, "the CLI's teardown log has no launch counts")
    return (*(int(found.group(i)) for i in (1, 2, 3, 4)), found.group(5))


def phase_cli() -> dict:
    """``python -m fishnet_tpu_torch run`` as a user starts it, as a
    subprocess against the stdlib fake lichess (8 games, 2 move jobs):
    once every job is submitted, SIGINT drains it; it must exit 0, and
    its teardown log (-v) must show, counted from after the service's
    warm-up, one packed kernel launch per device dispatch, at least
    one, and no dense launch."""
    import signal

    with FakeServer() as server:
        lichess = server.lichess
        analysis_ids, move_ids = add_run_jobs(lichess, 8, 2, seed=31)
        cmd = [sys.executable, "-m", "fishnet_tpu_torch", "run", "--no-conf",
               "--no-stats-file", "--endpoint", server.endpoint, "--key",
               VALID_KEY, "--max-backoff", "1", "-v"]
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            deadline = time.monotonic() + 600
            while not all(i in lichess.analyses or i in lichess.moves
                          for i in analysis_ids + move_ids):
                check(proc.poll() is None,
                      f"the CLI exited early ({proc.returncode})")
                check(time.monotonic() < deadline, "the CLI did not finish")
                time.sleep(0.1)
            proc.send_signal(signal.SIGINT)
            out, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    tail = out.splitlines()[-6:]
    for line in tail:
        log(f"  | {line[:300]}")
    check(proc.returncode == 0, f"the CLI exited {proc.returncode}")
    steps, dispatches, packed, dense, rung = teardown_counts(out)
    check(packed > 0, "the CLI never launched the kernel after its warm-up")
    check(packed == dispatches, f"the CLI: {packed} packed launches for "
                                f"{dispatches} dispatches")
    check(dense == 0, f"the CLI launched the dense mode {dense} times")
    check(rung == "fused", "the CLI's service left the fused rung")
    log(f"  the CLI's teardown log, since the warm-up: ft_gather launches "
        f"{packed} (packed) for {dispatches} device dispatches of {steps} "
        f"steps, {dense} (dense), rung fused")
    report = run_report(lichess, analysis_ids, move_ids, "cli")
    report["launches"] = packed
    return report


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
        load_core()  # g++ over cpp/src (chess/core.py)
        paths = kernels.result()
    log(f"  built {[p.name for p in paths]} in {time.perf_counter() - t0:.3f} s")
    for name, text in _build.build_logs.items():
        for line in text.strip().splitlines():
            log(f"  {name}: {line}")

    t0 = time.perf_counter()
    weights = NnueWeights.random(seed=0)
    params = params_from_weights(weights, dev)
    log(f"  random net (seed 0) on the card in {time.perf_counter() - t0:.3f} s")

    log("[fen] the native core's FEN formatter next to torch (ROADMAP C7)")
    phase_fen()

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
        entries[0]["fused_launches"] = serve["fused_dispatches"]
        entries[0]["step_fused"] = serve["step"]["fused"]
    if "coalesce" in phases:
        log("[coalesce] fused segmented dispatches: kernel level, then the "
            "service with the new defaults")
        fused = phase_coalesce(torch, weights, params, dev)
        for entry in entries:
            entry["fused"] = fused["timings"]
            entry["max_abs_err"] = max(entry["max_abs_err"], fused["worst"])
            entry["fused_launches_defaults"] = fused["fused_dispatches"]
    if "run" in phases:
        log("[run] the fishnet client over the tpu-nnue engine on the GPU, "
            "against a stdlib fake lichess")
        run = phase_run(weights, dev)
        for entry in entries:
            entry["launches_run"] = run["launches"]
    if "cli" in phases:
        log("[cli] python -m fishnet_tpu_torch run, drained by SIGINT")
        cli = phase_cli()
        for entry in entries:
            entry["launches_cli"] = cli["launches"]
    if "profile" in phases:
        log("[profile] a loaded burst under torch.profiler, at one driver "
            "thread and at the default")
        from fishnet_tpu_torch.configure import parse_and_configure

        for threads in sorted({1, parse_and_configure(
                ["run", "--no-conf"]).resolved_search_threads()}):
            phase_profile(torch, weights, dev, threads)
    if "anatomy" in phases and serve is not None:
        log("[anatomy] the kernel with one part of its work removed at a time")
        phase_anatomy(torch, params, dev, serve)
    if "ladder" in phases:
        log("[ladder] entry buckets from 64 vs from 8, one call")
        phase_ladder(weights, dev)
    if "sweep" in phases:
        log("[sweep] the burst by driver threads, coalescer on and off")
        phase_sweep(weights, dev)
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
