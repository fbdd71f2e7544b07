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
(one driver thread per core), runs the fishnet client — in process,
then ``python -m fishnet_tpu_torch run`` as a subprocess — against a
fake lichess server built on the standard library, and checks the
position-keyed eval cache and the bounds tier: the kernel's copy-source
mode against its plain version, the service with the cache off, cold
and warm, position dedup, a snapshot restart and the bounds tier, then
the burst and the ``run`` workload with the cache off, then on; runs
the split evaluator plane: an evaluator host process on the GPU serving
search frontend processes over shared-memory rings; runs the AZ/MCTS
family: the policy+value tower on the card, batched PUCT MCTS over the
shared AZ dispatch plane and ``run --engine az-mcts``; trains: teacher
labels through the card's search, the NNUE and AZ trainers, self-play
over the shared AZ plane and over an evaluator host, checkpoints; and
runs the serving mesh: the kernel's partials mode, two launching
threads on one card, the service and the AZ plane on two logical shards
of the card, the per-shard ladder and drain, the legacy sharded
evaluator; and drives the fault plane: the supervisor's ladder forced by
injected device-step crashes, the client under a fault plan with the
exactly-once batch ledger on, a shard-local device fault on the mesh, a
``run`` process drained by SIGTERM, and ``rpc.detach`` on the split
plane; and runs the multi-tenant front end: two tenants against the
scalar search, the soak harness, four tenants saturating the server
under admission control.

It prints, in order: the card (``nvidia-smi`` name and power limit,
torch and CUDA versions), the builds, the FEN check, the parity checks,
the UCI answers with the kernel's launch count, the scalar parity, the
kernel's times, the coalescer's checks and the fused launch's times,
the client runs' throughput and latencies, the cache phase's checks and
numbers, the split phase's checks and numbers, the az phase's checks
and numbers (and one JSON object ``{"az": {...}}``), the train phase's
(and ``{"train": {...}}``), the mesh phase's (and ``{"mesh": {...}}``),
the trainshard, metrics, spans, faults and overload phases' (and their
objects), then
on the last three lines the card again, one JSON object
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
without the last line. It refuses to run without a GPU, and outside a
checkout (it needs the package beside it).

``--phases`` (comma-separated: kernel, serve, parity, timing, coalesce,
run, cli, cache, split, az, train, mesh, trainshard, metrics, spans,
faults, overload; default all seventeen) limits a run to some phases
while iterating on one of them; each phase starts from a cold eval cache.
``split`` runs the split evaluator plane: a host process on the card
(``python -m fishnet_tpu_torch.rpc.host``'s main) serving frontend
processes over shared-memory rings, after a two-process ring ping in
its link directory; frontend analyses == the monolith's, one dense
launch per host dispatch, no CUDA context in a frontend, the kernel ==
its plain version on the largest fused host batches (timed); then the
burst on the monolith with the cache on and off and on the split plane
with 3 frontends, in the order A, B, C.
``az`` runs the AZ family at full width (the default AzConfig, 64 x 6,
value hidden 128) and the CLI's microbatch of 1024: the forward on the
card against the port's CPU forward; each bucket of the plane's ladder
against the capacity's rows (a prefix and a permutation), bit for bit,
and a repeat against the first (shapes below the ladder's floor
reported), with each bucket's forward time, kernels and bound; 32
searches x 200 visits with the plane == the private evaluator on the
default and each forced rung, a warm replay == cold with pre-wire hits,
speculation off == on, and the same roots split between two pools on
one plane, fusing their lanes, == the private evaluator on each forced
rung; a 256-search x 100-visit burst with the cache off, then on (A, B,
the same trees); and the ``run`` path with ``--engine az-mcts`` (4 games, a move
job, a variant game on the scalar tier). The AZ path reaches no
hand kernel: the tower is PyTorch's convolutions and matmuls, as the
JAX package leaves it to XLA.
``train`` runs training at full width (last): 512 seeded
playout positions labelled at 400 nodes through a gated SearchService on
the card (one packed launch per dispatch) == the CPU plain service's
batch bit for bit (computed in a child process beside the rest); the
NNUE trainer at full spec (``NetConfig()``) and the AZ trainer at the
default AzConfig, each with step 1 held against the CPU's from the same
params, 20 steps with the loss falling, the step timed at B = 16384 and
at 1024 rows with peak memory; the exported NNUE net served by the kernel
bit for bit against its plain version (timed, with its bound and
``embedding_bag``) and tracking the float forward; the exported AZ
``.npz`` reloading to the same net; 16 self-play games over the shared
plane; two frontend processes self-playing over ``RemoteAzPlane``s
served by one host process (``--az-seed``) == the in-process plane,
fused on the host, no frontend CUDA context; checkpoint round trips and
resume at 2 == uninterrupted at 4, on the CPU and on the card.
``mesh`` runs the serving mesh at full width (last), on this host's
one card as two logical shards: the kernel's partials mode (``sparse=``)
== its plain version (timed, with its bound and embedding_bag), two
threads launching 200 times on one card == plain; 12 gated positions at
3000 nodes (one driver thread, 32 slots, microbatch 1024: all at once)
through ``mesh_devices="auto"`` and
FISHNET_NO_MESH=1 over [cuda:0, cuda:0] (one shard each on one card)
and through two logical shards under FISHNET_SHARD_PLACEMENT rr and lb,
all == the no-mesh service, both shards dispatching; shard 1 stepped
down to host-material and drained mid-search (shard 0's rung unmoved,
migrated table blocks equal, the first dispatch after a move == plain
on CPU copies, analyses unchanged); 2 driver threads x pipeline 2 on two
shards (checks that do not depend on timing); the legacy
``ShardedEvaluator`` over two shards == single-device evaluate_packed;
the AZ plane over two shards == one shard; and the burst, one shard
(A) and two (B), A, B at 150 nodes (numbers only). Launches on
``cuda:N`` with N > 0 need a host with more cards.
``trainshard`` runs the sharded trainers on logical shards of the card
(after ``train``, whose labelled positions it serves the export on; alone,
on 512 seeded positions): NNUE at full spec, B = 16384, 3 steps on 2x1,
1x2 and 2x2 meshes against the single-device steps (every step held to
the train phase's step-1 gate; the single run on the batch's rows
permuted beside them), timed; a 1x2 export of carried parameters ==
the single-device export byte for byte; the 1x2 run's export on the
packed kernel == plain; AZ at the default AzConfig, 1024 rows, one step on
1x2 and 2x1 held to the AZ step-1 gate, timed; a 1x2 checkpoint resumed
in a 1x2 trainer bit for bit and in a single-device one within the gate.
``metrics`` runs the coalesce phase's service under the ``/metrics``
exporter: the burst without an exporter (A) and scraped every second
(B), A, B (numbers only; each leg a fresh service and cache), B's
scrapes all valid exposition 0.0.4 and, after it, the
service's families == ``counters()`` == the packed launches; after
``close()`` the scrape answers without the service's families; a
two-logical-shard service's ``fishnet_shard_*`` == ``shard_report()``.
``start_exporter`` turns span recording on, so B measures scrape plus
spans, and its burst's ``/spans`` passes ``span_checks``; the flag goes
off when each exporter closes. ``spans`` runs the faults ladder's 8
gated positions at 1000 nodes (width pinned to 4) with spans and the
cost plane off, then on: the analyses equal bit for bit, packed launches
== dispatches, and the spans hold no orphan, one ``pack`` root a step
trace, every ``dispatch_issue`` paired with its ``dispatch_wait`` by
``seq``, one ``dispatch_issue`` per packed launch and ``width - 1``
links on every ``coalesce`` span; the port's ``critical_path`` finds no
orphan and covers at least 95% of the step traces' wall; the cost
ledger holds one record a stepped microbatch, its tenants summing to
its wall within 2%. Beside it ``FISHNET_PROFILE=1 python -m
fishnet_tpu_torch run --metrics-port 0 --spans-dir D`` on 2 games x 20
plies at RUN_NODES and 1 move job: each batch's complete tree on
``/spans``; ``/profile`` with the driver, pack and decode roles and a
non-empty collapsed text, ``/trace`` valid, the stage histogram and the
tenants' device ms (== the measured total within 2%) on ``/metrics``;
a SIGUSR2 dump and, after SIGTERM, the ``drain`` span and the drain
dump (its log in ``chiprun_out/spans/``).
``faults`` drives every fault site of the port's path on the
card: 8 gated positions at 1000 nodes through the supervised factory,
crashed twice by ``service.device_step:nth=1:crash`` (the CLI's
``degrade_after``), retried one rung down (fused -> host-material) ==
the unfaulted searches, one packed launch per dispatch on every rung,
the error word unmoved; the ``run`` client (4 games at RUN_NODES, 2
move jobs) under a plan hitting ``net.acquire``, ``net.submit``,
``engine.spawn`` and ``queue.schedule`` with the batch ledger on: the
ledger clean, each batch submitted once on the server or (the one whose
schedule failed) invalid, ``fishnet_faults_injected_total`` on
``/metrics`` == what the plan's rules and call counts say; two logical
shards under ``service.device_step:nth=2:error``: one shard steps down,
the analyses == the unfaulted mesh run's, the ledger clean; ``python -m
fishnet_tpu_torch run --drain-deadline 10s`` SIGTERM'd mid-run:
readiness 503 with ``draining: true``, liveness 200,
``fishnet_drain_state`` 1, exit 0, no job held or submitted twice on the
server; an evaluator host under ``rpc.detach:every=40:error`` and one
frontend: resubmits, analyses == the monolith's. Its drain and host
logs land in ``chiprun_out/faults/`` and ``chiprun_out/split/``.
``overload`` (last) runs the multi-tenant front end at the CLI's
defaults: ``client_parity`` at two tenants and one worker, 2 games x 20
plies at 1500 nodes queued one at a time, == the native scalar search,
with ``python -m fishnet_tpu_torch.resilience.soak`` on the card as a
subprocess beside it (exit 0, phase B one rung down the card's ladder,
the ledger clean before and after phase C, the four families scraped;
its output in ``chiprun_out/overload/``); then 4 tenants for 30 s
against the fake lichess kept at 32 unacquired jobs (every 4th a move
job, the rest 40-ply games at 1500 nodes) under
``ShedPolicy(high_watermark=256)`` with the ledger and an exporter on,
then a hard stop (``saturate``, ``overload_gates``): something shed and
admitted, the throughput lane within 256 + 4 x 41, the ledger clean, no
job held or submitted twice, every move job answered unless the stop
cut it, ``/healthz`` 503 with ``shedding: true`` while shedding, one
packed launch per dispatch and the error word unmoved; it prints the
served counts' max/min ratio (not gated at this traffic: the JAX front
end's own spreads past 2.0 over 30 s), the move and first-report
latencies, the sheds, activations and nodes/s (``launches_overload`` in
the kernels line).
``coalesce`` holds the fused segmented dispatch of K in {2, 4, 8} real
group steps against K solo dispatches and the plain segmented version,
times the fused launch, and runs the service with the new defaults (one
driver thread per core, coalescer and async pipeline on). Four extra
phases run only on request: ``profile`` traces a loaded burst with
torch.profiler, ``anatomy`` (after ``serve``) times the kernel with one
part of its work removed at a time, ``ladder`` times the UCI session and
the burst with the entry-bucket ladder starting at 64 and at 8, and
``sweep`` times the burst at 1, 2, 4 and 7 driver threads with and
without the coalescer.

The module imports only the standard library, so its fake lichess
(``FakeLichess``, ``FakeServer``) also serves the CPU tests.
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import contextlib
import ctypes
import faulthandler
import itertools
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
PHASES = ("kernel", "serve", "parity", "timing", "coalesce", "run", "cli",
          "cache", "split", "az", "train", "mesh", "trainshard", "metrics",
          "spans", "faults", "overload")
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


#: The run's start, for the seconds each logged line carries.
T_START = time.perf_counter()


def log(line: str) -> None:
    """Print ``line`` with the seconds since the run began before it, so
    a run's output shows where its time went inside each phase."""
    print(f"[{time.perf_counter() - T_START:7.1f}] {line}", flush=True)


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
    is answered (a long poll), outside the lock. ``submissions`` counts
    the completing submissions of each job (a final analysis or a move),
    the server's half of the exactly-once check (``audit``).

    The saturation generator of ``tests/fake_server.py``: with
    ``auto_refill`` > 0 every acquire first tops the queue back up to
    that many unacquired jobs (every ``refill_move_every``-th job
    synthesized a best-move job, the rest analysis jobs, at most
    ``refill_limit`` in all); ``refill_analysis(n)``, when set, gives
    the ``add_analysis_job`` arguments of the n-th synthesized job (the
    defaults otherwise). Work ids are ``work_id_prefix`` and a counter;
    ``first_report_at`` holds when each job's first analysis report
    (progress or final) arrived."""

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
        self.first_report_at = {}
        self.bodies = {}  # work id -> the job as added, kept after it is done
        self.submissions = {}  # work id -> completing submissions
        self.auto_refill = 0
        self.refill_move_every = 0
        self.refill_limit = None
        self.refill_count = 0
        self.refill_analysis = None
        self.work_id_prefix = "wk"
        self._ids = itertools.count()

    def add_analysis_job(self, moves: str = "e2e4 e7e5", position: str = STARTPOS,
                         variant: str = "standard", skip_positions=None,
                         nodes: int = 5000, multipv=None, depth=None,
                         game_id: str = "", user_queue: bool = False) -> str:
        body = self._analysis_body(moves, position, variant, skip_positions,
                                   nodes, multipv, depth, game_id)
        self._add(body, user_queue)
        return body["work"]["id"]

    def _analysis_body(self, moves: str = "e2e4 e7e5", position: str = STARTPOS,
                       variant: str = "standard", skip_positions=None,
                       nodes: int = 5000, multipv=None, depth=None,
                       game_id: str = "") -> dict:
        work = {"type": "analysis", "id": self._next_id(),
                "nodes": {"sf15": nodes, "sf14": nodes, "classical": nodes * 2},
                "timeout": 7000}
        if multipv is not None:
            work["multipv"] = multipv
        if depth is not None:
            work["depth"] = depth
        return {"work": work, "game_id": game_id, "position": position,
                "variant": variant, "moves": moves,
                "skipPositions": skip_positions or []}

    def add_move_job(self, moves: str = "", position: str = STARTPOS,
                     level: int = 5, clock=None, variant: str = "standard") -> str:
        body = self._move_body(moves, position, level, clock, variant)
        self._add(body, False)
        return body["work"]["id"]

    def _move_body(self, moves: str = "", position: str = STARTPOS,
                   level: int = 5, clock=None, variant: str = "standard") -> dict:
        work = {"type": "move", "id": self._next_id(), "level": level}
        if clock:
            work["clock"] = clock
        return {"work": work, "game_id": "", "position": position,
                "variant": variant, "moves": moves}

    def _next_id(self) -> str:
        return f"{self.work_id_prefix}{next(self._ids):06d}"

    def _add(self, body, user_queue: bool) -> None:
        with self.lock:
            self._append(body, user_queue)

    def _append(self, body, user_queue: bool) -> None:
        """Queue a job (the caller holds the lock)."""
        self.bodies[body["work"]["id"]] = body
        self.jobs.append({"body": body, "user_queue": user_queue,
                          "acquired": False})

    def _refill(self) -> None:
        """Top the queue back up to ``auto_refill`` unacquired jobs (the
        caller holds the lock)."""
        if self.auto_refill <= 0:
            return
        pending = sum(1 for j in self.jobs if not j["acquired"])
        while pending < self.auto_refill:
            if (self.refill_limit is not None
                    and self.refill_count >= self.refill_limit):
                return
            self.refill_count += 1
            if (self.refill_move_every > 0
                    and self.refill_count % self.refill_move_every == 0):
                body = self._move_body()
            else:
                kw = (self.refill_analysis(self.refill_count)
                      if self.refill_analysis is not None else {})
                body = self._analysis_body(**kw)
            self._append(body, False)
            pending += 1

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
                self._refill()
                return self._hand_out(slow=query.get("slow") == ["true"])
            if not authed:
                return 401, None
            if route == "analysis":
                self.first_report_at.setdefault(arg, time.monotonic())
                analysis = (body or {}).get("analysis") or []
                if analysis and analysis[0] is None:
                    self.progress_reports.setdefault(arg, []).append(body)
                else:
                    self.analyses[arg] = body
                    self.submissions[arg] = self.submissions.get(arg, 0) + 1
                    self.completed_at.setdefault(arg, time.monotonic())
                    self._done(arg)
                return 204, None
            if route == "move":
                self.moves[arg] = body
                self.submissions[arg] = self.submissions.get(arg, 0) + 1
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

    def audit(self) -> dict:
        """The server's exactly-once view of every job it handed out:
        completed (by a final analysis or a move), returned by an abort,
        or still held — taken and never given back, which once the
        client is gone means lost. ``duplicated`` lists the jobs
        completed more than once."""
        with self.lock:
            held = sorted(j["body"]["work"]["id"] for j in self.jobs
                          if j["acquired"])
            handed = sorted(self.handed_at)
            return {"handed": len(handed),
                    "completed": sum(1 for i in handed if i in self.submissions),
                    "aborted": len(set(self.aborted)),
                    "held": held,
                    "duplicated": sorted(i for i, n in self.submissions.items()
                                         if n > 1)}


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


def load_burst(service, out: Optional[dict] = None,
               nodes: int = 3000) -> float:
    """256 concurrent ``go nodes 3000`` searches through the service (the
    cache and split phases' at fewer nodes); returns nodes per second
    (``out`` receives the searches, nodes, seconds and counter deltas)."""
    walks = random_lines(256, seed=11)
    c0 = service.counters()

    async def burst():
        return await asyncio.gather(*[
            service.search(STARTPOS, moves, nodes=nodes) for moves in walks
        ])

    t0 = time.perf_counter()
    results = asyncio.run(burst())
    t_burst = time.perf_counter() - t0
    check(all(r.best_move for r in results), "burst: a search failed")
    nodes = sum(r.nodes for r in results)
    c = {k: v - c0[k] for k, v in service.counters().items()}
    if out is not None:
        out.update(searches=len(results), nodes=nodes, seconds=t_burst,
                   counters=c)
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

    fresh_cache()
    service = SearchService(weights=weights, batch_capacity=1024,
                            pipeline_depth=2, device=dev)
    captured = {}
    evaluate = service._eval_fn
    calls = [0]

    def recorder(params, packed, buckets, parent, material, tab, n_rows,
                 ptab, *, offsets, copy_src=None, parent_host=None):
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
                        n_rows, ptab, offsets=offsets, copy_src=copy_src,
                        parent_host=parent_host)

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
        fresh_cache()
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

    fresh_cache()
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


def phase_parity(weights, dev, positions: int = 20, **gpu_kw) -> dict:
    """``positions`` seeded positions (the first of the same 20), one at
    a time at fixed depth with the prefetch
    budget pinned: the GPU service (pipeline 1 and one driver thread
    unless ``gpu_kw`` says otherwise) and the native scalar evaluator
    must agree on (value, is_mate, move). The GPU service runs with the
    eval cache and without the bounds tier (FISHNET_NO_BOUNDS=1): the
    scalar backend has no reuse plane, and seeded bound records change
    what a search finds. Returns the GPU service's counters."""
    from fishnet_tpu_torch.search.service import SearchService

    walks = random_lines(20, seed=99)[:positions]
    counters = {}

    async def run(backend, **kw):
        fresh_cache()
        with env_vars(FISHNET_NO_BOUNDS="1"):
            svc = SearchService(weights=weights, pool_slots=16,
                                batch_capacity=64, tt_bytes=256 << 20,
                                backend=backend, device=dev, **kw)
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


def fresh_cache() -> None:
    """Start from a cold process eval cache and bounds tier: the phases
    before ``cache`` search the same seeded walks more than once in one
    process, and each measures its own workload from nothing, as before
    the cache was ported."""
    from fishnet_tpu_torch.search import eval_cache

    eval_cache.reset_cache()


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

    fresh_cache()
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
                     ptab, *, offsets, copy_src=None, parent_host=None):
            call = dict(packed=packed, offsets=offsets, parent=parent,
                        tab=tab, ptab=ptab, material=material,
                        buckets=buckets, copy_src=None if copy_src is None
                        else copy_src.clone())
            self.calls.append(call)
            out = evaluate(params, packed, buckets, parent, material, tab,
                           n_rows, ptab, offsets=offsets, copy_src=copy_src,
                           parent_host=parent_host)
            call["values"] = out[0].clone()
            return out

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

    def fused(self, torch, steps, groups, probes=None):
        """One fused dispatch of ``groups``' steps, in that order: (the
        host values, the tickets, the tables before and after); checks
        that it launched the kernel once. ``probes`` (per group: the
        entries' position hashes, cache-hit mask and cached values) puts
        the dispatch in position-keyed mode."""
        from fishnet_tpu_torch.ops import ft_gather
        from fishnet_tpu_torch.search.coalesce import _CoalesceTicket

        svc = self.svc
        self.load(steps, groups)
        before = (svc._anchor_all.cpu().clone(), svc._psqt_all.cpu().clone())
        self.calls.clear()
        launches = ft_gather.ft_accumulate_packed_cuda.launches
        probes = probes or {}
        tickets = [_CoalesceTicket(g, steps[g]["n"], steps[g]["rows"],
                                   **dict(zip(("hashes", "cache_mask",
                                               "cache_vals"),
                                              probes.get(g, ()))))
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


def gated_run(weights, dev, walks, nodes: int = 3000, fresh: bool = True,
              hook=None, mesh_devices=None, pool_slots: int = 8,
              batch_capacity: int = 256, plan: Optional[str] = None,
              ledger=None, **env):
    """``walks`` (move lists from the start position) searched at
    ``nodes`` nodes on one service (``pool_slots`` slots, 8 by default,
    in 4 groups, one driver thread, ``batch_capacity`` entries, prefetch
    pinned) whose driver parks after its warm-up until
    every search is submitted, so the schedule is a function of the
    submission sequence. ``env`` is set while the service is built (the
    hatches are read there), ``fresh`` starts from a cold eval cache,
    ``hook(service)`` runs before the searches, ``mesh_devices`` is the
    service's serving mesh, ``plan`` a fault plan installed from the
    gate's opening to the last answer, and ``ledger`` a batch ledger
    each search is acquired in and submitted to. On the card the packed
    kernel must launch once per device dispatch and the dense mode
    never, and the kernel's error word must not move. Returns the
    analyses and the counters, with the copy-source launches (and with a
    mesh the shard report, under "shards")."""
    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.search.service import SearchService

    class Gated(SearchService):
        def __init__(self, *args, **kwargs):
            self.gate = threading.Event()
            super().__init__(*args, **kwargs)

        def warmup(self):
            super().warmup()
            self.gate.wait()

    if fresh:
        fresh_cache()
    with env_vars(**env):
        svc = Gated(weights=weights, pool_slots=pool_slots,
                    batch_capacity=batch_capacity, tt_bytes=8 << 20,
                    pipeline_depth=4, driver_threads=1, device=dev,
                    mesh_devices=mesh_devices)
    gpu = svc.device.type == "cuda"
    launches = ft_gather.ft_accumulate_packed_cuda
    try:
        SearchService.warmup(svc)  # the warm-up's launch, before the count
        if hook is not None:
            hook(svc)
        svc.set_prefetch(0, adaptive=False)
        errors0 = ft_gather.kernel_errors(dev) if gpu else 0
        before = (launches.launches, launches.copy_launches,
                  ft_gather.ft_accumulate_cuda.launches)

        results = asyncio.run(open_gate(svc, walks, nodes, plan=plan,
                                        ledger=ledger))
        counters = svc.counters()
        if mesh_devices is not None:
            counters["shards"] = svc.shard_report()
    finally:
        svc.gate.set()
        svc.close()
    packed, copies, dense = (launches.launches - before[0],
                             launches.copy_launches - before[1],
                             ft_gather.ft_accumulate_cuda.launches - before[2])
    counters["copy_launches"] = copies
    if gpu:
        errors = ft_gather.kernel_errors(dev)
        check(packed == counters["dispatches"],
              f"gated run: {packed} packed launches for "
              f"{counters['dispatches']} dispatches")
        check(dense == 0, "gated run: the dense mode launched")
        check(errors == errors0,
              f"gated run: the error word moved {errors0} -> {errors}")
    analyses = [(r.best_move, r.depth, r.nodes,
                 [(l.multipv, l.depth, l.is_mate, l.value, l.pv)
                  for l in r.lines]) for r in results]
    return analyses, counters


async def open_gate(svc, walks, nodes: int, plan: Optional[str] = None,
                    ledger=None, return_exceptions: bool = False) -> list:
    """The gated loop: ``walks`` submitted to ``svc`` (parked on
    ``svc.gate``), then ``plan`` installed, the gate opened and the
    answers gathered (with ``return_exceptions``, failed searches as
    their exceptions); the plan is cleared after the last answer. With a
    ``ledger``, each search is acquired in it before it is submitted and
    recorded submitted after its answer: the harness's own bookkeeping,
    no ledger call of the port lies on this path."""
    from fishnet_tpu_torch.resilience import faults

    async def one(i, m):
        if ledger is not None:
            ledger.record_acquired(f"gated-{i}")
        r = await svc.search(STARTPOS, m, nodes=nodes)
        if ledger is not None:
            ledger.record_submitted(f"gated-{i}")
        return r

    tasks = [asyncio.ensure_future(one(i, m)) for i, m in enumerate(walks)]
    await asyncio.sleep(0.5)
    if plan is not None:
        faults.install(plan)
    svc.gate.set()
    try:
        return await asyncio.gather(*tasks,
                                    return_exceptions=return_exceptions)
    finally:
        faults.clear()


def gated_searches(weights, dev, coalesce: bool):
    """Eight searches of 3000 nodes through ``gated_run``: with the
    coalescer (width pinned to 4) or without. Returns the analyses and
    the counters."""
    hatch = (dict(FISHNET_COALESCE_WIDTH="4", FISHNET_NO_COALESCE=None)
             if coalesce else dict(FISHNET_NO_COALESCE="1"))
    return gated_run(weights, dev, random_lines(8, seed=3), **hatch)


def gated_service(weights, dev, **kwargs):
    """A SearchService on ``dev`` with one driver thread that parks after
    its warm-up until ``service.gate`` is set, its prefetch pinned to 0
    (``kwargs``: the rest of its settings). Searched through
    ``gated_labels``, its schedule is a function of the submission
    sequence, so two such services (the card's and the CPU's) label the
    same positions with the same bits."""
    from fishnet_tpu_torch.search.service import SearchService

    class Gated(SearchService):
        def __init__(self, *args, **kw):
            self.gate = threading.Event()
            super().__init__(*args, **kw)

        def warmup(self):
            super().warmup()
            self.gate.wait()

    svc = Gated(weights=weights, device=dev, driver_threads=1, **kwargs)
    svc.set_prefetch(0, adaptive=False)
    return svc


def gated_labels(service, positions, nodes: int) -> dict:
    """``train.data.label_positions(service, positions, nodes)`` on a
    ``gated_service``: the gate opens once every search is queued."""
    from fishnet_tpu_torch.train.data import label_positions

    async def go():
        task = asyncio.ensure_future(label_positions(service, positions, nodes))
        deadline = time.monotonic() + 120
        while len(service._submissions[0]) < len(positions):
            check(time.monotonic() < deadline and not task.done(),
                  "labels: the searches were not all queued")
            await asyncio.sleep(0.005)
        service.gate.set()
        return await task

    try:
        return asyncio.run(go())
    finally:
        service.gate.set()


#: The coalesce phase's burst at the defaults: 1500 nodes a search, cut
#: from 3000 so the default run keeps its time on a slow host.
COALESCE_BURST_NODES = 1500
#: The coalesce phase's scalar parity at the defaults: the first 8 of the
#: parity phase's 20 positions. One search at a time on 7 driver threads
#: dispatches at ~5 ms a step on the card's host (120 s for 20); the
#: ``run`` phase's client parity holds the same service to the scalar
#: search too.
COALESCE_PARITY_POSITIONS = 8


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
    was; COALESCE_PARITY_POSITIONS positions at depth 4 one at a time
    must equal the native scalar search; and eight gated concurrent searches must give the
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
    fresh_cache()
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
        nps = load_burst(service, nodes=COALESCE_BURST_NODES)
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
    parity = phase_parity(weights, dev, COALESCE_PARITY_POSITIONS,
                          driver_threads=threads,
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
            "dispatches": c["dispatches"], "eval_steps": c["eval_steps"],
            "steps": steps}


def plant_positions(steps, groups):
    """Position probes for a fused dispatch of ``groups``' captured
    steps that make the position-keyed planner drop one entry of each
    kind: every entry gets a hash of its own, except that a plain full,
    an in-batch delta, a persistent full and a persistent delta (never
    an entry an in-batch delta reads, never a segment's first) take the
    hash of a plain full, an in-batch delta or a persistent anchor code
    earlier in the dispatch; and one more plain full is a cache hit.
    Returns (probes by group: hashes, hit mask, cached values; [(drop
    group, index, source group, index)]; (fill group, index, value))."""
    import numpy as np

    flat = []  # (kinds of the entry, group, index) in wire order
    probes = {}
    for k, g in enumerate(groups):
        p = steps[g]["parent"].astype(np.int64)
        n = len(p)
        used = np.zeros(n, bool)
        used[p[p >= 0] >> 1] = True
        for i in range(n):
            pers, free = p[i] <= -2, not used[i] and i > 0
            delta_bit = ((-p[i] - 2) >> 1) & 1
            kinds = {"any_full"} if p[i] == -1 else set()
            if p[i] == -1 and free:
                kinds.add("full")
            if p[i] >= 0:
                kinds.add("delta")
            if pers:
                kinds.add("pers")
                if free:
                    kinds.add("pers_delta" if delta_bit else "pers_full")
            flat.append((kinds, g, i))
        probes[g] = [((np.arange(n, dtype=np.uint64) + 1)
                      | np.uint64((k + 1) << 32)),
                     np.zeros(n, bool), np.zeros(n, np.int32)]
    taken = set()
    pairs = []
    for kind, skind in (("full", "any_full"), ("delta", "delta"),
                        ("pers_full", "pers"), ("pers_delta", "any_full")):
        found = None
        for d in range(len(flat) - 1, 0, -1):
            kinds, dg, di = flat[d]
            if kind not in kinds or (dg, di) in taken:
                continue
            found = next(((dg, di, sg, si) for skinds, sg, si in flat[:d]
                          if skind in skinds and (sg, si) not in taken
                          and (sg, si) != (dg, di)), None)
            if found is not None:
                break
        check(found is not None, f"no {kind} to drop after a {skind} "
                                 f"source in groups {groups}")
        dg, di, sg, si = found
        probes[dg][0][di] = probes[sg][0][si]
        taken.update({(dg, di), (sg, si)})
        pairs.append(found)
    fill = next(((g, i) for kinds, g, i in flat
                 if "full" in kinds and (g, i) not in taken), None)
    check(fill is not None, "no plain full left for a cache hit")
    probes[fill[0]][1][fill[1]] = True
    probes[fill[0]][2][fill[1]] = 12345
    return probes, pairs, (fill[0], fill[1], 12345)


def copy_source_kernel(torch, weights, params, dev, steps) -> dict:
    """The kernel's copy-source mode on the card, bit for bit: for K in
    FUSE_WIDTHS, K captured group steps (with PSQT on the card and on
    the host-material wire) go through the service's fused dispatch in
    position-keyed mode, with planted duplicates (``plant_positions``):
    the planner drops them and the cache hit, and the one launch with
    ``copy_src`` must equal the plain version with ``copy_src`` on CPU
    copies — values, and every group's anchor and PSQT rows — and the
    host must restore each drop's value. Then on the K = 8 launch: an
    identity ``copy_src`` equals none, a source planted past the host
    check (through the raw wrapper) is counted once in the error word
    and the launch returns, 200 repeated launches are identical, and
    the launch is timed against the same step without ``copy_src``."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec, torch_eval
    from fishnet_tpu_torch.ops import ft_gather

    cpu_params = {k: v.cpu() for k, v in params.items()}
    worst = 0
    timed = None
    for psqt_path in (None, "host-material"):
        harness = FusedHarness(weights, dev, psqt_path)
        try:
            for k_segs in FUSE_WIDTHS:
                groups = [(3 * k + 1) % CAPTURE_GROUPS for k in range(k_segs)]
                probes, pairs, fill = plant_positions(steps, groups)
                co = harness.svc._coalescer
                dedup0 = co.deduped_evals
                whole, tickets, before, tabs = harness.fused(
                    torch, steps, groups, probes)
                call = harness.calls[0]
                check(call["copy_src"] is not None,
                      f"K={k_segs}: the fused launch had no copy_src")
                at = {tk.group: tk.start for tk in tickets}
                for dg, di, sg, si in pairs:
                    check(whole[at[dg] + di] == whole[at[sg] + si],
                          f"K={k_segs}: drop ({dg}, {di}) != its source")
                check(whole[at[fill[0]] + fill[1]] == fill[2],
                      f"K={k_segs}: the cache hit was not filled")
                tab = before[0].reshape(-1, 2, spec.L1).clone()
                ptab = before[1].reshape(-1, 2, spec.NUM_PSQT_BUCKETS).clone()
                material = call["material"]
                values, _, _ = torch_eval._packed_anchored_core(
                    cpu_params, call["packed"].cpu(), call["offsets"].cpu(),
                    call["buckets"].cpu(), call["parent"].cpu(),
                    None if material is None else material.cpu(), tab, ptab,
                    copy_src=call["copy_src"])
                diffs = [max_diff([call["values"].cpu()], [values]),
                         max_diff([t.cpu().reshape(-1) for t in tabs],
                                  [tab.reshape(-1), ptab.reshape(-1)])]
                worst = max(worst, *diffs)
                check(max(diffs) == 0, f"K={k_segs} {psqt_path or 'fused'}: "
                                       f"copy-source launch != plain {diffs}")
                moved = int((call["copy_src"].numpy()
                             != np.arange(len(call["copy_src"]))).sum())
                log(f"  K={k_segs} ({psqt_path or 'PSQT on the card'}): "
                    f"{len(pairs)} planted duplicates and a cache hit, "
                    f"{co.deduped_evals - dedup0} dropped by position, "
                    f"{moved} entries redirected: one launch == plain "
                    "with copy_src on CPU (values, every group's anchor "
                    "and PSQT rows), drops restored on the host")
                if psqt_path is None and k_segs == FUSE_WIDTHS[-1]:
                    timed = copy_source_launches(torch, params, dev, call,
                                                 before)
        finally:
            harness.close()
    timed["worst"] = worst
    return timed


def copy_source_launches(torch, params, dev, call, before) -> dict:
    """The raw wrapper on one recorded copy-source launch: identity,
    a bad source, 200 repeats and the timing (see
    ``copy_source_kernel``)."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec
    from fishnet_tpu_torch.ops import ft_gather

    w, b, fp = params["ft_w"], params["ft_b"], params["ft_psqt"]
    pk, off, par = call["packed"], call["offsets"], call["parent"]
    tab0 = before[0].reshape(-1, 2, spec.L1).to(dev)
    ptab0 = before[1].reshape(-1, 2, spec.NUM_PSQT_BUCKETS).to(dev)
    batch = par.shape[0]
    cs = call["copy_src"].to(dev)

    def launch(copy_src):
        tab, ptab = tab0.clone(), ptab0.clone()
        acc, psqt = ft_gather.ft_accumulate_packed_cuda(
            w, b, pk, off, par, tab, ft_psqt=fp, psqt_tab=ptab,
            copy_src=copy_src)
        return [acc, psqt, tab, ptab]

    plain = launch(None)
    ident = torch.arange(batch, dtype=torch.int32, device=dev)
    d_ident = max_diff(launch(ident), plain)
    check(d_ident == 0, f"identity copy_src != none by {d_ident}")
    first = launch(cs)
    d_rep = max(max_diff(launch(cs), first) for _ in range(200))
    check(d_rep == 0, f"200 copy-source launches differ by {d_rep}")
    bad = ident.clone()
    j = batch // 2
    bad[j] = j + 1  # a LATER source: refused, counted, never waited on
    torch.cuda.synchronize()
    errors0 = ft_gather.kernel_errors(dev)
    got = launch(bad)
    torch.cuda.synchronize()
    counted = ft_gather.kernel_errors(dev) - errors0
    d_bad = max_diff(got, plain)
    check(counted == 1 and d_bad == 0,
          f"bad source: {counted} errors counted, results differ by {d_bad}")
    tab, ptab = tab0.clone(), ptab0.clone()

    def with_copy():
        return ft_gather.ft_accumulate_packed_cuda(
            w, b, pk, off, par, tab, ft_psqt=fp, psqt_tab=ptab, copy_src=cs)

    def without():
        return ft_gather.ft_accumulate_packed_cuda(
            w, b, pk, off, par, tab, ft_psqt=fp, psqt_tab=ptab)

    ptab_plain, pptab_plain = tab0.clone(), ptab0.clone()
    ms = graph_time_ms(torch, with_copy)
    base_ms = graph_time_ms(torch, without)
    again = graph_time_ms(torch, with_copy)
    base_again = graph_time_ms(torch, without)
    plain_ms = graph_time_ms(torch, lambda: ft_gather.ft_accumulate_packed_plain(
        w, b, pk, off, par, ptab_plain, ft_psqt=fp, psqt_tab=pptab_plain,
        copy_src=cs))
    bound_ms, bound_by, nbytes, ops = packed_bound(
        pk.cpu().numpy().view(np.uint16), off.cpu().numpy(),
        par.cpu().numpy(), tab0.shape[0], True, spec.L1)
    # The fan-in's own input: copy_src, read once.
    bound_ms, bound_by = _bound_of(nbytes + 4 * batch, ops)[:2]
    moved = int((cs.cpu().numpy() != np.arange(batch)).sum())
    log(f"  K=8 copy-source launch ({batch} entries, {moved} redirected): "
        f"identity == none, 200 repeats identical, a later source counted "
        f"once ({counted}) and the launch returned; {ms:.6f} / {again:.6f} "
        f"ms against {base_ms:.6f} / {base_again:.6f} ms without copy_src, "
        f"plain {plain_ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}, "
        f"{nbytes + 4 * batch} B)")
    return {"entries": batch, "redirected": moved, "ms": ms,
            "repeat_ms": again, "without_ms": base_ms,
            "without_repeat_ms": base_again, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes": nbytes + 4 * batch, "bound_ops": ops}


def host_timers(service) -> dict:
    """Time the host's work around the device on ``service``: the pack
    worker's dispatches ("pack": its calls of the coalescer's
    ``_execute``, staging, planning, uploads and launches, not the
    device's work), and with the eval cache the drivers' pre-dispatch
    probe ("probe": hashes, cache and bounds probe), the provide-time
    insert ("insert"), and the bounds tier's submit-time seed ("seed")
    and harvest ("harvest"). Wall time of each call, waits for the
    interpreter lock included. Returns the live totals, name -> [calls,
    seconds]."""
    totals = {}

    def wrap(owner, attr, name, thread=None):
        fn = getattr(owner, attr)
        cell = totals.setdefault(name, [0, 0.0])

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if thread is None or threading.current_thread().name == thread:
                    cell[0] += 1
                    cell[1] += time.perf_counter() - t0

        setattr(owner, attr, timed)

    if service._coalescer is not None:
        wrap(service._coalescer, "_execute", "pack", "dispatch-pack")
    if service._eval_cache is not None:
        wrap(service, "_probe_batch", "probe")
        wrap(service._eval_cache, "insert_block", "insert")
    if service._bounds_cache is not None:
        wrap(service, "_seed_bound_chain", "seed")
        wrap(service, "_harvest_bounds", "harvest")
    return totals


#: The cache phase's bursts (cut from 3000 nodes a search, then 1000, so
#: the default run keeps its time on a slow host).
CACHE_BURST_NODES = 500


def cache_numbers(weights, dev) -> dict:
    """The burst (at ``CACHE_BURST_NODES`` a search, so the default run
    keeps its time with the az phase) and the ``run`` workload (at the
    ``cli`` phase's nodes, 4 games at RUN_NODES and 2 move jobs) with the
    cache off, then on (each run from a cold cache, on a fresh service;
    cut from off, on, on, off so the default run keeps its time):
    nodes/s and positions/s, the pre-wire hit share (entries answered
    before the wire over entries probed), skipped
    dispatches, position dedup, the bounds tier's seeds and harvests,
    the cache's size and evictions, and the host's ms per call
    (``host_timers``; the pack worker's per dispatch)."""
    from fishnet_tpu_torch.configure import parse_and_configure
    from fishnet_tpu_torch.search import eval_cache
    from fishnet_tpu_torch.search.service import SearchService

    threads = parse_and_configure(["run", "--no-conf"]).resolved_search_threads()
    out = {"burst": [], "run": []}

    def summary(label, c, probes, timers, nps, pps):
        pack = timers.get("pack", [0, 0.0])
        row = {"cache": label, "nodes_per_s": nps, "positions_per_s": pps,
               "prewire_hit_share": c["cache_prewire_hits"] / max(1, probes),
               "probes": probes,
               "pack_ms_per_dispatch": pack[1] * 1e3 / max(1, pack[0]),
               "host_ms_per_call": {k: v[1] * 1e3 / max(1, v[0])
                                    for k, v in timers.items()},
               "host_calls": {k: v[0] for k, v in timers.items()}}
        for key in ("cache_prewire_hits", "cache_skipped_dispatches",
                    "position_dedup", "bounds_seeded", "bounds_harvested",
                    "cache_entries", "cache_evictions", "dispatches",
                    "eval_steps", "fused_dedup"):
            row[key] = c[key]
        return row

    for label in ("off", "on"):
        hatch = dict(FISHNET_NO_EVAL_CACHE="1" if label == "off" else None)
        fresh_cache()
        with env_vars(**hatch):
            svc = SearchService(weights=weights, batch_capacity=1024,
                                pipeline_depth=2, driver_threads=threads,
                                device=dev)
        try:
            svc.warmup()
            timers = host_timers(svc)
            cache = eval_cache.get_cache()
            st0 = cache.stats() if cache is not None else None
            burst = {}
            nps = load_burst(svc, burst, nodes=CACHE_BURST_NODES)
        finally:
            svc.close()
        probes = 0 if st0 is None else (
            cache.stats()["hits"] + cache.stats()["misses"]
            - st0["hits"] - st0["misses"])
        row = summary(label, burst["counters"], probes, timers, nps,
                      burst["searches"] / burst["seconds"])
        out["burst"].append(row)
        log(f"  burst, cache {label}: {row}")
    for label in ("off", "on"):
        hatch = dict(FISHNET_NO_EVAL_CACHE="1" if label == "off" else None)
        report = run_workload(f"run, cache {label}", hatch, games=4,
                              moves=2, nodes=RUN_NODES)
        row = summary(label, report["counters"], report["probes"],
                      report["timers"], report["nodes_per_s"],
                      report["positions_per_s"])
        out["run"].append(row)
        log(f"  run, cache {label}: {row}")
    return out


def phase_cache(torch, weights, params, dev, steps=None,
                beside: Optional["SplitParity"] = None) -> dict:
    """The position-keyed eval cache and the bounds tier on the card.

    Kernel level (``copy_source_kernel``): the copy-source mode of the
    packed launch, planted duplicates of every kind, against the plain
    version, then identity, a bad source, repeats and timing.

    Service level, full width, on ``gated_run`` workloads (one launch
    per device dispatch, no dense launch, the error word unchanged, in
    every run): cache off, cold and warm (a fresh service over the
    surviving cache) give the same analyses, and warm answers batches
    before the wire, skips dispatches and dispatches less than cold; one
    position in every group coalesces with position dedup, persistent
    anchor codes among the drops and copy-source launches, equal to the
    FISHNET_NO_DEDUP=1 FISHNET_NO_EVAL_CACHE=1 run; a snapshot (save,
    reset, load) resolves the next service's first batch before the
    wire with the same analyses; and with the bounds tier on, a fresh
    service seeds what the first harvested, the same in two identical
    such sequences. The comparisons run without the bounds tier
    (FISHNET_NO_BOUNDS=1), which changes what a search finds by design.

    Then ``cache_numbers``. ``beside`` (the split phase's parity run)
    starts after the kernel's timings and has ended before the numbers:
    it runs beside the service-level checks alone."""
    import tempfile

    import numpy as np

    from fishnet_tpu_torch.search import eval_cache
    from fishnet_tpu_torch.search import service as service_mod

    if steps is None:
        steps, _ = capture_group_steps(weights, dev)
    timed = copy_source_kernel(torch, weights, params, dev, steps)
    if beside is not None:
        beside.start()

    quiet = dict(FISHNET_NO_BOUNDS="1", FISHNET_COALESCE_WIDTH="4",
                 FISHNET_NO_COALESCE=None)
    walks = random_lines(8, seed=3)
    off = gated_run(weights, dev, walks, FISHNET_NO_EVAL_CACHE="1", **quiet)
    cold = gated_run(weights, dev, walks, **quiet)
    warm = gated_run(weights, dev, walks, fresh=False, **quiet)
    check(off[0] == cold[0] == warm[0],
          "cache off, cold and warm analyses differ")
    c_cold, c_warm = cold[1], warm[1]
    check(c_warm["cache_prewire_hits"] > 0
          and c_warm["cache_skipped_dispatches"] > 0
          and c_warm["dispatches"] < c_cold["dispatches"],
          f"the warm run did not reuse the cache: {c_warm}")
    log(f"  8 gated searches, cache off / cold / warm: the same analyses; "
        f"dispatches {off[1]['dispatches']} / {c_cold['dispatches']} / "
        f"{c_warm['dispatches']}, pre-wire hits "
        f"{c_cold['cache_prewire_hits']} / {c_warm['cache_prewire_hits']}, "
        f"skipped dispatches {c_cold['cache_skipped_dispatches']} / "
        f"{c_warm['cache_skipped_dispatches']}")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cache.npz")
        fp = weights.fingerprint()
        check(eval_cache.save_snapshot(path, fingerprint=fp) == path,
              "the snapshot was not written")
        entries = len(eval_cache.get_cache())
        fresh_cache()
        check(eval_cache.load_snapshot(path, fingerprint=fp),
              "the snapshot did not load")
        first = []

        def watch(svc):
            probe = svc._probe_batch

            def recorder(g, n, hash_ptr, dctx=None):
                got = probe(g, n, hash_ptr, dctx)
                first.append(bool(got[2].all()))
                return got
            svc._probe_batch = recorder

        restart = gated_run(weights, dev, walks, fresh=False, hook=watch,
                            **quiet)
    check(restart[0] == cold[0], "the restarted service's analyses differ")
    check(first and first[0], "the first batch after the restart went to "
                              "the wire")
    log(f"  snapshot warm restart ({entries} entries): the first batch "
        f"resolved before the wire, {restart[1]['cache_prewire_hits']} "
        f"pre-wire hits, {restart[1]['dispatches']} dispatches; the same "
        "analyses")

    same = [[] for _ in range(8)]
    planned = []
    plan = service_mod.plan_segment_dedup

    def recorder(parents, *args, **kwargs):
        got = plan(parents, *args, **kwargs)
        if kwargs.get("hashes") is not None:
            planned.append(sum(int((np.asarray(parents[k])[d] <= -2).sum())
                               for k, d in enumerate(got[0])))
        return got

    service_mod.plan_segment_dedup = recorder
    try:
        dd = gated_run(weights, dev, same, **quiet)
    finally:
        service_mod.plan_segment_dedup = plan
    plain = gated_run(weights, dev, same, FISHNET_NO_DEDUP="1",
                      FISHNET_NO_EVAL_CACHE="1", **quiet)
    check(dd[0] == plain[0], "position dedup changed the analyses")
    check(dd[1]["position_dedup"] > 0 and sum(planned) > 0
          and dd[1]["copy_launches"] > 0,
          f"no persistent position dedup: {dd[1]['position_dedup']}, "
          f"{sum(planned)}, {dd[1]['copy_launches']}")
    log(f"  one position in 8 searches: {dd[1]['position_dedup']} evals "
        f"deduped by position ({sum(planned)} persistent anchor codes), "
        f"{dd[1]['copy_launches']} copy-source launches of "
        f"{dd[1]['dispatches']} dispatches; == dedup and cache off")

    sequences = []
    for _ in range(2):
        first_run = gated_run(weights, dev, walks, FISHNET_NO_BOUNDS=None,
                              FISHNET_COALESCE_WIDTH="4",
                              FISHNET_NO_COALESCE=None)
        second = gated_run(weights, dev, walks, fresh=False,
                           FISHNET_NO_BOUNDS=None, FISHNET_COALESCE_WIDTH="4",
                           FISHNET_NO_COALESCE=None)
        check(first_run[1]["bounds_harvested"] > 0
              and second[1]["bounds_seeded"] > 0,
              f"bounds: harvested {first_run[1]['bounds_harvested']}, "
              f"seeded {second[1]['bounds_seeded']}")
        sequences.append((first_run, second))
    check(sequences[0][0][0] == sequences[1][0][0]
          and sequences[0][1][0] == sequences[1][1][0],
          "two identical bounds sequences gave different analyses")
    (h1, s1) = (sequences[0][0][1], sequences[0][1][1])
    log(f"  bounds tier: {h1['bounds_harvested']} records harvested, a "
        f"fresh service seeded {s1['bounds_seeded']} (nodes "
        f"{sum(a[2] for a in sequences[0][0][0])} -> "
        f"{sum(a[2] for a in sequences[0][1][0])}); two sequences gave "
        "the same analyses")
    if beside is not None:
        beside.wait()
    fresh_cache()
    numbers = cache_numbers(weights, dev)
    fresh_cache()
    return {"copy_src": timed, "numbers": numbers}


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
            fresh_cache()
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


# -- the split evaluator plane ------------------------------------------------

#: The split phase's burst layouts, (frontends, driver threads each): at
#: most the monolith's 7 driver threads in all. One layout: a run costs
#: ~35 s of process start-up and hand-over for ~10 s of burst.
SPLIT_LAYOUTS = ((3, 2),)
#: The largest fused host batches a host run keeps for the kernel check.
SPLIT_CAPTURES = 4
#: The parity run: seeded walks searched one at a time at these nodes.
SPLIT_PARITY_WALKS = 6
#: The split phase's bursts (A, B, C: four in all, cut from A, B, C, C',
#: B, A) at 500 nodes a search, cut from 3000 (then 1000) so the default
#: run keeps its time on a slow host.
SPLIT_BURST_NODES = 500
SPLIT_PARITY_NODES = 1000
#: The host's and the frontends' per-process settings (the CLI's
#: microbatch 1024, pipeline 2).
SPLIT_SERVICE = dict(batch_capacity=1024, pipeline_depth=2)


def _child_cmd(fn: str, *args: str) -> list:
    """A ``python3`` subprocess running ``chip_smoke.<fn>(args)`` from this
    checkout: the split phase's processes are started fresh, never forked
    from this one, which holds a CUDA context."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; sys.exit(chip_smoke.{fn}(sys.argv[1:]))")
    return [sys.executable, "-c", code, *args]


def _read_line(proc, deadline: float, what: str) -> str:
    """The next line of ``proc``'s standard output, before ``deadline``
    (a thread per process reads its lines into a queue, so lines that
    arrive together are not held in a buffer ``select`` cannot see)."""
    import queue

    lines = getattr(proc, "lines", None)
    if lines is None:
        lines = proc.lines = queue.Queue()

        def pump():
            for line in proc.stdout:
                lines.put(line)
            lines.put(None)

        threading.Thread(target=pump, daemon=True).start()
    try:
        line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
    except queue.Empty:
        raise SmokeFailure(f"{what}: no answer in time") from None
    check(line is not None, f"{what}: exited (rc {proc.poll()})")
    return line.strip()


def _stop(proc, sig=None) -> Optional[int]:
    """End ``proc`` (``sig``: sent first) and reap it."""
    if proc.poll() is None:
        if sig is not None:
            proc.send_signal(sig)
        try:
            return proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
    return proc.wait(timeout=60)


def split_ping_child(argv) -> int:
    """The frontend side of the ring ping: ``argv[1]`` records of seeded
    bytes (1-512 entries of the dense wire) pushed through a link in
    ``argv[0]``, each waited for and checked against its echo (the bytes
    reversed); prints the round trips as JSON."""
    import numpy as np

    from fishnet_tpu_torch.rpc import rings

    link = rings.create_frontend_link(argv[0], name="ping.ring")
    rng = np.random.default_rng(1)
    rtts = []
    try:
        for i in range(int(argv[1])):
            k = int(rng.integers(1, 513))
            pay = rng.integers(0, 256, k * rings.NNUE_ENTRY_BYTES,
                               dtype=np.uint8).tobytes()
            t0 = time.perf_counter()
            link.push(rings.KIND_NNUE_SUBMIT, i + 1, 1, k, pay)
            deadline = time.monotonic() + 10
            got = []
            while not got and time.monotonic() < deadline:
                got = link.drain()
                if not got:
                    time.sleep(0.0001)
            rtts.append(time.perf_counter() - t0)
            if got != [(rings.KIND_NNUE_RESULT, i + 1, 1, k, pay[::-1])]:
                print(f"record {i}: echo missing or wrong", flush=True)
                return 1
        print(json.dumps({
            "records": len(rtts),
            "median_rtt_ms": sorted(rtts)[len(rtts) // 2] * 1e3,
            "max_rtt_ms": max(rtts) * 1e3}), flush=True)
        return 0
    finally:
        link.close()
        os.unlink(link.path)


def split_ping(rpc_dir: str, records: int = 500) -> dict:
    """Two processes, one ring link in ``rpc_dir``: this one echoes what a
    fresh child pushes. Fails unless every record comes back whole (the
    link directory must be coherent across processes)."""
    from fishnet_tpu_torch.rpc import rings

    child = subprocess.Popen(
        _child_cmd("split_ping_child", rpc_dir, str(records)),
        stdout=subprocess.PIPE, text=True)
    path = os.path.join(rpc_dir, "ping.ring")
    host = None
    try:
        deadline = time.monotonic() + 120
        while host is None:
            check(time.monotonic() < deadline and child.poll() is None,
                  "ring ping: no link file appeared")
            try:
                host = rings.attach_host_link(path)
            except (OSError, ValueError):
                time.sleep(0.01)
        while child.poll() is None and time.monotonic() < deadline:
            for _kind, ticket, epoch, n, pay in host.drain():
                host.push(rings.KIND_NNUE_RESULT, ticket, epoch, n, pay[::-1])
            time.sleep(0.0001)
        out = child.stdout.read().strip().splitlines()
        check(_stop(child) == 0 and bool(out),
              f"ring ping through {rpc_dir} failed: {out}")
        return json.loads(out[-1])
    finally:
        if host is not None:
            host.close()
        _stop(child)


def split_host_child(argv) -> int:
    """The split phase's evaluator host: ``python -m
    fishnet_tpu_torch.rpc.host``'s ``main`` on ``argv[2:]``, its
    dispatches instrumented. At exit (SIGTERM) it writes to ``argv[0]``
    (JSON) the host's counters, the kernel's dense and packed launches
    and the plain version's calls since the host's warm-up, and the ring
    counters; to ``argv[1]`` (npz) the SPLIT_CAPTURES largest fused
    batches it dispatched, as staged (features, buckets, parents,
    material)."""
    import numpy as np

    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.rpc import host as host_mod
    from fishnet_tpu_torch.rpc import rings

    stats_path, caps_path, argv = argv[0], argv[1], argv[2:]
    made, plain, caps, warm = [], [0], [], {}
    plain_fn = ft_gather.ft_accumulate_plain

    def counted_plain(*args, **kwargs):
        plain[0] += 1
        return plain_fn(*args, **kwargs)

    ft_gather.ft_accumulate_plain = counted_plain

    class Host(host_mod.EvaluatorHost):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def warmup(self):
            super().warmup()
            warm.update(dense=ft_gather.ft_accumulate_cuda.launches,
                        packed=ft_gather.ft_accumulate_packed_cuda.launches,
                        plain=plain[0])

    stage_fn = host_mod._HostNnueBackend._stage_inputs
    sweep_fn = host_mod.EvaluatorHost.sweep
    busy = [0, 0.0]

    def timed_sweep(self):
        t0 = time.perf_counter()
        served = sweep_fn(self)
        if served:
            busy[0] += 1
            busy[1] += time.perf_counter() - t0
        return served

    host_mod.EvaluatorHost.sweep = timed_sweep

    def stage(self, bucket, segs):
        out = stage_fn(self, bucket, segs)
        rows = sum(len(s[1]) for s in segs)
        if len(segs) > 1 and (len(caps) < SPLIT_CAPTURES
                              or rows > caps[-1][0]):
            buf = self._in_t.numpy()[:bucket * 67].copy()
            caps.append((rows, len(segs), buf))
            caps.sort(key=lambda c: -c[0])
            del caps[SPLIT_CAPTURES:]
        return out

    host_mod._HostNnueBackend._stage_inputs = stage
    host_mod.EvaluatorHost = Host
    rc = host_mod.main(argv)
    stats = {"rc": rc, "rings": rings.stats(), "busy_sweeps": busy[0],
             "busy_s": busy[1]}
    if made:
        stats.update(made[0].counters(), launches={
            "dense": ft_gather.ft_accumulate_cuda.launches
            - warm.get("dense", 0),
            "packed": ft_gather.ft_accumulate_packed_cuda.launches
            - warm.get("packed", 0),
            "plain": plain[0] - warm.get("plain", 0)})
    np.savez(caps_path, **{f"b{i}": c[2] for i, c in enumerate(caps)},
             rows=np.array([c[0] for c in caps]),
             segs=np.array([c[1] for c in caps]))
    with open(stats_path, "w", encoding="utf-8") as fp:
        json.dump(stats, fp)
    return rc


def split_frontend_child(argv) -> int:
    """One split-plane frontend: a ``RemoteBackend`` (``argv[0]``, JSON:
    net, link dir, driver threads, walks, nodes, parity) warmed up, then
    "ready" on its standard output; on a line on its standard input it
    searches the walks from the start position (parity: one at a time,
    prefetch pinned to 0; else all at once) and prints one JSON line: the
    wall-clock start and end, nodes, counter deltas, whether this process
    holds a CUDA context or loaded the kernel, its ring counters
    (``resubmits`` among them), and (parity) the analyses."""
    spec = json.loads(argv[0])
    import torch

    from fishnet_tpu_torch.nnue.weights import NnueWeights
    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.rpc import rings
    from fishnet_tpu_torch.rpc.client import RemoteBackend

    svc = RemoteBackend(
        weights=NnueWeights.load(spec["net"]), net_path=spec["net"],
        rpc_dir=spec["dir"], driver_threads=spec["threads"],
        **SPLIT_SERVICE)
    # Per step on the driver threads: the dense expansion, packing and
    # push ("ship"), and the wait for the host's answer ("wait").
    timers = {"ship": [0, 0.0], "wait": [0, 0.0]}
    lock = threading.Lock()

    def timed(fn, cell):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with lock:
                    cell[0] += 1
                    cell[1] += time.perf_counter() - t0
        return call

    try:
        svc.warmup()
        svc._dispatch_eval = timed(svc._dispatch_eval, timers["ship"])
        svc._resolve_eval = timed(svc._resolve_eval, timers["wait"])
        if spec["parity"]:
            svc.set_prefetch(0, adaptive=False)
        print("ready", flush=True)
        sys.stdin.readline()
        c0 = svc.counters()

        async def go():
            if spec["parity"]:
                return [await svc.search(STARTPOS, m, nodes=spec["nodes"])
                        for m in spec["walks"]]
            return await asyncio.gather(*[
                svc.search(STARTPOS, m, nodes=spec["nodes"])
                for m in spec["walks"]])

        t0 = time.time()
        results = asyncio.run(go())
        t1 = time.time()
        c = {k: v - c0[k] for k, v in svc.counters().items()}
        print(json.dumps({
            "t0": t0, "t1": t1, "searches": len(results),
            "failed": sum(not r.best_move for r in results),
            "nodes": sum(r.nodes for r in results), "counters": c,
            "cuda_context": torch.cuda.is_initialized(),
            "kernel_loaded": ft_gather._lib is not None,
            "timers": timers, "rings": rings.stats(),
            "analyses": [analysis_of(r) for r in results]
            if spec["parity"] else None}), flush=True)
    finally:
        svc.close()
    return 0


def analysis_of(r) -> list:
    """A search result as a comparable (JSON-shaped) analysis."""
    return [r.best_move, r.depth, r.nodes,
            [[l.multipv, l.depth, l.is_mate, l.value, list(l.pv)]
             for l in r.lines]]


def split_run(net: str, rpc_dir: str, frontends: int, threads: int,
              walks, nodes: int, tag: str, parity: bool = False,
              uci: bool = False, env: Optional[dict] = None,
              base_env: Optional[dict] = None, say=None) -> dict:
    """One run of the split plane on the card: the evaluator host
    (``split_host_child``, ``--device cuda``) and ``frontends`` frontend
    processes of ``threads`` driver threads each, the walks dealt out in
    turn; the host is warmed up before the first frontend starts. Every
    frontend must answer every search without a CUDA context or the
    kernel; the host must make one dense launch per dispatch, no packed
    launch, call no plain version, refuse nothing and fail no dispatch.
    ``uci``: then also one ``FISHNET_RPC=1 python -m fishnet_tpu_torch
    uci`` session (mate in one at depth 4). ``env``: variables added to
    the processes' environment, which is ``base_env`` (``os.environ`` by
    default: a run on a thread of its own passes a copy, since the main
    thread sets variables for its services meanwhile). ``say`` takes
    the run's log lines (``log`` by default). Returns the frontends'
    reports, the host's stats and captures, and the run's numbers."""
    import numpy as np

    say = say or log
    out_dir = ROOT / "chiprun_out" / "split"
    out_dir.mkdir(parents=True, exist_ok=True)
    stats_path = os.path.join(rpc_dir, f"host-{tag}.json")
    caps_path = os.path.join(rpc_dir, f"caps-{tag}.npz")
    env = dict(os.environ if base_env is None else base_env,
               FISHNET_RPC_DIR=rpc_dir, **(env or {}))
    host_log = open(out_dir / f"host-{tag}.log", "w", encoding="utf-8")
    fe_log = open(out_dir / f"frontends-{tag}.log", "w", encoding="utf-8")
    host = subprocess.Popen(
        _child_cmd("split_host_child", stats_path, caps_path, "--dir",
                   rpc_dir, "--nnue-file", net, "--device", "cuda"),
        env=env, stdout=host_log, stderr=subprocess.STDOUT)
    procs = []
    try:
        deadline = time.monotonic() + 300
        while "rpc host: serving" not in (out_dir / f"host-{tag}.log"
                                          ).read_text():
            check(host.poll() is None and time.monotonic() < deadline,
                  f"split {tag}: the host did not start (rc {host.poll()})")
            time.sleep(0.05)
        for f in range(frontends):
            spec = dict(net=net, dir=rpc_dir, threads=threads, nodes=nodes,
                        walks=walks[f::frontends] if not parity else walks,
                        parity=parity)
            procs.append(subprocess.Popen(
                _child_cmd("split_frontend_child", json.dumps(spec)),
                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=fe_log, text=True))
        deadline = time.monotonic() + 300
        for p in procs:
            check(_read_line(p, deadline, f"split {tag} frontend") == "ready",
                  f"split {tag}: a frontend did not warm up")
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.flush()
        deadline = time.monotonic() + 900
        reports = [json.loads(_read_line(p, deadline, f"split {tag} frontend"))
                   for p in procs]
        rcs = [_stop(p) for p in procs]
        check(rcs == [0] * frontends, f"split {tag}: frontend exit codes {rcs}")
        uci_out = []
        if uci:
            p = subprocess.Popen(
                [sys.executable, "-m", "fishnet_tpu_torch", "uci",
                 "--nnue-file", net, "--microbatch", "1024"],
                cwd=ROOT, env=dict(env, FISHNET_RPC="1"),
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=fe_log, text=True)
            procs.append(p)
            p.stdin.write(f"uci\nisready\nposition fen {MATE_FEN}\n"
                          "go depth 4\n")
            p.stdin.flush()
            deadline = time.monotonic() + 300
            while not uci_out or not uci_out[-1].startswith("bestmove"):
                uci_out.append(_read_line(p, deadline, "split uci frontend"))
            p.stdin.write("quit\n")
            p.stdin.flush()
            check(_stop(p) == 0, "split: the uci frontend did not exit 0")
    finally:
        for p in procs:
            _stop(p, signal.SIGTERM)
        host_rc = _stop(host, signal.SIGTERM)
        host_log.close()
        fe_log.close()
    check(host_rc == 0, f"split {tag}: the host exited {host_rc}")
    with open(stats_path, encoding="utf-8") as fp:
        stats = json.load(fp)
    caps = np.load(caps_path)
    captures = [(int(r), int(s), caps[f"b{i}"]) for i, (r, s) in
                enumerate(zip(caps["rows"], caps["segs"]))]
    if uci:
        check(uci_out[-1].startswith("bestmove d1d8")
              and any("score mate 1" in line for line in uci_out),
              f"split {tag}: the FISHNET_RPC=1 uci frontend answered "
              f"{uci_out[-4:]}")
        say(f"  {tag}: FISHNET_RPC=1 uci frontend: {uci_out[-1]}")
    for r in reports:
        check(r["failed"] == 0, f"split {tag}: a search failed")
        check(not r["cuda_context"] and not r["kernel_loaded"],
              f"split {tag}: a frontend created a CUDA context or loaded "
              "the kernel")
    launches, ring = stats["launches"], stats["rings"]
    check(launches["dense"] == stats["dispatches"] > 0,
          f"split {tag}: {launches['dense']} dense launches for "
          f"{stats['dispatches']} host dispatches")
    check(launches["packed"] == 0 and launches["plain"] == 0,
          f"split {tag}: packed launches or plain calls on the card "
          f"{launches}")
    for key in ("eval_errors", "refused.nnue", "refused.az",
                "result_drops", "torn", "stale_refusals"):
        check(ring.get(key, 0) == 0, f"split {tag}: host counted {key} "
                                     f"{ring.get(key)}")
    nodes_all = sum(r["nodes"] for r in reports)
    wall = max(r["t1"] for r in reports) - min(r["t0"] for r in reports)
    fc = {k: sum(r["counters"][k] for r in reports)
          for k in reports[0]["counters"]}
    row = {
        "run": f"split, {frontends} frontends x {threads} threads",
        "nodes_per_s": nodes_all / wall, "nodes": nodes_all, "seconds": wall,
        "host_ms_per_dispatch": stats["run_s"] * 1e3
        / max(1, stats["dispatches"]),
        "host_dispatches": stats["dispatches"],
        "host_fused_dispatches": stats["fused_dispatches"],
        "mean_fused_width": stats["segments"] / max(1, stats["dispatches"]),
        "fused_rows_over_slots": stats["rows"] / max(1, stats["slots"]),
        "frontend_steps": fc["eval_steps"],
        "wire_bytes_per_slot": fc["wire_bytes"] / max(1, fc["bucket_slots"]),
        "wire_bytes_per_entry": fc["wire_bytes"]
        / max(1, fc["evals_shipped"]),
        "dense_launches": launches["dense"],
        "host_busy_share": stats["busy_s"] / wall,
        "host_sweep_ms": stats["busy_s"] * 1e3 / max(1, stats["busy_sweeps"]),
        "frontend_ms_per_step": {
            k: sum(r["timers"][k][1] for r in reports) * 1e3
            / max(1, sum(r["timers"][k][0] for r in reports))
            for k in ("ship", "wait")},
        "frontend_step_ms": wall * 1e3 * frontends * threads
        * SPLIT_SERVICE["pipeline_depth"] / max(1, fc["eval_steps"]),
    }
    say(f"  {tag}: {row}")
    return {"row": row, "reports": reports, "stats": stats,
            "captures": captures}


def split_monolith(weights, dev, cache: bool, threads: int) -> dict:
    """The 256-search burst on the monolith (microbatch 1024, pipeline 2,
    ``threads`` driver threads), the eval cache on or off, with the pack
    worker's ms per dispatch (``host_timers``)."""
    from fishnet_tpu_torch.search.service import SearchService

    fresh_cache()
    with env_vars(FISHNET_NO_EVAL_CACHE=None if cache else "1"):
        svc = SearchService(weights=weights, driver_threads=threads,
                            device=dev, **SPLIT_SERVICE)
    try:
        svc.warmup()
        timers = host_timers(svc)
        burst = {}
        nps = load_burst(svc, burst, nodes=SPLIT_BURST_NODES)
    finally:
        svc.close()
    c, pack = burst["counters"], timers.get("pack", [0, 0.0])
    row = {
        "run": f"monolith, cache {'on' if cache else 'off'}",
        "nodes_per_s": nps, "nodes": burst["nodes"],
        "seconds": burst["seconds"],
        "pack_ms_per_dispatch": pack[1] * 1e3 / max(1, pack[0]),
        "dispatches": c["dispatches"],
        "mean_fused_width": c["eval_steps"] / max(1, c["dispatches"]),
        "wire_bytes_per_slot": c["wire_bytes"] / max(1, c["bucket_slots"]),
        "wire_bytes_per_entry": c["wire_bytes"] / max(1, c["evals_shipped"]),
    }
    log(f"  {row['run']}: {row}")
    return row


def split_kernel(torch, params, dev, captures) -> dict:
    """The kernel's dense mode on fused batches the host dispatched: the
    accumulators and the values equal the plain version on CPU copies,
    then each batch's time (CUDA events around graph-replayed calls, as
    the timing phase), the plain version's on the card, the bound, and
    ``embedding_bag`` where it computes the same function (an all-full
    batch; else None)."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec, torch_eval
    from fishnet_tpu_torch.ops import ft_gather

    w, b = params["ft_w"], params["ft_b"]
    cpu = {k: v.cpu() for k, v in params.items()}
    errors0 = ft_gather.kernel_errors(dev)  # earlier phases plant some
    out = []
    for rows, segs, buf in captures:
        bucket = len(buf) // 67
        nf = bucket * 64
        idx_np = buf[:nf].reshape(bucket, 2, 32)
        parent_np = buf[nf + bucket: nf + 2 * bucket]
        host_t = torch.from_numpy(buf)
        x = host_t.to(dev)
        idx = x[:nf].view(bucket, 2, 32)
        buckets, parent = x[nf: nf + bucket], x[nf + bucket: nf + 2 * bucket]
        material = x[nf + 2 * bucket: nf + 3 * bucket]
        kw = dict(delta_base=spec.DELTA_BASE, parent=parent)
        got = ft_gather.ft_accumulate_cuda(w, b, idx, **kw)
        ref = ft_gather.ft_accumulate_plain(
            cpu["ft_w"], cpu["ft_b"], host_t[:nf].view(bucket, 2, 32),
            delta_base=spec.DELTA_BASE, parent=host_t[nf + bucket:
                                                      nf + 2 * bucket])
        diff = max_diff([got.cpu()], [ref])
        vals = torch_eval.evaluate_batch(params, idx, buckets, parent,
                                         material).cpu()
        vref = torch_eval.evaluate_batch(
            cpu, host_t[:nf].view(bucket, 2, 32),
            host_t[nf: nf + bucket], host_t[nf + bucket: nf + 2 * bucket],
            host_t[nf + 2 * bucket: nf + 3 * bucket])
        diff = max(diff, max_diff([vals], [vref]))
        check(diff == 0, f"split: captured host batch ({rows} rows, {segs} "
                         f"records): kernel != plain ({diff})")
        ms = graph_time_ms(torch, lambda: ft_gather.ft_accumulate_cuda(
            w, b, idx, **kw))
        plain_ms = graph_time_ms(torch, lambda: ft_gather.ft_accumulate_plain(
            w, b, idx, **kw))
        bound_ms, bound_by, nbytes, ops = bound(idx_np, parent_np, False,
                                                False, spec.L1)
        library_ms = None
        if (parent_np == -1).all():
            flat, w_f = idx.view(-1, 32).long(), w.float()
            lib_out = torch.nn.functional.embedding_bag(flat, w_f, mode="sum")
            check(torch.equal(lib_out.view(bucket, 2, -1).to(torch.int32)
                              + b.to(torch.int32), got),
                  "split: embedding_bag does not compute the same sums")
            library_ms = graph_time_ms(
                torch, lambda: torch.nn.functional.embedding_bag(
                    flat, w_f, mode="sum"))
        entry = {"entries": bucket, "rows": rows, "records": segs,
                 "in_batch_deltas": int((parent_np >= 0).sum()),
                 "max_abs_err": diff, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "bound_bytes": nbytes, "bound_ops": ops,
                 "library_ms": library_ms}
        log(f"  captured host batch: {entry}")
        out.append(entry)
    torch.cuda.synchronize()
    check(ft_gather.kernel_errors(dev) == errors0,
          "split: the kernel's error word moved on captured host batches")
    return out


class SplitParity:
    """The split phase's parity run (``split_run``: two frontends of one
    driver thread searching SPLIT_PARITY_WALKS walks one at a time, and
    the ``uci`` frontend) in a link directory of its own that passed the
    ring ping, on a thread of its own. It is a check, not a number, and
    its work is in other processes, so it runs beside the checks of the
    main thread (the cache phase's gated runs; the split phase's
    monolith) instead of after them. Its processes get a copy of the
    environment taken at ``start`` (the main thread sets variables for
    its services meanwhile), with the eval cache and the bounds tier
    off; its log lines wait for ``result``."""

    def __init__(self, weights):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="fishnet-split-")
        self.net = os.path.join(self.dir, "net.nnue")
        weights.save(self.net)
        self.walks = random_lines(SPLIT_PARITY_WALKS, seed=5)
        self.ping = None
        self.lines = []
        self._pool = ThreadPoolExecutor(1)
        self._future = None

    def start(self) -> None:
        """The ring ping on this thread (its round trips are numbers:
        nothing else runs beside it), then the parity run on its own."""
        self.ping = split_ping(self.dir)
        self._future = self._pool.submit(
            split_run, self.net, self.dir, 2, 1, self.walks,
            SPLIT_PARITY_NODES, "parity", parity=True, uci=True,
            env={"FISHNET_NO_EVAL_CACHE": "1", "FISHNET_NO_BOUNDS": "1"},
            base_env=dict(os.environ), say=self.lines.append)

    def wait(self) -> None:
        """Until the parity run has ended, whatever its outcome (the
        split phase reads it), so that the numbers taken next run alone."""
        if self._future is not None:
            concurrent.futures.wait([self._future])

    def result(self) -> dict:
        """The parity run's result (its failure raised here), after its
        log lines."""
        try:
            return self._future.result()
        finally:
            for line in self.lines:
                log(line)
            self.lines.clear()

    def close(self) -> None:
        import shutil

        self._pool.shutdown(wait=True)
        shutil.rmtree(self.dir, ignore_errors=True)


def phase_split(torch, weights, params, dev,
                parity_run: Optional[SplitParity] = None) -> dict:
    """The split evaluator plane on the card: one host process
    (``python -m fishnet_tpu_torch.rpc.host``'s main, ``--device cuda``)
    serving frontend processes (``RemoteBackend``) through a link
    directory that passed a two-process ring ping.

    Parity: two frontends search the same seeded walks one at a time
    (prefetch pinned, one driver thread, the host-material wire; no eval
    cache or bounds tier on either side) while the host fuses their
    microbatches; each frontend's analyses equal the monolith's on the
    card under the same settings, bit for bit. A ``FISHNET_RPC=1``
    ``uci`` frontend answers a mate in one. Every run: one dense launch
    per host dispatch, no packed launch and no plain call on the card,
    nothing refused, no frontend with a CUDA context. The kernel equals
    its plain version on the largest fused host batches, which are then
    timed.

    Throughput, in one call, in the order A, B, C: the 256-search burst
    (at SPLIT_BURST_NODES) on the monolith at its defaults (A: cache on),
    with ``FISHNET_NO_EVAL_CACHE=1`` (B), and on the split plane with 3
    frontends x 2 threads (C).

    ``parity_run``: the parity run (``SplitParity``), started beside the
    cache phase's checks; else it starts here, beside the monolith's
    searches."""
    from fishnet_tpu_torch.configure import parse_and_configure
    from fishnet_tpu_torch.search.service import SearchService

    if parity_run is None:
        parity_run = SplitParity(weights)
        parity_run.start()
    rpc_dir, net, walks = parity_run.dir, parity_run.net, parity_run.walks
    try:
        ping = parity_run.ping
        log(f"  ring ping, two processes, {rpc_dir}: {ping}")
        with env_vars(FISHNET_NO_EVAL_CACHE="1", FISHNET_NO_BOUNDS="1"):
            fresh_cache()
            mono = SearchService(weights=weights, device=dev,
                                 psqt_path="host-material",
                                 driver_threads=1, **SPLIT_SERVICE)
            try:
                mono.set_prefetch(0, adaptive=False)

                async def sequential():
                    return [analysis_of(await mono.search(
                        STARTPOS, m, nodes=SPLIT_PARITY_NODES))
                        for m in walks]

                want = asyncio.run(sequential())
            finally:
                mono.close()
        parity = parity_run.result()
        for r in parity["reports"]:
            check(r["analyses"] == want,
                  "split: a frontend's analyses differ from the monolith's")
        log(f"  parity: 2 frontends x {len(walks)} searches at "
            f"{SPLIT_PARITY_NODES} nodes == the monolith's, bit for bit; "
            f"host fused {parity['stats']['fused_dispatches']} of "
            f"{parity['stats']['dispatches']} dispatches")

        threads = parse_and_configure(
            ["run", "--no-conf"]).resolved_search_threads()
        burst_walks = random_lines(256, seed=11)  # load_burst's
        runs, captures = [], list(parity["captures"])
        layouts = list(SPLIT_LAYOUTS)
        for leg in ("A", "B", "C"):
            if leg in ("A", "B"):
                runs.append(split_monolith(weights, dev, leg == "A",
                                           threads))
                continue
            for frontends, per in layouts:
                got = split_run(net, rpc_dir, frontends, per, burst_walks,
                                SPLIT_BURST_NODES, f"{frontends}x{per}")
                runs.append(got["row"])
                captures += got["captures"]
        captures.sort(key=lambda c: -c[0])
        check(len(captures) >= 3, "split: fewer than 3 fused host batches "
                                  "were captured")
        kernel = split_kernel(torch, params, dev,
                              captures[:SPLIT_CAPTURES])
    finally:
        parity_run.close()
    return {"ping": ping, "runs": runs, "kernel": kernel,
            "launches": parity["stats"]["launches"]["dense"],
            "parity_dispatches": parity["stats"]["dispatches"]}


# -- the AZ/MCTS family ---------------------------------------------------------

#: The az phase's sizes: the default AzConfig (64 x 6, value hidden 128)
#: at the CLI's microbatch, the parity runs and the burst.
AZ_CAP = 1024
AZ_PARITY = (32, 200)  # searches, visits
#: 100 visits a search (800, 400, then 200 before), so the default run
#: keeps under its time limit on a slow host: the burst is host-bound
#: Python at ~4500 visits/s (PERF.md).
AZ_BURST = (256, 100)
#: The forward on the card against the port's CPU forward: both bf16,
#: cuDNN and the CPU sum a conv's products in other orders, so a result
#: may move by a few bf16 steps: at most AZ_STEPS steps of the largest
#: logit's magnitude for the logits, of each value's own magnitude (at
#: least 1/16) for the values; and most logits keep their bits.
AZ_STEPS = 4
AZ_SAME_BITS = 0.5
#: H100 SXM dense bf16 tensor-core peak (NVIDIA's data sheet).
BF16_FLOP_PER_S = 989e12


def az_params():
    """The az phase's net: the default AzConfig's dev-mode draw (seed 0)
    with every zero leaf given small seeded values, so the biases'
    rounding and the value head are live."""
    import numpy as np

    from fishnet_tpu_torch.models.az import AzConfig, init_az_params

    rng = np.random.default_rng(0)
    params = init_az_params(0, AzConfig())
    for name, arr in params.items():
        if not arr.any():
            params[name] = (rng.standard_normal(arr.shape) * 0.05).astype(np.float32)
    return params


def az_flops_per_row(cfg) -> int:
    """Multiply-adds x 2 of one row of the tower (conv and fc products;
    the bias adds, relus and tanh are not counted)."""
    c, sq = cfg.channels, 64
    macs = sq * 9 * 19 * c  # stem
    macs += cfg.blocks * 2 * sq * 9 * c * c  # residual convs
    macs += sq * c * cfg.policy_planes + sq * c * 4  # 1x1 heads
    macs += 4 * sq * cfg.value_hidden + cfg.value_hidden  # value fc1, fc2
    return 2 * macs


def az_bound(cfg, rows: int, params) -> dict:
    """The least time the card could take for one forward of ``rows``:
    the larger of its operations over the bf16 peak and its bytes (uint8
    planes in, bf16 weights once, fp16 logits and float32 values out)
    over the HBM rate."""
    weights = sum(a.size for a in params.values()) * 2
    nbytes = rows * (8 * 8 * 19 + cfg.policy_size * 2 + 4) + weights
    flops = rows * az_flops_per_row(cfg)
    by_ops = flops / BF16_FLOP_PER_S * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(by_ops, by_bytes), "flops": flops, "bytes": nbytes,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes"}


def bf16_step(torch, magnitude):
    """The spacing of bf16 numbers at ``magnitude`` (a tensor > 0)."""
    return torch.exp2(torch.floor(torch.log2(magnitude)) - 7)


def az_planes(rows: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, (rows, 8, 8, 19)).astype(np.uint8)
    x[..., 17] = rng.integers(0, 101, (rows, 1, 1))
    return x


def az_kernels_per_forward(torch, net, x) -> Optional[float]:
    """Device kernels one forward launches (torch.profiler over 5
    forwards); None when the profiler shows no device events."""
    from fishnet_tpu_torch.models.az import wire_forward

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            wire_forward(net, x)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return kernels / 5 if kernels else None


def az_forward_checks(torch, params, dev) -> dict:
    """Checks 1-2 of the az phase, and the forward's times: the tower on
    the card against the port's CPU forward; each bucket's rows against
    the same rows at capacity, bit for bit, and a repeat call against the
    first; shapes below the ladder's floor reported (the reason for it);
    per bucket the eager forward's time (CUDA events around 20 calls, as
    the plane launches it), its device time (20 replays of a CUDA graph
    of 10 forwards), its kernels and its bound."""
    import numpy as np

    from fishnet_tpu_torch.models.az import params_from_jax, wire_forward
    from fishnet_tpu_torch.search.az_plane import (
        CUDA_MIN_BUCKET,
        _bucket_ladder,
        configure_backends,
    )

    configure_backends(dev)
    net = params_from_jax(params, dev)
    cfg = net.cfg
    x = torch.from_numpy(az_planes(AZ_CAP, seed=1))
    xd = x.to(dev)
    full_l, full_v = wire_forward(net, xd)
    cpu_rows = 256
    ref_l, ref_v = wire_forward(params_from_jax(params), x[:cpu_rows])
    got_l = full_l[:cpu_rows].float().cpu()
    got_v = full_v[:cpu_rows].cpu()
    scale = ref_l.float().abs().max().item()
    tol_l = AZ_STEPS * bf16_step(torch, torch.tensor(scale)).item()
    tol_v = AZ_STEPS * bf16_step(torch, ref_v.abs().clamp(min=1 / 16))
    err_l = (got_l - ref_l.float()).abs().max().item()
    err_v = (got_v - ref_v).abs()
    same = (got_l == ref_l.float()).float().mean().item()
    log(f"  forward, card vs the port's CPU forward ({cpu_rows} rows, "
        f"{cfg}): logits max |err| {err_l} (largest |logit| {scale}, "
        f"tolerance {tol_l}; {same:.4f} of them the same bits, at least "
        f"{AZ_SAME_BITS}), values max |err| {err_v.max().item()} "
        f"(largest |value| {ref_v.abs().max().item()}; tolerance "
        f"{AZ_STEPS} bf16 steps of each)")
    check(err_l <= tol_l and bool((err_v <= tol_v).all())
          and same > AZ_SAME_BITS,
          "the AZ forward on the card disagrees with the CPU forward")
    check(bool(torch.isfinite(full_l.float()).all())
          and bool((full_v.abs() <= 1).all()), "non-finite AZ outputs")
    ladder = _bucket_ladder(AZ_CAP, CUDA_MIN_BUCKET)
    buckets = {}
    order = torch.from_numpy(np.random.default_rng(2).permutation(AZ_CAP)).to(dev)
    for b in sorted(set([32, 64, 128] + ladder)):
        l1, v1 = wire_forward(net, xd[:b].clone())
        l2, v2 = wire_forward(net, xd[:b].clone())
        # The plane compacts misses: rows from anywhere in the batch, in
        # another order, must keep their bits too.
        idx = order[:b]
        lp, vp = wire_forward(net, xd[idx])
        eq = (torch.equal(l1, full_l[:b]) and torch.equal(v1, full_v[:b])
              and torch.equal(lp, full_l[idx]) and torch.equal(vp, full_v[idx]))
        rep = torch.equal(l1, l2) and torch.equal(v1, v2)
        diff = (l1.float() - full_l[:b].float()).abs().max().item()
        xb = xd[:b].clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            wire_forward(net, xb)
        start.record()
        for _ in range(20):
            wire_forward(net, xb)
        end.record()
        end.synchronize()
        eager = start.elapsed_time(end) / 20
        device = graph_time_ms(torch, lambda: wire_forward(net, xb))
        kernels = az_kernels_per_forward(torch, net, xb)
        bnd = az_bound(cfg, b, params)
        buckets[b] = {"in_ladder": b in ladder, "rows_equal_capacity": eq,
                      "repeat_equal": rep, "max_diff_vs_capacity": diff,
                      "eager_ms": eager, "device_ms": device,
                      "kernels": kernels, **bnd}
        log(f"  bucket {b:4d}{'' if b in ladder else ' (below the floor)'}: "
            f"rows (the first {b}, and {b} permuted) == capacity's {eq} "
            f"(max |diff| {diff}), repeat == first "
            f"{rep}; forward {eager:.6f} ms eager, {device:.6f} ms device "
            f"({kernels} kernels), bound {bnd['bound_ms']:.6f} ms "
            f"({bnd['bound_by']}: {bnd['flops']} FLOP, {bnd['bytes']} B)")
        check(rep, f"bucket {b}: a repeat forward gave other bits")
        if b in ladder:
            check(eq, f"bucket {b} of the ladder: rows differ from the "
                      "capacity's (the plane's bit-identity rests on it)")
    return {"cpu_max_abs_err": max(err_l, err_v.max().item()),
            "logit_scale": scale, "logit_same_bits": same,
            "buckets": buckets, "ladder": ladder}


def az_pool_run(params, dev, searches: int, visits: int, seed: int,
                env: Optional[dict] = None, rung=None) -> dict:
    """``searches`` seeded roots at ``visits`` each through one MctsPool
    (capacity AZ_CAP, default MctsConfig) over the shared plane on
    ``dev`` (``rung`` forced, or the ladder's own), from a cold cache,
    ``env`` set for the run. Returns the results, the pool's counters,
    and the host's times: wall, per step the evaluate call (the plane:
    probe, dispatch, wait, read-back) and the rest (collect and apply)."""
    from fishnet_tpu_torch.models.az import AzConfig
    from fishnet_tpu_torch.search.az_plane import AzDispatchPlane
    from fishnet_tpu_torch.search.mcts import MctsConfig, MctsPool

    fresh_cache()
    cfg = MctsConfig(batch_capacity=AZ_CAP, az=AzConfig())
    roots = random_lines(searches, seed)
    with env_vars(**(env or {})):
        plane = (AzDispatchPlane(params, cfg, device=dev, force_rung=rung)
                 if rung is not None else None)
        pool = MctsPool(params, cfg, evaluator=plane, device=dev)
        try:
            pool.warmup()
            ev = pool._evaluator
            real = ev.evaluate
            spent = [0.0]

            def timed(*a, **k):
                t = time.perf_counter()
                try:
                    return real(*a, **k)
                finally:
                    spent[0] += time.perf_counter() - t

            ev.evaluate = timed
            t0 = time.perf_counter()
            sids = [pool.submit(STARTPOS, line, visits) for line in roots]
            steps = 0
            while pool.active() > 0:
                pool.step()
                steps += 1
            wall = time.perf_counter() - t0
            results = []
            for sid in sids:
                r = pool.harvest(sid)
                results.append((r.best_move, r.visits, r.value,
                                tuple(r.root_visits), tuple(r.pv)))
            counters = pool.counters()
        finally:
            pool.close()
            if plane is not None:
                plane.close()
    return {"results": results, "counters": counters, "wall_s": wall,
            "steps": steps, "visits_per_s": counters["visits"] / wall,
            "host_ms_step": (wall - spent[0]) / steps * 1e3,
            "eval_ms_step": spent[0] / steps * 1e3}


def az_parity(params, dev) -> dict:
    """Check 3: plane == the private evaluator on the default ladder and
    each forced rung (cache and speculation on, as by default), a warm
    replay (the same cache, a fresh pool and plane) == cold with pre-wire
    hits, and speculation off == on."""
    searches, visits = AZ_PARITY
    hatch = az_pool_run(params, dev, searches, visits, seed=31,
                        env={"FISHNET_NO_SHARED_AZ_PLANE": "1"})
    check("dispatch" not in hatch["counters"], "the hatch used the plane")
    runs = {"hatch": hatch}
    for rung in (None, 0, 1, 2):
        run = az_pool_run(params, dev, searches, visits, seed=31, rung=rung)
        d = run["counters"]["dispatch"]
        name = f"rung {rung if rung is not None else 'default'}"
        log(f"  {name}: == hatch {run['results'] == hatch['results']}; "
            f"{d['dispatches']} dispatches, {d['forwards']} forwards "
            f"{d['bucket_forwards']}, {d['spec_rows']} speculative rows, "
            f"{d['prewire_hits']} pre-wire hits")
        check(run["results"] == hatch["results"],
              f"{name}: the plane's trees differ from the hatch's")
        runs[name] = run
    check(runs["rung default"]["counters"]["dispatch"]["spec_rows"] > 0,
          "no speculative pad row in the default parity run")
    # Warm replay: a fresh pool and plane on the cache the cold run left.
    from fishnet_tpu_torch.models.az import AzConfig
    from fishnet_tpu_torch.search.mcts import MctsConfig, MctsPool

    cold = az_pool_run(params, dev, searches, visits, seed=31)
    cfg = MctsConfig(batch_capacity=AZ_CAP, az=AzConfig())
    pool = MctsPool(params, cfg, device=dev)
    try:
        sids = [pool.submit(STARTPOS, line, visits)
                for line in random_lines(searches, 31)]
        while pool.active() > 0:
            pool.step()
        warm = [(r.best_move, r.visits, r.value, tuple(r.root_visits),
                 tuple(r.pv)) for r in map(pool.harvest, sids)]
        warm_c = pool.counters()["dispatch"]
    finally:
        pool.close()
    log(f"  warm replay: == cold {warm == cold['results']}; pre-wire hits "
        f"{warm_c['prewire_hits']}, skipped dispatches "
        f"{warm_c['skipped_dispatches']}, rows dispatched "
        f"{warm_c['rows_dispatched']} (cold "
        f"{cold['counters']['dispatch']['rows_dispatched']})")
    check(warm == cold["results"], "the warm replay's trees differ from cold")
    check(warm_c["prewire_hits"] > 0, "the warm replay had no pre-wire hit")
    off = az_pool_run(params, dev, searches, visits, seed=31,
                      env={"FISHNET_NO_SPECULATION": "1"})
    log(f"  speculation off: == on {off['results'] == cold['results']}, "
        f"{off['counters']['dispatch']['spec_rows']} speculative rows")
    check(off["results"] == cold["results"]
          and off["counters"]["dispatch"]["spec_rows"] == 0,
          "speculation changed the trees, or ran with the hatch set")
    return {"warm_prewire_hits": warm_c["prewire_hits"],
            "spec_rows": cold["counters"]["dispatch"]["spec_rows"]}


def drive_in_lockstep(pools, lines, visits):
    """Each pool on its own thread over its own roots (move lists from
    the start position), their evaluator calls met at a barrier (so
    every lane's microbatch reaches the plane together) until the first
    pool finishes. Returns each pool's results."""
    barrier = threading.Barrier(len(pools))
    for pool in pools:
        ev = pool._evaluator
        real = ev.evaluate

        def evaluate(*a, _real=real, **k):
            try:
                barrier.wait(timeout=120)
            except threading.BrokenBarrierError:
                pass
            return _real(*a, **k)

        ev.evaluate = evaluate
    out, errors = [None] * len(pools), []

    def drive(i):
        pool = pools[i]
        try:
            sids = [pool.submit(STARTPOS, line, visits) for line in lines[i]]
            while pool.active() > 0:
                pool.step()
            out[i] = [(r.best_move, r.visits, r.value, tuple(r.root_visits),
                       tuple(r.pv)) for r in map(pool.harvest, sids)]
        except BaseException as err:  # noqa: BLE001 - raised below
            errors.append(err)
        finally:
            barrier.abort()  # the other pools step on alone

    threads = [threading.Thread(target=drive, args=(i,))
               for i in range(len(pools))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def az_two_lanes(params, dev) -> dict:
    """Check 3, fused: the parity roots split between two pools, each on
    its own driver thread and lane of ONE plane (width 2, lingering for
    the sibling lane), on each forced rung; each pool's trees == the
    private evaluator's for its half, and the plane fused lanes."""
    from fishnet_tpu_torch.models.az import AzConfig
    from fishnet_tpu_torch.search.az_plane import AZ_RUNGS, AzDispatchPlane
    from fishnet_tpu_torch.search.mcts import MctsConfig, MctsPool

    searches, visits = AZ_PARITY
    roots = random_lines(searches, 31)
    halves = [roots[:searches // 2], roots[searches // 2:]]
    cfg = MctsConfig(batch_capacity=AZ_CAP, az=AzConfig())
    hatch = []
    with env_vars(FISHNET_NO_SHARED_AZ_PLANE="1"):
        for half in halves:
            fresh_cache()
            pool = MctsPool(params, cfg, device=dev)
            try:
                hatch.extend(drive_in_lockstep([pool], [half], visits))
            finally:
                pool.close()
    out = {}
    for rung in (0, 1, 2):
        fresh_cache()
        plane = AzDispatchPlane(params, cfg, device=dev, coalesce_width=2,
                                force_rung=rung)
        pools = [MctsPool(params, cfg, evaluator=plane, device=dev)
                 for _ in halves]
        try:
            got = drive_in_lockstep(pools, halves, visits)
            d = plane.counters()
        finally:
            for pool in pools:
                pool.close()
            plane.close()
        log(f"  two pools on one plane, rung {rung}: == hatch "
            f"{got == hatch}; {d['dispatches']} dispatches, "
            f"{d['fused_dispatches']} fused, {d['forwards']} forwards "
            f"{d['bucket_forwards']}")
        check(got == hatch, f"two lanes, rung {rung}: a pool's trees differ "
                            "from the hatch's")
        check(d["fused_dispatches"] > 0 and d["rung"] == AZ_RUNGS[rung],
              f"two lanes, rung {rung}: no fused dispatch ({d})")
        out[rung] = {k: d[k] for k in ("dispatches", "fused_dispatches",
                                       "forwards")}
    return out


def az_burst(params, dev) -> list:
    """Check and numbers 4: the burst with the cache off (A), then on
    (B; cut from A, B, B, A so the default run keeps its time); both give
    the same trees (the cache is exact) and one forward per dispatch on
    the fused rung."""
    searches, visits = AZ_BURST
    runs, first = [], None
    for label in ("A", "B"):
        env = {"FISHNET_NO_EVAL_CACHE": "1" if label == "A" else None}
        run = az_pool_run(params, dev, searches, visits, seed=41, env=env)
        c, d = run["counters"], run["counters"]["dispatch"]
        first = first or run["results"]
        check(run["results"] == first, f"burst {label}: the trees differ "
                                       "from the first run's")
        check(d["forwards"] == d["dispatches"] and d["rung"] == "fused",
              f"burst {label}: {d['forwards']} forwards for "
              f"{d['dispatches']} dispatches on rung {d['rung']}")
        row = {"cache": label == "B", "visits": c["visits"],
               "wall_s": run["wall_s"], "visits_per_s": run["visits_per_s"],
               "steps": run["steps"], "dispatches": d["dispatches"],
               "fused_dispatches": d["fused_dispatches"],
               "records_per_dispatch": (run["steps"] - d["skipped_dispatches"])
               / max(1, d["dispatches"]),
               "rows_over_slots": d["dispatch_fill"],
               "bucket_forwards": d["bucket_forwards"],
               "prewire_hits": d["prewire_hits"],
               "skipped_dispatches": d["skipped_dispatches"],
               "spec_rows": d["spec_rows"], "memo_hits": c["memo_hits"],
               "collisions": c["collisions"],
               "host_ms_step": run["host_ms_step"],
               "eval_ms_step": run["eval_ms_step"]}
        log(f"  burst {label} (cache {'on' if row['cache'] else 'off'}): "
            f"{c['visits']} visits in {run['wall_s']:.3f} s = "
            f"{run['visits_per_s']:.1f} visits/s; {run['steps']} steps, "
            f"{d['dispatches']} dispatches ({d['fused_dispatches']} fused), "
            f"{row['records_per_dispatch']:.3f} records a dispatch, rows over "
            f"slots {d['dispatch_fill']:.4f}, forwards by bucket "
            f"{d['bucket_forwards']}; pre-wire hits {d['prewire_hits']} "
            f"({d['skipped_dispatches']} dispatches skipped), speculative "
            f"rows {d['spec_rows']}, memo hits {c['memo_hits']}; per step: "
            f"host {run['host_ms_step']:.3f} ms (collect and apply), "
            f"evaluate {run['eval_ms_step']:.3f} ms")
        runs.append(row)
    return runs


def az_run_workload(dev) -> dict:
    """Check 5: ``python -m fishnet_tpu_torch run --engine az-mcts``'s
    path in process — the engine factory the CLI builds (dev-mode net,
    microbatch 1024, on the card) and the port's Client — against the
    stdlib fake lichess: 4 games of 40 plies at 200 visits a position
    (nodes = visits x 1024, the engine's scale), a move job with a
    clock, and a variant game that must go to the scalar tier. The
    FT-gather kernel must not launch (no NNUE work on the card)."""
    from fishnet_tpu_torch.__main__ import build_engine_factory
    from fishnet_tpu_torch.client import Client
    from fishnet_tpu_torch.configure import parse_and_configure
    from fishnet_tpu_torch.engine.az_engine import NODES_PER_VISIT
    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.utils.logger import Logger

    fresh_cache()
    logger = Logger(verbose=0)
    opt = parse_and_configure(["run", "--no-conf", "--no-stats-file",
                               "--engine", "az-mcts", "--microbatch",
                               str(AZ_CAP)])
    factory = build_engine_factory(opt, logger)
    service = factory.service
    with FakeServer() as server:
        lichess = server.lichess
        analysis_ids, move_ids = add_run_jobs(
            lichess, 4, 1, seed=43, nodes=200 * NODES_PER_VISIT)
        variant = lichess.add_analysis_job(moves="e2e4 e7e5 g1f3",
                                           variant="kingofthehill", nodes=2000)
        client = Client(endpoint=server.endpoint, key=VALID_KEY,
                        cores=opt.resolved_cores(), engine_factory=factory,
                        logger=logger, max_backoff=1.0,
                        workers=opt.resolved_workers())
        try:
            # One search waits out the driver thread's warm-up (every
            # bucket's shape once), as the first job would.
            asyncio.run(service.search(STARTPOS, [], 8))
            ft_gather.ft_accumulate_packed_cuda.launches = 0
            ft_gather.ft_accumulate_cuda.launches = 0
            c0 = service.pool_counters()
            t0 = time.perf_counter()
            asyncio.run(drive_client(client, lichess,
                                     analysis_ids + move_ids + [variant], 600))
            wall = time.perf_counter() - t0
            c1 = service.pool_counters()
            fallback = factory.variant_fallback.service.counters()
            launches = (ft_gather.ft_accumulate_packed_cuda.launches
                        + ft_gather.ft_accumulate_cuda.launches)
        finally:
            factory.close()
    report = run_report(lichess, analysis_ids, move_ids, "az run")
    check(lichess.analyses[variant]["stockfish"]["flavor"] == "classical",
          "the variant job did not go to the scalar tier")
    check(fallback["eval_steps"] == 0 and launches == 0,
          f"the az run touched the NNUE device path ({launches} launches)")
    visits = c1["visits"] - c0["visits"]
    d0, d1 = c0["dispatch"], c1["dispatch"]
    report.update(visits=visits, visits_per_s=visits / wall,
                  dispatches=d1["dispatches"] - d0["dispatches"],
                  forwards=d1["forwards"] - d0["forwards"],
                  prewire_hits=d1["prewire_hits"] - d0["prewire_hits"])
    log(f"  az run: {visits} visits in {wall:.3f} s = "
        f"{visits / wall:.1f} visits/s; {report['dispatches']} dispatches, "
        f"{report['forwards']} forwards, {report['prewire_hits']} pre-wire "
        f"hits; the variant game on the scalar tier, no NNUE launch")
    check(report["forwards"] == report["dispatches"] > 0,
          "az run: forwards != dispatches")
    return report


def phase_az(torch, dev) -> dict:
    """The az phase: checks 1-5 of the AZ family on the card."""
    params = az_params()
    t0 = time.perf_counter()
    forward = az_forward_checks(torch, params, dev)
    log(f"  [az] forward checks in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parity = az_parity(params, dev)
    log(f"  [az] parity in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lanes = az_two_lanes(params, dev)
    log(f"  [az] two lanes in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    burst = az_burst(params, dev)
    log(f"  [az] burst in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run = az_run_workload(dev)
    log(f"  [az] run in {time.perf_counter() - t0:.1f} s")
    return {"forward": forward, "parity": parity, "lanes": lanes,
            "burst": burst,
            "run": {k: v for k, v in run.items() if k != "move_s"}}


#: The train phase (the NNUE and AZ trainers, labels, self-play, the
#: split plane's AZ half, checkpoints) at full width.
TRAIN_LABELS = (32, 60, 512, 400)  # playout games, plies, positions, nodes
TRAIN_SERVICE = dict(pool_slots=512, batch_capacity=1024, pipeline_depth=2,
                     tt_bytes=64 << 20)
TRAIN_STEPS = 20
#: nnue-pytorch's default --batch-size, and the CLI's AZ microbatch.
TRAIN_NNUE_BATCH = 16384
TRAIN_AZ_ROWS = 1024
TRAIN_SELFPLAY = (16, 64, 40)  # games, visits, max plies
TRAIN_SPLIT_SELFPLAY = (4, 32, 20)
TRAIN_SPLIT_SEED = 5  # the host's --az-seed
TRAIN_RESUME = (2, 4)  # checkpoint at step 2, compare at step 4
#: The CPU's intra-op threads for the phase's CPU references.
TRAIN_CPU_THREADS = 4
#: Step 1 on the card against the CPU, from the same params and batch:
#: the loss within 2**-7 of its magnitude (AZ, bf16) or rtol 1e-4 (NNUE,
#: float32); each parameter's gradient within TRAIN_GRAD_TOL (AZ) or
#: 1e-4 (NNUE) of its norm; the parameters after the step within rtol
#: 2e-4, atol 2e-6 (the CPU tests' bound), except for at most
#: TRAIN_OFF_SHARE of a parameter's entries: Adam's first update is
#: lr x g / (|g| + eps), so an entry whose gradient is rounding noise
#: (another sign, or |g| near eps) moves by up to 2 x lr.
TRAIN_GRAD_TOL = 0.05
TRAIN_OFF_SHARE = 0.05


def train_synthetic_nnue(rows: int, seed: int) -> dict:
    """A seeded full-spec NNUE batch: 20-32 live features a perspective."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec

    rng = np.random.default_rng(seed)
    idx = np.full((rows, 2, 32), spec.NUM_FEATURES, np.int32)
    live = rng.integers(20, 33, rows)
    feats = rng.integers(0, spec.NUM_FEATURES, (rows, 2, 32), dtype=np.int32)
    mask = np.broadcast_to(np.arange(32)[None, None, :] < live[:, None, None],
                           idx.shape)
    idx[mask] = feats[mask]
    return {"indices": idx,
            "buckets": rng.integers(0, 8, rows).astype(np.int32),
            "score_cp": rng.normal(0, 300, rows).astype(np.float32),
            "outcome": rng.choice([0.0, 0.5, 1.0], rows).astype(np.float32)}


def train_synthetic_az(rows: int, seed: int) -> dict:
    """A seeded AZ batch: 0/1 planes (clock plane in [0, 1]), visit
    targets on 8 moves a row, values in [-1, 1]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 2, (rows, 8, 8, 19)).astype(np.float32)
    planes[..., 17] = rng.integers(0, 101, (rows, 1, 1)) / 100.0
    pol = np.zeros((rows, 4672), np.float32)
    for r in range(rows):
        w = rng.random(8).astype(np.float32)
        pol[r, rng.choice(4672, 8, replace=False)] = w / w.sum()
    return {"planes": planes, "policy_target": pol,
            "value_target": rng.uniform(-1, 1, rows).astype(np.float32)}


def cuda_ms(torch, fn, reps: int) -> float:
    """Wall time of one ``fn()`` on the card: CUDA events around ``reps``
    calls after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def step_profile(torch, fn, steps: int = 5) -> Optional[dict]:
    """Where a training step's time goes: torch.profiler over ``steps``
    calls of ``fn`` (one step each): device ms and kernels a step, the
    device's busy share of the profiled wall time (the profiler's own
    host cost included), and the six kernels with the most device time.
    None when the profiler shows no device events."""
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    total = sum(device_us(e) for e in kernels)
    top = sorted(kernels, key=device_us, reverse=True)[:6]
    return {"device_ms": total / 1e3 / steps,
            "kernels": sum(e.count for e in kernels) / steps,
            "profiled_wall_ms": wall * 1e3 / steps,
            "busy_share": total / 1e6 / wall,
            "top_ms": {e.key[:80]: device_us(e) / 1e3 / steps for e in top}}


def state_tensors(state) -> dict:
    """Every tensor of a train state on the host: the parameters by name
    and the optimizer's state by (parameter index, key)."""
    out = {f"param {n}": p.detach().cpu().clone()
           for n, p in state.params.named_parameters()}
    for i, s in state.opt_state.state_dict()["state"].items():
        for k, v in s.items():
            if hasattr(v, "cpu"):
                out[f"opt {i} {k}"] = v.detach().cpu().clone()
    return out


def max_tensor_diff(a: dict, b: dict) -> float:
    check(a.keys() == b.keys(), "train states with other tensors")
    return max(float((a[k].double() - b[k].double()).abs().max())
               if a[k].numel() else 0.0 for k in a)


def step_vs_cpu(torch, trainer_cls, cfg, params, batch, dev, loss_tol,
                grad_tol, what: str) -> dict:
    """Step 1 from the same carried ``params`` on the card and on the CPU,
    held to the tolerances above TRAIN_GRAD_TOL. Returns the numbers and
    the card's trainer and state."""
    threads = torch.get_num_threads()
    torch.set_num_threads(TRAIN_CPU_THREADS)
    try:
        cpu_t = trainer_cls(cfg, device="cpu")
        cpu_s, cpu_m = cpu_t.step(cpu_t.init(params=params), batch)
    finally:
        torch.set_num_threads(threads)
    card_t = trainer_cls(cfg, device=dev)
    card_s, card_m = card_t.step(card_t.init(params=params), batch)
    lr = card_s.opt_state.param_groups[0]["lr"]
    metric_diff = {k: abs(card_m[k] - v) for k, v in cpu_m.items()}
    check(metric_diff["loss"] <= loss_tol * max(1.0, abs(cpu_m["loss"])),
          f"{what}: step 1's loss on the card {card_m['loss']} against the "
          f"CPU's {cpu_m['loss']}")
    cpu_p = dict(cpu_s.params.named_parameters())
    grads, off, worst = {}, {}, 0.0
    for name, p in card_s.params.named_parameters():
        g_card, g_cpu = p.grad.double().cpu(), cpu_p[name].grad.double()
        grads[name] = float((g_card - g_cpu).norm()
                            / g_cpu.norm().clamp(min=1e-30))
        got, want = p.detach().cpu(), cpu_p[name].detach()
        diff = (got - want).abs()
        outside = diff > 2e-6 + 2e-4 * want.abs()
        off[name] = float(outside.float().mean())
        worst = max(worst, float(diff.max()))
        check(grads[name] <= grad_tol, f"{what}: step 1's {name} gradient on "
              f"the card is {grads[name]} of its norm off the CPU's")
    log(f"  {what}: step 1 card vs CPU: metrics |diff| {metric_diff}; "
        f"gradients, |diff| / |cpu| by parameter: largest {max(grads.values())}"
        f" ({max(grads, key=grads.get)}); parameters max |diff| {worst} (2 x "
        f"lr = {2 * lr}), entries off rtol 2e-4 / atol 2e-6: largest share "
        f"{max(off.values()):.6f} ({max(off, key=off.get)})")
    check(worst <= 2 * lr * (1 + 1e-3) and max(off.values()) <= TRAIN_OFF_SHARE,
          f"{what}: step 1's parameters on the card are off the CPU's")
    return {"metric_diff": metric_diff, "grad_rel": grads,
            "param_max_diff": worst, "off_share": max(off.values()),
            "state": card_s, "trainer": card_t, "card_loss": card_m["loss"]}


def resume_checks(torch, make_trainer, params, batch, dev, tmp: str,
                  what: str) -> dict:
    """Checkpoints: save -> restore reproduces every tensor bit for bit
    (on the card); resuming at TRAIN_RESUME's first step and running to
    its second equals the uninterrupted run on the CPU bit for bit, and
    on the card bit
    for bit or within the spread of two uninterrupted runs from the same
    state (at most twice it)."""
    from fishnet_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    mid, end = TRAIN_RESUME

    def run(device, steps, state=None):
        trainer = make_trainer(device)
        state = trainer.init(params=params) if state is None else state
        for _ in range(steps):
            state, _ = trainer.step(state, batch)
        return trainer, state

    def resumed(device, tag):
        trainer, state = run(device, mid)
        path = os.path.join(tmp, f"{what}-{tag}.pt")
        save_checkpoint(path, state)
        before = state_tensors(state)
        restored = restore_checkpoint(path, trainer.init(params=params))
        check(restored.step == mid
              and max_tensor_diff(before, state_tensors(restored)) == 0.0
              and all(p.device.type == torch.device(device).type
                      for p in restored.params.parameters()),
              f"{what}: a checkpoint round trip on {tag} changed a tensor")
        return state_tensors(run(device, end - mid, restored)[1])

    threads = torch.get_num_threads()
    torch.set_num_threads(TRAIN_CPU_THREADS)
    try:
        cpu_ref = state_tensors(run("cpu", end)[1])
        cpu_res = resumed("cpu", "cpu")
    finally:
        torch.set_num_threads(threads)
    cpu_diff = max_tensor_diff(cpu_ref, cpu_res)
    card_a = state_tensors(run(dev, end)[1])
    card_b = state_tensors(run(dev, end)[1])
    card_res = resumed(dev, "card")
    spread = max_tensor_diff(card_a, card_b)
    card_diff = max_tensor_diff(card_a, card_res)
    log(f"  {what}: resume at {mid} to {end} vs uninterrupted: CPU max "
        f"|diff| {cpu_diff}; card {card_diff}, two uninterrupted card runs "
        f"{spread} ({'deterministic' if spread == 0 else 'not deterministic'})")
    check(cpu_diff == 0.0, f"{what}: the resumed CPU run differs")
    check(card_diff <= 2 * spread, f"{what}: the resumed card run differs by "
                                   f"{card_diff}, beyond the spread {spread}")
    return {"cpu_diff": cpu_diff, "card_diff": card_diff, "spread": spread}


def label_run(torch, where, positions, nodes: int) -> tuple:
    """``positions`` labelled at ``nodes`` through a ``gated_service`` on
    ``where`` (TRAIN_SERVICE, bounds tier off, a cold cache), its
    warm-up's launch before the count. Returns the batch, the service's
    counters, the seconds and the packed and dense launches."""
    from fishnet_tpu_torch.nnue.weights import NnueWeights
    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.search.service import SearchService

    fresh_cache()
    with env_vars(FISHNET_NO_BOUNDS="1"):
        svc = gated_service(NnueWeights.random(seed=0), where, **TRAIN_SERVICE)
    try:
        SearchService.warmup(svc)
        ft_gather.ft_accumulate_packed_cuda.launches = 0
        ft_gather.ft_accumulate_cuda.launches = 0
        t0 = time.perf_counter()
        batch = gated_labels(svc, positions, nodes)
        wall = time.perf_counter() - t0
        return (batch, svc.counters(), wall,
                ft_gather.ft_accumulate_packed_cuda.launches,
                ft_gather.ft_accumulate_cuda.launches)
    finally:
        svc.close()


def label_positions_of_phase(games: int, plies: int, count: int):
    """The first ``count`` positions of ``games`` seeded playouts."""
    from fishnet_tpu_torch.train.data import playout_positions

    positions = playout_positions(n_games=games, max_plies=plies, seed=7)[:count]
    check(len(positions) == count, f"labels: {len(positions)} positions")
    return positions


def train_cpu_labels_child(argv) -> int:
    """The labels' CPU reference, in a process of its own so it runs
    beside the card's work: the positions of ``argv[1]`` (JSON: the
    parent's TRAIN_LABELS, TRAIN_SERVICE and TRAIN_CPU_THREADS) through
    the CPU plain service, the batch saved to ``argv[0]`` (npz) with its
    seconds."""
    import numpy as np
    import torch

    global TRAIN_SERVICE
    labels, TRAIN_SERVICE, threads = json.loads(argv[1])
    torch.set_num_threads(threads)
    batch, _c, wall, _p, _d = label_run(
        torch, "cpu", label_positions_of_phase(*labels[:3]), labels[3])
    np.savez(argv[0], seconds=np.float64(wall), **batch)
    return 0


def train_labels(torch, dev) -> dict:
    """Check 1, the card's half: the teacher labels of seeded playout
    positions through a SearchService on the card (the hand kernel, one
    packed launch per device dispatch). ``train_labels_equal`` holds them
    against the CPU plain service's."""
    nodes = TRAIN_LABELS[3]
    batch, counters, wall, packed, dense = label_run(
        torch, dev, label_positions_of_phase(*TRAIN_LABELS[:3]), nodes)
    rate = len(batch["indices"]) / wall
    log(f"  labels: {len(batch['indices'])} positions x {nodes} nodes on the "
        f"card in {wall:.3f} s = {rate:.1f} positions/s ({counters['nodes']} "
        f"nodes); {counters['dispatches']} dispatches, {packed} packed "
        f"launches, {dense} dense")
    check(packed == counters["dispatches"] > 0 and dense == 0,
          f"labels: {packed} packed launches for {counters['dispatches']} "
          "dispatches")
    check(len(batch["indices"]) == TRAIN_LABELS[2],
          "labels: a position lost its label")
    return {"batch": batch, "positions_per_s": rate, "seconds": wall,
            "nodes": counters["nodes"], "dispatches": counters["dispatches"],
            "launches": packed}


def train_labels_equal(labels: dict, child, path: str) -> float:
    """Check 1, the CPU's half: the CPU child's batch == the card's, bit
    for bit. Returns the child's seconds."""
    import numpy as np

    check(child.wait(timeout=600) == 0, "labels: the CPU reference failed")
    ref = np.load(path)
    batch = labels["batch"]
    same = all(np.array_equal(batch[k], ref[k]) and batch[k].dtype == ref[k].dtype
               for k in batch)
    log(f"  labels: the card's batch == the CPU plain service's {same} (CPU "
        f"{float(ref['seconds']):.3f} s, beside the card's work)")
    check(same, "labels: the card's batch differs from the CPU's")
    return float(ref["seconds"])


def train_export_kernel(torch, weights, batch, dev) -> dict:
    """The exported net on the serving path: the kernel's dense mode
    (with fused PSQT, as ``evaluate_batch`` calls it) on the labelled
    positions equals its plain version on CPU copies, accumulators and
    values; timed as the split phase times host batches. Returns the
    kernel entry's numbers and the card's integer values."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec
    from fishnet_tpu_torch.nnue.torch_eval import evaluate_batch, params_from_weights
    from fishnet_tpu_torch.ops import ft_gather

    params = params_from_weights(weights, dev)
    cpu = params_from_weights(weights, "cpu")
    idx_np = batch["indices"]
    idx_h = torch.from_numpy(idx_np)
    bk_h = torch.from_numpy(batch["buckets"])
    idx, bk = idx_h.to(dev), bk_h.to(dev)
    w, b, psqt = params["ft_w"], params["ft_b"], params["ft_psqt"]
    launches0 = ft_gather.ft_accumulate_cuda.launches
    acc, ps = ft_gather.ft_accumulate_cuda(w, b, idx, ft_psqt=psqt)
    values = evaluate_batch(params, idx, bk).cpu()
    launches = ft_gather.ft_accumulate_cuda.launches - launches0
    ref_acc, ref_ps = ft_gather.ft_accumulate_plain(
        cpu["ft_w"], cpu["ft_b"], idx_h, ft_psqt=cpu["ft_psqt"])
    ref_values = evaluate_batch(cpu, idx_h, bk_h)
    diff = max(max_diff([acc.cpu(), ps.cpu()], [ref_acc, ref_ps]),
               max_diff([values], [ref_values]))
    check(launches == 2, f"export: {launches} dense launches for 2 calls")
    check(diff == 0, f"export: the kernel on the exported net != plain ({diff})")
    ms = graph_time_ms(torch, lambda: ft_gather.ft_accumulate_cuda(
        w, b, idx, ft_psqt=psqt))
    plain_ms = graph_time_ms(torch, lambda: ft_gather.ft_accumulate_plain(
        w, b, idx, ft_psqt=psqt))
    parent_np = np.full(len(idx_np), -1, np.int32)
    bound_ms, bound_by, nbytes, ops = bound(idx_np, parent_np, False, True,
                                            spec.L1)
    flat, w_f = idx.view(-1, 32).long(), w.float()
    # embedding_bag sums the same rows (the sentinel rows excluded by a
    # zero per-sample weight), without PSQT: the library's yardstick.
    live = (flat < spec.NUM_FEATURES).float()
    safe = flat.clamp(max=spec.NUM_FEATURES - 1)
    lib = torch.nn.functional.embedding_bag(safe, w_f, mode="sum",
                                            per_sample_weights=live)
    check(torch.equal(lib.view(len(idx_np), 2, -1).to(torch.int32)
                      + b.to(torch.int32), acc),
          "export: embedding_bag does not compute the same sums")
    library_ms = graph_time_ms(torch, lambda: torch.nn.functional.embedding_bag(
        safe, w_f, mode="sum", per_sample_weights=live))
    entry = {"entries": len(idx_np), "max_abs_err": diff, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "bound_bytes": nbytes, "bound_ops": ops, "library_ms": library_ms}
    log(f"  export: the kernel (dense, fused PSQT) on the exported net == "
        f"plain on {len(idx_np)} labelled positions: {entry}")
    return {"entry": entry, "values": values}


def train_nnue(torch, labels: dict, dev, tmp: str) -> dict:
    """Check 2: the NNUE trainer at full spec on the labelled batch: step
    1 on the card == the CPU's within tolerance, 20 steps with the loss
    falling, the step timed at B = TRAIN_NNUE_BATCH, the export served by
    the kernel bit for bit against its plain version and tracking the
    float forward, and the checkpoints."""
    import numpy as np

    from fishnet_tpu_torch.train import NetConfig, Trainer
    from fishnet_tpu_torch.train.model import NNUE2SCORE, forward, init_params

    cfg = NetConfig()
    params = init_params(0, cfg)
    batch = labels["batch"]
    first = step_vs_cpu(torch, Trainer, cfg, params, batch, dev, 1e-4, 1e-4,
                        "nnue")
    trainer, state = first["trainer"], first["state"]
    losses = [first["card_loss"]]
    for _ in range(TRAIN_STEPS - 1):
        state, metrics = trainer.step(state, batch)
        losses.append(metrics["loss"])
    log(f"  nnue: {TRAIN_STEPS} steps on {len(batch['indices'])} labelled "
        f"positions, loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    check(losses[-1] < losses[0] and all(np.isfinite(losses)),
          "nnue: the loss did not fall")
    weights = trainer.export(state)
    export = train_export_kernel(torch, weights, batch, dev)
    with torch.no_grad():
        float_cp = (forward(state.params, torch.from_numpy(batch["indices"]).to(dev),
                            torch.from_numpy(batch["buckets"]).to(dev), cfg)
                    * NNUE2SCORE).cpu().numpy()
    int_cp = export["values"].numpy().astype(np.float64)
    err = np.abs(float_cp - int_cp)
    corr = float(np.corrcoef(float_cp, int_cp)[0, 1])
    slope = float(np.polyfit(float_cp, int_cp, 1)[0])
    log(f"  nnue: exported net, integer eval vs float forward x 600 on the "
        f"labelled positions: slope {slope:.4f} (0.8-1.25), corr {corr:.6f} "
        f"(> 0.95), mean |err| {err.mean():.3f} cp (<= 60)")
    check(0.8 <= slope <= 1.25 and corr > 0.95 and err.mean() <= 60.0,
          "nnue: the quantized net does not track the float forward")

    big = train_synthetic_nnue(TRAIN_NNUE_BATCH, seed=3)
    timed = trainer.init(params=params)
    data = {k: torch.from_numpy(v).to(dev) for k, v in big.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    holder = [timed]

    def one():
        holder[0], _ = trainer.step(holder[0], data)

    ms = cuda_ms(torch, one, reps=10)
    peak = torch.cuda.max_memory_allocated(dev)
    prof = step_profile(torch, one)
    log(f"  nnue: step at B = {TRAIN_NNUE_BATCH}: {ms:.3f} ms "
        f"({TRAIN_NNUE_BATCH / ms * 1e3:.0f} positions/s), peak memory "
        f"{peak / 2**30:.3f} GiB; profiled: {prof}")
    resume = resume_checks(torch, lambda d: Trainer(cfg, device=d), params,
                           batch, dev, tmp, "nnue")
    return {"losses": losses, "step1": {k: first[k] for k in (
        "metric_diff", "grad_rel", "param_max_diff", "off_share")},
        "export": export["entry"], "float_vs_int": {
            "slope": slope, "corr": corr, "mean_err_cp": float(err.mean())},
        "step_ms": ms, "positions_per_s": TRAIN_NNUE_BATCH / ms * 1e3,
        "peak_bytes": peak, "profile": prof, "resume": resume}


def train_pool(params, dev, cap: int = AZ_CAP):
    """An MctsPool over the shared AZ plane on ``dev`` (default AzConfig),
    warmed up."""
    from fishnet_tpu_torch.models.az import AzConfig
    from fishnet_tpu_torch.search.mcts import MctsConfig, MctsPool

    pool = MctsPool(params, MctsConfig(batch_capacity=cap, az=AzConfig()),
                    device=dev)
    pool.warmup()
    return pool


def train_selfplay(dev) -> dict:
    """Check 3a: a generation of self-play over the shared plane on the
    card at the default AzConfig and microbatch 1024: games, rows,
    visits/s."""
    import numpy as np

    from fishnet_tpu_torch.train.selfplay import SelfPlayConfig, selfplay_batch

    games, visits, plies = TRAIN_SELFPLAY
    fresh_cache()
    pool = train_pool(az_params(), dev)
    try:
        t0 = time.perf_counter()
        batch = selfplay_batch(pool, SelfPlayConfig(
            games=games, visits=visits, max_plies=plies), seed=11)
        wall = time.perf_counter() - t0
        c = pool.counters()
    finally:
        pool.close()
    rows = len(batch["planes"])
    d = c["dispatch"]
    log(f"  self-play: {games} games x {visits} visits (<= {plies} plies) in "
        f"{wall:.3f} s: {rows} rows, {c['visits']} visits = "
        f"{c['visits'] / wall:.1f} visits/s; {d['dispatches']} dispatches, "
        f"{d['forwards']} forwards, rows over slots {d['dispatch_fill']:.4f}")
    check(0 < rows <= games * plies
          and np.allclose(batch["policy_target"].sum(1), 1.0, atol=1e-5)
          and set(np.unique(batch["value_target"])) <= {-1.0, 0.0, 1.0},
          "self-play: a malformed batch")
    return {"batch": batch, "rows": rows, "games": games,
            "visits": c["visits"], "seconds": wall,
            "visits_per_s": c["visits"] / wall, "dispatches": d["dispatches"]}


def train_az(torch, batch: dict, dev, tmp: str) -> dict:
    """Check 3b: the AZ trainer at the default AzConfig on the self-play
    batch: step 1 on the card == the CPU's within the bf16 tolerance, 20
    steps with the loss falling, the export reloaded through the JAX
    layout equal to the trained net bit for bit with an equal
    fingerprint, the step timed at TRAIN_AZ_ROWS rows, and the
    checkpoints."""
    import numpy as np

    from fishnet_tpu_torch.models.az import (
        AzConfig,
        jax_layout,
        load_az_params,
        params_from_jax,
        wire_forward,
    )
    from fishnet_tpu_torch.search.eval_cache import az_net_fingerprint
    from fishnet_tpu_torch.train import AzTrainer

    cfg = AzConfig()
    params = az_params()
    first = step_vs_cpu(torch, AzTrainer, cfg, params, batch, dev, 2.0 ** -7,
                        TRAIN_GRAD_TOL, "az")
    trainer, state = first["trainer"], first["state"]
    losses = [first["card_loss"]]
    for _ in range(TRAIN_STEPS - 1):
        state, metrics = trainer.step(state, batch)
        losses.append(metrics["loss"])
    log(f"  az: {TRAIN_STEPS} steps on {len(batch['planes'])} self-play rows, "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    check(losses[-1] < losses[0] and all(np.isfinite(losses)),
          "az: the loss did not fall")
    path = os.path.join(tmp, "az.npz")
    trainer.export(state, path)
    loaded = load_az_params(path)
    reloaded = params_from_jax(loaded, dev)
    x = torch.from_numpy(az_planes(AZ_CAP, seed=5)).to(dev)
    got, want = wire_forward(reloaded, x), wire_forward(state.params, x)
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    fp = az_net_fingerprint(loaded) == az_net_fingerprint(jax_layout(state.params))
    log(f"  az: export .npz -> load_az_params -> params_from_jax: forward "
        f"== the trained net's {same}, fingerprint equal {fp}")
    check(same and fp, "az: the exported net is not the trained net")

    big = train_synthetic_az(TRAIN_AZ_ROWS, seed=6)
    data = {k: torch.from_numpy(v).to(dev) for k, v in big.items()}
    holder = [trainer.init(params=params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def one():
        holder[0], _ = trainer.step(holder[0], data)

    ms = cuda_ms(torch, one, reps=10)
    peak = torch.cuda.max_memory_allocated(dev)
    prof = step_profile(torch, one)
    log(f"  az: step at {TRAIN_AZ_ROWS} rows: {ms:.3f} ms "
        f"({TRAIN_AZ_ROWS / ms * 1e3:.0f} rows/s), peak memory "
        f"{peak / 2**30:.3f} GiB; profiled: {prof}")
    resume = resume_checks(torch, lambda d: AzTrainer(cfg, device=d), params,
                           batch, dev, tmp, "az")
    return {"losses": losses, "step1": {k: first[k] for k in (
        "metric_diff", "grad_rel", "param_max_diff", "off_share")},
        "step_ms": ms, "rows_per_s": TRAIN_AZ_ROWS / ms * 1e3,
        "peak_bytes": peak, "profile": prof, "resume": resume}


def train_host_child(argv) -> int:
    """The train phase's evaluator host: ``python -m
    fishnet_tpu_torch.rpc.host``'s ``main`` on ``argv[1:]``. At exit
    (SIGTERM) it writes to ``argv[0]`` (JSON) the host's counters, the
    ring counters and the records' rows of its largest fused AZ
    dispatch."""
    from fishnet_tpu_torch.rpc import host as host_mod
    from fishnet_tpu_torch.rpc import rings

    made, fused = [], [[]]
    run_fn = host_mod._HostAzBackend._run

    def run(self, segs):
        if len(segs) > 1 and sum(map(len, segs)) > sum(map(len, fused[0])):
            fused[0] = list(segs)
        return run_fn(self, segs)

    class Host(host_mod.EvaluatorHost):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    host_mod._HostAzBackend._run = run
    host_mod.EvaluatorHost = Host
    rc = host_mod.main(argv[1:])
    stats = {"rc": rc, "rings": rings.stats(),
             "largest_fused": [len(s) for s in fused[0]]}
    if made:
        stats.update(made[0].counters())
    with open(argv[0], "w", encoding="utf-8") as fp:
        json.dump(stats, fp)
    return rc


def train_frontend_child(argv) -> int:
    """One split-plane self-play frontend: an MctsPool over a
    ``RemoteAzPlane`` (``argv[0]``, JSON: link dir, link name, seed,
    --az-seed, capacity, self-play sizes, output path), warmed up, then
    "ready" on its standard output; on a line on its standard input it
    plays ``selfplay_batch``, saves the batch (npz) and prints one JSON
    line: the plane's counters, the largest record it sent, and whether
    this process holds a CUDA context."""
    import numpy as np
    import torch

    from fishnet_tpu_torch.models.az import AzConfig, init_az_params
    from fishnet_tpu_torch.rpc.client import RemoteAzPlane
    from fishnet_tpu_torch.search.mcts import MctsConfig, MctsPool
    from fishnet_tpu_torch.train.selfplay import SelfPlayConfig, selfplay_batch

    spec = json.loads(argv[0])
    cfg = MctsConfig(batch_capacity=spec["cap"], az=AzConfig())
    params = init_az_params(spec["az_seed"], cfg.az)
    plane = RemoteAzPlane(cfg, params, rpc_dir=spec["dir"],
                          link_name=spec["link"])
    largest = [0]
    submit = plane._client.submit

    def counted(kind, n, payload):
        largest[0] = max(largest[0], n)
        return submit(kind, n, payload)

    plane._client.submit = counted
    try:
        pool = MctsPool(params, cfg, evaluator=plane)
        pool.warmup()
        print("ready", flush=True)
        sys.stdin.readline()
        games, visits, plies = spec["selfplay"]
        t0 = time.time()
        batch = selfplay_batch(pool, SelfPlayConfig(
            games=games, visits=visits, max_plies=plies), seed=spec["seed"])
        t1 = time.time()
        np.savez(spec["out"], **batch)
        print(json.dumps({"t0": t0, "t1": t1, "rows": len(batch["planes"]),
                          "visits": pool.counters()["visits"],
                          "plane": plane.counters(), "largest_record": largest[0],
                          "cuda_context": torch.cuda.is_initialized()}),
              flush=True)
    finally:
        plane.close()
    return 0


def train_split(dev, tmp: str) -> dict:
    """Check 4: the split plane's AZ half on the card: one host process
    (``--az-seed``, ``--device cuda``) and two frontend processes, each
    self-playing over a RemoteAzPlane; each frontend's batch equals the
    in-process plane's at the same seed and params, bit for bit; no
    frontend holds a CUDA context; the host fused records of both
    frontends into one dispatch."""
    import numpy as np

    from fishnet_tpu_torch.models.az import AzConfig, init_az_params
    from fishnet_tpu_torch.train.selfplay import SelfPlayConfig, selfplay_batch

    games, visits, plies = TRAIN_SPLIT_SELFPLAY
    seeds = (21, 22)
    params = init_az_params(TRAIN_SPLIT_SEED, AzConfig())
    want = {}
    for seed in seeds:
        fresh_cache()
        pool = train_pool(params, dev)
        try:
            want[seed] = selfplay_batch(pool, SelfPlayConfig(
                games=games, visits=visits, max_plies=plies), seed=seed)
        finally:
            pool.close()
    rpc_dir = os.path.join(tmp, "rpc")
    os.makedirs(rpc_dir, exist_ok=True)
    out_dir = ROOT / "chiprun_out" / "train"
    out_dir.mkdir(parents=True, exist_ok=True)
    stats_path = os.path.join(tmp, "host.json")
    host_log = open(out_dir / "host.log", "w", encoding="utf-8")
    fe_log = open(out_dir / "frontends.log", "w", encoding="utf-8")
    host = subprocess.Popen(
        _child_cmd("train_host_child", stats_path, "--dir", rpc_dir,
                   "--az-seed", str(TRAIN_SPLIT_SEED), "--az-capacity",
                   str(AZ_CAP), "--device", "cuda"),
        stdout=host_log, stderr=subprocess.STDOUT)
    procs = []
    try:
        deadline = time.monotonic() + 300
        while "rpc host: serving" not in (out_dir / "host.log").read_text():
            check(host.poll() is None and time.monotonic() < deadline,
                  f"train split: the host did not start (rc {host.poll()})")
            time.sleep(0.05)
        for i, seed in enumerate(seeds):
            spec = dict(dir=rpc_dir, link=f"train-{i}.ring", seed=seed,
                        az_seed=TRAIN_SPLIT_SEED, cap=AZ_CAP,
                        selfplay=TRAIN_SPLIT_SELFPLAY,
                        out=os.path.join(tmp, f"split-{seed}.npz"))
            procs.append(subprocess.Popen(
                _child_cmd("train_frontend_child", json.dumps(spec)),
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=fe_log,
                text=True))
        deadline = time.monotonic() + 300
        for p in procs:
            check(_read_line(p, deadline, "train split frontend") == "ready",
                  "train split: a frontend did not warm up")
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.flush()
        deadline = time.monotonic() + 600
        reports = [json.loads(_read_line(p, deadline, "train split frontend"))
                   for p in procs]
        rcs = [_stop(p) for p in procs]
        check(rcs == [0, 0], f"train split: frontend exit codes {rcs}")
    finally:
        for p in procs:
            _stop(p, signal.SIGTERM)
        host_rc = _stop(host, signal.SIGTERM)
        host_log.close()
        fe_log.close()
    check(host_rc == 0, f"train split: the host exited {host_rc}")
    with open(stats_path, encoding="utf-8") as fp:
        stats = json.load(fp)
    for seed, r in zip(seeds, reports):
        got = np.load(os.path.join(tmp, f"split-{seed}.npz"))
        same = all(np.array_equal(got[k], want[seed][k]) for k in want[seed])
        check(same, f"train split: frontend seed {seed}'s batch differs from "
                    "the in-process plane's")
        check(not r["cuda_context"], "train split: a frontend created a CUDA "
                                     "context")
    az, ring = stats["az"], stats["rings"]
    for key in ("eval_errors", "refused.nnue", "refused.az", "result_drops",
                "torn", "stale_refusals", "unserviceable"):
        check(ring.get(key, 0) == 0, f"train split: host counted {key} "
                                     f"{ring.get(key)}")
    largest = stats["largest_fused"]
    record = max(r["largest_record"] for r in reports)
    wall = max(r["t1"] for r in reports) - min(r["t0"] for r in reports)
    visits_all = sum(r["visits"] for r in reports)
    row = {"frontends": len(reports), "rows": [r["rows"] for r in reports],
           "visits": visits_all, "seconds": wall,
           "visits_per_s": visits_all / wall,
           "host_dispatches": az["dispatches"],
           "host_fused_dispatches": az["fused_dispatches"],
           "host_forwards": az["forwards"],
           "host_ms_per_dispatch": az["run_s"] * 1e3 / max(1, az["dispatches"]),
           "rows_over_slots": az["rows"] / max(1, az["slots"]),
           "largest_fused_records": largest, "largest_record": record}
    log(f"  split AZ: 2 frontends' self-play == in-process at the same seeds "
        f"and params; {row}")
    check(az["fused_dispatches"] > 0 and len(largest) > 1
          and sum(largest) > max(largest),
          "train split: the host fused no records of the two frontends")
    return row


def phase_train(torch, dev) -> dict:
    """The train phase: checks 1-5 of training on the card."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory(prefix="train-") as tmp:
        cpu_path = os.path.join(tmp, "cpu-labels.npz")
        cpu_child = subprocess.Popen(_child_cmd(
            "train_cpu_labels_child", cpu_path,
            json.dumps([TRAIN_LABELS, TRAIN_SERVICE, TRAIN_CPU_THREADS])))
        try:
            out.update(train_steps(torch, dev, tmp, cpu_child, cpu_path))
        finally:
            _stop(cpu_child, signal.SIGTERM)
    return out


def train_steps(torch, dev, tmp: str, cpu_child, cpu_path: str) -> dict:
    """The train phase's checks, the CPU labels running beside them."""
    out = {}
    t0 = time.perf_counter()
    labels = train_labels(torch, dev)
    out["labels"] = {k: v for k, v in labels.items() if k != "batch"}
    log(f"  [train] labels in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["nnue"] = train_nnue(torch, labels, dev, tmp)
    log(f"  [train] nnue in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sp = train_selfplay(dev)
    out["selfplay"] = {k: v for k, v in sp.items() if k != "batch"}
    log(f"  [train] self-play in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["az"] = train_az(torch, sp["batch"], dev, tmp)
    log(f"  [train] az in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["split"] = train_split(dev, tmp)
    log(f"  [train] split in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["labels"]["cpu_seconds"] = train_labels_equal(labels, cpu_child,
                                                      cpu_path)
    out["_batch"] = labels["batch"]  # for the trainshard phase; not printed
    log(f"  [train] waited {time.perf_counter() - t0:.1f} s for the CPU "
        "labels")
    return out


#: The mesh phase's sizes: gated positions at one driver thread (the
#: coalesce phase's 3000 nodes) on a service whose
#: slots hold them all at once, at the CLI's microbatch; the concurrent
#: 2 x 2 run's searches; the A/B burst's nodes (the coalesce phase's
#: burst, cut from 3000 nodes a search, then 600 and 300, so the default
#: run keeps its time on a slow host; the gated positions from 20 for the
#: same reason, each still at 3000 nodes); and shard 1's dispatches at
#: which the drain check steps it down a rung and then drains it.
MESH_POSITIONS = 12
MESH_NODES = 3000
MESH_GATED = dict(pool_slots=32, batch_capacity=1024)
MESH_CONCURRENT = 32
MESH_BURST_NODES = 150
MESH_DRAIN_AT = (6, 12)


def mesh_sparse_kernel(torch, params, dev) -> dict:
    """The kernel's partials mode (``sparse=``, dense mode without
    parents) at the serving width: a B = 512 batch, half fulls and half
    sparse deltas with removals, fused PSQT; == the plain version on
    the card and on the CPU, bit for bit, one launch counted; timed
    against its plain version, its bound and ``embedding_bag`` with
    signed per-sample weights (the same signed sums)."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec
    from fishnet_tpu_torch.ops import ft_gather

    rng = np.random.default_rng(41)
    b, nf, db, ds = 512, spec.NUM_FEATURES, spec.DELTA_BASE, spec.DELTA_SLOTS
    idx = np.full((b, 2, spec.MAX_ACTIVE_FEATURES), nf, np.int32)
    sparse = rng.integers(0, 2, b).astype(np.int32)
    for e in range(b):
        if not sparse[e]:
            live = int(rng.integers(20, 33))
            idx[e, :, :live] = rng.integers(0, nf, (2, live))
            continue
        for p in range(2):
            n_add, n_rem = (int(x) for x in rng.integers(0, ds + 1, 2))
            idx[e, p, :n_add] = rng.integers(0, nf, n_add)
            idx[e, p, ds: ds + n_rem] = db + rng.integers(0, nf, n_rem)
            idx[e, p, ds + n_rem: 2 * ds] = db + nf
    w, bias, fp = params["ft_w"], params["ft_b"], params["ft_psqt"]
    t_idx, t_sp = (torch.from_numpy(a).to(dev) for a in (idx, sparse))
    kw = dict(delta_base=db, sparse=t_sp, ft_psqt=fp)
    errors0 = ft_gather.kernel_errors(dev)
    before = ft_gather.ft_accumulate_cuda.sparse_launches
    got = ft_gather.ft_accumulate_cuda(w, bias, t_idx, **kw)
    check(ft_gather.ft_accumulate_cuda.sparse_launches == before + 1,
          "the partials mode was not counted")
    ref = ft_gather.ft_accumulate_plain(w, bias, t_idx, **kw)
    cpu = ft_gather.ft_accumulate_plain(
        w.cpu(), bias.cpu(), t_idx.cpu(), delta_base=db, sparse=t_sp.cpu(),
        ft_psqt=fp.cpu())
    err = max(max_diff(got, ref), max_diff([g.cpu() for g in got], cpu))
    check(err == 0, f"partials mode: kernel != plain by {err}")
    dec = np.where(idx >= db, idx - db, idx).reshape(-1, 32)
    sign = np.where(idx >= db, -1.0, 1.0).astype(np.float32).reshape(-1, 32)
    flat = torch.from_numpy(dec).long().to(dev)
    psw = torch.from_numpy(sign).to(dev)
    w_f = w.float()

    def library():
        return torch.nn.functional.embedding_bag(
            flat, w_f, per_sample_weights=psw, mode="sum")

    check(torch.equal(library().view(b, 2, -1).to(torch.int32)
                      + bias.to(torch.int32), got[0]),
          "embedding_bag does not compute the partials")
    ms = graph_time_ms(torch, lambda: ft_gather.ft_accumulate_cuda(
        w, bias, t_idx, **kw))
    plain_ms = graph_time_ms(torch, lambda: ft_gather.ft_accumulate_plain(
        w, bias, t_idx, **kw))
    library_ms = graph_time_ms(torch, library)
    # The bound counts the partials' reads as the kernel's: a flagged
    # entry's 2*DELTA_SLOTS slots, as a delta's (a stand-in code).
    fake = np.where(sparse == 1, pers_code(0, True), -1).astype(np.int32)
    bound_ms, bound_by, nbytes, ops = bound(idx, fake, False, True, spec.L1)
    torch.cuda.synchronize()
    check(ft_gather.kernel_errors(dev) == errors0,
          "partials mode: the kernel's error word moved")
    row = {"entries": b, "sparse": int(sparse.sum()), "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
           "bound_ops": ops, "max_abs_err": err}
    log(f"  partials mode (sparse=), B={b} ({row['sparse']} sparse, fused "
        f"PSQT): == plain on the card and the CPU; kernel {ms:.6f} ms, "
        f"plain {plain_ms:.6f} ms, embedding_bag {library_ms:.6f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}, {nbytes} B)")
    return row


def mesh_threads_kernel(torch, params, dev, launches: int = 100) -> dict:
    """Two threads launching on one card, as two shards' pack workers do:
    each ``launches`` dense launches with in-batch deltas and persistent
    codes (the ready words and the entry ticket in play), met at a
    barrier before each, thread 1's first launch growing the device's
    ready words while thread 0's may be in flight; every result == the
    plain version's, and the error word stays where it was."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec
    from fishnet_tpu_torch.ops import ft_gather

    rng = np.random.default_rng(43)
    w, bias, fp = params["ft_w"], params["ft_b"], params["ft_psqt"]
    held = ft_gather._states.get(dev.index or 0, (None, None))[1]
    grow = (4096 if held is None else held.shape[0]) + 512
    jobs = []
    for size in (512, grow):
        (pk, off, par, tab, ptab), _, _ = device_wire(torch, rng, dev, size,
                                                      64)
        dense = ft_gather.expand_packed(pk, off, par)
        kw = dict(delta_base=spec.DELTA_BASE, parent=par, anchor_tab=tab,
                  ft_psqt=fp, psqt_tab=ptab)
        jobs.append((dense, kw, ft_gather.ft_accumulate_plain(
            w, bias, dense, **kw)))
    errors0 = ft_gather.kernel_errors(dev)
    barrier = threading.Barrier(2)
    bad, failures = [0, 0], []

    def drive(i):
        dense, kw, ref = jobs[i]
        try:
            for _ in range(launches):
                barrier.wait(timeout=60)
                out = ft_gather.ft_accumulate_cuda(w, bias, dense, **kw)
                bad[i] += int(max_diff(out, ref) != 0)
        except BaseException as err:  # noqa: BLE001 - raised below
            failures.append(err)
            barrier.abort()

    threads = [threading.Thread(target=drive, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        raise failures[0]
    torch.cuda.synchronize()
    errors = ft_gather.kernel_errors(dev)
    log(f"  two threads x {launches} launches on one card (B = 512 and "
        f"{grow}, the second growing the ready words): {bad} results != "
        f"plain, error word {errors0} -> {errors}")
    check(bad == [0, 0], f"two launching threads: {bad} results != plain")
    check(errors == errors0, "two launching threads: the error word moved")
    return {"launches": 2 * launches, "batches": [512, grow], "wrong": bad}


def mesh_drain_run(torch, weights, dev, walks, ref) -> dict:
    """Check 4: the gated positions on two logical shards (round-robin),
    shard 1 stepped down one rung (host-material) at its
    MESH_DRAIN_AT[0]-th dispatch and drained at its [1]-th, mid-search:
    the analyses stay ``ref``'s; shard 0 never leaves its rung; every
    group ends on shard 0; each drained group's table block arrives on
    shard 0 equal to the block it left; the first dispatch after such a
    move equals the plain version on CPU copies of its inputs and
    tables."""
    from fishnet_tpu_torch.nnue import torch_eval
    from fishnet_tpu_torch.resilience.supervisor import ladder_for

    ladder = ladder_for(dev.type)  # cuda: fused -> host-material
    state = {"seen": 0, "mid": None, "moved": [], "armed": False,
             "first": None}

    def hook(svc):
        solo, fused = svc._dispatch_eval, svc._dispatch_segmented
        place, evaluate = svc._place_group_tables, svc._eval_fn

        def count(group):
            if svc._router.shard_of(group) == 1:
                state["seen"] += 1
                if state["seen"] in MESH_DRAIN_AT:
                    svc._degrade_shard_for(group,
                                           RuntimeError("forced ladder step"))
                    if state["mid"] is None:
                        state["mid"] = svc.shard_report()

        def on_solo(group, n, rows):
            count(group)
            return solo(group, n, rows)

        def on_fused(tickets):
            count(tickets[0].group)
            return fused(tickets)

        def on_place(group, shard):
            old = svc._table_home[group]
            place(group, shard)
            if old != shard:
                same = (torch.equal(svc._anchor_shards[shard][group],
                                    svc._anchor_shards[old][group])
                        and torch.equal(svc._psqt_shards[shard][group],
                                        svc._psqt_shards[old][group]))
                state["moved"].append((group, old, shard, same))
                state["armed"] = True

        def on_eval(params, packed, buckets, parent, material, tab, n_rows,
                    ptab, **kw):
            if not state["armed"] or state["first"] is not None:
                return evaluate(params, packed, buckets, parent, material,
                                tab, n_rows, ptab, **kw)
            state["armed"] = False
            snap = {"args": [t.cpu().clone() if t is not None else None
                             for t in (packed, buckets, parent, material,
                                       tab)],
                    "n_rows": n_rows, "ptab": ptab.cpu().clone(),
                    "kw": {k: (v.cpu().clone() if hasattr(v, "cpu")
                               else v.copy() if hasattr(v, "copy") else v)
                           for k, v in kw.items()}}
            out = evaluate(params, packed, buckets, parent, material, tab,
                           n_rows, ptab, **kw)
            snap["out"] = [out[0].cpu(), tab.cpu().clone(),
                           ptab.cpu().clone()]
            state["first"] = snap
            return out

        svc._dispatch_eval, svc._dispatch_segmented = on_solo, on_fused
        svc._place_group_tables, svc._eval_fn = on_place, on_eval

    run = gated_run(weights, dev, walks, MESH_NODES, hook=hook,
                    mesh_devices=[dev, dev], FISHNET_SHARD_PLACEMENT="rr",
                    FISHNET_COALESCE_WIDTH="2", **MESH_GATED)
    rep = run[1]["shards"]
    mid = state["mid"]
    log(f"  ladder: at shard 1's dispatch {MESH_DRAIN_AT[0]} "
        f"{mid['rungs'] if mid else None}, at {MESH_DRAIN_AT[1]} drained; "
        f"end {rep['rungs']}, groups {rep['groups']}, dispatches "
        f"{rep['dispatches']}, moved blocks "
        f"{[(g, o, s) for g, o, s, _ in state['moved']]}; == no mesh "
        f"{run[0] == ref}")
    check(run[0] == ref, "ladder and drain: the analyses changed")
    check(mid is not None and mid["rungs"] == list(ladder)
          and all(mid["alive"]), f"ladder: the step went wrong ({mid})")
    check(rep["rungs"] == [ladder[0], "drained"] and rep["groups"][1] == []
          and sorted(rep["groups"][0]) == [0, 1, 2, 3],
          f"drain: shard 1 not drained onto shard 0 ({rep})")
    check(state["moved"] and all(m[3] for m in state["moved"]),
          f"drain: a migrated table block differs ({state['moved']})")
    snap = state["first"]
    check(snap is not None, "drain: no dispatch after a move")
    cpu_params = {k: v.cpu() for k, v in
                  torch_eval.params_from_weights(weights, "cpu").items()}
    packed, buckets, parent, material, tab = snap["args"]
    ptab = snap["ptab"]
    values, _, _ = torch_eval.evaluate_packed_anchored(
        cpu_params, packed, buckets, parent, material, tab, snap["n_rows"],
        ptab, **snap["kw"])
    # The table rows this dispatch reads and stores: its groups' blocks.
    # (The rest of the flat table may take another shard's pack worker's
    # stores between the snapshot and the launch.)
    rows = torch.unique((-parent[parent <= -2] - 2) >> 2).long()
    out_v, out_t, out_pt = snap["out"]
    dv = max_diff([values], [out_v])
    dt = max_diff([tab[rows], ptab[rows]], [out_t[rows], out_pt[rows]])
    diff = max(dv, dt)
    log(f"  the first dispatch after a move ({len(parent)} entries, "
        f"{len(rows)} table rows, "
        f"{'host-material' if material is not None else 'PSQT on the card'}"
        f"): == plain on CPU copies, values and its table rows (max diff "
        f"{dv}, {dt})")
    check(diff == 0, f"drain: the first dispatch after a move != plain "
                     f"({diff})")
    return {"moved": [m[:3] for m in state["moved"]],
            "dispatches": rep["dispatches"], "first_after_move_diff": diff}


def mesh_concurrent(torch, weights, dev) -> dict:
    """Two logical shards under 2 driver threads x pipeline 2 (4 groups,
    concurrent driver threads: their shared TT makes the analyses depend
    on timing, so this run checks what does not): every search answers,
    both shards dispatch, one packed launch per dispatch and no dense
    launch, the error word unmoved."""
    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.search.service import SearchService

    fresh_cache()
    svc = SearchService(weights=weights, batch_capacity=1024,
                        pipeline_depth=2, driver_threads=2, device=dev,
                        mesh_devices=[dev, dev])
    try:
        svc.warmup()
        errors0 = ft_gather.kernel_errors(dev)
        packed0 = ft_gather.ft_accumulate_packed_cuda.launches
        dense0 = ft_gather.ft_accumulate_cuda.launches
        c0 = svc.counters()
        walks = random_lines(MESH_CONCURRENT, seed=59)

        async def go():
            return await asyncio.gather(*[
                svc.search(STARTPOS, m, nodes=MESH_NODES) for m in walks])

        results = asyncio.run(go())
        c = {k: v - c0[k] for k, v in svc.counters().items()}
        rep = svc.shard_report()
        packed = ft_gather.ft_accumulate_packed_cuda.launches - packed0
        dense = ft_gather.ft_accumulate_cuda.launches - dense0
        torch.cuda.synchronize()
        errors = ft_gather.kernel_errors(dev)
    finally:
        svc.close()
    widths = [st / max(1, d) for st, d in zip(rep["steps"], rep["dispatches"])]
    log(f"  2 driver threads x pipeline 2 on two logical shards: "
        f"{len(results)} searches, dispatches per shard {rep['dispatches']}, "
        f"mean width per shard {[round(x, 3) for x in widths]}, re-homes "
        f"{rep['rehomes']}, groups {rep['groups']}; launches {packed} packed, "
        f"{dense} dense for {c['dispatches']} dispatches")
    check(all(r.best_move for r in results), "2 x 2: a search failed")
    check(all(d > 0 for d in rep["dispatches"]), "2 x 2: a shard idled")
    check(packed == c["dispatches"] and dense == 0,
          f"2 x 2: {packed} packed / {dense} dense launches for "
          f"{c['dispatches']} dispatches")
    check(errors == errors0, "2 x 2: the kernel's error word moved")
    return {"dispatches": rep["dispatches"], "widths": widths,
            "rehomes": rep["rehomes"]}


def mesh_sharded_evaluator(torch, weights, params, dev) -> dict:
    """Check 5: the legacy tier of an explicit ``--mesh DxM`` with M > 1,
    ``ShardedEvaluator`` over two logical shards on the card, behind the
    service (one entry bucket, the pool's emission aligned to the shard
    size, the per-shard repack ``_dispatch_sharded_packed``): every
    captured dispatch's values == the single-device ``evaluate_packed``
    of the same group wire; two dense launches (one per shard) per
    dispatch."""
    import numpy as np

    from fishnet_tpu_torch.nnue import torch_eval
    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.parallel.mesh import ShardedEvaluator, make_mesh
    from fishnet_tpu_torch.search.service import SearchService

    fresh_cache()
    ev = ShardedEvaluator(params, mesh=make_mesh([dev, dev]),
                          batch_capacity=1024)
    svc = SearchService(weights=weights, evaluator=ev, batch_capacity=1024,
                        pipeline_depth=2, driver_threads=1)
    captured = []
    real = svc._dispatch_sharded_packed

    def record(size, n, rows, packed, buckets, parents, material, offsets):
        values, acct = real(size, n, rows, packed, buckets, parents,
                            material, offsets)
        if len(captured) < 16:
            captured.append((n, packed[: rows + 4].copy(),
                             offsets[:size].copy(), buckets[:size].copy(),
                             parents[:size].copy(), material[:size].copy(),
                             np.asarray(values).copy()))
        return values, acct

    svc._dispatch_sharded_packed = record
    try:
        svc.warmup()
        dense0 = ft_gather.ft_accumulate_cuda.launches
        c0 = svc.counters()

        async def go():
            return await asyncio.gather(*[
                svc.search(STARTPOS, m, nodes=1000)
                for m in random_lines(8, seed=61)])

        results = asyncio.run(go())
        c = {k: v - c0[k] for k, v in svc.counters().items()}
        dense = ft_gather.ft_accumulate_cuda.launches - dense0
        align, sizes = svc._shard_align, svc._eval_sizes
    finally:
        svc.close()
    check(all(r.best_move for r in results), "sharded evaluator: a search "
                                             "failed")
    worst = 0
    for n, packed, offsets, buckets, parents, material, got in captured:
        one = torch_eval.evaluate_packed(
            params, *(torch.from_numpy(a).to(dev) for a in (
                packed.view(np.int16), offsets, buckets, parents,
                material))).cpu().numpy()
        worst = max(worst, int(np.abs(one.astype(np.int64)
                                      - got.astype(np.int64)).max()))
    log(f"  ShardedEvaluator over two logical shards (bucket {sizes}, "
        f"align {align}): {len(captured)} captured dispatches == "
        f"single-device evaluate_packed (max diff {worst}); {dense} dense "
        f"launches for {c['dispatches']} dispatches")
    check(captured and worst == 0,
          f"sharded evaluator != evaluate_packed by {worst}")
    check(dense == 2 * c["dispatches"],
          f"sharded evaluator: {dense} dense launches for "
          f"{c['dispatches']} dispatches of two shards")
    return {"dispatches": c["dispatches"], "dense_launches": dense,
            "max_abs_err": worst}


def mesh_az(dev) -> dict:
    """Check 6: the AZ plane on two logical shards (the default AzConfig,
    ``devices=[dev, dev]``, lanes round-robin): the parity roots split
    between two pools, each on its own lane, give the trees of the same
    two pools on a one-shard plane, and both shards dispatch."""
    from fishnet_tpu_torch.models.az import AzConfig
    from fishnet_tpu_torch.search.az_plane import AzDispatchPlane
    from fishnet_tpu_torch.search.mcts import MctsConfig, MctsPool

    params = az_params()
    cfg = MctsConfig(batch_capacity=AZ_CAP, az=AzConfig())
    searches, visits = AZ_PARITY
    roots = random_lines(searches, 53)
    halves = [roots[: searches // 2], roots[searches // 2:]]
    runs = {}
    for name, devices in (("one shard", None), ("two shards", [dev, dev])):
        fresh_cache()
        with env_vars(FISHNET_SHARD_PLACEMENT="rr"):
            plane = AzDispatchPlane(params, cfg, device=dev, devices=devices)
        pools = [MctsPool(params, cfg, evaluator=plane, device=dev)
                 for _ in halves]
        try:
            got = drive_in_lockstep(pools, halves, visits)
            counters = plane.counters()
        finally:
            for pool in pools:
                pool.close()
            plane.close()
        runs[name] = (got, counters)
    shard_d = runs["two shards"][1]["shard_dispatches"]
    same = runs["two shards"][0] == runs["one shard"][0]
    log(f"  AZ plane, {searches} searches x {visits} visits over two pools: "
        f"two logical shards == one shard {same}; dispatches per shard "
        f"{shard_d} (one shard: {runs['one shard'][1]['dispatches']})")
    check(same, "AZ plane: two shards' trees differ from one shard's")
    check(all(d > 0 for d in shard_d), "AZ plane: a shard never dispatched")
    return {"shard_dispatches": shard_d}


def mesh_burst(weights, dev) -> list:
    """Numbers 7, not gates: the coalesce phase's burst (the default
    service) at MESH_BURST_NODES a search, one shard (A) and two logical
    shards (B) on the card, in the order A, B (cut from A, B, B, A so the
    default run keeps its time): nodes/s, dispatches
    and mean width per shard, and each pack worker's ms per dispatch
    (its ``_execute`` calls). One packed launch per dispatch."""
    from fishnet_tpu_torch.configure import parse_and_configure
    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.search.service import SearchService

    threads = parse_and_configure(["run", "--no-conf"]).resolved_search_threads()
    rows = []
    for label in ("A", "B"):
        fresh_cache()
        svc = SearchService(weights=weights, batch_capacity=1024,
                            pipeline_depth=2, driver_threads=threads,
                            device=dev,
                            mesh_devices=None if label == "A" else [dev, dev])
        pack = {}
        try:
            svc.warmup()
            co = svc._coalescer
            real = co._execute

            def timed(tickets, _real=real, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _real(tickets, **kwargs)
                finally:
                    name = threading.current_thread().name
                    if name.startswith("dispatch-pack"):
                        cell = pack.setdefault(name, [0, 0.0])
                        cell[0] += 1
                        cell[1] += time.perf_counter() - t0

            co._execute = timed
            packed0 = ft_gather.ft_accumulate_packed_cuda.launches
            burst = {}
            nps = load_burst(svc, burst, nodes=MESH_BURST_NODES)
            packed = ft_gather.ft_accumulate_packed_cuda.launches - packed0
            rep = svc.shard_report()
        finally:
            svc.close()
        c = burst["counters"]
        check(packed == c["dispatches"],
              f"burst {label}: {packed} launches for {c['dispatches']} "
              "dispatches")
        row = {"label": label, "shards": rep["n_shards"],
               "nodes_per_s": nps, "dispatches": rep["dispatches"],
               "mean_width": [st / max(1, d) for st, d in
                              zip(rep["steps"], rep["dispatches"])],
               "pack_ms_per_dispatch": {k: v[1] * 1e3 / max(1, v[0])
                                        for k, v in sorted(pack.items())},
               "pack_busy_s": {k: v[1] for k, v in sorted(pack.items())},
               "seconds": burst["seconds"]}
        rows.append(row)
        log(f"  burst {label} ({rep['n_shards']} shard(s), {threads} driver "
            f"threads): {row}")
    return rows


def phase_mesh(torch, weights, params, dev) -> dict:
    """The serving mesh on the card, with the full-width net and the
    CLI's microbatch. Kernel: the partials mode == plain (timed), two
    launching threads on one card exact. Services (gated, one driver
    thread, MESH_POSITIONS positions at MESH_NODES nodes; every run one
    packed launch per dispatch): ``mesh_devices="auto"`` on this host
    and FISHNET_NO_MESH=1 over [cuda:0, cuda:0] == the no-mesh service;
    two logical shards on the card == it under FISHNET_SHARD_PLACEMENT
    rr (the phase's main path, its launches counted from 0) and lb, both
    shards dispatching; the ladder step and the drain with migrated
    table blocks; 2 driver threads x pipeline 2 on two shards. Then the
    legacy ShardedEvaluator, the AZ plane on two shards, and the burst
    A, B (numbers only)."""
    from fishnet_tpu_torch.ops import ft_gather

    t_phase = time.perf_counter()

    def mark(what):
        log(f"  ({time.perf_counter() - t_phase:.1f} s into the phase: "
            f"{what} done)")

    two = [dev, dev]
    out = {"sparse": mesh_sparse_kernel(torch, params, dev),
           "threads": mesh_threads_kernel(torch, params, dev)}
    mark("kernel")
    walks = random_lines(MESH_POSITIONS, seed=47)
    ref = gated_run(weights, dev, walks, MESH_NODES, **MESH_GATED)[0]
    seen = {}

    def watch(name):
        def hook(svc):
            seen[name] = svc._n_shards
        return hook

    auto = gated_run(weights, dev, walks, MESH_NODES, hook=watch("auto"),
                     mesh_devices="auto", **MESH_GATED)[0]
    hatch = gated_run(weights, dev, walks, MESH_NODES, hook=watch("hatch"),
                      mesh_devices=two, FISHNET_NO_MESH="1", **MESH_GATED)[0]
    one_card = torch.cuda.device_count() == 1
    log(f"  one shard: --mesh auto on {torch.cuda.device_count()} card(s) "
        f"({seen['auto']} shard(s)) == no mesh {auto == ref}; "
        f"FISHNET_NO_MESH=1 over [{dev}, {dev}] ({seen['hatch']} shard) == "
        f"no mesh {hatch == ref}")
    check(auto == ref and hatch == ref, "one shard: analyses differ from "
                                        "the no-mesh service's")
    check(seen["hatch"] == 1 and (seen["auto"] == 1) == one_card,
          f"one shard: the mesh turned on or off wrongly {seen}")
    mark("one shard (3 gated runs)")
    runs = {}
    for placement in ("rr", "lb"):
        if placement == "rr":  # the phase's main path: counts from 0
            ft_gather.ft_accumulate_packed_cuda.launches = 0
        analyses, c = gated_run(weights, dev, walks, MESH_NODES,
                                mesh_devices=two,
                                FISHNET_SHARD_PLACEMENT=placement,
                                **MESH_GATED)
        if placement == "rr":
            out["launches"] = ft_gather.ft_accumulate_packed_cuda.launches
        rep = c["shards"]
        widths = [st / max(1, d) for st, d in zip(rep["steps"],
                                                  rep["dispatches"])]
        runs[placement] = {"dispatches": rep["dispatches"],
                           "widths": widths, "rehomes": rep["rehomes"]}
        log(f"  two logical shards, placement {placement}: == no mesh "
            f"{analyses == ref}; dispatches per shard {rep['dispatches']} "
            f"(= packed launches), mean width per shard "
            f"{[round(x, 3) for x in widths]}, group re-homes "
            f"{rep['rehomes']}, groups {rep['groups']}")
        check(analyses == ref, f"two shards ({placement}): analyses differ "
                               "from the no-mesh service's")
        check(all(d > 0 for d in rep["dispatches"]),
              f"two shards ({placement}): a shard never dispatched")
        check(sum(rep["dispatches"]) == c["dispatches"],
              "two shards: the shards' dispatches do not add up")
    check(out["launches"] > 0, "the mesh's main path never launched the "
                               "kernel")
    out["shards"] = runs
    mark("two shards (2 gated runs)")
    out["drain"] = mesh_drain_run(torch, weights, dev, walks, ref)
    mark("ladder and drain")
    out["concurrent"] = mesh_concurrent(torch, weights, dev)
    mark("2 x 2")
    out["sharded_evaluator"] = mesh_sharded_evaluator(torch, weights, params,
                                                      dev)
    mark("sharded evaluator")
    out["az"] = mesh_az(dev)
    mark("AZ plane")
    out["burst"] = mesh_burst(weights, dev)
    mark("burst")
    out["worst"] = max(out["sparse"]["max_abs_err"],
                       out["drain"]["first_after_move_diff"],
                       out["sharded_evaluator"]["max_abs_err"])
    return out


#: The trainshard phase: the sharded trainers on logical shards of the
#: card, (data, model) meshes over [cuda:0] * (data x model). NNUE at
#: full spec at the train phase's B for TRAINSHARD_STEPS steps against
#: the single-device steps; AZ at the default AzConfig, one step at the
#: train phase's rows (each data slice >= 256 rows: cuDNN's rows below
#: 256 depend on the batch shape, PERF.md §6).
TRAINSHARD_MESHES = ((2, 1), (1, 2), (2, 2))
TRAINSHARD_AZ_MESHES = ((1, 2), (2, 1))
TRAINSHARD_STEPS = 3


def card_mesh(dev, data: int, model: int):
    """A ``data x model`` mesh of logical shards of ``dev``."""
    from fishnet_tpu_torch.parallel.mesh import make_mesh

    return make_mesh([dev] * (data * model), data=data, model=model)


def nnue_arrays(net) -> dict:
    """A net's parameters (single-device or sharded, gathered) as numpy
    copies in the JAX layout."""
    from fishnet_tpu_torch.train.model import PARAM_NAMES

    return {k: net[k].detach().cpu().numpy().copy() for k in PARAM_NAMES}


#: A sharded NNUE step on the card is held to the train phase's step-1
#: gate of the card against the CPU (PERF.md §2) at every step: the loss
#: within rtol 1e-4; each parameter within rtol 2e-4 / atol 2e-6 but for
#: at most TRAIN_OFF_SHARE of its entries, each within 2 x lr a step.
#: On the card cuBLAS picks its kernels (and their sum order) by the
#: rows of a slice, so an activation that sits on a clamp's edge can
#: round to the other side and flip its gradient, and Adam (an update
#: of ~lr x g / |g|) spreads such noise to lr size in entries whose
#: gradient is small. The CPU, whose sums do not depend on the slice,
#: meets rtol 2e-4 / atol 2e-6 on every entry (the CPU tests, and
#: PERF.md §6).


def nnue_off(got: dict, want: dict) -> dict:
    """Per parameter: (max |diff|, entries outside rtol 2e-4 / atol 2e-6,
    their share)."""
    import numpy as np

    out = {}
    for k, w in want.items():
        d = np.abs(got[k].astype(np.float64) - w)
        off = int((d > 2e-6 + 2e-4 * np.abs(w)).sum())
        out[k] = (float(d.max()), off, off / d.size)
    return out


def nnue_gate(per: dict, lr: float, step: int) -> tuple:
    """(max |diff|, entries off, largest share off and its parameter,
    passes) of ``nnue_off`` after ``step`` Adam steps at ``lr``."""
    worst = max(v[0] for v in per.values())
    off = sum(v[1] for v in per.values())
    name = max(per, key=lambda k: per[k][2])
    share = per[name][2]
    ok = share <= TRAIN_OFF_SHARE and worst <= 2 * lr * step * (1 + 1e-3)
    return worst, off, f"{share:.2e} ({name})", ok


def packed_export_kernel(torch, weights, batch, dev) -> dict:
    """The exported net on the packed kernel: ``batch``'s positions as
    plain full entries of the packed wire (4 rows of 8 feature pairs
    each, then the sentinel block), the kernel == its plain version on
    CPU copies (accumulators, PSQT and both tables), bit for bit."""
    import numpy as np

    from fishnet_tpu_torch.nnue import spec, torch_eval
    from fishnet_tpu_torch.nnue.torch_eval import params_from_weights
    from fishnet_tpu_torch.ops import ft_gather

    idx = batch["indices"]
    b = len(idx)
    packed = np.full((4 * b + 4, 2, 8), spec.NUM_FEATURES, np.uint16)
    packed[:4 * b] = idx.reshape(b, 2, 4, 8).transpose(0, 2, 1, 3).reshape(
        4 * b, 2, 8)
    parent = np.full(b, -1, np.int32)
    offsets = torch_eval.derive_offsets_np(parent, 4 * b)
    tab = np.zeros((1, 2, spec.L1), np.int32)
    ptab = np.zeros((1, 2, 8), np.int32)
    host = [torch.from_numpy(a) for a in (packed.view(np.int16), offsets,
                                          parent, tab, ptab)]
    wire = tuple(t.to(dev) for t in host)
    params = params_from_weights(weights, dev)
    cpu = params_from_weights(weights, "cpu")
    launches0 = ft_gather.ft_accumulate_packed_cuda.launches
    got = packed_outputs(torch, ft_gather.ft_accumulate_packed_cuda, params,
                         wire, True)
    launches = ft_gather.ft_accumulate_packed_cuda.launches - launches0
    want = packed_outputs(torch, ft_gather.ft_accumulate_packed_plain, cpu,
                          tuple(host), True)
    diff = max_diff([t.cpu() for t in got], want)
    check(launches == 1, f"trainshard export: {launches} packed launches")
    check(diff == 0, f"trainshard export: the packed kernel != plain ({diff})")
    log(f"  export of the 1x2 run's step {TRAINSHARD_STEPS}: the packed kernel "
        f"== plain on {b} positions as plain full entries (accumulators, PSQT, "
        "tables)")
    return {"entries": b, "max_abs_err": diff, "launches": launches}


def trainshard_nnue(torch, dev, export_batch) -> dict:
    """NNUE at full spec: TRAINSHARD_STEPS steps at B = TRAIN_NNUE_BATCH
    on each of TRAINSHARD_MESHES against the single-device steps on the
    card (TF32 off), every step held to ``nnue_gate`` (the train phase's
    step-1 gate). Beside them the single-device run on the batch's rows
    permuted (the same step, its batch sums in another order). Timed;
    the export
    of carried parameters from a 1x2 trainer == the single-device export
    byte for byte; the 1x2 run's last state exported and served by the
    packed kernel."""
    import numpy as np

    from fishnet_tpu_torch.train import NetConfig, Trainer
    from fishnet_tpu_torch.train.model import init_params

    cfg = NetConfig()
    params = init_params(0, cfg)
    big = train_synthetic_nnue(TRAIN_NNUE_BATCH, seed=3)
    perm = np.random.default_rng(1).permutation(TRAIN_NNUE_BATCH)
    data = {k: torch.from_numpy(v).to(dev) for k, v in big.items()}
    permuted = {k: torch.from_numpy(np.ascontiguousarray(v[perm])).to(dev)
                for k, v in big.items()}

    def run(mesh, batch, ref=None):
        trainer = Trainer(cfg, mesh=mesh, device=dev)
        state = trainer.init(params=params)
        lr = state.opt_state.param_groups[0]["lr"]
        losses, ms, snaps = [], [], []
        for step in range(1, TRAINSHARD_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = trainer.step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"])
            arrays = nnue_arrays(state.params)
            snaps.append(arrays if ref is None else
                         nnue_gate(nnue_off(arrays, ref[step - 1]), lr, step))
        return trainer, state, losses, ms, snaps

    single_t, single_s, ref_losses, ref_ms, ref = run(None, data)
    del single_s
    out = {"single": {"losses": ref_losses, "ms": ref_ms}}
    log(f"  nnue single device: losses {ref_losses}, ms a step {ref_ms}")
    _, _, p_losses, _, floor = run(None, permuted, ref)
    out["permuted"] = {"losses": p_losses, "steps": [g[:3] for g in floor]}
    log(f"  nnue single device, the batch's rows permuted (the noise floor): "
        f"per step (max |diff|, entries off, largest share) "
        f"{[g[:3] for g in floor]}")
    last = None
    for shape in TRAINSHARD_MESHES:
        name = f"{shape[0]}x{shape[1]}"
        trainer, state, losses, ms, gates = run(card_mesh(dev, *shape), data,
                                                ref)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        out[name] = {"losses": losses, "ms": ms, "loss_rel": loss_rel,
                     "steps": [g[:3] for g in gates]}
        log(f"  nnue {name}: losses {losses} (max rel diff {loss_rel:.3e}), "
            f"ms a step {ms} (single {ref_ms}); per step (max |diff|, entries "
            f"off, largest share) {[g[:3] for g in gates]}")
        check(loss_rel <= 1e-4, f"trainshard {name}: the loss is off the "
                                "single-device step's")
        check(all(g[3] for g in gates), f"trainshard {name}: the parameters "
                                        "are off the single-device steps'")
        if shape == (1, 2):
            last = (trainer, state)
        else:
            del trainer, state
    trainer, state = last
    a = single_t.export(single_t.init(params=params))
    b = trainer.export(trainer.init(params=params))
    fields = ("ft_weight", "ft_bias", "ft_psqt", "l1_weight", "l1_bias",
              "l2_weight", "l2_bias", "out_weight", "out_bias")
    same = all(getattr(a, f).tobytes() == getattr(b, f).tobytes() for f in fields)
    log(f"  nnue: carried parameters exported from a 1x2 trainer == the "
        f"single-device export, byte for byte: {same}")
    check(same, "trainshard: the 1x2 export differs from the single-device one")
    out["export"] = packed_export_kernel(torch, trainer.export(state),
                                         export_batch, dev)
    return out


def trainshard_az(torch, dev) -> dict:
    """AZ at the default AzConfig: one step at TRAIN_AZ_ROWS rows on each
    of TRAINSHARD_AZ_MESHES against the single-device step on the card,
    held to the train phase's AZ step-1 gate (the loss within 2**-7 of
    its magnitude; each gradient within TRAIN_GRAD_TOL of its norm; the
    parameters within 2 x lr, at most TRAIN_OFF_SHARE of a parameter's
    entries outside rtol 2e-4 / atol 2e-6); ms a step, timed."""
    from fishnet_tpu_torch.models.az import AzConfig
    from fishnet_tpu_torch.train import AzTrainer

    cfg = AzConfig()
    params = az_params()
    batch = train_synthetic_az(TRAIN_AZ_ROWS, seed=6)
    data = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def one_step(mesh):
        trainer = AzTrainer(cfg, mesh=mesh, device=dev)
        state, metrics = trainer.step(trainer.init(params=params), data)
        net = state.params
        if mesh is None:
            grads = {n: p.grad.detach().cpu().double()
                     for n, p in net.named_parameters()}
            values = {n: p.detach().cpu() for n, p in net.named_parameters()}
        else:
            grads = {n: net.gather(n, [p.grad for p in net.leaves(n)]).double()
                     for n in net.names}
            values = {n: net.gather(n) for n in net.names}
        holder = [trainer.init(params=params)]

        def step():
            holder[0], _ = trainer.step(holder[0], data)

        ms = cuda_ms(torch, step, reps=3)
        lr = state.opt_state.param_groups[0]["lr"]
        return metrics, grads, values, ms, lr

    ref_m, ref_g, ref_v, ref_ms, lr = one_step(None)
    out = {"single": {"loss": ref_m["loss"], "ms": ref_ms}}
    log(f"  az single device: loss {ref_m['loss']}, {ref_ms:.3f} ms a step")
    for shape in TRAINSHARD_AZ_MESHES:
        name = f"{shape[0]}x{shape[1]}"
        m, g, v, ms, _ = one_step(card_mesh(dev, *shape))
        loss_diff = abs(m["loss"] - ref_m["loss"])
        grad_rel = {n: float((g[n] - ref_g[n]).norm()
                             / ref_g[n].norm().clamp(min=1e-30)) for n in ref_g}
        worst, share = 0.0, 0.0
        for n, want in ref_v.items():
            diff = (v[n] - want).abs()
            worst = max(worst, float(diff.max()))
            share = max(share, float((diff > 2e-6 + 2e-4 * want.abs())
                                     .float().mean()))
        out[name] = {"loss": m["loss"], "loss_diff": loss_diff,
                     "grad_rel_max": max(grad_rel.values()),
                     "param_max_diff": worst, "off_share": share, "ms": ms}
        log(f"  az {name}: loss {m['loss']} (|diff| {loss_diff:.3e}), "
            f"gradients |diff| / |single| largest {max(grad_rel.values()):.3e} "
            f"({max(grad_rel, key=grad_rel.get)}), parameters max |diff| "
            f"{worst:.3e} (2 x lr = {2 * lr}), off share {share:.6f}; "
            f"{ms:.3f} ms a step (single {ref_ms:.3f})")
        check(loss_diff <= 2.0 ** -7 * max(1.0, abs(ref_m["loss"])),
              f"trainshard az {name}: the loss is off the single step's")
        check(max(grad_rel.values()) <= TRAIN_GRAD_TOL,
              f"trainshard az {name}: a gradient is off the single step's")
        check(worst <= 2 * lr * (1 + 1e-3) and share <= TRAIN_OFF_SHARE,
              f"trainshard az {name}: the parameters are off the single step's")
    return out


def trainshard_resume(torch, dev, tmp: str) -> dict:
    """A 1x2 checkpoint after step 1: restored into a 1x2 trainer, its
    step 2 == the uninterrupted 1x2 run's step 2 bit for bit; restored
    into a single-device trainer, its step 2 matches that step at the
    NNUE tolerances."""
    import numpy as np

    from fishnet_tpu_torch.train import NetConfig, Trainer
    from fishnet_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from fishnet_tpu_torch.train.model import init_params

    cfg = NetConfig()
    params = init_params(0, cfg)
    big = train_synthetic_nnue(TRAIN_NNUE_BATCH, seed=4)
    data = {k: torch.from_numpy(v).to(dev) for k, v in big.items()}
    mesh = card_mesh(dev, 1, 2)
    trainer = Trainer(cfg, mesh=mesh)
    state, _ = trainer.step(trainer.init(params=params), data)
    path = os.path.join(tmp, "shard.pt")
    save_checkpoint(path, state)
    state, m_ref = trainer.step(state, data)
    ref = nnue_arrays(state.params)
    del state
    again = Trainer(cfg, mesh=mesh)
    r, m_again = again.step(restore_checkpoint(path, again.init(seed=1)), data)
    got = nnue_arrays(r.params)
    del r
    bits = m_again["loss"] == m_ref["loss"] and all(
        np.array_equal(got[k], ref[k]) for k in ref)
    single = Trainer(cfg, device=dev)
    s, m_single = single.step(restore_checkpoint(path, single.init(seed=1)), data)
    lr = s.opt_state.param_groups[0]["lr"]
    worst, off, share, ok = nnue_gate(nnue_off(nnue_arrays(s.params), ref), lr, 1)
    loss_rel = abs(m_single["loss"] - m_ref["loss"]) / abs(m_ref["loss"])
    log(f"  resume: 1x2 checkpoint -> 1x2 step 2 == uninterrupted bit for bit: "
        f"{bits}; -> single-device step 2: loss rel diff {loss_rel:.3e}, "
        f"parameters max |diff| {worst:.3e}, {off} entries off (largest "
        f"share {share})")
    check(bits, "trainshard: the 1x2 resume is not the uninterrupted run")
    check(loss_rel <= 1e-4 and ok,
          "trainshard: the single-device resume is off the 1x2 run")
    return {"sharded_bits": bits, "single_loss_rel": loss_rel,
            "single_param_max_diff": worst, "single_params_off": off,
            "single_share_off": share}


def phase_trainshard(torch, dev, export_batch=None) -> dict:
    """The trainshard phase: the sharded trainers on logical shards of
    the card (NNUE, AZ, resume). ``export_batch`` holds the positions
    the packed kernel serves the export on: the train phase's labelled
    positions when it ran, else 512 seeded positions."""
    import tempfile

    from fishnet_tpu_torch.ops import ft_gather

    if export_batch is None:
        export_batch = train_synthetic_nnue(TRAIN_LABELS[2], seed=9)
    ft_gather.ft_accumulate_packed_cuda.launches = 0
    ft_gather.ft_accumulate_cuda.launches = 0
    out = {}
    t0 = time.perf_counter()
    out["nnue"] = trainshard_nnue(torch, dev, export_batch)
    log(f"  [trainshard] nnue in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["az"] = trainshard_az(torch, dev)
    log(f"  [trainshard] az in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="trainshard-") as tmp:
        out["resume"] = trainshard_resume(torch, dev, tmp)
    log(f"  [trainshard] resume in {time.perf_counter() - t0:.1f} s")
    out["launches"] = ft_gather.ft_accumulate_packed_cuda.launches
    dense = ft_gather.ft_accumulate_cuda.launches
    check(out["launches"] == 1 and dense == 0,
          f"trainshard: {out['launches']} packed, {dense} dense launches")
    return out


#: The metrics phase's bursts (256 searches of 500 nodes, cut from the
#: coalesce phase's 3000, then 1000, so its four bursts fit the default
#: run's time on a slow host) and the scraper's period.
METRICS_BURST_NODES = 500
METRICS_SCRAPE_S = 1.0


def exposition_families(text: str) -> dict:
    """Parse Prometheus text exposition 0.0.4 strictly: every line a
    HELP/TYPE comment or a sample of a typed family. Returns {family:
    type}; raises SmokeFailure on a bad line."""
    import re

    type_re = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
                         r"(counter|gauge|histogram|summary|untyped)$")
    help_re = re.compile(r"^# HELP [a-zA-Z_:][a-zA-Z0-9_:]* .*$")
    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
        r'(?:\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*"'
        r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*")*\})?'
        r" -?(?:[0-9]+(?:\.[0-9]+)?(?:[eE][-+]?[0-9]+)?|inf|nan)$")
    types = {}
    for line in text.splitlines():
        if not line:
            continue
        m = type_re.match(line)
        if m:
            types[m.group(1)] = m.group(2)
            continue
        if line.startswith("#"):
            check(help_re.match(line) is not None, f"metrics: bad line {line!r}")
            continue
        m = sample_re.match(line)
        check(m is not None, f"metrics: bad sample line {line!r}")
        name = m.group(1)
        family = name if name in types else re.sub(r"_(bucket|sum|count)$", "",
                                                     name)
        check(family in types, f"metrics: untyped sample {name}")
    return types


def metric_value(text: str, name: str, **labels) -> float:
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            if all(f'{k}="{v}"' in line for k, v in labels.items()):
                return float(line.rsplit(" ", 1)[1])
    raise SmokeFailure(f"metrics: no sample {name}{labels}")


def metric_total(text: str, name: str) -> float:
    """The sum of every sample of ``name`` (all label sets)."""
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith((name + "{", name + " ")))


def http_get(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as res:
        return res.read().decode()


class Scraper:
    """A thread polling ``url`` every METRICS_SCRAPE_S seconds; each
    scrape must parse as exposition 0.0.4 (``exposition_families``)."""

    def __init__(self, url: str) -> None:
        self.url, self.scrapes, self.errors = url, 0, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            try:
                exposition_families(http_get(self.url))
                self.scrapes += 1
            except Exception as err:  # noqa: BLE001 - reported by stop()
                self.errors.append(repr(err))
            if self._stop.wait(METRICS_SCRAPE_S):
                return

    def stop(self) -> int:
        self._stop.set()
        self._thread.join(30)
        check(not self._thread.is_alive(), "metrics: the scraper hung")
        check(not self.errors, f"metrics: scrapes failed: {self.errors[:3]}")
        return self.scrapes


#: counters() key -> the family that adapts it (the JAX names).
METRICS_ADAPTED = {
    "nodes": "fishnet_pool_nodes_total", "steps": "fishnet_pool_steps_total",
    "evals_shipped": "fishnet_pool_evals_shipped_total",
    "suspensions": "fishnet_pool_suspensions_total",
    "delta_evals": "fishnet_pool_delta_evals_total",
    "tt_eval_hits": "fishnet_pool_tt_eval_hits_total",
    "eval_steps": "fishnet_service_eval_steps_total",
    "dispatches": "fishnet_dispatches_total",
    "fused_dispatches": "fishnet_coalesced_dispatches_total",
    "bucket_slots": "fishnet_service_bucket_slots_total",
    "wire_bytes": "fishnet_service_wire_bytes_total",
    "fused_dedup": "fishnet_fused_dedup_total",
    "position_dedup": "fishnet_position_dedup_total",
    "cache_skipped_dispatches": "fishnet_eval_cache_skipped_dispatches_total",
    "bounds_seeded": "fishnet_bounds_seeded_total",
    "bounds_harvested": "fishnet_bounds_harvested_total",
}


def metrics_service(weights, dev):
    """The coalesce phase's service at the defaults (one driver thread
    per core, pipeline 2, microbatch 1024, the cache on), from a cold
    process cache, warmed up, with ``host_timers`` on it."""
    from fishnet_tpu_torch.configure import parse_and_configure
    from fishnet_tpu_torch.search.service import SearchService

    fresh_cache()
    threads = parse_and_configure(["run", "--no-conf"]).resolved_search_threads()
    service = SearchService(weights=weights, batch_capacity=1024,
                            pipeline_depth=2, driver_threads=threads,
                            device=dev)
    service.warmup()
    return service, host_timers(service)


def metrics_gates(service, url: str, c0: dict, scrapes: int) -> dict:
    """After a scraped burst: the service's families == ``counters()``
    (read once the pipeline's last decode is in: two equal reads around
    a scrape) and == the packed launches counted since ``c0``."""
    from fishnet_tpu_torch.ops import ft_gather

    launches = ft_gather.ft_accumulate_packed_cuda.launches
    dense = ft_gather.ft_accumulate_cuda.launches
    for _ in range(100):
        counters = service.counters()
        text = http_get(url)
        if service.counters() == counters:
            break
        time.sleep(0.05)
    families = exposition_families(text)
    off = {key: (metric_value(text, fam), counters[key])
           for key, fam in METRICS_ADAPTED.items()
           if metric_value(text, fam) != counters[key]}
    burst = counters["dispatches"] - c0["dispatches"]
    log(f"  {scrapes} scrapes of {len(families)} families during the burst, "
        f"all valid 0.0.4; after it fishnet_dispatches_total "
        f"{metric_value(text, 'fishnet_dispatches_total')}, counters() "
        f"{counters['dispatches']} ({burst} in the burst), packed launches "
        f"{launches}, dense {dense}; {len(METRICS_ADAPTED)} adapted "
        f"counters, off: {off}")
    check(scrapes >= 2, f"metrics: {scrapes} scrapes during the burst")
    check(not off, f"metrics: families != counters(): {off}")
    check(launches == burst > 0 and dense == 0,
          f"metrics: {launches} packed launches for {burst} dispatches")
    check(metric_value(text, "fishnet_shard_dispatches_total", shard="0")
          == counters["dispatches"], "metrics: shard 0's dispatches")
    return {"launches": launches, "families": len(families)}


def metrics_leg(weights, dev, scraped: bool, gate: bool = False) -> dict:
    """One burst at METRICS_BURST_NODES on a service of its own (a cold
    cache and table each leg): with ``scraped`` an exporter on an
    ephemeral port and a Scraper polling it, else no exporter; with
    ``gate`` the launch counts set to 0 before the burst and
    ``metrics_gates`` after it. ``start_exporter`` turns span recording
    on, as ``run --metrics-port`` does, so the scraped leg measures
    scrape plus spans; with ``gate`` its burst's ``/spans`` then passes
    ``span_checks`` (the leg's rings sized by ``whole_run_rings``). The
    flag goes off again when the leg's exporter closes."""
    rings = whole_run_rings() if gate else contextlib.nullcontext()
    with rings:
        return _metrics_leg(weights, dev, scraped, gate)


def _metrics_leg(weights, dev, scraped: bool, gate: bool) -> dict:
    from fishnet_tpu_torch import telemetry
    from fishnet_tpu_torch.ops import ft_gather

    service, timers = metrics_service(weights, dev)
    exporter = scraper = None
    out, gated = {}, None
    try:
        if scraped:
            exporter = telemetry.start_exporter(0)
            scraper = Scraper(f"{exporter.url}/metrics")
        ft_gather.ft_accumulate_packed_cuda.launches = 0
        ft_gather.ft_accumulate_cuda.launches = 0
        t_burst = time.monotonic()
        c0 = service.counters()
        try:
            nps = load_burst(service, out, nodes=METRICS_BURST_NODES)
        finally:
            scrapes = scraper.stop() if scraper is not None else 0
        if gate:
            gated = metrics_gates(service, f"{exporter.url}/metrics", c0,
                                  scrapes)
            for _ in range(100):  # the last dispatch_wait may trail
                spans = [sp for sp in json.loads(http_get(
                    f"{exporter.url}/spans"))["spans"]
                    if sp["t"] >= t_burst - 1e-4]
                stages = [sp["stage"] for sp in spans]
                if (stages.count("dispatch_wait")
                        >= stages.count("dispatch_issue")):
                    break
                time.sleep(0.02)
            gated["spans"] = span_checks(spans, "metrics B",
                                         launches=gated["launches"])
    finally:
        if exporter is not None:
            exporter.close()
            telemetry.disable()
        service.close()
    calls, seconds = timers.get("pack", [0, 0.0])
    return {"nps": nps, "dispatches": out["counters"]["dispatches"],
            "pack_ms_per_dispatch": seconds * 1e3 / max(1, calls),
            "scrapes": scrapes, "gate": gated}


def phase_metrics(torch, weights, dev) -> dict:
    """The metrics plane over the coalesce phase's service (one driver
    thread per core, pipeline 2, microbatch 1024, the cache on): the
    burst without an exporter (A) and with one on an ephemeral port
    scraped every second (B), A, B (cut from A, B, B, A so the default
    run keeps its time), numbers only; on B
    every scrape valid exposition 0.0.4, and after it the service's
    families == ``counters()`` and the packed launches. After close() a
    scrape still answers, without the service's families; two shards on
    a two-logical-shard mesh service."""
    from fishnet_tpu_torch import telemetry
    from fishnet_tpu_torch.search.service import SearchService

    legs = [metrics_leg(weights, dev, scraped, gate)
            for scraped, gate in ((False, False), (True, True))]
    log("  A, B (A without an exporter, B scraped every "
        f"{METRICS_SCRAPE_S:.0f} s and recording spans): nodes/s "
        f"{[round(leg['nps']) for leg in legs]} (B/A "
        f"{legs[1]['nps'] / max(legs[0]['nps'], 1e-9):.4f}, not gated), "
        "dispatches "
        f"{[leg['dispatches'] for leg in legs]}, pack ms a dispatch "
        f"{[round(leg['pack_ms_per_dispatch'], 4) for leg in legs]}, "
        f"scrapes {[leg['scrapes'] for leg in legs]}")
    exporter = telemetry.start_exporter(0)
    try:
        url = f"{exporter.url}/metrics"
        text = http_get(url)
        exposition_families(text)
        gone = ("fishnet_pool_nodes_total" not in text
                and "fishnet_service_info" not in text)
        log(f"  after close(): a scrape answers, the service's families "
            f"gone: {gone}")
        check(gone, "metrics: the closed service's families are exported")
        fresh_cache()
        mesh = SearchService(weights=weights, batch_capacity=1024,
                             pipeline_depth=2, driver_threads=2, device=dev,
                             mesh_devices=[dev, dev])
        try:
            mesh.warmup()
            load_burst(mesh, nodes=300)
            rep = mesh.shard_report()
            text = http_get(url)
            shards = [metric_value(text, "fishnet_shard_dispatches_total",
                                   shard=str(s)) for s in range(2)]
        finally:
            mesh.close()
    finally:
        exporter.close()
        telemetry.disable()
    log(f"  two logical shards: fishnet_shard_dispatches_total {shards}, "
        f"shard_report {rep['dispatches']}")
    check(shards == [float(d) for d in rep["dispatches"]] and min(shards) > 0,
          "metrics: the mesh service's shard families")
    gated = legs[1]["gate"]
    return {"launches": gated["launches"], "families": gated["families"],
            "legs": [{k: v for k, v in leg.items() if k != "gate"}
                     for leg in legs], "shard_dispatches": shards,
            "b_spans": gated["spans"]}


# -- spans and causal traces ----------------------------------------------------

#: The spans phase's sizes: the gated check's positions and nodes (the
#: faults ladder's), its pinned coalescer width (so fused dispatches
#: and their ``coalesce`` spans occur), and the client leg's games,
#: plies a game and move jobs (at RUN_NODES).
SPANS_WALKS = 8
SPANS_NODES = 1000
SPANS_WIDTH = "4"
SPANS_CLIENT = (2, 20, 1)


#: Spans a thread's ring holds while ``span_checks`` reads a run
#: (``whole_run_rings``): the recorder keeps its newest DEFAULT_CAPACITY
#: (4096) a thread, and a driver thread of the gated leg records more.
SPANS_RING = 1 << 17


@contextlib.contextmanager
def whole_run_rings():
    """Size the flight recorder's rings to SPANS_RING for the threads
    that record their first span inside this block (a thread's ring is
    made at its first span), so ``span_checks`` sees every span of the
    run; the default comes back after it."""
    from fishnet_tpu_torch.telemetry.spans import RECORDER

    capacity = RECORDER._capacity
    RECORDER._capacity = SPANS_RING
    try:
        yield
    finally:
        RECORDER._capacity = capacity


def span_checks(spans, what: str, launches: Optional[int] = None) -> dict:
    """The card's checks of one run's spans (the JAX package's
    ``critical_path`` does not run here, so they are written out): every
    step trace (``group_traces``' rule: a span with ``links`` also
    belongs to each linked trace, under the linked span) has one ``pack``
    root and no orphan; every ``dispatch_issue`` pairs with one
    ``dispatch_wait`` by ``seq``; every ``coalesce`` span carries
    ``width - 1`` links; and with ``launches`` the ``dispatch_issue``
    count equals the packed launches. The run's rings must hold all of
    it (``whole_run_rings``): a full ring fails the check. Returns the
    counts."""
    from collections import Counter

    per_thread = Counter(sp["thread"] for sp in spans)
    full = sorted(th for th, n in per_thread.items() if n >= SPANS_RING)
    traces = {}
    for sp in spans:
        if "trace_id" not in sp:
            continue
        traces.setdefault(sp["trace_id"], []).append(sp)
        for ltid, lsid in sp.get("links") or ():
            if ltid != sp["trace_id"]:
                traces.setdefault(ltid, []).append(
                    dict(sp, trace_id=ltid, parent_id=lsid))
    orphans = roots_bad = 0
    for tid, tree in traces.items():
        ids = {sp["span_id"] for sp in tree}
        roots = [sp for sp in tree if sp["stage"] == "pack"]
        roots_bad += len(roots) != 1 or roots[0]["span_id"] != tid
        orphans += sum(sp.get("parent_id") is not None
                       and sp["parent_id"] not in ids for sp in tree)
    issues = Counter(sp["seq"] for sp in spans
                     if sp["stage"] == "dispatch_issue")
    waits = Counter(sp["seq"] for sp in spans
                    if sp["stage"] == "dispatch_wait")
    coalesce = [sp for sp in spans if sp["stage"] == "coalesce"]
    bad_links = sum(len(sp.get("links") or ()) != sp["width"] - 1
                    for sp in coalesce)
    out = {"spans": len(spans), "step_traces": len(traces),
           "orphans": orphans, "dispatch_issue": sum(issues.values()),
           "dispatch_wait": sum(waits.values()), "coalesce": len(coalesce),
           "threads": len(per_thread),
           "stages": sorted({sp["stage"] for sp in spans})}
    log(f"  {what}: spans {out}")
    check(not full, f"{what}: the rings of {full} are full: the check "
                    "cannot see the whole run")
    check(traces, f"{what}: no step trace among the spans")
    check(orphans == 0 and roots_bad == 0,
          f"{what}: {orphans} orphan spans, {roots_bad} traces without one "
          "pack root")
    check(issues == waits and set(issues.values()) <= {1},
          f"{what}: dispatch_issue and dispatch_wait do not pair by seq")
    check(bad_links == 0,
          f"{what}: {bad_links} coalesce spans without width - 1 links")
    if launches is not None:
        check(out["dispatch_issue"] == launches,
              f"{what}: {out['dispatch_issue']} dispatch_issue spans for "
              f"{launches} packed launches")
    return out


def spans_gated(weights, dev) -> dict:
    """The gated service (the faults ladder's positions and nodes, the
    coalescer's width pinned to SPANS_WIDTH) with spans and the cost
    plane off, then both on (``telemetry.enable()`` and
    ``cost.enable()``, as ``start_exporter`` does under
    ``FISHNET_PROFILE=1``): the analyses equal bit for bit, packed
    launches == dispatches in both (``gated_run``), and the on run's
    spans pass ``span_checks`` with one ``dispatch_issue`` per packed
    launch, have no orphan under the port's ``critical_path`` and a
    ``report`` coverage of at least 0.95. The cost ledger records one
    entry a stepped microbatch (the JAX ledger's count, one a ticket),
    and its tenant shares sum to its measured wall within 2%. The launch
    counts are set to 0 after the on run's warm-up and read after its
    last answer."""
    import tempfile

    import torch

    from fishnet_tpu_torch import telemetry
    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.telemetry import cost
    from fishnet_tpu_torch.telemetry import critical_path as cp
    from fishnet_tpu_torch.telemetry.spans import RECORDER

    walks = random_lines(SPANS_WALKS, seed=13)
    env = dict(FISHNET_COALESCE_WIDTH=SPANS_WIDTH, FISHNET_NO_COALESCE=None)
    t_off = time.perf_counter()
    off, c_off = gated_run(weights, dev, walks, nodes=SPANS_NODES, **env)
    t_off = time.perf_counter() - t_off
    mark = {}

    def zero(svc):
        packed = ft_gather.ft_accumulate_packed_cuda
        packed.launches = packed.copy_launches = 0
        ft_gather.ft_accumulate_cuda.launches = 0
        mark["t0"] = time.monotonic()

    cost.reset()
    cost.enable()
    telemetry.enable()
    try:
        with whole_run_rings():
            t_on = time.perf_counter()
            on, c_on = gated_run(weights, dev, walks, nodes=SPANS_NODES,
                                 hook=zero, **env)
            t_on = time.perf_counter() - t_on
    finally:
        telemetry.disable()
        cost.disable()
    ledger = cost.LEDGER.snapshot()
    launches = ft_gather.ft_accumulate_packed_cuda.launches
    held = RECORDER.spans()
    spans = [sp for sp in held if sp["t"] >= mark["t0"] - 1e-4]
    # The on leg's close() dumped every span the process holds (the
    # service's clean-close dump): time the same dump once more.
    with tempfile.TemporaryDirectory() as tmp:
        t_dump = time.perf_counter()
        RECORDER.dump(os.path.join(tmp, "spans.jsonl"), reason="timing")
        t_dump = time.perf_counter() - t_dump
    log(f"  gated: {len(walks)} positions at {SPANS_NODES} nodes, width "
        f"{SPANS_WIDTH}: spans off {c_off['dispatches']} dispatches "
        f"({c_off['fused_dispatches']} fused) in {t_off:.3f} s, on "
        f"{c_on['dispatches']} ({c_on['fused_dispatches']} fused) in "
        f"{t_on:.3f} s (build, warm-up, searches and close; on, close() "
        f"dumps the {len(held)} spans the process holds: such a dump "
        f"takes {t_dump:.3f} s); packed launches {launches}")
    check(on == off, "spans gated: the analyses with spans and the cost "
                     "plane on differ from those with both off")
    check(c_on["dispatches"] == c_off["dispatches"] == launches > 0
          or torch.device(dev).type != "cuda",
          f"spans gated: {launches} launches, dispatches off "
          f"{c_off['dispatches']} on {c_on['dispatches']}")
    check(c_on["fused_dispatches"] > 0, "spans gated: no fused dispatch")
    report = span_checks(spans, "gated", launches=c_on["dispatches"])
    traced = [sp for sp in spans if "trace_id" in sp]
    orphans = cp.orphan_spans(traced)
    attribution = cp.report(traced)
    log(f"  gated: critical_path: {len(orphans)} orphan spans, report "
        f"{attribution}")
    check(orphans == [], f"spans gated: critical_path finds {len(orphans)} "
                         "orphan spans")
    check(attribution["coverage"] >= 0.95,
          f"spans gated: critical_path coverage {attribution['coverage']}")
    attributed = sum(ledger["tenant_device_ms"].values())
    log(f"  gated: cost ledger {ledger['dispatches']} records (one a "
        f"ticket) for {c_on['eval_steps']} eval steps in "
        f"{c_on['dispatches']} dispatches; tenants "
        f"{ledger['tenant_device_ms']} ms of {ledger['total_device_ms']:.3f} "
        f"ms measured, wire bytes {ledger['tenant_wire_bytes']}, cache hits "
        f"{ledger['tenant_cache_hits']}; card: {card_line()}")
    check(ledger["dispatches"] == c_on["eval_steps"] > 0,
          f"spans gated: the cost ledger holds {ledger['dispatches']} "
          f"records for {c_on['eval_steps']} eval steps")
    check(abs(attributed - ledger["total_device_ms"])
          <= 0.02 * ledger["total_device_ms"],
          f"spans gated: tenants' {attributed} ms against "
          f"{ledger['total_device_ms']} ms measured")
    log("  gated: the analyses with spans and the cost plane on == both "
        "off, bit for bit")
    return {"launches": launches, "dispatches": c_on["dispatches"],
            "fused": c_on["fused_dispatches"], "seconds_off": t_off,
            "seconds_on": t_on, "held": len(held), "dump_s": t_dump,
            "spans": report, "critical_path": attribution,
            "cost": {"records": ledger["dispatches"],
                     "eval_steps": c_on["eval_steps"],
                     "total_device_ms": ledger["total_device_ms"],
                     "tenant_device_ms": ledger["tenant_device_ms"]}}


class SpansClientLeg:
    """``python -m fishnet_tpu_torch run --metrics-port 0 --spans-dir D``
    as a subprocess against the stdlib fake lichess, SPANS_CLIENT[0]
    games of SPANS_CLIENT[1] plies at RUN_NODES and SPANS_CLIENT[2] move
    jobs queued at ``start``, so it works while the phase's in-process
    leg runs. ``finish`` waits for every submission, then: ``/spans``
    holds each submitted batch's complete tree (an ``acquire`` root
    whose span id is the trace id, its ``schedule`` child, one
    ``queue_wait`` per position under it, and for an analysis one
    ``submit`` under the root; no orphan); SIGUSR2 writes a
    ``fishnet-spans/2`` dump into D; SIGTERM drains it, records the
    ``drain`` span, and it dumps at the service's close and once more
    (reason "drain") before it exits 0
    with one packed launch per dispatch since its warm-up. The process
    runs with ``FISHNET_PROFILE=1``, so ``start_exporter`` arms the
    profiler and the cost plane: ``profile_checks`` reads ``/profile``,
    ``/trace`` and ``/metrics`` before the signals. Its log lands in
    ``chiprun_out/spans/``."""

    def __init__(self, dev) -> None:
        import tempfile

        import torch

        self.device = torch.device(dev).type
        out_dir = ROOT / "chiprun_out" / "spans"
        out_dir.mkdir(parents=True, exist_ok=True)
        self.log_path = out_dir / "run.log"
        self.tmp = tempfile.mkdtemp(prefix="fishnet-spans-")
        self.port_file = os.path.join(self.tmp, "metrics.port")
        self.spans_dir = os.path.join(self.tmp, "spans")
        self.server = FakeServer()
        self.proc = None
        self.jobs = {}

    def start(self) -> None:
        self.server.__enter__()
        games, plies, moves = SPANS_CLIENT
        lines = random_games(games + moves, plies, seed=53)
        for line in lines[:games]:
            self.jobs[self.server.lichess.add_analysis_job(
                moves=" ".join(line), nodes=RUN_NODES)] = plies + 1
        for line in lines[games:]:
            self.jobs[self.server.lichess.add_move_job(
                moves=" ".join(line[:plies // 2]), level=1)] = 1
        cmd = [sys.executable, "-m", "fishnet_tpu_torch", "run", "--no-conf",
               "--no-stats-file", "--endpoint", self.server.endpoint, "--key",
               VALID_KEY, "--max-backoff", "1", "--metrics-port", "0",
               "--metrics-port-file", self.port_file, "--spans-dir",
               self.spans_dir, "--device", self.device, "-v"]
        env = dict(os.environ, FISHNET_PROFILE="1")
        for var in ("FISHNET_SPANS_FILE", "FISHNET_SPANS_DIR",
                    "FISHNET_FAULT_PLAN", "FISHNET_PROFILE_HZ"):
            env.pop(var, None)
        with open(self.log_path, "w", encoding="utf-8") as logf:
            self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=logf,
                                         stderr=subprocess.STDOUT)

    def close(self) -> None:
        import shutil

        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.server.__exit__(None, None, None)
        shutil.rmtree(self.tmp, ignore_errors=True)

    def _dump(self) -> tuple:
        """(headers, spans by header index) of the process's dump file."""
        path = os.path.join(self.spans_dir,
                            f"fishnet-spans-{self.proc.pid}.jsonl")
        headers, bodies = [], []
        if os.path.exists(path):
            with open(path, encoding="utf-8") as fp:
                for line in fp:
                    rec = json.loads(line)
                    if "format" in rec:
                        headers.append(rec)
                        bodies.append([])
                    elif bodies:
                        bodies[-1].append(rec)
        return headers, bodies

    @staticmethod
    def profile_checks(base: str) -> dict:
        """The profiling plane of the running process: ``/profile``'s
        samples include the driver, pack and decode roles and its
        collapsed text is non-empty; ``/trace`` passes the port's
        ``validate_chrome_trace``; ``/metrics`` carries the stage
        histogram and the tenants' device ms, which sum to the measured
        ``fishnet_cost_device_ms_total`` within 2%."""
        from fishnet_tpu_torch.telemetry.trace_export import (
            validate_chrome_trace,
        )

        prof = json.loads(http_get(f"{base}/profile"))
        roles = prof["samples_by_role"]
        collapsed = http_get(f"{base}/profile?format=collapsed")
        trace = json.loads(http_get(f"{base}/trace"))
        validate_chrome_trace(trace)
        text = http_get(f"{base}/metrics")
        families = exposition_families(text)
        tenants = metric_total(text, "fishnet_tenant_device_ms_total")
        total = metric_total(text, "fishnet_cost_device_ms_total")
        duty = prof["self_seconds"] / prof["wall_seconds"]
        log(f"  client: /profile {prof['samples']} samples at {prof['hz']} "
            f"Hz over {prof['wall_seconds']} s, roles {roles}, "
            f"{prof['distinct_stacks']} stacks, {len(collapsed.splitlines())} "
            f"collapsed lines; the sampler's duty cycle (self_seconds / "
            f"wall) {duty:.6f} on {card_line()}")
        log(f"  client: /trace {len(trace['traceEvents'])} events, valid; "
            f"/metrics tenants {tenants:.3f} ms of {total:.3f} ms measured "
            f"over {metric_total(text, 'fishnet_cost_dispatches_total'):.0f} "
            f"records, stages "
            f"{sorted(prof['stages'])}")
        check({"driver", "pack", "decode"} <= set(roles),
              f"spans client: /profile roles {roles}")
        check(collapsed.strip() != "", "spans client: /profile?format="
                                       "collapsed is empty")
        check("fishnet_stage_duration_seconds" in families
              and "fishnet_tenant_device_ms_total" in families,
              "spans client: /metrics lacks the stage histogram or the "
              "tenants' device ms")
        check(total > 0 and abs(tenants - total) <= 0.02 * total,
              f"spans client: tenants' {tenants} ms against {total} ms")
        return {"samples": prof["samples"], "roles": roles,
                "duty_cycle": duty, "trace_events": len(trace["traceEvents"]),
                "tenant_device_ms": tenants, "cost_device_ms": total}

    def finish(self) -> dict:
        from fishnet_tpu_torch.telemetry.tracing import trace_id_for_batch

        proc, lichess = self.proc, self.server.lichess
        t0 = time.monotonic()
        deadline = t0 + 300
        while not all(i in lichess.analyses or i in lichess.moves
                      for i in self.jobs):
            check(proc.poll() is None,
                  f"spans client: the CLI exited early ({proc.returncode})")
            check(time.monotonic() < deadline,
                  "spans client: the jobs did not finish")
            time.sleep(0.05)
        waited = time.monotonic() - t0
        with open(self.port_file, encoding="utf-8") as fp:
            base = f"http://127.0.0.1:{int(fp.read())}"
        trees = {}
        while True:
            doc = json.loads(http_get(f"{base}/spans"))
            check(set(doc) == {"pid", "monotonic_to_epoch", "spans"},
                  f"spans client: /spans keys {sorted(doc)}")
            for bid in self.jobs:
                tid = trace_id_for_batch(bid)
                trees[bid] = [sp for sp in doc["spans"]
                              if sp.get("trace_id") == tid]
            if all(any(sp["stage"] == "submit" for sp in trees[bid])
                   for bid in self.jobs if bid in lichess.analyses):
                break
            check(time.monotonic() < deadline,
                  "spans client: no submit span for a submitted analysis")
            time.sleep(0.05)
        shapes = {}
        for bid, positions in self.jobs.items():
            tid, tree = trace_id_for_batch(bid), trees[bid]
            by_id = {sp["span_id"]: sp["stage"] for sp in tree}
            shape = {}
            for sp in tree:
                key = f"{sp['stage']}<{by_id.get(sp.get('parent_id'), '-')}"
                shape[key] = shape.get(key, 0) + 1
            want = {"acquire<-": 1, "schedule<acquire": 1,
                    "queue_wait<schedule": positions}
            if bid in lichess.analyses:
                want["submit<acquire"] = 1
            roots = [sp for sp in tree if sp["stage"] == "acquire"]
            check(shape == want and roots[0]["span_id"] == tid,
                  f"spans client: batch {bid}'s tree {shape} != {want}")
            shapes[bid] = shape
        profile = self.profile_checks(base)
        proc.send_signal(signal.SIGUSR2)
        while not [h for h in self._dump()[0] if h["reason"] == "SIGUSR2"]:
            check(time.monotonic() < deadline, "spans client: no SIGUSR2 dump")
            time.sleep(0.05)
        t_term = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        took = time.monotonic() - t_term
        headers, bodies = self._dump()
        text = self.log_path.read_text()
        for line in text.splitlines()[-3:]:
            log(f"  | {line[:300]}")
        reasons = [h["reason"] for h in headers]
        drains = [sp for body in bodies for sp in body
                  if sp["stage"] == "drain"]
        log(f"  client: {len(self.jobs)} batches submitted after "
            f"{waited:.3f} s, each with its complete tree on /spans "
            f"({len(doc['spans'])} spans); dumps {reasons} "
            f"({[h['spans'] for h in headers]} spans), the drain span "
            f"{[(sp['reason'], sp.get('deadline_s')) for sp in drains[-1:]]}; "
            f"exit {rc} {took:.3f} s after SIGTERM")
        check(rc == 0, f"spans client: the CLI exited {rc}")
        # The service's close() dumps too (reason "close"), before the
        # drained exit's own dump.
        check(all(h["format"] == "fishnet-spans/2" for h in headers)
              and reasons == ["SIGUSR2", "close", "drain"],
              f"spans client: dumps {reasons}")
        check([sp["reason"] for sp in bodies[-1] if sp["stage"] == "drain"]
              == ["sigterm"], "spans client: the drain dump has no drain span")
        steps, dispatches, packed, dense, rung = teardown_counts(text)
        check(packed > 0 and dense == 0
              and (packed == dispatches or self.device != "cuda"),
              f"spans client: {packed} packed launches ({dense} dense) for "
              f"{dispatches} dispatches")
        return {"batches": len(self.jobs), "trees": shapes,
                "dumps": reasons, "spans_on_route": len(doc["spans"]),
                "exit_after_sigterm_s": took, "launches": packed,
                "dispatches": dispatches, "profile": profile}


def phase_spans(torch, weights, dev) -> dict:
    """Spans and causal traces on the card: ``spans_gated`` in process
    while ``SpansClientLeg``'s ``run`` process serves its jobs beside
    it, then the client leg's checks. "launches" is the gated on run's
    count (the client's launches are its process's own)."""
    t0 = time.perf_counter()
    leg = SpansClientLeg(dev)
    try:
        leg.start()
        out = {"gated": spans_gated(weights, dev)}
        out["client"] = leg.finish()
    finally:
        leg.close()
    out["launches"] = out["gated"]["launches"]
    out["seconds"] = time.perf_counter() - t0
    log(f"  spans: {out['seconds']:.3f} s on {card_line()}")
    return out


# -- fault injection, exactly-once accounting, graceful drain -------------------

#: The faults phase's sizes: the gated positions of the ladder and mesh
#: legs and their nodes; the client leg's games (40 plies at RUN_NODES)
#: and move jobs; the drain leg's; the split leg's walks.
FAULTS_WALKS = 8
FAULTS_NODES = 1000
FAULTS_CLIENT = (4, 2)
FAULTS_DRAIN = (6, 2)
FAULTS_DRAIN_DEADLINE = 10
FAULTS_RPC_WALKS = 3
FAULTS_RPC_NODES = 500
#: Every fault site of the client's path at once, all ``nth``: two
#: acquires, the first submission, the first engine start, the second
#: batch's schedule.
FAULTS_CLIENT_PLAN = ("seed=7;net.acquire:nth=2..3:error;net.submit:nth=1:error;"
                      "engine.spawn:nth=1:error;queue.schedule:nth=2:error")
#: The split host drops its link every 40th sweep with one attached: the
#: sweeps before the frontend's first record count too, so an early
#: single ``nth`` would land before anything is in flight.
FAULTS_DETACH_PLAN = "rpc.detach:every=40:error"


def expected_injections(plan) -> dict:
    """(site, action) -> the faults an all-``nth`` plan injected, from
    its per-site call counts."""
    counts = plan.counts()
    out = {}
    for site, rules in plan.rules.items():
        for rule in rules:
            check(rule.trigger == "nth", f"faults: {site} is not an nth rule")
            fired = max(0, min(rule.hi, counts[site]) - rule.lo + 1)
            out[(site, rule.action)] = out.get((site, rule.action), 0) + fired
    return out


def injected(text: str, key) -> float:
    """``fishnet_faults_injected_total`` of one (site, action) in an
    exposition; 0 before the first injection there."""
    site, action = key
    try:
        return metric_value(text, "fishnet_faults_injected_total", site=site,
                            action=action)
    except SmokeFailure:
        return 0.0


def faults_ladder(weights, dev, walks) -> tuple:
    """The supervisor's ladder forced on the card: ``walks`` (gated
    positions) searched unfaulted on the top rung (``gated_run``), then
    through the supervised ``tpu-nnue`` factory (the CLI's
    ``degrade_after``) under ``service.device_step:nth=1:crash`` twice —
    each crash takes the driver down before its first dispatch and fails
    every search — and a third time without a plan, one rung down. The
    retried searches equal the unfaulted ones bit for bit; every rung
    launches the packed kernel once per dispatch (each round's counts
    zeroed after its service's warm-up) and the error word never moves.
    Returns the leg's report and the unfaulted analyses."""
    import torch

    from fishnet_tpu_torch.engine.tpu_engine import TpuNnueEngineFactory
    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.protocol.types import EngineFlavor
    from fishnet_tpu_torch.resilience.supervisor import (
        ServiceSupervisor,
        ladder_for,
    )
    from fishnet_tpu_torch.search.service import SearchService
    from fishnet_tpu_torch.utils.logger import Logger

    device = torch.device(dev)
    gpu = device.type == "cuda"
    ladder = ladder_for(device.type)
    want, ref = gated_run(weights, dev, walks, nodes=FAULTS_NODES)

    def builder(rung):
        fresh_cache()
        svc = gated_service(weights, dev, pool_slots=8, batch_capacity=256,
                            tt_bytes=8 << 20, pipeline_depth=4,
                            psqt_path=rung)
        SearchService.warmup(svc)  # the warm-up's launch, before the count
        return svc

    sup = ServiceSupervisor(builder, rungs=ladder, logger=Logger(verbose=0))
    factory = TpuNnueEngineFactory(service_builder=sup.build)
    packed = ft_gather.ft_accumulate_packed_cuda
    rounds = []

    async def one_round(crash: bool):
        engine = await factory.create(EngineFlavor.OFFICIAL)
        svc = engine.service
        errors0 = ft_gather.kernel_errors(dev) if gpu else 0
        d0 = svc.counters()["dispatches"]
        packed.launches = packed.copy_launches = 0  # after the warm-up
        ft_gather.ft_accumulate_cuda.launches = 0
        results = await open_gate(
            svc, walks, FAULTS_NODES, return_exceptions=True,
            plan="service.device_step:nth=1:crash" if crash else None)
        row = {"rung": svc.psqt_path, "supervisor": sup.rung,
               "failed": sum(isinstance(r, BaseException) for r in results),
               "alive": svc.is_alive(),
               "dispatches": svc.counters()["dispatches"] - d0,
               "launches": packed.launches,
               "dense": ft_gather.ft_accumulate_cuda.launches}
        if gpu:
            errors = ft_gather.kernel_errors(dev)
            check(errors == errors0, f"faults ladder: the error word moved "
                                     f"{errors0} -> {errors}")
            check(row["launches"] == row["dispatches"] and row["dense"] == 0,
                  f"faults ladder: launches {row}")
        rounds.append(row)
        return [(r.best_move, r.depth, r.nodes,
                 [(ln.multipv, ln.depth, ln.is_mate, ln.value, ln.pv)
                  for ln in r.lines])
                for r in results if not isinstance(r, BaseException)]

    async def walk():
        return [await one_round(crash) for crash in (True, True, False)]

    try:
        t0 = time.perf_counter()
        _, _, retried = asyncio.run(walk())
        seconds = time.perf_counter() - t0
    finally:
        factory.close()
    log(f"  ladder: {len(walks)} gated positions at {FAULTS_NODES} nodes, "
        f"unfaulted on {ladder[0]} ({ref['dispatches']} dispatches); then "
        f"crash, crash, retry: {rounds}; respawns {sup.respawns}; "
        f"{seconds:.3f} s")
    check([r["rung"] for r in rounds] == [ladder[0], ladder[0], ladder[1]],
          f"faults ladder: rungs {rounds}")
    check([r["failed"] for r in rounds] == [len(walks), len(walks), 0]
          and [r["alive"] for r in rounds[:2]] == [False, False],
          f"faults ladder: the crashes did not take the driver down {rounds}")
    check(rounds[2]["dispatches"] > 0 and sup.respawns == 2,
          f"faults ladder: the retry {rounds[2]}, respawns {sup.respawns}")
    check(retried == want, "faults ladder: the retried searches on "
                           f"{ladder[1]} differ from the unfaulted ones")
    log(f"  ladder: the retried searches on {ladder[1]} == the unfaulted "
        f"ones on {ladder[0]}, bit for bit")
    return {"rounds": rounds, "unfaulted_dispatches": ref["dispatches"],
            "respawns": sup.respawns, "seconds": seconds,
            "launches": sum(r["launches"] for r in rounds)}, want


def faults_client(dev, url: str) -> dict:
    """The client under FAULTS_CLIENT_PLAN with the batch ledger on:
    ``Client`` over the factory ``run`` builds, against the stdlib fake
    lichess (FAULTS_CLIENT games at RUN_NODES, move jobs). Every batch
    ends submitted (once, on the server too) or, the one whose schedule
    failed, invalid; the ledger is clean; each site fired as its rules
    say, and ``fishnet_faults_injected_total`` on ``url``'s /metrics
    moved by just that; the service stayed on its top rung with one
    packed launch per dispatch."""
    import torch

    from fishnet_tpu_torch.__main__ import build_engine_factory
    from fishnet_tpu_torch.client import Client
    from fishnet_tpu_torch.configure import parse_and_configure
    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.protocol.types import EngineFlavor
    from fishnet_tpu_torch.resilience import accounting, faults
    from fishnet_tpu_torch.resilience.supervisor import ladder_for
    from fishnet_tpu_torch.utils.logger import Logger

    fresh_cache()
    logger = Logger(verbose=0)
    device = torch.device(dev)
    opt = parse_and_configure(
        ["run", "--no-conf", "--no-stats-file", "--microbatch", "1024",
         "--pipeline", "2", "--device", device.type])
    before = http_get(f"{url}/metrics")
    plan = faults.install(FAULTS_CLIENT_PLAN)
    led = accounting.install()
    factory = build_engine_factory(opt, logger)
    packed = ft_gather.ft_accumulate_packed_cuda
    try:
        with FakeServer() as server:
            lichess = server.lichess
            games, moves = FAULTS_CLIENT
            ids, move_ids = add_run_jobs(lichess, games, moves, seed=43,
                                         nodes=RUN_NODES)
            jobs = ids + move_ids
            client = Client(endpoint=server.endpoint, key=VALID_KEY,
                            cores=opt.resolved_cores(), engine_factory=factory,
                            logger=logger, max_backoff=1.0,
                            workers=opt.resolved_workers())

            async def run():
                await factory.create(EngineFlavor.OFFICIAL)
                d0 = factory.service.counters()["dispatches"]
                packed.launches = packed.copy_launches = 0  # after warm-up
                ft_gather.ft_accumulate_cuda.launches = 0
                t0 = time.perf_counter()
                await client.start()
                try:
                    deadline = time.monotonic() + 600
                    while not all(led.record(i) is not None
                                  and led.record(i).terminal is not None
                                  for i in jobs):
                        check(time.monotonic() < deadline,
                              f"faults client: not done {led.report()}")
                        await asyncio.sleep(0.05)
                finally:
                    await client.stop()
                return (time.perf_counter() - t0,
                        factory.service.counters()["dispatches"] - d0,
                        packed.launches,
                        ft_gather.ft_accumulate_cuda.launches)

            seconds, dispatches, launches, dense = asyncio.run(run())
            audit = lichess.audit()
            subs = dict(lichess.submissions)
            rung = (factory.supervisor.rung, factory.service.psqt_path,
                    factory.supervisor.respawns, factory.service.is_alive())
            analyses = {i: lichess.analyses[i]["analysis"] for i in ids
                        if i in lichess.analyses}
    finally:
        factory.close()
        faults.clear()
        accounting.clear()
    after = http_get(f"{url}/metrics")
    report = led.assert_clean()
    records = {i: led.record(i) for i in jobs}
    want = {k: float(v) for k, v in expected_injections(plan).items()}
    fired = {k: injected(after, k) - injected(before, k) for k in want}
    terminals = sorted(r.terminal for r in records.values())
    log(f"  client: {games} games at {RUN_NODES} nodes and {moves} move jobs "
        f"under {FAULTS_CLIENT_PLAN!r}: ledger {report}; site calls "
        f"{plan.counts()}; /metrics injected {sorted(fired.items())}; "
        f"{dispatches} dispatches, {launches} packed launches, rung {rung}; "
        f"{seconds:.3f} s")
    check(terminals == ["invalid"] + ["submitted"] * (len(jobs) - 1),
          f"faults client: terminal states {terminals}")
    for i, rec in records.items():
        if rec.terminal == "submitted":
            check(subs.get(i) == 1, f"faults client: {i} submitted "
                                    f"{subs.get(i)} times on the server")
        else:
            check(i not in subs, f"faults client: invalid {i} submitted")
    check(not audit["duplicated"], f"faults client: {audit}")
    check(fired == want and want[("queue.schedule", "error")] == 1
          and want[("engine.spawn", "error")] == 1
          and want[("net.submit", "error")] == 1
          and want[("net.acquire", "error")] == 2,
          f"faults client: /metrics injected {fired}, the plan's rules and "
          f"counts say {want}")
    check(rung == (ladder_for(device.type)[0],) * 2 + (0, True),
          f"faults client: the service left its top rung or died {rung}")
    check(launches > 0 and dense == 0
          and (launches == dispatches or device.type != "cuda"),
          f"faults client: {launches} packed launches ({dense} dense) for "
          f"{dispatches} dispatches")
    for work_id, parts in analyses.items():
        check(len(parts) == 41 and sum(p == {"skipped": True}
                                       for p in parts) == 1
              and all("score" in p for p in parts if p != {"skipped": True}),
              f"faults client: {work_id} analysis malformed")
    return {"ledger": report, "calls": plan.counts(),
            "injected": {f"{s}:{a}": v for (s, a), v in sorted(fired.items())},
            "dispatches": dispatches, "launches": launches,
            "seconds": seconds}


def faults_mesh(weights, dev, walks, want) -> dict:
    """Two logical shards of the card under ``service.device_step:nth=2:
    error``: the faulted group's shard steps one rung down, its sibling
    never moves, the step is dispatched on the degraded path, and the
    analyses equal ``want``, the ladder leg's unfaulted ``walks`` on one
    device (the mesh phase holds the mesh to no mesh). The launch counts
    are zeroed after the warm-up (``gated_run`` holds the packed
    launches to the dispatches). The ledger is the harness's own bookkeeping around
    ``svc.search`` (``open_gate``), as in the JAX package's test: no
    ledger call of the port lies on this path."""
    import torch

    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.resilience import accounting
    from fishnet_tpu_torch.resilience.supervisor import ladder_for

    ladder = ladder_for(torch.device(dev).type)
    packed = ft_gather.ft_accumulate_packed_cuda

    def zero(_svc):
        packed.launches = packed.copy_launches = 0
        ft_gather.ft_accumulate_cuda.launches = 0

    led = accounting.install()
    try:
        t0 = time.perf_counter()
        got, c = gated_run(weights, dev, walks, nodes=FAULTS_NODES,
                           mesh_devices=[dev, dev], hook=zero,
                           plan="service.device_step:nth=2:error", ledger=led,
                           FISHNET_SHARD_PLACEMENT="rr")
        seconds = time.perf_counter() - t0
    finally:
        accounting.clear()
    rep = c["shards"]
    report = led.assert_clean()
    launches = packed.launches
    log(f"  mesh: two logical shards, {len(walks)} gated positions: "
        f"rungs {rep['rungs']}, degradations {rep['degradations']}, "
        f"dispatches {rep['dispatches']}, {launches} packed launches, "
        f"ledger {report}; {seconds:.3f} s")
    check(len(rep["degradations"]) == 1, f"faults mesh: {rep}")
    shard, frm, to = rep["degradations"][0]
    check((frm, to) == ladder[:2] and rep["rungs"][shard] == ladder[1]
          and rep["rungs"][1 - shard] == ladder[0] and all(rep["alive"]),
          f"faults mesh: not one shard-local step {rep}")
    check(got == want, "faults mesh: the analyses differ from the "
                       "unfaulted run's")
    check(report["submitted"] == len(walks), f"faults mesh: {report}")
    log("  mesh: one shard stepped down, its sibling unmoved; the analyses "
        "== the unfaulted run's, bit for bit")
    return {"rungs": rep["rungs"], "degradations": rep["degradations"],
            "dispatches": rep["dispatches"], "launches": launches,
            "ledger": report, "seconds": seconds}


class DrainLeg:
    """``python -m fishnet_tpu_torch run`` as a subprocess with
    ``--drain-deadline`` and a submit latency fault widening the flush,
    against the stdlib fake lichess. ``start`` launches it with no job
    queued (it starts up and polls while the phase's other legs run);
    ``finish`` queues FAULTS_DRAIN games and move jobs and SIGTERMs it
    once the move jobs are in, the games' searches in flight. While it
    drains, ``/healthz/ready`` answers 503 with ``draining: true``,
    ``/healthz/live`` 200 and ``fishnet_drain_state`` is 1; it exits 0,
    and on the server every job it took was submitted once or aborted
    back, none held. Its teardown log counts one packed launch per
    dispatch since its warm-up. SIGTERM waits for the move jobs because
    of ROADMAP C16: a move job whose search ends during a drain is
    neither submitted nor aborted (the queue stops chasing move
    submissions once ``shutdown_soon`` runs, as in the JAX package), so
    it would stay held until the server's timeout;
    tests/test_torch_resilience.py pins that gap on the CPU."""

    def __init__(self, dev) -> None:
        import tempfile

        import torch

        self.device = torch.device(dev).type
        out_dir = ROOT / "chiprun_out" / "faults"
        out_dir.mkdir(parents=True, exist_ok=True)
        self.log_path = out_dir / "drain.log"
        self.port_file = os.path.join(
            tempfile.mkdtemp(prefix="fishnet-drain-"), "metrics.port")
        self.server = FakeServer()
        self.proc = None

    def start(self) -> None:
        self.server.__enter__()
        cmd = [sys.executable, "-m", "fishnet_tpu_torch", "run", "--no-conf",
               "--no-stats-file", "--endpoint", self.server.endpoint, "--key",
               VALID_KEY, "--max-backoff", "1", "--drain-deadline",
               f"{FAULTS_DRAIN_DEADLINE}s", "--metrics-port", "0",
               "--metrics-port-file", self.port_file, "--fault-plan",
               "net.submit:every=1:latency=0.5", "--device", self.device,
               "-v"]
        env = dict(os.environ)
        env.pop("FISHNET_FAULT_PLAN", None)
        with open(self.log_path, "w", encoding="utf-8") as logf:
            self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=logf,
                                         stderr=subprocess.STDOUT)

    def close(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.server.__exit__(None, None, None)

    def finish(self) -> dict:
        import json as json_mod
        import urllib.error
        import urllib.request

        def get(url):
            try:
                with urllib.request.urlopen(url, timeout=5) as res:
                    return res.status, res.read()
            except urllib.error.HTTPError as err:
                return err.code, err.read()

        proc, lichess = self.proc, self.server.lichess
        deadline = time.monotonic() + 300
        while not os.path.exists(self.port_file):
            check(proc.poll() is None,
                  f"faults drain: the CLI exited early ({proc.returncode})")
            check(time.monotonic() < deadline, "faults drain: no exporter")
            time.sleep(0.05)
        with open(self.port_file, encoding="utf-8") as fp:
            base = f"http://127.0.0.1:{int(fp.read())}"
        games, moves = FAULTS_DRAIN
        ids, move_ids = add_run_jobs(lichess, games, moves, seed=47,
                                     nodes=RUN_NODES)
        while not all(i in lichess.moves for i in move_ids):
            check(proc.poll() is None,
                  f"faults drain: the CLI exited early ({proc.returncode})")
            check(time.monotonic() < deadline,
                  "faults drain: the move jobs did not finish")
            time.sleep(0.02)
        done_before = sum(i in lichess.analyses for i in ids)
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        ready = live = state = seen_at = None
        while ready is None and time.monotonic() < t0 + 10:
            try:
                status, body = get(f"{base}/healthz/ready")
                if status == 503 and b"draining" in body:
                    seen_at = time.monotonic() - t0
                    ready = json_mod.loads(body)["providers"]["drain"]
                    live = get(f"{base}/healthz/live")
                    state = metric_value(get(f"{base}/metrics")[1].decode(),
                                         "fishnet_drain_state")
            except OSError:
                pass  # the exporter may be gone already: checked below
            time.sleep(0.02)
        rc = proc.wait(timeout=FAULTS_DRAIN_DEADLINE + 110)
        took = time.monotonic() - t0
        audit = lichess.audit()
        done_after = sum(i in lichess.analyses for i in ids)
        text = self.log_path.read_text()
        for line in text.splitlines()[-4:]:
            log(f"  | {line[:300]}")
        log(f"  drain: SIGTERM after {done_before} of {games} games; "
            f"readiness 503 after {seen_at} s: {ready}; liveness {live}; "
            f"fishnet_drain_state {state}; exit {rc} after {took:.3f} s; "
            f"{done_after} games submitted; server audit {audit}")
        check(rc == 0, f"faults drain: the CLI exited {rc}")
        check(ready is not None and ready["reason"] == "sigterm"
              and ready["deadline_s"] == float(FAULTS_DRAIN_DEADLINE)
              and "pending" in ready,
              f"faults drain: readiness never answered 503 draining: {ready}")
        check(live == (200, b"ok\n"), f"faults drain: liveness {live}")
        check(state == 1.0, f"faults drain: fishnet_drain_state {state}")
        check(not audit["held"] and not audit["duplicated"],
              f"faults drain: jobs held or submitted twice: {audit}")
        check(took < FAULTS_DRAIN_DEADLINE + 30,
              f"faults drain: {took:.1f} s from SIGTERM to exit")
        steps, dispatches, packed, dense, rung = teardown_counts(text)
        check(packed > 0 and dense == 0
              and (packed == dispatches or self.device != "cuda"),
              f"faults drain: {packed} packed launches ({dense} dense) for "
              f"{dispatches} dispatches")
        return {"sigterm_to_exit_s": took, "ready_503_after_s": seen_at,
                "pending_at_sigterm": ready["pending"],
                "games_before": done_before, "games_after": done_after,
                "audit": audit, "launches": packed, "dispatches": dispatches,
                "rung": rung}


def faults_rpc_monolith(weights, dev, walks) -> list:
    """The split leg's reference: the walks searched one at a time on the
    monolith on the card under the split phase's parity settings."""
    from fishnet_tpu_torch.search.service import SearchService

    with env_vars(FISHNET_NO_EVAL_CACHE="1", FISHNET_NO_BOUNDS="1"):
        fresh_cache()
        mono = SearchService(weights=weights, device=dev,
                             psqt_path="host-material", driver_threads=1,
                             **SPLIT_SERVICE)
    try:
        mono.set_prefetch(0, adaptive=False)

        async def sequential():
            return [analysis_of(await mono.search(STARTPOS, m,
                                                  nodes=FAULTS_RPC_NODES))
                    for m in walks]

        return asyncio.run(sequential())
    finally:
        mono.close()


def faults_rpc(net: str, rpc_dir: str, walks, want) -> dict:
    """``rpc.detach`` on the split plane: an evaluator host process under
    FAULTS_DETACH_PLAN (from FISHNET_FAULT_PLAN) and one frontend
    process searching ``walks`` one at a time. The host detaches the
    link while microbatches are in flight, the frontend resubmits after
    the epoch bump, and its analyses equal ``want``, the monolith's
    (``faults_rpc_monolith``), bit for bit."""
    t0 = time.perf_counter()
    run = split_run(net, rpc_dir, 1, 1, walks, FAULTS_RPC_NODES, "detach",
                    parity=True, env={"FISHNET_FAULT_PLAN": FAULTS_DETACH_PLAN})
    seconds = time.perf_counter() - t0
    front = run["reports"][0]
    detaches = run["stats"]["rings"].get("detach.fault", 0)
    resubmits = front["rings"].get("resubmits", 0)
    log(f"  rpc.detach: {detaches} detaches on the host, {resubmits} "
        f"resubmits by the frontend, {run['stats']['dispatches']} host "
        f"dispatches; {seconds:.3f} s")
    check(detaches >= 1 and resubmits >= 1,
          f"faults rpc: {detaches} detaches, {resubmits} resubmits")
    check(front["analyses"] == want,
          "faults rpc: the frontend's analyses differ from the monolith's")
    log(f"  rpc.detach: {len(walks)} searches at {FAULTS_RPC_NODES} nodes "
        "through the detaching host == the monolith's, bit for bit")
    return {"detaches": detaches, "resubmits": resubmits,
            "host_dispatches": run["stats"]["dispatches"],
            "host_launches": run["stats"]["launches"]["dense"],
            "seconds": seconds}


def phase_faults(torch, weights, dev) -> dict:
    """Fault injection, exactly-once accounting and graceful drain on
    the card (``faults_ladder``, ``faults_client``, ``faults_mesh``,
    ``DrainLeg``, ``faults_rpc``). The drain leg's process starts first
    and idles while the in-process legs run; then it drains while the
    split leg's processes run beside it. Each in-process leg zeroes the
    kernel's launch counts just before its faulted run and reads them
    just after; "launches" holds those three counts (the drain's and the
    split host's launches are their processes' own)."""
    import shutil
    import tempfile

    from fishnet_tpu_torch import telemetry

    t0 = time.perf_counter()
    drain = DrainLeg(dev)
    rpc_dir = tempfile.mkdtemp(prefix="fishnet-faults-")
    try:
        drain.start()
        walks = random_lines(FAULTS_WALKS, seed=13)
        out = {}
        out["ladder"], want = faults_ladder(weights, dev, walks)
        exporter = telemetry.start_exporter(0)
        try:
            out["client"] = faults_client(dev, exporter.url)
        finally:
            exporter.close()
            telemetry.disable()
        out["mesh"] = faults_mesh(weights, dev, walks, want)
        out["launches"] = {leg: out[leg]["launches"]
                           for leg in ("ladder", "client", "mesh")}
        walks = random_lines(FAULTS_RPC_WALKS, seed=19)
        want = faults_rpc_monolith(weights, dev, walks)
        net = os.path.join(rpc_dir, "net.nnue")
        weights.save(net)
        with ThreadPoolExecutor(2) as pool:
            rpc = pool.submit(faults_rpc, net, rpc_dir, walks, want)
            out["drain"] = drain.finish()
            out["rpc"] = rpc.result()
    finally:
        drain.close()
        shutil.rmtree(rpc_dir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"  faults: {out['seconds']:.3f} s, packed launches of the faulted "
        f"runs {out['launches']}")
    return out


#: The overload phase's sizes: the parity leg's games, plies a game and
#: nodes a position (two tenants, one worker, one job at a time); the
#: saturation leg's tenants, the unacquired jobs the server keeps
#: queued, the period of its move jobs, plies a synthesized game, the
#: shed policy's high watermark (the JAX default) and the seconds.
OVERLOAD_PARITY = (2, 20, 1500)
OVERLOAD_TENANTS = 4
OVERLOAD_REFILL = 32
OVERLOAD_MOVE_EVERY = 4
OVERLOAD_PLIES = 40
OVERLOAD_HIGH = 256
OVERLOAD_SECONDS = 30.0


async def saturate(client, lichess, seconds: float, overshoot: int,
                   health_url: Optional[str] = None) -> dict:
    """Drive a started multi-tenant ``client`` (its server saturated by
    ``lichess.auto_refill``) for ``seconds``, sampling the lane depths
    and the shed flag every 20 ms, then ``stop(abort_pending=True)``.
    With ``health_url``, ``/healthz`` there is scraped once while the
    policy sheds. Returns the summary of the JAX package's
    ``bench.py --overload``: latencies on the server's clock (handed out
    -> move done, handed out -> first analysis report), shedding,
    fairness (the DRR scheduler's served counts), the sampled lane
    maxima against ``depth_bound`` (the high watermark plus
    ``overshoot`` positions a tenant: admission is checked per batch
    before its positions are pushed), the server's counts, and the
    ledger's report when one is installed."""
    import urllib.error
    import urllib.request

    from fishnet_tpu_torch.resilience import accounting
    from fishnet_tpu_torch.resilience.shedding import (
        LANE_LATENCY,
        LANE_THROUGHPUT,
    )
    from fishnet_tpu_torch.telemetry.registry import percentile

    def healthz():
        try:
            with urllib.request.urlopen(health_url, timeout=5) as res:
                return res.status, json.loads(res.read() or b"null")
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read() or b"null")

    frontend = client._frontend
    check(frontend is not None, "saturate: the client has no front end")
    sched, policy = frontend.state.scheduler, frontend.shed_policy
    max_depth = {LANE_LATENCY: 0, LANE_THROUGHPUT: 0}
    samples = activations = 0
    was_shedding = False
    health = None
    loop = asyncio.get_running_loop()
    t_end = loop.time() + seconds
    while loop.time() < t_end:
        for lane, depth in sched.depths().items():
            max_depth[lane] = max(max_depth[lane], depth)
        shedding = policy.shed_active
        activations += shedding and not was_shedding
        was_shedding = shedding
        samples += 1
        if shedding and health is None and health_url is not None:
            health = await asyncio.to_thread(healthz)
        await asyncio.sleep(0.02)
    await client.stop(abort_pending=True)

    with lichess.lock:
        move_ms = [(lichess.move_done_at[k] - lichess.handed_at[k]) * 1e3
                   for k in lichess.move_done_at if k in lichess.handed_at]
        first_ms = [(lichess.first_report_at[k] - lichess.handed_at[k]) * 1e3
                    for k in lichess.first_report_at
                    if k in lichess.handed_at]
        server = {"acquires": lichess.acquire_count,
                  "analyses_completed": len(lichess.analyses),
                  "moves_completed": len(lichess.moves),
                  "aborted": len(lichess.aborted),
                  "jobs_synthesized": lichess.refill_count}
    served = dict(sched.served)
    positive = [v for v in served.values() if v > 0]
    tenants = len(frontend.tenants)
    depth_bound = policy.high_watermark + tenants * overshoot
    led = accounting.get()
    return {
        "tenants": tenants, "seconds": seconds,
        "latency": {
            "move_p50_ms": percentile(move_ms, 50),
            "move_p99_ms": percentile(move_ms, 99), "move_n": len(move_ms),
            "analysis_first_p50_ms": percentile(first_ms, 50),
            "analysis_first_p99_ms": percentile(first_ms, 99),
            "analysis_n": len(first_ms),
        },
        "shedding": {
            "shed_total": sum(ts.shed for ts in frontend.tenants.values()),
            "admitted_total": sum(ts.acquired
                                  for ts in frontend.tenants.values()),
            "shed_by_tenant": {ts.name: ts.shed
                               for ts in frontend.tenants.values()},
            "admitted_by_tenant": {ts.name: ts.acquired
                                   for ts in frontend.tenants.values()},
            "activations": activations, "policy": policy.snapshot(),
        },
        "fairness": {
            "served_by_tenant": served,
            "ratio": (max(positive) / min(positive)
                      if len(positive) >= 2 else None),
        },
        "queue": {
            "max_latency_depth": max_depth[LANE_LATENCY],
            "max_throughput_depth": max_depth[LANE_THROUGHPUT],
            "depth_bound": depth_bound,
            "bounded": max_depth[LANE_THROUGHPUT] <= depth_bound,
            "samples": samples,
        },
        "health_while_shedding": health,
        "ledger": None if led is None else led.report(),
        "server": server,
    }


def overload_gates(summary: dict, lichess, what: str) -> None:
    """The saturation gates of the JAX package's overload smoke, plus the
    server's side: something shed and something admitted; the
    throughput lane's sampled maximum within its bound; the ledger clean;
    every job handed out submitted once or aborted back, none held; every
    move job handed out answered, unless the stop aborted it in flight
    or dropped the acquire that took it (none shed or lost); ``/healthz``
    503 with ``shedding: true`` while shedding, when it was scraped. Adds
    the move jobs' counts and the ledger's report to ``summary``. The
    served counts' max/min ratio, which the JAX smoke gates at 2.0, is
    left to the caller: admission is first come, first served, a batch
    at a time, and the JAX front end's own ratio passes 2.0 in some runs
    at both the smoke's traffic and the card's
    (``python -m tests.test_torch_overload``)."""
    from fishnet_tpu_torch.resilience import accounting

    shed, queue = summary["shedding"], summary["queue"]
    check(shed["shed_total"] >= 1 and shed["admitted_total"] >= 1,
          f"{what}: shed {shed['shed_total']}, admitted "
          f"{shed['admitted_total']}")
    check(queue["bounded"], f"{what}: the throughput lane reached "
                            f"{queue['max_throughput_depth']} > "
                            f"{queue['depth_bound']}")
    led = accounting.get()
    check(led is not None, f"{what}: no ledger installed")
    report = led.assert_clean()
    audit = lichess.audit()
    check(not audit["held"] and not audit["duplicated"],
          f"{what}: jobs held or submitted twice on the server: {audit}")
    with lichess.lock:
        handed_moves = [i for i in lichess.handed_at
                        if lichess.bodies[i]["work"]["type"] == "move"]
        answered = [i for i in handed_moves if i in lichess.moves]
    cut = [i for i in handed_moves if i not in answered]
    records = [led.record(i) for i in cut]
    reasons = sorted({r.reason for r in records if r is not None})
    check(answered and None not in records
          and all(r.startswith("shutdown") or r == "callback_dropped"
                  for r in reasons),
          f"{what}: {len(answered)} of {len(handed_moves)} move jobs "
          f"answered, the rest {reasons}")
    health = summary["health_while_shedding"]
    if health is not None:
        code, body = health
        check(code == 503 and body["providers"]["serving"]["shedding"] is True,
              f"{what}: /healthz while shedding: {code} {body}")
    summary["moves"] = {"handed": len(handed_moves), "answered": len(answered),
                        "cut_by_stop": len(cut)}
    summary["ledger"] = report


def overload_saturation(dev, url: str) -> dict:
    """The saturation leg: ``run``'s engine factory at the CLI's defaults
    (the full-width net, 224 workers on 7 cores) behind OVERLOAD_TENANTS
    tenants against the stdlib fake lichess, which keeps OVERLOAD_REFILL
    unacquired jobs queued (every OVERLOAD_MOVE_EVERY-th a move job, the
    rest games of OVERLOAD_PLIES plies at RUN_NODES), under
    ``ShedPolicy(high_watermark=OVERLOAD_HIGH)`` with the batch ledger and
    an exporter (``url``) on, for OVERLOAD_SECONDS (``saturate``), then
    ``overload_gates`` with a bound of one game a tenant over the
    watermark. The packed kernel's launch counts are zeroed after the
    service's warm-up and read after the stop: one launch per device
    dispatch, no dense launch, the error word unmoved."""
    import torch

    from fishnet_tpu_torch.__main__ import build_engine_factory
    from fishnet_tpu_torch.client import Client
    from fishnet_tpu_torch.configure import parse_and_configure
    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.protocol.types import EngineFlavor
    from fishnet_tpu_torch.resilience import accounting
    from fishnet_tpu_torch.resilience.shedding import ShedPolicy
    from fishnet_tpu_torch.utils.logger import Logger

    fresh_cache()
    device = torch.device(dev)
    gpu = device.type == "cuda"
    logger = Logger(verbose=0)
    opt = parse_and_configure(
        ["run", "--no-conf", "--no-stats-file", "--microbatch", "1024",
         "--pipeline", "2", "--device", device.type])
    factory = build_engine_factory(opt, logger)
    games = random_games(64, OVERLOAD_PLIES, seed=53)
    packed = ft_gather.ft_accumulate_packed_cuda
    accounting.install()
    try:
        with FakeServer() as server:
            lichess = server.lichess
            lichess.auto_refill = OVERLOAD_REFILL
            lichess.refill_move_every = OVERLOAD_MOVE_EVERY
            lichess.refill_analysis = lambda n: dict(
                moves=" ".join(games[n % len(games)]), nodes=RUN_NODES)
            client = Client(endpoint=server.endpoint, key=VALID_KEY,
                            cores=opt.resolved_cores(), engine_factory=factory,
                            logger=logger, max_backoff=1.0,
                            workers=opt.resolved_workers(),
                            tenants=OVERLOAD_TENANTS,
                            shed_policy=ShedPolicy(high_watermark=OVERLOAD_HIGH),
                            supervisor=factory.supervisor)

            async def run():
                await factory.create(EngineFlavor.OFFICIAL)
                svc = factory.service
                c0 = svc.counters()
                errors0 = ft_gather.kernel_errors(dev) if gpu else 0
                packed.launches = packed.copy_launches = 0  # after warm-up
                ft_gather.ft_accumulate_cuda.launches = 0
                await client.start()
                summary = await saturate(client, lichess, OVERLOAD_SECONDS,
                                         overshoot=OVERLOAD_PLIES + 1,
                                         health_url=f"{url}/healthz")
                # The stop cancels the workers mid-search, but a
                # cancelled search runs on in the service, and may
                # dispatch, until its driver harvests it. Read the counts
                # once no search is left, no dispatch is in flight and
                # two reads agree, from that one snapshot.
                t_stop = time.monotonic()
                live_at_stop = live_searches(svc)
                last, deadline = None, t_stop + 60
                while True:
                    c1 = svc.counters()
                    now = (c1["dispatches"], packed.launches,
                           c1["inflight_dispatches"], live_searches(svc))
                    if now == last and now[2] == 0 and now[3] == 0:
                        break
                    check(time.monotonic() < deadline,
                          "overload: the service never went quiet "
                          f"(dispatches, launches, in flight, searches) "
                          f"{now}")
                    last = now
                    await asyncio.sleep(0.1)
                summary["after_stop"] = {
                    "searches": live_at_stop,
                    "drained_s": time.monotonic() - t_stop}
                summary["kernel"] = {
                    "dispatches": now[0] - c0["dispatches"],
                    "launches": now[1],
                    "dense": ft_gather.ft_accumulate_cuda.launches,
                    "errors_moved": (ft_gather.kernel_errors(dev) - errors0
                                     if gpu else 0)}
                summary["nodes_per_s"] = (c1["nodes"] - c0["nodes"]) / \
                    OVERLOAD_SECONDS
                return summary

            summary = asyncio.run(run())
            try:
                overload_gates(summary, lichess, "overload")
            finally:
                log_saturation(summary)
    finally:
        factory.close()
        accounting.clear()
    kern = summary["kernel"]
    check(summary["health_while_shedding"] is not None,
          "overload: /healthz was never scraped while shedding")
    check(kern["launches"] > 0 and kern["dense"] == 0
          and (kern["launches"] == kern["dispatches"] or not gpu),
          f"overload: {kern}")
    check(kern["errors_moved"] == 0, f"overload: the error word moved {kern}")
    return summary


def live_searches(svc) -> int:
    """The searches ``svc`` still holds, running or queued. A caller's
    cancellation stops its search, but the search stays in the service
    until its driver harvests it."""
    with svc._lock:
        return (sum(len(p) for p in svc._pending)
                + sum(len(q) for q in svc._submissions))


def log_saturation(summary: dict) -> None:
    """The saturation leg's numbers (``overload_saturation``), logged
    before or after its gates."""
    kern, lat, shed = summary["kernel"], summary["latency"], summary["shedding"]
    health = summary["health_while_shedding"]
    log(f"  saturation: {OVERLOAD_TENANTS} tenants, {OVERLOAD_SECONDS:.0f} s "
        f"at high watermark {OVERLOAD_HIGH}: shed {shed['shed_total']} "
        f"(by tenant {shed['shed_by_tenant']}), admitted "
        f"{shed['admitted_total']}, {shed['activations']} activations; "
        f"throughput lane max {summary['queue']['max_throughput_depth']} "
        f"(bound {summary['queue']['depth_bound']}), latency lane max "
        f"{summary['queue']['max_latency_depth']}; served "
        f"{summary['fairness']['served_by_tenant']} (ratio "
        f"{summary['fairness']['ratio']}); ledger {summary['ledger']}; "
        f"server {summary['server']}; move jobs {summary.get('moves')}")
    log(f"  saturation: move (handed out -> move done) p50 "
        f"{lat['move_p50_ms']} ms, p99 {lat['move_p99_ms']} ms over "
        f"{lat['move_n']}; analysis first report p50 "
        f"{lat['analysis_first_p50_ms']} ms, p99 "
        f"{lat['analysis_first_p99_ms']} ms over {lat['analysis_n']}; "
        f"{summary['nodes_per_s']:.0f} nodes/s; /healthz while shedding "
        f"{None if health is None else health[0]}; {kern['launches']} "
        f"packed launches ({kern['dense']} dense) for {kern['dispatches']} "
        "dispatches")
    stop = summary.get("after_stop")
    if stop is not None:
        log(f"  saturation: {stop['searches']} searches still in the service "
            f"when the stop returned, none left {stop['drained_s']:.3f} s "
            "later")


def overload_soak(dev) -> dict:
    """``python -m fishnet_tpu_torch.resilience.soak --device <dev>`` as
    a subprocess: exit 0, its report ``ok`` with phase B on the ladder's
    second rung, the ledger clean before and after phase C and the four
    families scraped. Its output lands in ``chiprun_out/overload/``."""
    import torch

    from fishnet_tpu_torch.resilience.soak import REQUIRED_FAMILIES
    from fishnet_tpu_torch.resilience.supervisor import ladder_for

    device = torch.device(dev).type
    out_dir = ROOT / "chiprun_out" / "overload"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fishnet_tpu_torch.resilience.soak",
         "--device", device], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    seconds = time.perf_counter() - t0
    (out_dir / "soak.log").write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0,
          f"soak: exit {proc.returncode}: {proc.stderr[-2000:]}")
    report = json.loads(proc.stdout)
    ladder = ladder_for(device)
    clean = all(not report[k]["lost"] and not report[k]["duplicated"]
                for k in ("ledger", "ledger_final"))
    log(f"  soak: exit 0 in {seconds:.3f} s; phase B {report['phase_b']}; "
        f"phase C shed {report['phase_c']['shed']}, admitted "
        f"{report['phase_c']['admitted']}, max depth "
        f"{report['phase_c']['max_throughput_depth']} (bound "
        f"{report['phase_c']['depth_bound']}); degradation "
        f"{report['counters']['degradation']}; ledger before C "
        f"{report['ledger']}, after {report['ledger_final']}")
    check(report["ok"] and report["phase_b"]["rung"] == ladder[1]
          and report["counters"]["degradation"]["from"] == ladder[0]
          and clean
          and sorted(report["metric_families"]) == sorted(REQUIRED_FAMILIES),
          f"soak: {report}")
    return {"phase_b": report["phase_b"], "phase_c": report["phase_c"],
            "counters": report["counters"], "seconds": seconds}


def phase_overload(weights, dev) -> dict:
    """The multi-tenant front end on the card: the parity leg
    (``client_parity`` at two tenants, one worker, OVERLOAD_PARITY games
    queued one at a time, against the native scalar service) with the
    soak subprocess (``overload_soak``) beside it, then the saturation
    leg (``overload_saturation``) under an exporter. "launches" is the
    saturation leg's packed launches."""
    from fishnet_tpu_torch import telemetry

    t0 = time.perf_counter()
    games, plies, nodes = OVERLOAD_PARITY
    with ThreadPoolExecutor(1) as pool:
        soak = pool.submit(overload_soak, dev)
        tp = time.perf_counter()
        client_parity(weights, dev, games=games, plies=plies, nodes=nodes,
                      tenants=2)
        parity_s = time.perf_counter() - tp
        out = {"soak": soak.result(), "parity_s": parity_s}
    exporter = telemetry.start_exporter(0)
    try:
        out["saturation"] = overload_saturation(dev, exporter.url)
    finally:
        exporter.close()
        telemetry.disable()
    out["launches"] = out["saturation"]["kernel"]["launches"]
    out["seconds"] = time.perf_counter() - t0
    log(f"  overload: {out['seconds']:.3f} s (parity {parity_s:.3f} s, soak "
        f"{out['soak']['seconds']:.3f} s beside it)")
    return out


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


async def drive_one_at_a_time(client, lichess, adds, timeout: float) -> list:
    """Run ``client`` over the jobs that ``adds`` queue on the server,
    each called only once the job before it is submitted; returns the
    work ids."""
    await client.start()
    ids = []
    try:
        deadline = time.monotonic() + timeout
        for add in adds:
            ids.append(add())
            while ids[-1] not in lichess.analyses:
                check(time.monotonic() < deadline, "the client did not finish "
                                                   f"in {timeout:.0f} s")
                await asyncio.sleep(0.02)
    finally:
        await client.stop()
    return ids


def client_parity(weights, dev, games: int, plies: int,
                  depth: Optional[int] = None, threads: int = 1,
                  nodes: Optional[int] = None, tenants: int = 1) -> None:
    """The ``run`` path's parity check: ``games`` seeded games of
    ``plies`` plies, analysed at ``depth`` (or ``nodes`` a position)
    through the port's Client (one worker, prefetch pinned) on a
    SearchService over ``dev`` (with ``threads`` driver threads and two
    pipeline groups each: with more than one group the coalescer's
    ticket path) and on the native scalar service, must submit the same
    score, best move and depth per ply. With ``tenants`` > 1 the client
    runs the multi-tenant front end and each game is queued on the
    server only once the one before it is submitted, so the job
    sequence is fixed whichever tenant takes a game. The worker's engine
    budget is lifted for the check, and it fails on any engine timeout,
    requeued or abandoned position, or abort: a search run again over a
    TT it already filled may differ without any fault of the evaluator.
    As in ``phase_parity``, the GPU service runs without the bounds
    tier."""
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
            fresh_cache()
            with env_vars(FISHNET_NO_BOUNDS="1"):
                svc = SearchService(weights=weights, pool_slots=16,
                                    batch_capacity=64, tt_bytes=256 << 20,
                                    backend=backend, device=dev, **torch_kw)
            svc.set_prefetch(8, adaptive=False)
            logger = Recorder()
            with FakeServer() as server:
                lichess = server.lichess

                def add(game):
                    return lichess.add_analysis_job(
                        moves=" ".join(game), depth=depth,
                        nodes=10_000_000 if nodes is None else nodes)

                client = Client(endpoint=server.endpoint, key=VALID_KEY,
                                cores=1, workers=1,
                                engine_factory=TpuNnueEngineFactory(svc),
                                logger=logger, max_backoff=0.2,
                                tenants=tenants)
                try:
                    if tenants == 1:
                        ids = [add(g) for g in lines]
                        asyncio.run(drive_client(client, lichess, ids, 600))
                    else:
                        ids = asyncio.run(drive_one_at_a_time(
                            client, lichess, [lambda g=g: add(g)
                                              for g in lines], 600))
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
    budget = f"depth {depth}" if nodes is None else f"{nodes} nodes"
    log(f"  parity: {games} games, {n} plies at {budget} through the client "
        f"({tenants} tenant{'s' if tenants > 1 else ''}), no timeout, "
        f"requeue or abort: the service on {dev} == the native scalar "
        "service on (score, best move, depth) per ply")


#: The ``run`` phase's nodes a position: at 3000, its 16 games (640
#: positions over 224 workers) overran the client's engine budget on a
#: slow host (73 engine timeouts; PERF.md, PR 7).
RUN_NODES = 1500


def run_workload(what: str, env: Optional[dict] = None, games: int = 16,
                 moves: int = 4, nodes: int = 3000) -> dict:
    """The ``run`` phase's workload through the entry points a user
    calls: the port's ``Client`` over the ``tpu-nnue`` engine factory
    that ``python -m fishnet_tpu_torch run`` builds (microbatch 1024,
    pipeline 2, one driver thread per core, the supervisor's ladder),
    against the stdlib fake lichess with ``games`` analysis games at
    ``nodes`` a position and ``moves`` move jobs, from a cold eval cache (``env`` set while the
    service is built), at the user's engine budget (60 s a position).
    The packed kernel's launch counts are zeroed after the service's
    warm-up and read after the run: one launch per device dispatch, no
    dense launch; the rung must stay "fused". Returns ``run_report``'s
    numbers with the launches, the counter deltas, the cache probes and
    the host's timers (``host_timers``)."""
    from fishnet_tpu_torch.__main__ import build_engine_factory
    from fishnet_tpu_torch.client import Client
    from fishnet_tpu_torch.configure import parse_and_configure
    from fishnet_tpu_torch.ops import ft_gather
    from fishnet_tpu_torch.protocol.types import EngineFlavor
    from fishnet_tpu_torch.search import eval_cache
    from fishnet_tpu_torch.utils.logger import Logger

    fresh_cache()
    logger = Logger(verbose=0)
    opt = parse_and_configure(["run", "--no-conf", "--no-stats-file",
                               "--microbatch", "1024", "--pipeline", "2"])
    factory = build_engine_factory(opt, logger)
    supervisor = factory.supervisor
    with FakeServer() as server:
        lichess = server.lichess
        analysis_ids, move_ids = add_run_jobs(lichess, games, moves, seed=23,
                                              nodes=nodes)
        client = Client(endpoint=server.endpoint, key=VALID_KEY,
                        cores=opt.resolved_cores(), engine_factory=factory,
                        logger=logger, max_backoff=1.0,
                        workers=opt.resolved_workers())

        async def run():
            # The user's path builds and warms the service before the
            # first acquire (run_client); so does this.
            with env_vars(**(env or {})):
                await factory.create(EngineFlavor.OFFICIAL)
            timers = host_timers(factory.service)
            ft_gather.ft_accumulate_packed_cuda.launches = 0
            ft_gather.ft_accumulate_packed_cuda.copy_launches = 0
            ft_gather.ft_accumulate_cuda.launches = 0
            cache = eval_cache.get_cache()
            st0 = None if cache is None else cache.stats()
            c0 = factory.service.counters()
            await drive_client(client, lichess, analysis_ids + move_ids, 600)
            probes = 0 if st0 is None else sum(
                cache.stats()[k] - st0[k] for k in ("hits", "misses"))
            return ({k: v - c0[k]
                     for k, v in factory.service.counters().items()},
                    timers, probes)

        try:
            c, timers, probes = asyncio.run(run())
            launches = ft_gather.ft_accumulate_packed_cuda.launches
            copies = ft_gather.ft_accumulate_packed_cuda.copy_launches
            dense = ft_gather.ft_accumulate_cuda.launches
            service = factory.service
            rung = (supervisor.rung, service.psqt_path, supervisor.respawns,
                    service.is_alive())
        finally:
            factory.close()
    log(f"  {what}: {opt.resolved_workers()} workers, "
        f"{opt.resolved_search_threads()} driver threads; ft_gather launches "
        f"{launches} (packed; {copies} with copy_src), {dense} (dense) for "
        f"{c['eval_steps']} dispatched steps in {c['dispatches']} device "
        f"dispatches ({c['fused_dispatches']} fused, {c['fused_dedup']} "
        f"evals deduped, {c['position_dedup']} by position); "
        f"{c['cache_prewire_hits']} pre-wire hits of {probes} probes, "
        f"{c['cache_skipped_dispatches']} dispatches skipped; bounds "
        f"seeded {c['bounds_seeded']}, harvested {c['bounds_harvested']}; "
        f"rung {rung[0]} (service {rung[1]}), respawns {rung[2]}")
    check(launches > 0, f"{what}: the run path never launched the kernel")
    check(launches == c["dispatches"],
          f"{what}: {launches} packed launches for {c['dispatches']} "
          "dispatches")
    check(dense == 0, f"{what}: the run path launched the dense mode")
    check(rung == ("fused", "fused", 0, True),
          f"{what}: the service left the fused rung or died: {rung}")
    report = run_report(lichess, analysis_ids, move_ids, what)
    report.update(launches=launches, copy_launches=copies,
                  fused_dispatches=c["fused_dispatches"], counters=c,
                  probes=probes, timers=timers)
    return report


def phase_run(weights, dev):
    """The main path through the entry points a user calls
    (``run_workload``, the eval cache and bounds tier at their
    defaults). Then the parity sub-run (``client_parity``): 2 games at
    depth 4 on a GPU service (as many driver threads) and on the native
    scalar service must submit the same score, best move and depth per
    ply."""
    from fishnet_tpu_torch.configure import parse_and_configure

    report = run_workload("run", nodes=RUN_NODES)
    threads = parse_and_configure(["run", "--no-conf"]).resolved_search_threads()
    client_parity(weights, dev, games=2, plies=10, depth=4, threads=threads)
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
    subprocess against the stdlib fake lichess (8 games at RUN_NODES, 2
    move jobs):
    once every job is submitted, SIGINT drains it; it must exit 0, and
    its teardown log (-v) must show, counted from after the service's
    warm-up, one packed kernel launch per device dispatch, at least
    one, and no dense launch."""
    import signal

    with FakeServer() as server:
        lichess = server.lichess
        analysis_ids, move_ids = add_run_jobs(lichess, 8, 2, seed=31,
                                              nodes=RUN_NODES)
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

    from fishnet_tpu_torch.search import eval_cache

    log("[build] nvcc (sm_90a), the native core and the eval cache's "
        "tables, in parallel")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        kernels = pool.submit(_build.build, ["ft_gather"])
        # g++ over search/csrc/eval_cache.cpp (search/eval_cache.py)
        tables = pool.submit(eval_cache._tables)
        load_core()  # g++ over cpp/src (chess/core.py)
        paths = kernels.result()
        tables.result()
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

    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        """Log the seconds the phase that just ended took."""
        now = time.perf_counter()
        log(f"  ({name}: {now - clock[0]:.1f} s)")
        clock[0] = now

    worst = None
    train_batch = None
    split_parity = None
    if "kernel" in phases:
        log("[kernel] hand kernel vs plain version, every entry kind")
        worst = phase_kernel(torch, params, dev)
        lap("kernel")
    serve = None
    if "serve" in phases:
        log("[serve] UCI over SearchService(device='cuda'), microbatch 1024")
        serve = phase_serve(torch, weights, dev)
        check(serve["launches"] > 0, "the main path never launched the kernel")
        lap("serve")
    if "parity" in phases:
        log("[parity] GPU service vs native scalar evaluator")
        phase_parity(weights, dev)
        lap("parity")
    entries = []
    if "timing" in phases and serve is not None:
        log("[timing] ft_gather at the serving shape (B = 512)")
        entries.append(phase_timing(torch, params, dev, serve, worst))
        entries[0]["fused_launches"] = serve["fused_dispatches"]
        entries[0]["step_fused"] = serve["step"]["fused"]
        lap("timing")
    fused = None
    if "coalesce" in phases:
        log("[coalesce] fused segmented dispatches: kernel level, then the "
            "service with the new defaults")
        fused = phase_coalesce(torch, weights, params, dev)
        for entry in entries:
            entry["fused"] = fused["timings"]
            entry["max_abs_err"] = max(entry["max_abs_err"], fused["worst"])
            entry["fused_launches_defaults"] = fused["fused_dispatches"]
        lap("coalesce")
    if "run" in phases:
        log("[run] the fishnet client over the tpu-nnue engine on the GPU, "
            "against a stdlib fake lichess")
        run = phase_run(weights, dev)
        for entry in entries:
            entry["launches_run"] = run["launches"]
            entry["copy_launches_run"] = run["copy_launches"]
        lap("run")
    if "cli" in phases:
        log("[cli] python -m fishnet_tpu_torch run, drained by SIGINT")
        cli = phase_cli()
        for entry in entries:
            entry["launches_cli"] = cli["launches"]
        lap("cli")
    if "cache" in phases:
        log("[cache] the eval cache and the bounds tier: the kernel's "
            "copy-source mode, the service, then cache off / on numbers")
        if "split" in phases:  # its parity run goes beside the checks
            split_parity = SplitParity(weights)
        cache = phase_cache(torch, weights, params, dev,
                            None if fused is None else fused["steps"],
                            split_parity)
        for entry in entries:
            entry["copy_src"] = cache["copy_src"]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       cache["copy_src"]["worst"])
            entry["cache_numbers"] = cache["numbers"]
        lap("cache")
    if "split" in phases:
        log("[split] the split evaluator plane: a host process on the card "
            "serving frontend processes over shared-memory rings")
        split = phase_split(torch, weights, params, dev, split_parity)
        kern = split["kernel"]
        top = kern[0]  # the largest fused host batch
        facts = {"launches": split["launches"],
                 "parity_dispatches": split["parity_dispatches"],
                 "batches": kern, "runs": split["runs"],
                 "ring_ping": split["ping"]}
        worst_split = max(k["max_abs_err"] for k in kern)
        if entries:
            entries[0]["launches_split"] = split["launches"]
            entries[0]["split"] = facts
            entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"],
                                            worst_split)
        else:
            entries.append({
                "name": "ft_gather", "route": "cuda",
                "source": "fishnet_tpu_torch/ops/csrc/ft_gather.cu",
                "replaces": "fishnet_tpu/ops/ft_gather.py:402",
                "launches": split["launches"], "max_abs_err": worst_split,
                "ms": top["ms"], "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                "library_ms": top["library_ms"],
                "mode": "dense, in-batch parents (the split host's)",
                "split": facts})
        lap("split")
    if "az" in phases:
        log("[az] the AZ/MCTS family: the policy+value tower on the card, "
            "batched PUCT MCTS over the shared AZ dispatch plane, the AZ "
            "eval cache and run --engine az-mcts")
        print(json.dumps({"az": phase_az(torch, dev)}), flush=True)
        lap("az")
    if "train" in phases:
        log("[train] training on the card: teacher labels through the "
            "kernel, the NNUE and AZ trainers at full width, self-play over "
            "the shared plane and the split plane's AZ half, checkpoints")
        train = phase_train(torch, dev)
        train_batch = train.pop("_batch")
        export = train["nnue"]["export"]
        facts = {"label_launches": train["labels"]["launches"],
                 "label_dispatches": train["labels"]["dispatches"],
                 "export": export}
        if entries:
            entries[0]["launches_train"] = train["labels"]["launches"]
            entries[0]["train"] = facts
            entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"],
                                            export["max_abs_err"])
        else:
            entries.append({
                "name": "ft_gather", "route": "cuda",
                "source": "fishnet_tpu_torch/ops/csrc/ft_gather.cu",
                "replaces": "fishnet_tpu/ops/ft_gather.py:402",
                "launches": train["labels"]["launches"],
                "max_abs_err": export["max_abs_err"], "ms": export["ms"],
                "plain_ms": export["plain_ms"], "bound_ms": export["bound_ms"],
                "bound_by": export["bound_by"],
                "library_ms": export["library_ms"],
                "mode": "packed (labels); dense with fused PSQT, timed on "
                        "the exported net",
                "train": facts})
        print(json.dumps({"train": train}), flush=True)
        lap("train")
    if "mesh" in phases:
        log("[mesh] the serving mesh: the kernel's partials mode and two "
            "launching threads, the service and the AZ plane on two logical "
            "shards of the card, the per-shard ladder and drain, the legacy "
            "sharded evaluator, the burst on one shard and two")
        mesh = phase_mesh(torch, weights, params, dev)
        facts = {"launches": mesh["launches"], "sparse": mesh["sparse"],
                 "shards": mesh["shards"], "drain": mesh["drain"],
                 "sharded_evaluator": mesh["sharded_evaluator"]}
        if entries:
            entries[0]["launches_mesh"] = mesh["launches"]
            entries[0]["mesh"] = facts
            entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"],
                                            mesh["worst"])
        else:
            sp = mesh["sparse"]
            entries.append({
                "name": "ft_gather", "route": "cuda",
                "source": "fishnet_tpu_torch/ops/csrc/ft_gather.cu",
                "replaces": "fishnet_tpu/ops/ft_gather.py:402",
                "launches": mesh["launches"], "max_abs_err": mesh["worst"],
                "ms": sp["ms"], "plain_ms": sp["plain_ms"],
                "bound_ms": sp["bound_ms"], "bound_by": sp["bound_by"],
                "library_ms": sp["library_ms"],
                "mode": "packed on two logical shards; dense partials "
                        "(sparse=), timed",
                "mesh": facts})
        print(json.dumps({"mesh": mesh}), flush=True)
        lap("mesh")
    if "trainshard" in phases:
        log("[trainshard] the sharded trainers on logical shards of the card: "
            "NNUE 2x1, 1x2, 2x2 and AZ 1x2, 2x1 against one device, the "
            "export on the packed kernel, resume across placements")
        trainshard = phase_trainshard(torch, dev, train_batch)
        for entry in entries:
            entry["launches_trainshard"] = trainshard["launches"]
            entry["trainshard_export"] = trainshard["nnue"]["export"]
        print(json.dumps({"trainshard": trainshard}), flush=True)
        lap("trainshard")
    if "metrics" in phases:
        log("[metrics] the /metrics exporter over the service: scrapes "
            "during a burst, families == counters(), close(), two shards; "
            "the burst without and with scrapes, A, B")
        metrics = phase_metrics(torch, weights, dev)
        for entry in entries:
            entry["launches_metrics"] = metrics["launches"]
        print(json.dumps({"metrics": metrics}), flush=True)
        lap("metrics")
    if "spans" in phases:
        log("[spans] the span flight recorder and the profiling plane: a "
            "gated service with spans and the cost plane off and on (equal "
            "analyses, no orphan, every dispatch_issue paired, coalesce "
            "links, critical-path coverage, the ledger's sum), beside a "
            "FISHNET_PROFILE=1 run process with --metrics-port 0 "
            "--spans-dir: batch trees on /spans, /profile, /trace, cost on "
            "/metrics, the SIGUSR2 and drain dumps")
        sp = phase_spans(torch, weights, dev)
        for entry in entries:
            entry["launches_spans"] = sp["launches"]
        print(json.dumps({"spans": sp}), flush=True)
        lap("spans")
    if "faults" in phases:
        log("[faults] fault injection, exactly-once accounting and graceful "
            "drain: the ladder forced by device-step crashes, the client "
            "under a plan with the ledger on, a shard-local fault on the "
            "mesh, a SIGTERM'd run process, rpc.detach on the split plane")
        faults = phase_faults(torch, weights, dev)
        for entry in entries:
            entry["launches_faults"] = faults["launches"]
        print(json.dumps({"faults": faults}), flush=True)
        lap("faults")
    if "overload" in phases:
        log("[overload] the multi-tenant front end: two tenants against the "
            "scalar search, the soak harness, then four tenants saturating "
            "the server under admission control")
        overload = phase_overload(weights, dev)
        for entry in entries:
            entry["launches_overload"] = overload["launches"]
        print(json.dumps({"overload": overload}), flush=True)
        lap("overload")
    if "profile" in phases:
        log("[profile] a loaded burst under torch.profiler, at one driver "
            "thread and at the default")
        from fishnet_tpu_torch.configure import parse_and_configure

        for threads in sorted({1, parse_and_configure(
                ["run", "--no-conf"]).resolved_search_threads()}):
            phase_profile(torch, weights, dev, threads)
        lap("profile")
    if "anatomy" in phases and serve is not None:
        log("[anatomy] the kernel with one part of its work removed at a time")
        phase_anatomy(torch, params, dev, serve)
        lap("anatomy")
    if "ladder" in phases:
        log("[ladder] entry buckets from 64 vs from 8, one call")
        phase_ladder(weights, dev)
        lap("ladder")
    if "sweep" in phases:
        log("[sweep] the burst by driver threads, coalescer on and off")
        phase_sweep(weights, dev)
        lap("sweep")
    log(f"card: {card_line()}")
    log(f"whole run: {time.perf_counter() - T_START:.1f} s on {card_line()}")
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
