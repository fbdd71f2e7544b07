"""The port's wire model (fishnet_tpu_torch.protocol.types) against the
JAX package's: the same acquire bodies parse to the same work, and the
same results serialise to the same JSON, byte for byte. The last tests
carry the bodies over HTTP: the port's API actor acquires from and
submits to the standard-library fake lichess server of chip_smoke.py,
and what the server receives is what the JAX package would send."""

import asyncio
import dataclasses
import json

import pytest

from chip_smoke import VALID_KEY, FakeServer
from fishnet_tpu.protocol import types as ref
from fishnet_tpu_torch.net.api import channel
from fishnet_tpu_torch.protocol import types as port
from fishnet_tpu_torch.utils.logger import Logger

ENDPOINT = "https://lichess.org/fishnet"
FEN = "r1bqkbnr/pppp1ppp/2n5/4p3/4P3/5N2/PPPP1PPP/RNBQKB1R w KQkq - 2 3"

BODIES = {
    "analysis": {"work": {"type": "analysis", "id": "a1",
                          "nodes": {"sf15": 1500000, "classical": 4000000},
                          "timeout": 7000},
                 "game_id": "abcd1234", "position": ref.STARTPOS,
                 "variant": "standard", "moves": "e2e4 e7e5 g1f3",
                 "skipPositions": [1, 3]},
    "multipv-depth": {"work": {"type": "analysis", "id": "a2", "multipv": 3,
                               "depth": 14,
                               "nodes": {"sf15": 10, "classical": 20},
                               "timeout": 3000},
                      "position": FEN, "variant": "Chess960",
                      "moves": ["d2d4", "d7d5"], "game_id": ""},
    "variant": {"work": {"type": "analysis", "id": "a3",
                         "nodes": {"sf15": 5, "classical": 9},
                         "timeout": 100},
                "variant": "Three-check", "moves": ""},
    "move-clock": {"work": {"type": "move", "id": "m1", "level": 8,
                            "clock": {"wtime": 18000, "btime": 9000,
                                      "inc": 2}},
                   "position": FEN, "variant": "crazyhouse", "moves": "a2a3"},
    "move-bare": {"work": {"type": "move", "id": "m2", "level": 1}},
}

BAD_BODIES = {
    "no-work": {"position": ref.STARTPOS},
    "unknown-type": {"work": {"type": "x", "id": "1"}},
    "multipv-0": {"work": {"type": "analysis", "id": "1", "multipv": 0,
                           "nodes": {"sf15": 1, "classical": 1},
                           "timeout": 1}},
    "long-id": {"work": {"type": "move", "id": "x" * 25, "level": 1}},
    "bad-level": {"work": {"type": "move", "id": "1", "level": 9}},
    "bad-variant": {"work": {"type": "move", "id": "1", "level": 1},
                    "variant": "bughouse"},
    "bad-skips": {"work": {"type": "move", "id": "1", "level": 1},
                  "skipPositions": ["x"]},
}


def _view(body, types):
    """Everything a parsed acquire body tells the client, as plain data."""
    work = body.work
    return {
        "work": {k: (v.value if hasattr(v, "value") else v)
                 for k, v in dataclasses.asdict(work).items()},
        "position": body.position, "variant": body.variant.value,
        "moves": body.moves, "skip": body.skip_positions,
        "game_id": body.game_id, "url": body.batch_url(ENDPOINT),
        "timeout_s": work.timeout_seconds(),
        "matrix": work.matrix_wanted, "multipv": work.effective_multipv(),
        "uci_variant": body.variant.uci(),
        "short": body.variant.short_name(),
        "level": None if work.level is None else (
            work.level.movetime_ms(), work.level.skill_level(),
            work.level.depth()),
        "flavor": (types.EngineFlavor.OFFICIAL
                   if body.variant.is_standard and work.is_analysis
                   else types.EngineFlavor.MULTI_VARIANT).eval_flavor().value,
    }


@pytest.mark.parametrize("name", sorted(BODIES))
def test_acquire_bodies_parse_alike(name):
    raw = BODIES[name]
    got = _view(port.AcquireResponseBody.from_json(json.loads(json.dumps(raw))),
                port)
    want = _view(ref.AcquireResponseBody.from_json(json.loads(json.dumps(raw))),
                 ref)
    assert got == want


@pytest.mark.parametrize("name", sorted(BAD_BODIES))
def test_malformed_bodies_are_refused_alike(name):
    with pytest.raises(ref.ProtocolError) as want:
        ref.AcquireResponseBody.from_json(BAD_BODIES[name])
    with pytest.raises(port.ProtocolError) as got:
        port.AcquireResponseBody.from_json(BAD_BODIES[name])
    assert str(got.value) == str(want.value)


def _parts(types):
    """Submission parts: a best-line part, a part without pv or nps, a
    skipped part and a multipv matrix with missing cells."""
    matrix_pv = [[None, ["e2e4"], ["e2e4", "e7e5"]], [None, ["d2d4"]]]
    matrix_score = [[None, types.Score.cp(31), types.Score.mate(-2)],
                    [None, types.Score.cp(-7)]]
    return [
        types.AnalysisPart.best(["e2e4", "e7e5"], types.Score.cp(12), 9,
                                1500, 250, nps=6000),
        types.AnalysisPart.best([], types.Score.mate(0), 0, 0, 0),
        types.AnalysisPart.skipped(),
        types.AnalysisPart.matrix(matrix_pv, matrix_score, 2, 300, 5),
    ]


def test_request_bodies_serialise_byte_for_byte():
    for types in (ref, port):
        assert types.Matrix().best() is None
    pairs = [
        (port.analysis_request_body("2.6.8", "k", port.EvalFlavor.NNUE,
                                    [None] + _parts(port)),
         ref.analysis_request_body("2.6.8", "k", ref.EvalFlavor.NNUE,
                                   [None] + _parts(ref))),
        (port.move_request_body("2.6.8", None, "e2e4"),
         ref.move_request_body("2.6.8", None, "e2e4")),
        (port.void_request_body("2.6.8", "k"),
         ref.void_request_body("2.6.8", "k")),
    ]
    for got, want in pairs:
        assert json.dumps(got) == json.dumps(want)
    status = {"analysis": {"user": {"acquired": 3, "queued": -1, "oldest": 9},
                           "system": {"queued": 4}}}
    assert (dataclasses.asdict(port.AnalysisStatus.from_json(status))
            == dataclasses.asdict(ref.AnalysisStatus.from_json(status)))


def test_actor_round_trip_through_the_stdlib_server():
    """Acquire every body from the stdlib server with the port's actor,
    then submit an analysis, a move and a queue-status request: the
    parsed work matches the JAX parse of the same body, and the server
    receives the bytes the JAX package would have sent."""

    async def run(server):
        stub, actor = channel(server.endpoint, VALID_KEY, Logger())
        task = asyncio.create_task(actor.run())
        acquired = []
        for _ in BODIES:
            got = await stub.acquire(slow=False)
            assert got.kind is port.AcquiredKind.ACCEPTED
            acquired.append(got.body)
        assert (await stub.acquire(slow=False)).kind is port.AcquiredKind.NO_CONTENT
        status = await stub.status()
        stub.submit_analysis("a1", port.EvalFlavor.NNUE, _parts(port),
                             final=True)
        chained = await stub.submit_move_and_acquire("m1", "e2e4")
        actor.stop()
        await asyncio.wait_for(task, 10)
        return acquired, status, chained

    with FakeServer() as server:
        for raw in BODIES.values():
            server.lichess._add(json.loads(json.dumps(raw)), False)
        acquired, status, chained = asyncio.run(run(server))
        endpoint = server.endpoint
    received = server.lichess
    for body, raw in zip(acquired, BODIES.values()):
        assert _view(body, port) == _view(ref.AcquireResponseBody.from_json(raw),
                                          ref)
    assert status.system.queued == 0 and status.user.queued == 0
    assert chained.kind is port.AcquiredKind.NO_CONTENT
    want = ref.analysis_request_body("2.6.8", VALID_KEY, ref.EvalFlavor.NNUE,
                                     _parts(ref))
    assert json.dumps(received.analyses["a1"]) == json.dumps(want)
    assert json.dumps(received.moves["m1"]) == json.dumps(
        ref.move_request_body("2.6.8", VALID_KEY, "e2e4"))
    assert endpoint.endswith("/fishnet")
