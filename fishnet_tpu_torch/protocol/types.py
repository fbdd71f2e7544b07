"""Wire model of the fishnet HTTP/JSON work protocol.

The port's own copy of ``fishnet_tpu/protocol/types.py``: the JSON it
reads and writes is the same, byte for byte. These types mirror, field for field, the JSON bodies documented in the
reference's doc/protocol.md and implemented in src/api.rs:74-395. The
protocol must stay byte-compatible with lichess (lila), so all
serialization quirks of the reference are preserved:

* ``work.timeout`` is milliseconds, ``clock.wtime``/``btime`` are
  centiseconds, ``clock.inc`` is seconds (api.rs:140, 275-291);
* acquired ``moves`` is a single space-separated UCI string (api.rs:305);
* an analysis part's ``pv`` is a space-separated string and omitted when
  empty; ``nps`` is omitted when unknown (api.rs:355-369);
* a multipv "matrix" part serializes ``pv``/``score`` as
  multipv x depth nested arrays with nulls for missing cells
  (api.rs:370-380);
* scores are ``{"cp": n}`` or ``{"mate": n}`` (api.rs:382-388).

This module is pure data: no I/O, no chess logic. FENs and UCI moves stay
strings here; legality is enforced by the scheduler via the chess core.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union


class ProtocolError(ValueError):
    """Malformed JSON body from the server."""


# ---------------------------------------------------------------------------
# Engine / eval flavors (reference: src/assets.rs:378-431)
# ---------------------------------------------------------------------------


class EngineFlavor(enum.Enum):
    """Which engine tier handles a position.

    OFFICIAL is the standard-chess analysis path (NNUE eval); MULTI_VARIANT
    handles variants and all best-move jobs (classical HCE eval) — same
    routing as the reference (src/queue.rs:530-539).
    """

    OFFICIAL = "official"
    MULTI_VARIANT = "multivariant"

    def eval_flavor(self) -> "EvalFlavor":
        return EvalFlavor.NNUE if self is EngineFlavor.OFFICIAL else EvalFlavor.HCE


class EvalFlavor(enum.Enum):
    """Evaluation flavor reported to the server (api.rs:117-120)."""

    NNUE = "nnue"
    HCE = "classical"

    @property
    def is_nnue(self) -> bool:
        return self is EvalFlavor.NNUE

    @property
    def is_hce(self) -> bool:
        return self is EvalFlavor.HCE


# ---------------------------------------------------------------------------
# Variants (reference: shakmaty::variant::Variant, logger.rs:192-203)
# ---------------------------------------------------------------------------


class Variant(enum.Enum):
    STANDARD = "standard"
    ANTICHESS = "antichess"
    ATOMIC = "atomic"
    CRAZYHOUSE = "crazyhouse"
    HORDE = "horde"
    KING_OF_THE_HILL = "kingofthehill"
    RACING_KINGS = "racingkings"
    THREE_CHECK = "3check"

    @classmethod
    def parse(cls, s: Optional[str]) -> "Variant":
        if not s:
            return cls.STANDARD
        key = s.lower().replace(" ", "").replace("-", "")
        aliases = {
            "standard": cls.STANDARD,
            "chess960": cls.STANDARD,
            "fromposition": cls.STANDARD,
            "chess": cls.STANDARD,
            "antichess": cls.ANTICHESS,
            "atomic": cls.ATOMIC,
            "crazyhouse": cls.CRAZYHOUSE,
            "horde": cls.HORDE,
            "kingofthehill": cls.KING_OF_THE_HILL,
            "racingkings": cls.RACING_KINGS,
            "3check": cls.THREE_CHECK,
            "threecheck": cls.THREE_CHECK,
        }
        try:
            return aliases[key]
        except KeyError:
            raise ProtocolError(f"unknown variant: {s!r}") from None

    @property
    def is_standard(self) -> bool:
        return self is Variant.STANDARD

    def uci(self) -> str:
        """Variant name as spoken over UCI (`UCI_Variant`)."""
        return {
            Variant.STANDARD: "chess",
            Variant.ANTICHESS: "antichess",
            Variant.ATOMIC: "atomic",
            Variant.CRAZYHOUSE: "crazyhouse",
            Variant.HORDE: "horde",
            Variant.KING_OF_THE_HILL: "kingofthehill",
            Variant.RACING_KINGS: "racingkings",
            Variant.THREE_CHECK: "3check",
        }[self]

    def short_name(self) -> Optional[str]:
        from fishnet_tpu_torch.utils.logger import short_variant_name

        return short_variant_name(self.value)


# ---------------------------------------------------------------------------
# Scores
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Score:
    """Centipawn or mate score (api.rs:382-388)."""

    kind: str  # "cp" | "mate"
    value: int

    @classmethod
    def cp(cls, value: int) -> "Score":
        return cls("cp", value)

    @classmethod
    def mate(cls, value: int) -> "Score":
        return cls("mate", value)

    def to_json(self) -> Dict[str, int]:
        return {self.kind: self.value}

    @classmethod
    def from_json(cls, data: Dict[str, int]) -> "Score":
        if "cp" in data:
            return cls.cp(int(data["cp"]))
        if "mate" in data:
            return cls.mate(int(data["mate"]))
        raise ProtocolError(f"invalid score: {data!r}")


# ---------------------------------------------------------------------------
# Work descriptions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NodeLimit:
    """Per-eval-flavor node limits assigned by the server
    (api.rs:207-220; doc/protocol.md:27-31)."""

    classical: int
    sf15: int

    def get(self, flavor: EvalFlavor) -> int:
        return self.sf15 if flavor.is_nnue else self.classical

    @classmethod
    def from_json(cls, data: Dict[str, int]) -> "NodeLimit":
        try:
            return cls(classical=int(data["classical"]), sf15=int(data["sf15"]))
        except (KeyError, TypeError, ValueError) as err:
            raise ProtocolError(f"invalid node limit: {data!r}") from err


class SkillLevel(enum.IntEnum):
    """Play-vs-computer level 1..8 with the reference's exact mapping to
    movetime / engine skill / depth (api.rs:222-273)."""

    ONE = 1
    TWO = 2
    THREE = 3
    FOUR = 4
    FIVE = 5
    SIX = 6
    SEVEN = 7
    EIGHT = 8

    def movetime_ms(self) -> int:
        return {1: 50, 2: 100, 3: 150, 4: 200, 5: 300, 6: 400, 7: 500, 8: 1000}[self.value]

    def skill_level(self) -> int:
        return {1: -9, 2: -5, 3: -1, 4: 3, 5: 7, 6: 11, 7: 16, 8: 20}[self.value]

    def depth(self) -> int:
        return {1: 5, 2: 5, 3: 5, 4: 5, 5: 5, 6: 8, 7: 13, 8: 22}[self.value]


@dataclass(frozen=True)
class Clock:
    """Game clock for best-move jobs: wtime/btime centiseconds, inc seconds
    (api.rs:275-291)."""

    wtime_centis: int
    btime_centis: int
    inc_seconds: int

    @property
    def wtime_ms(self) -> int:
        return self.wtime_centis * 10

    @property
    def btime_ms(self) -> int:
        return self.btime_centis * 10

    @property
    def inc_ms(self) -> int:
        return self.inc_seconds * 1000

    @classmethod
    def from_json(cls, data: Dict[str, int]) -> "Clock":
        try:
            return cls(
                wtime_centis=int(data["wtime"]),
                btime_centis=int(data["btime"]),
                inc_seconds=int(data["inc"]),
            )
        except (KeyError, TypeError, ValueError) as err:
            raise ProtocolError(f"invalid clock: {data!r}") from err


MAX_BATCH_ID_LEN = 24  # BatchId is capacity-bounded in the reference (api.rs:190-199)


def _parse_batch_id(raw: object) -> str:
    batch_id = str(raw)
    if not batch_id or len(batch_id) > MAX_BATCH_ID_LEN:
        raise ProtocolError(f"invalid batch id: {batch_id!r}")
    return batch_id


@dataclass(frozen=True)
class Work:
    """Tagged work description: analysis of a whole game, or a single
    best-move request (api.rs:130-188)."""

    kind: str  # "analysis" | "move"
    id: str
    # analysis
    nodes: Optional[NodeLimit] = None
    depth: Optional[int] = None
    multipv: Optional[int] = None
    timeout_ms: Optional[int] = None
    # move
    level: Optional[SkillLevel] = None
    clock: Optional[Clock] = None

    @property
    def is_analysis(self) -> bool:
        return self.kind == "analysis"

    @property
    def is_move(self) -> bool:
        return self.kind == "move"

    def effective_multipv(self) -> int:
        return self.multipv or 1

    @property
    def matrix_wanted(self) -> bool:
        return self.is_analysis and self.multipv is not None

    def timeout_seconds(self) -> float:
        """Per-position time budget: server-assigned for analysis, a flat
        2 s for best-move jobs (api.rs:160-165)."""
        if self.is_analysis:
            return (self.timeout_ms or 0) / 1000.0
        return 2.0

    @classmethod
    def from_json(cls, data: Dict) -> "Work":
        kind = data.get("type")
        try:
            if kind == "analysis":
                multipv = data.get("multipv")
                if multipv is not None:
                    multipv = int(multipv)
                    if multipv < 1:
                        raise ProtocolError("multipv must be >= 1")
                depth = data.get("depth")
                return cls(
                    kind="analysis",
                    id=_parse_batch_id(data["id"]),
                    nodes=NodeLimit.from_json(data["nodes"]),
                    depth=int(depth) if depth is not None else None,
                    multipv=multipv,
                    timeout_ms=int(data["timeout"]),
                )
            if kind == "move":
                clock = data.get("clock")
                return cls(
                    kind="move",
                    id=_parse_batch_id(data["id"]),
                    level=SkillLevel(int(data["level"])),
                    clock=Clock.from_json(clock) if clock else None,
                )
        except ProtocolError:
            raise
        except (KeyError, TypeError, ValueError) as err:
            raise ProtocolError(f"malformed work: {err}") from err
        raise ProtocolError(f"unknown work type: {kind!r}")


# ---------------------------------------------------------------------------
# Acquire response
# ---------------------------------------------------------------------------

STARTPOS = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"


@dataclass(frozen=True)
class AcquireResponseBody:
    """Body of a 200/202 acquire response (api.rs:293-319)."""

    work: Work
    position: str  # root X-FEN
    variant: Variant = Variant.STANDARD
    moves: List[str] = field(default_factory=list)
    skip_positions: List[int] = field(default_factory=list)
    game_id: Optional[str] = None

    @classmethod
    def from_json(cls, data: Dict) -> "AcquireResponseBody":
        if "work" not in data:
            raise ProtocolError("missing work")
        work = Work.from_json(data["work"])
        moves_raw = data.get("moves", "")
        moves = moves_raw.split() if isinstance(moves_raw, str) else list(moves_raw)
        game_id = data.get("game_id") or None  # empty string means absent
        skips = data.get("skipPositions") or []
        try:
            skip_positions = [int(s) for s in skips]
        except (TypeError, ValueError) as err:
            raise ProtocolError(f"malformed skipPositions: {skips!r}") from err
        return cls(
            work=work,
            position=data.get("position") or STARTPOS,
            variant=Variant.parse(data.get("variant")),
            moves=moves,
            skip_positions=skip_positions,
            game_id=game_id,
        )

    def batch_url(self, endpoint_url: str) -> Optional[str]:
        """URL of the game on the website, for log/progress display
        (api.rs:311-319)."""
        if not self.game_id:
            return None
        from urllib.parse import urlsplit, urlunsplit

        parts = urlsplit(endpoint_url)
        return urlunsplit((parts.scheme, parts.netloc, f"/{self.game_id}", "", ""))


class AcquiredKind(enum.Enum):
    ACCEPTED = "accepted"
    NO_CONTENT = "no_content"
    REJECTED = "rejected"


@dataclass(frozen=True)
class Acquired:
    """Outcome of an acquire request (api.rs:321-328). REJECTED means the
    server answered 400/401/403/406 and the client must stop
    (doc/protocol.md:240-244)."""

    kind: AcquiredKind
    body: Optional[AcquireResponseBody] = None

    @classmethod
    def accepted(cls, body: AcquireResponseBody) -> "Acquired":
        return cls(AcquiredKind.ACCEPTED, body)

    @classmethod
    def no_content(cls) -> "Acquired":
        return cls(AcquiredKind.NO_CONTENT)

    @classmethod
    def rejected(cls) -> "Acquired":
        return cls(AcquiredKind.REJECTED)


# ---------------------------------------------------------------------------
# Analysis output
# ---------------------------------------------------------------------------


class Matrix:
    """multipv x depth matrix of values, as accumulated from engine `info`
    lines (reference: src/ipc.rs:67-93). ``best()`` is the deepest entry of
    the first PV."""

    def __init__(self) -> None:
        self.rows: List[List[Optional[object]]] = []

    def set(self, multipv: int, depth: int, value: object) -> None:
        while len(self.rows) < multipv:
            self.rows.append([])
        row = self.rows[multipv - 1]
        while len(row) <= depth:
            row.append(None)
        row[depth] = value

    def best(self) -> Optional[object]:
        if not self.rows or not self.rows[0]:
            return None
        return self.rows[0][-1]

    def to_json(self) -> List[List[Optional[object]]]:
        return self.rows


AnalysisPartJson = Dict[str, object]


class AnalysisPart:
    """One entry of the submitted ``analysis`` array (api.rs:352-380)."""

    @staticmethod
    def skipped() -> AnalysisPartJson:
        return {"skipped": True}

    @staticmethod
    def best(
        pv: List[str],
        score: Score,
        depth: int,
        nodes: int,
        time_ms: int,
        nps: Optional[int] = None,
    ) -> AnalysisPartJson:
        part: AnalysisPartJson = {
            "score": score.to_json(),
            "depth": depth,
            "nodes": nodes,
            "time": time_ms,
        }
        if pv:
            part["pv"] = " ".join(pv)
        if nps is not None:
            part["nps"] = nps
        return part

    @staticmethod
    def matrix(
        pv: List[List[Optional[List[str]]]],
        score: List[List[Optional[Score]]],
        depth: int,
        nodes: int,
        time_ms: int,
        nps: Optional[int] = None,
    ) -> AnalysisPartJson:
        part: AnalysisPartJson = {
            "pv": pv,
            "score": [
                [cell.to_json() if cell is not None else None for cell in row]
                for row in score
            ],
            "depth": depth,
            "nodes": nodes,
            "time": time_ms,
        }
        if nps is not None:
            part["nps"] = nps
        return part


# ---------------------------------------------------------------------------
# Request bodies (client -> server)
# ---------------------------------------------------------------------------


def fishnet_header(version: str, key: Optional[str]) -> Dict[str, str]:
    """The ``fishnet`` object present in every POST body (api.rs:102-115)."""
    return {"version": version, "apikey": key or ""}


def void_request_body(version: str, key: Optional[str]) -> Dict:
    return {"fishnet": fishnet_header(version, key)}


def analysis_request_body(
    version: str,
    key: Optional[str],
    flavor: EvalFlavor,
    analysis: List[Optional[AnalysisPartJson]],
) -> Dict:
    return {
        "fishnet": fishnet_header(version, key),
        "stockfish": {"flavor": flavor.value},
        "analysis": analysis,
    }


def move_request_body(version: str, key: Optional[str], best_move: Optional[str]) -> Dict:
    return {
        "fishnet": fishnet_header(version, key),
        "move": {"bestmove": best_move},
    }


# ---------------------------------------------------------------------------
# Status (server queue monitoring)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QueueStatus:
    """May be negative: lila computes these as differences of non-atomic
    measurements (api.rs:85-95)."""

    acquired: int = 0
    queued: int = 0
    oldest_seconds: int = 0

    @classmethod
    def from_json(cls, data: Dict) -> "QueueStatus":
        return cls(
            acquired=int(data.get("acquired", 0)),
            queued=int(data.get("queued", 0)),
            oldest_seconds=int(data.get("oldest", 0)),
        )


@dataclass(frozen=True)
class AnalysisStatus:
    user: QueueStatus = QueueStatus()
    system: QueueStatus = QueueStatus()

    @classmethod
    def from_json(cls, data: Dict) -> "AnalysisStatus":
        analysis = data.get("analysis", {})
        return cls(
            user=QueueStatus.from_json(analysis.get("user", {})),
            system=QueueStatus.from_json(analysis.get("system", {})),
        )
