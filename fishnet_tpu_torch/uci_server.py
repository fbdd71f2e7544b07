"""UCI server: expose the GPU-batched engine as a standard UCI engine.

``python -m fishnet_tpu_torch uci`` speaks UCI over stdin/stdout, so
chess GUIs and tooling can drive the batched search backend — the port
of ``fishnet_tpu/uci_server.py``, answering as ``fishnet-tpu-torch``.

Supported: uci / isready / setoption (MultiPV, UCI_Variant, UCI_Chess960)
/ ucinewgame / position / go (nodes, depth, movetime, infinite) / stop /
quit. ``go infinite`` runs until ``stop`` (bounded by a 1-hour guard).
Info lines are emitted per completed iteration when the search returns.
"""

from __future__ import annotations

import asyncio
import sys
import threading
from typing import List, Optional, TextIO

from fishnet_tpu_torch.protocol.types import STARTPOS, ProtocolError, Variant
from fishnet_tpu_torch.search.service import SearchResultData, SearchService
from fishnet_tpu_torch.version import __version__

INFINITE_GUARD_SECONDS = 3600.0


def _parse_uci_variant(value: str) -> Optional[Variant]:
    if value.lower() == "giveaway":  # Fairy-Stockfish's name for antichess
        return Variant.ANTICHESS
    try:
        return Variant.parse(value)
    except ProtocolError:
        return None


class UciServer:
    def __init__(self, service: SearchService, out: TextIO = sys.stdout) -> None:
        self.service = service
        self.out = out
        self.fen = STARTPOS
        self.moves: List[str] = []
        self.variant = Variant.STANDARD
        self.multipv = 1
        self._search_task: Optional[asyncio.Task] = None
        self._stop_event: Optional[threading.Event] = None

    def _send(self, line: str) -> None:
        self.out.write(line + "\n")
        self.out.flush()

    # -- command handlers --------------------------------------------------

    def _cmd_uci(self) -> None:
        self._send(f"id name fishnet-tpu-torch {__version__}")
        self._send("id author the fishnet-tpu authors")
        self._send("option name MultiPV type spin default 1 min 1 max 8")
        # Castling always uses Chess960 king-takes-rook notation (like an
        # engine with UCI_Chess960 permanently on); no toggle is offered.
        self._send(
            "option name UCI_Variant type combo default chess var "
            + " var ".join(sorted({v.uci() for v in Variant}))
        )
        self._send("uciok")

    def _cmd_setoption(self, tokens: List[str]) -> None:
        # setoption name <id> [value <x>]
        try:
            name_idx = tokens.index("name") + 1
            value_idx = tokens.index("value") + 1 if "value" in tokens else None
            name_end = value_idx - 1 if value_idx else len(tokens)
            name = " ".join(tokens[name_idx:name_end]).lower()
            value = " ".join(tokens[value_idx:]) if value_idx else ""
        except (ValueError, IndexError):
            return
        if name == "multipv":
            try:
                self.multipv = max(1, min(8, int(value)))
            except ValueError:
                pass
        elif name == "uci_variant":
            parsed = _parse_uci_variant(value)
            if parsed is not None:
                self.variant = parsed

    def _cmd_position(self, tokens: List[str]) -> None:
        if not tokens:
            return
        moves: List[str] = []
        if "moves" in tokens:
            mi = tokens.index("moves")
            moves = tokens[mi + 1 :]
            tokens = tokens[:mi]
        if tokens[0] == "startpos":
            fen = STARTPOS
        elif tokens[0] == "fen":
            fen = " ".join(tokens[1:])
        else:
            return
        self.fen = fen
        self.moves = moves

    async def _run_search(self, nodes: int, depth: int,
                          movetime: Optional[float]) -> None:
        try:
            result = await self.service.search(
                self.fen, self.moves, nodes=nodes, depth=depth,
                multipv=self.multipv, movetime_seconds=movetime,
                variant=self.variant, stop_event=self._stop_event,
            )
        except asyncio.CancelledError:
            raise
        except Exception as err:  # noqa: BLE001 - engine failure
            self._send(f"info string search failed: {err!r}")
            self._send("bestmove 0000")
            return
        self._emit_result(result)

    def _emit_result(self, result: SearchResultData) -> None:
        nps = int(result.nodes / result.time_seconds) if result.time_seconds > 0 else 0
        for line in result.lines:
            score = f"mate {line.value}" if line.is_mate else f"cp {line.value}"
            parts = [
                f"info depth {line.depth}",
                f"multipv {line.multipv}" if self.multipv > 1 else "",
                f"score {score}",
                f"nodes {result.nodes}",
                f"nps {nps}",
                f"time {int(result.time_seconds * 1000)}",
                ("pv " + " ".join(line.pv)) if line.pv else "",
            ]
            self._send(" ".join(p for p in parts if p))
        self._send(f"bestmove {result.best_move or '0000'}")

    async def _cmd_go(self, tokens: List[str]) -> None:
        await self._interrupt_search()  # one search at a time
        nodes = 0
        depth = 0
        movetime: Optional[float] = None
        clock: dict = {}
        i = 0

        def num(tok: str) -> Optional[int]:
            try:
                return int(tok)
            except ValueError:
                return None  # malformed numbers are ignored, like unknown tokens

        while i < len(tokens):
            tok = tokens[i]
            val = num(tokens[i + 1]) if i + 1 < len(tokens) else None
            if tok == "nodes" and val is not None:
                nodes = val; i += 2
            elif tok == "depth" and val is not None:
                depth = val; i += 2
            elif tok == "movetime" and val is not None:
                movetime = val / 1000.0; i += 2
            elif tok in ("wtime", "btime", "winc", "binc") and val is not None:
                clock[tok] = val; i += 2
            elif tok == "infinite":
                movetime = INFINITE_GUARD_SECONDS; i += 1
            else:
                i += 1
        if movetime is None and clock:
            # Simple time management: a fortieth of the remaining clock
            # plus most of the increment, floored at 50 ms.
            white = self._side_to_move_is_white()
            remaining = clock.get("wtime" if white else "btime", 0)
            inc = clock.get("winc" if white else "binc", 0)
            movetime = max(0.05, remaining / 40_000.0 + inc * 0.8 / 1000.0)
        if nodes == 0 and depth == 0 and movetime is None:
            depth = 12  # a sane default for bare `go`
        self._stop_event = threading.Event()
        self._search_task = asyncio.create_task(
            self._run_search(nodes, depth, movetime)
        )

    def _side_to_move_is_white(self) -> bool:
        fields = self.fen.split()
        white = len(fields) < 2 or fields[1] == "w"
        return white if len(self.moves) % 2 == 0 else not white

    async def _await_search(self) -> None:
        if self._search_task is not None:
            try:
                await self._search_task
            except asyncio.CancelledError:
                pass
            self._search_task = None

    async def _interrupt_search(self) -> None:
        """Cancel any running search (a new `go` supersedes it) — awaiting
        a `go infinite` here would block the stdin loop for the guard's
        full hour, making stop/quit unprocessable."""
        if self._search_task is not None and not self._search_task.done():
            self._search_task.cancel()
        await self._await_search()

    async def _cmd_stop(self) -> None:
        # Graceful stop: the native search halts at its next node poll and
        # the call returns the PARTIAL result (deepest completed
        # iterations), which _run_search emits as usual — the GUI gets the
        # best move the interrupted search actually found.
        if self._search_task is not None and not self._search_task.done():
            if self._stop_event is not None:
                self._stop_event.set()
                self.service.poke()
        await self._await_search()

    # -- main loop ---------------------------------------------------------

    async def handle_line(self, line: str) -> bool:
        """Process one command. Returns False on quit."""
        tokens = line.split()
        if not tokens:
            return True
        cmd, rest = tokens[0], tokens[1:]
        if cmd == "uci":
            self._cmd_uci()
        elif cmd == "isready":
            self._send("readyok")
        elif cmd == "setoption":
            self._cmd_setoption(rest)
        elif cmd == "ucinewgame":
            self.fen = STARTPOS
            self.moves = []
        elif cmd == "position":
            self._cmd_position(rest)
        elif cmd == "go":
            await self._cmd_go(rest)
        elif cmd == "stop":
            await self._cmd_stop()
        elif cmd == "quit":
            return False
        # Unknown commands are ignored, per UCI custom.
        return True

    async def run(self, reader) -> None:
        while True:
            raw = await reader()
            if raw is None:
                break
            if not await self.handle_line(raw.strip()):
                break
        # quit / stdin EOF: a running `go infinite` must not hold the
        # process open for the guard's full hour.
        await self._interrupt_search()


async def serve(service: SearchService) -> None:
    loop = asyncio.get_running_loop()

    async def read_stdin() -> Optional[str]:
        line = await loop.run_in_executor(None, sys.stdin.readline)
        return line if line else None

    await UciServer(service).run(read_stdin)
