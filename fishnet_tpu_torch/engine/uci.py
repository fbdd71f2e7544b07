"""UCI subprocess engine driver.

The port's copy of ``fishnet_tpu/engine/uci.py``, with the same
semantics: the reference's engine-process model (src/stockfish.rs), one
external UCI engine child per :class:`UciEngine`, spoken to over piped
stdin/stdout. ``run --engine uci --engine-exe EXE`` puts any UCI engine
behind the client's engine seam: a stock Stockfish as the oracle, or the
port's own ``python -m fishnet_tpu_torch uci`` (through a wrapper
script), whose child process then owns the GPU while this process opens
no device.

Semantics mirrored from the reference:

* child spawned with piped stdio in its own process group so a Ctrl-C at
  the terminal does not kill engines before batches drain
  (stockfish.rs:108-122), and killed on drop (stockfish.rs:138);
* one-time init: ``uci`` handshake, optional ``EvalFile``,
  ``UCI_Chess960 true``, then ``isready``/``readyok``
  (stockfish.rs:203-233);
* per job: ``ucinewgame``, ``Use NNUE``/``UCI_Variant``/``MultiPV``
  options, ``position fen … moves …`` (stockfish.rs:241-283), then
  ``go nodes N [depth D]`` for analysis (AnalyseMode=true, Skill 20) or
  ``go movetime T depth D [wtime …]`` for play with the mapped skill
  (stockfish.rs:286-344);
* ``info``/``bestmove`` stream parsed into multipv×depth matrices;
  a ``bestmove`` without any recorded score is an engine error
  (stockfish.rs:346-456, missing-score check :360-362).
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import signal
import sys
import time
from typing import Dict, List, Optional, Sequence

from fishnet_tpu_torch.engine.base import Engine, EngineError, EngineFactory
from fishnet_tpu_torch.ipc import Position, PositionResponse
from fishnet_tpu_torch.protocol.types import EngineFlavor, Matrix, Score
from fishnet_tpu_torch.utils.logger import Logger

__all__ = ["UciEngine", "UciEngineFactory"]

_IO_TIMEOUT = 30.0  # seconds to wait for handshake lines (not for `go`)


def _parse_info_line(tokens: Sequence[str]) -> Dict[str, object]:
    """Parse one ``info`` line into a field dict. Tokens after ``pv`` are
    the principal variation; unknown fields are skipped (the reference's
    parser is equally lenient for fields it does not use)."""
    out: Dict[str, object] = {}
    i = 1  # skip "info"
    n = len(tokens)
    while i < n:
        tok = tokens[i]
        if tok in ("depth", "seldepth", "multipv", "nodes", "nps", "time", "hashfull", "tbhits"):
            if i + 1 < n:
                try:
                    out[tok] = int(tokens[i + 1])
                except ValueError:
                    pass
            i += 2
        elif tok == "score":
            if i + 2 < n and tokens[i + 1] in ("cp", "mate"):
                try:
                    value = int(tokens[i + 2])
                except ValueError:
                    value = None
                if value is not None:
                    out["score"] = Score(tokens[i + 1], value)
            i += 3
            # Optional bound markers directly after the score.
            while i < n and tokens[i] in ("lowerbound", "upperbound"):
                out["bound"] = tokens[i]
                i += 1
        elif tok == "pv":
            out["pv"] = list(tokens[i + 1 :])
            break
        elif tok == "string":
            break
        else:
            i += 1
    return out


class UciEngine(Engine):
    """One UCI engine subprocess (reference StockfishActor,
    stockfish.rs:81-201)."""

    def __init__(
        self,
        command: str,
        flavor: EngineFlavor,
        logger: Optional[Logger] = None,
        args: Sequence[str] = (),
        eval_file: Optional[str] = None,
        hash_mib: Optional[int] = None,
    ) -> None:
        self.command = command
        self.args = list(args)
        self.flavor = flavor
        self.logger = logger or Logger(verbose=0)
        self.eval_file = eval_file
        self.hash_mib = hash_mib
        self._proc: Optional[asyncio.subprocess.Process] = None
        self._options: Dict[str, str] = {}  # advertised option names, lowercased -> exact
        self._initialized = False
        self._lock = asyncio.Lock()  # stub channel has capacity 1 (stockfish.rs:28)

    # -- process management -------------------------------------------------

    async def _spawn(self) -> None:
        try:
            # Own session/process group: terminal signals must not reach
            # the child (stockfish.rs:108-122).
            self._proc = await asyncio.create_subprocess_exec(
                self.command,
                *self.args,
                stdin=asyncio.subprocess.PIPE,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.DEVNULL,
                start_new_session=sys.platform != "win32",
            )
        except OSError as err:
            raise EngineError(f"failed to spawn engine {self.command!r}: {err}") from err
        self.logger.debug(f"Spawned engine process {self._proc.pid}: {self.command}")

    async def _send(self, line: str) -> None:
        proc = self._proc
        if proc is None or proc.stdin is None:
            raise EngineError("engine process is gone")
        self.logger.debug(f"{self._pid} << {line}")
        try:
            proc.stdin.write(line.encode() + b"\n")
            await proc.stdin.drain()
        except (ConnectionResetError, BrokenPipeError) as err:
            raise EngineError(f"engine stdin closed: {err}") from err

    async def _recv(self, timeout: Optional[float] = _IO_TIMEOUT) -> str:
        proc = self._proc
        if proc is None or proc.stdout is None:
            raise EngineError("engine process is gone")
        try:
            raw = await asyncio.wait_for(proc.stdout.readline(), timeout)
        except asyncio.TimeoutError:
            raise EngineError("timed out waiting for engine output") from None
        if not raw:
            code = proc.returncode
            raise EngineError(f"engine exited unexpectedly (code {code})")
        line = raw.decode(errors="replace").strip()
        if line:
            self.logger.debug(f"{self._pid} >> {line}")
        return line

    @property
    def _pid(self) -> str:
        return f"<{self._proc.pid}>" if self._proc else "<?>"

    # -- UCI protocol -------------------------------------------------------

    async def _init(self) -> None:
        """One-time handshake (stockfish.rs:203-233)."""
        await self._spawn()
        await self._send("uci")
        while True:
            line = await self._recv()
            tokens = line.split()
            if not tokens:
                continue
            if tokens[0] == "uciok":
                break
            if tokens[0] == "option" and "name" in tokens:
                # option name <Multi Word Name> type ...
                start = tokens.index("name") + 1
                end = tokens.index("type") if "type" in tokens else len(tokens)
                name = " ".join(tokens[start:end])
                self._options[name.lower()] = name
        if self.eval_file and self._supports("EvalFile"):
            await self._setoption("EvalFile", self.eval_file)
        if self.hash_mib is not None and self._supports("Hash"):
            await self._setoption("Hash", str(self.hash_mib))
        if self._supports("UCI_Chess960"):
            await self._setoption("UCI_Chess960", "true")
        await self._isready()
        self._initialized = True

    def _supports(self, option: str) -> bool:
        return option.lower() in self._options

    async def _setoption(self, name: str, value: str) -> None:
        await self._send(f"setoption name {name} value {value}")

    async def _isready(self) -> None:
        await self._send("isready")
        while True:
            if (await self._recv()).split()[:1] == ["readyok"]:
                return

    def _go_command(self, position: Position) -> str:
        """Build the ``go`` line (stockfish.rs:286-344)."""
        work = position.work
        if work.is_analysis:
            assert work.nodes is not None
            parts = ["go", "nodes", str(work.nodes.get(self.flavor.eval_flavor()))]
            if work.depth is not None:
                parts += ["depth", str(work.depth)]
            return " ".join(parts)

        assert work.level is not None
        parts = [
            "go",
            "movetime",
            str(work.level.movetime_ms()),
            "depth",
            str(work.level.depth()),
        ]
        if work.clock is not None:
            parts += [
                "wtime", str(work.clock.wtime_ms),
                "btime", str(work.clock.btime_ms),
                "winc", str(work.clock.inc_ms),
                "binc", str(work.clock.inc_ms),
            ]
        return " ".join(parts)

    async def go(self, position: Position) -> PositionResponse:
        async with self._lock:
            try:
                return await self._go(position)
            except EngineError:
                await self.close()
                raise

    async def _go(self, position: Position) -> PositionResponse:
        if not self._initialized:
            await self._init()

        work = position.work
        await self._send("ucinewgame")
        if self._supports("Use NNUE"):
            nnue = "true" if self.flavor.eval_flavor().is_nnue else "false"
            await self._setoption("Use NNUE", nnue)
        if self._supports("UCI_Variant"):
            await self._setoption("UCI_Variant", position.variant.uci())
        if self._supports("UCI_AnalyseMode"):
            await self._setoption("UCI_AnalyseMode", "true" if work.is_analysis else "false")
        if self._supports("Skill Level"):
            skill = 20 if work.is_analysis else work.level.skill_level()  # type: ignore[union-attr]
            await self._setoption("Skill Level", str(skill))
        await self._setoption("MultiPV", str(work.effective_multipv()))
        await self._isready()

        pos_line = f"position fen {position.root_fen}"
        if position.moves:
            pos_line += " moves " + " ".join(position.moves)
        await self._send(pos_line)
        await self._send(self._go_command(position))

        scores = Matrix()
        pvs = Matrix()
        depth = 0
        nodes = 0
        nps: Optional[int] = None
        time_ms = 0
        started = time.monotonic()

        while True:
            # `go` has no protocol-level timeout: the worker enforces the
            # rolling budget around us (main.rs:316-358).
            line = await self._recv(timeout=None)
            tokens = line.split()
            if not tokens:
                continue
            if tokens[0] == "info":
                fields = _parse_info_line(tokens)
                if isinstance(fields.get("nodes"), int):
                    nodes = fields["nodes"]  # type: ignore[assignment]
                if isinstance(fields.get("nps"), int):
                    nps = fields["nps"]  # type: ignore[assignment]
                if isinstance(fields.get("time"), int):
                    time_ms = fields["time"]  # type: ignore[assignment]
                if "bound" in fields:
                    continue  # only exact scores are recorded
                d = fields.get("depth")
                score = fields.get("score")
                multipv = int(fields.get("multipv", 1))  # type: ignore[arg-type]
                # Score and pv are recorded independently: a terminal
                # position reports `score mate 0` with no pv at all
                # (stockfish.rs records each field as it appears).
                if isinstance(d, int) and score is not None:
                    scores.set(multipv, d, score)
                    pvs.set(multipv, d, fields.get("pv", []))
                    if multipv == 1:
                        depth = max(depth, d)
            elif tokens[0] == "bestmove":
                best: Optional[str] = None
                if len(tokens) > 1 and tokens[1] != "(none)":
                    best = tokens[1]
                if scores.best() is None:
                    # bestmove without score (stockfish.rs:360-362)
                    raise EngineError("engine sent bestmove without score")
                elapsed = time_ms / 1000.0 if time_ms else (time.monotonic() - started)
                return PositionResponse(
                    work=work,
                    position_id=position.position_id,
                    scores=scores,
                    pvs=pvs,
                    best_move=best,
                    depth=depth,
                    nodes=nodes,
                    time_seconds=elapsed,
                    nps=nps,
                    url=position.url,
                )

    async def close(self) -> None:
        proc, self._proc = self._proc, None
        self._initialized = False
        if proc is None or proc.returncode is not None:
            return
        with contextlib.suppress(ProcessLookupError, OSError):
            if sys.platform != "win32":
                os.killpg(proc.pid, signal.SIGKILL)
            else:
                proc.kill()
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(proc.wait(), timeout=5.0)


class UciEngineFactory(EngineFactory):
    """Creates one subprocess per engine, routed per flavor like the
    reference's embedded Stockfish/Fairy-Stockfish pair
    (assets.rs:384-391)."""

    def __init__(
        self,
        official_command: str,
        multivariant_command: Optional[str] = None,
        logger: Optional[Logger] = None,
        eval_file: Optional[str] = None,
        args: Sequence[str] = (),
        hash_mib: Optional[int] = None,
    ) -> None:
        self.commands = {
            EngineFlavor.OFFICIAL: official_command,
            EngineFlavor.MULTI_VARIANT: multivariant_command or official_command,
        }
        self.logger = logger
        self.eval_file = eval_file
        self.args = list(args)
        self.hash_mib = hash_mib

    async def create(self, flavor: EngineFlavor) -> Engine:
        return UciEngine(
            self.commands[flavor],
            flavor,
            logger=self.logger,
            args=self.args,
            eval_file=self.eval_file if flavor is EngineFlavor.OFFICIAL else None,
            hash_mib=self.hash_mib,
        )
