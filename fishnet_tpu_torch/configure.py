"""CLI / config layer of the port.

The port's copy of the ``run`` and ``uci`` parts of
``fishnet_tpu/configure.py``: the same flags under the same names and
defaults, with the same precedence CLI > ``fishnet.ini`` (section
``[Fishnet]``), plus the port's ``--device cuda|cpu``. The interactive
first-run dialog, systemd, update and telemetry flags are not ported: a
missing ini file is simply not read.

Durations parse like the reference (configure.rs:323-342): ``90s``,
``2h``, ``1d``, ``500ms``, bare seconds.
"""

from __future__ import annotations

import argparse
import configparser
import os
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence, TextIO
from urllib.parse import urlsplit

from fishnet_tpu_torch.version import __version__

DEFAULT_ENDPOINT = "https://lichess.org/fishnet"
INI_SECTION = "Fishnet"

COMMANDS = ("run", "uci")
ENGINE_BACKENDS = ("tpu-nnue", "mock")
DEVICES = ("cuda", "cpu")


class ConfigError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Scalar option types (configure.rs:84-305)
# ---------------------------------------------------------------------------


def parse_endpoint(s: str) -> str:
    """Normalize an endpoint URL: strip one trailing slash
    (configure.rs:103-113)."""
    parts = urlsplit(s)
    if parts.scheme not in ("http", "https") or not parts.netloc:
        raise ConfigError(f"invalid endpoint url: {s!r}")
    return s[:-1] if s.endswith("/") else s


def parse_key(s: str) -> str:
    """Keys are non-empty ASCII alphanumeric (configure.rs:148-161)."""
    if not s:
        raise ConfigError("key expected to be non-empty")
    if not all(c.isascii() and c.isalnum() for c in s):
        raise ConfigError("key expected to be alphanumeric")
    return s


def available_cores() -> int:
    return os.cpu_count() or 1


def parse_cores(s: str) -> str:
    """Validate a cores spec, keeping the symbolic form
    (configure.rs:163-191)."""
    if s in ("auto", "all", "max"):
        return "all" if s == "max" else s
    try:
        n = int(s)
    except ValueError as err:
        raise ConfigError(f"invalid cores: {s!r}") from err
    if n < 1:
        raise ConfigError("cores must be >= 1")
    return str(n)


def resolve_cores(spec: Optional[str]) -> int:
    """``auto`` = n-1 (min 1), ``all`` = n (configure.rs:194-204)."""
    n = available_cores()
    if spec is None or spec == "auto":
        return max(1, n - 1)
    if spec == "all":
        return n
    return int(spec)


def parse_duration(s: str) -> float:
    """Duration in seconds from ``1d`` / ``2h`` / ``3m`` / ``500ms`` /
    ``90s`` / ``90`` (configure.rs:323-342)."""
    s = s.strip()
    for suffix, factor in (("ms", 0.001), ("d", 86400.0), ("h", 3600.0), ("m", 60.0), ("s", 1.0)):
        if s.endswith(suffix):
            body = s[: -len(suffix)]
            break
    else:
        body, factor = s, 1.0
    try:
        value = int(body.strip())
    except ValueError as err:
        raise ConfigError(f"invalid duration: {s!r}") from err
    if value < 0:
        raise ConfigError("duration must be non-negative")
    return value * factor


def parse_backlog(s: str) -> float:
    """``short`` = 30 s, ``long`` = 1 h, else a duration
    (configure.rs:240-276)."""
    if s == "short":
        return 30.0
    if s == "long":
        return 3600.0
    return parse_duration(s)


def _positive_int(value: str, name: str) -> int:
    try:
        n = int(value)
    except ValueError as err:
        raise ConfigError(f"{name} must be an integer: {value!r}") from err
    if n < 1:
        raise ConfigError(f"{name} must be >= 1")
    return n


def _choice(value: str, name: str, choices) -> str:
    if value not in choices:
        raise ConfigError(
            f"invalid {name}: {value!r} (choose from {', '.join(choices)})"
        )
    return value


# ---------------------------------------------------------------------------
# Opt
# ---------------------------------------------------------------------------


@dataclass
class Opt:
    """Resolved options (reference ``Opt``, configure.rs:19-69)."""

    #: None = bare invocation, which runs the client.
    command: Optional[str] = None
    verbose: int = 0
    conf: Optional[str] = None
    no_conf: bool = False
    key: Optional[str] = None
    endpoint: Optional[str] = None
    cores: Optional[str] = None
    max_backoff: Optional[float] = None
    user_backlog: Optional[float] = None
    system_backlog: Optional[float] = None
    stats_file: Optional[str] = None
    no_stats_file: bool = False
    engine: Optional[str] = None
    nnue_file: Optional[str] = None
    microbatch: Optional[int] = None
    pipeline: Optional[int] = None
    #: Scheduler threads driving the shared search pool (the host
    #: parallelism tier). Default one per core, as in the JAX package:
    #: the dispatch coalescer fuses their groups' steps into few device
    #: dispatches.
    search_threads: Optional[int] = None
    #: Worker (pull-loop) count. None = auto: the batched device engine
    #: (tpu-nnue) runs many pull loops per core over one shared service;
    #: the mock engine keeps the reference's one worker per core.
    search_concurrency: Optional[int] = None
    #: Per-batch deadline budget in seconds (None = no deadline).
    batch_deadline: Optional[float] = None
    #: Where the evaluator runs: "cuda" (default; no GPU is an error) or
    #: "cpu" (the plain versions, never chosen silently).
    device: Optional[str] = None

    def conf_path(self) -> Path:
        return Path(self.conf) if self.conf else Path("fishnet.ini")

    def resolved_endpoint(self) -> str:
        return self.endpoint or DEFAULT_ENDPOINT

    def resolved_cores(self) -> int:
        return resolve_cores(self.cores)

    def resolved_max_backoff(self) -> float:
        return self.max_backoff if self.max_backoff is not None else 30.0

    def resolved_engine(self) -> str:
        return self.engine or "tpu-nnue"

    def resolved_microbatch(self) -> int:
        return self.microbatch if self.microbatch is not None else 1024

    def resolved_pipeline(self) -> int:
        """Without --pipeline the depth is 2: the host phase of one
        group (fiber stepping, feature extraction) overlaps the other
        group's device work."""
        return self.pipeline if self.pipeline is not None else 2

    def resolved_search_threads(self) -> int:
        if self.search_threads is not None:
            return self.search_threads
        return self.resolved_cores()

    def resolved_workers(self) -> int:
        if self.search_concurrency is not None:
            return self.search_concurrency
        if self.resolved_engine() == "tpu-nnue":
            return min(256, 32 * self.resolved_cores())
        return self.resolved_cores()

    def resolved_device(self) -> str:
        return self.device or "cuda"

    def resolved_command(self) -> str:
        return self.command or "run"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fishnet_tpu_torch",
        description="Distributed GPU-batched chess analysis for lichess.org "
                    "(the PyTorch/CUDA port of fishnet-tpu).",
    )
    p.add_argument("--version", action="version",
                   version=f"fishnet-tpu-torch {__version__}")
    p.add_argument("command", nargs="?", choices=COMMANDS, default=None,
                   help="run (default): the fishnet client | uci: serve the "
                        "engine over UCI on stdin/stdout")
    p.add_argument("-v", "--verbose", action="count", default=0, help="Increase verbosity.")
    p.add_argument("--conf", help="Configuration file (default: fishnet.ini).")
    p.add_argument("--no-conf", action="store_true", help="Do not use a configuration file.")
    p.add_argument("-k", "--key", "--apikey", dest="key", help="Fishnet key.")
    p.add_argument("--endpoint", help=f"HTTP endpoint (default: {DEFAULT_ENDPOINT}).")
    p.add_argument("--cores", "--threads", dest="cores", help="Worker count: a number, auto (n-1), or all.")
    p.add_argument("--max-backoff", help="Maximum randomized backoff when idle (default 30s).")
    p.add_argument("--user-backlog", help="Join user queue only if backlog is older than this (e.g. 120s, short, long).")
    p.add_argument("--system-backlog", help="Join system queue only if backlog is older than this (e.g. 2h).")
    p.add_argument("--stats-file", help="File for local statistics (default: ~/.fishnet-tpu-stats).")
    p.add_argument("--no-stats-file", action="store_true", help="Do not record local statistics.")
    p.add_argument("--engine", choices=ENGINE_BACKENDS, default=None,
                   help="Engine backend: tpu-nnue (default; batched GPU evaluator) or mock.")
    p.add_argument("--nnue-file", help="Path to HalfKAv2_hm .nnue weights (default: random, seed 0).")
    p.add_argument("--microbatch", type=int, default=None, help="Eval microbatch size (default 1024).")
    p.add_argument("--pipeline", type=int, default=None,
                   help="In-flight device batches per driver thread (default 2).")
    p.add_argument("--search-threads", type=int, default=None,
                   help="Scheduler threads driving the search pool "
                        "(default: one per core).")
    p.add_argument("--search-concurrency", type=int, default=None,
                   help="Concurrent position analyses (worker pull loops). "
                        "Default: 32 per core (at most 256) for tpu-nnue, "
                        "1 per core for mock.")
    p.add_argument("--batch-deadline", default=None,
                   help="Per-batch deadline budget (duration, e.g. 120s): "
                        "batches older than this are flushed as partial "
                        "analyses. Default: no deadline.")
    p.add_argument("--device", choices=DEVICES, default=None,
                   help="Where the evaluator runs (default cuda; no GPU is "
                        "an error, never a silent CPU run).")
    return p


def _opt_from_namespace(ns: argparse.Namespace) -> Opt:
    opt = Opt(command=ns.command, verbose=ns.verbose, conf=ns.conf,
              no_conf=ns.no_conf, no_stats_file=ns.no_stats_file,
              stats_file=ns.stats_file, nnue_file=ns.nnue_file,
              engine=ns.engine, device=ns.device)
    if ns.conf and ns.no_conf:
        raise ConfigError("--conf conflicts with --no-conf")
    if ns.stats_file and ns.no_stats_file:
        raise ConfigError("--stats-file conflicts with --no-stats-file")
    if ns.key is not None:
        opt.key = parse_key(ns.key)
    if ns.endpoint is not None:
        opt.endpoint = parse_endpoint(ns.endpoint)
    if ns.cores is not None:
        opt.cores = parse_cores(ns.cores)
    if ns.max_backoff is not None:
        opt.max_backoff = parse_duration(ns.max_backoff)
    if ns.user_backlog is not None:
        opt.user_backlog = parse_backlog(ns.user_backlog)
    if ns.system_backlog is not None:
        opt.system_backlog = parse_backlog(ns.system_backlog)
    for flag in ("microbatch", "pipeline", "search_threads",
                 "search_concurrency"):
        value = getattr(ns, flag)
        if value is not None:
            if value < 1:
                raise ConfigError(f"--{flag.replace('_', '-')} must be >= 1")
            setattr(opt, flag, value)
    if ns.batch_deadline is not None:
        opt.batch_deadline = parse_duration(ns.batch_deadline)
        if opt.batch_deadline <= 0:
            raise ConfigError("--batch-deadline must be positive")
    return opt


# ---------------------------------------------------------------------------
# Ini handling (configure.rs:405-419, 574-599)
# ---------------------------------------------------------------------------

#: ini key -> (Opt attribute, parser)
_INI_FIELDS = (
    ("Endpoint", "endpoint", parse_endpoint),
    ("Key", "key", parse_key),
    ("Cores", "cores", parse_cores),
    ("UserBacklog", "user_backlog", parse_backlog),
    ("SystemBacklog", "system_backlog", parse_backlog),
    ("MaxBackoff", "max_backoff", parse_duration),
    ("Engine", "engine", lambda v: _choice(v, "engine backend", ENGINE_BACKENDS)),
    ("NnueFile", "nnue_file", str),
    ("SearchThreads", "search_threads", lambda v: _positive_int(v, "SearchThreads")),
    ("SearchConcurrency", "search_concurrency",
     lambda v: _positive_int(v, "SearchConcurrency")),
    ("BatchDeadline", "batch_deadline", parse_duration),
    ("Device", "device", lambda v: _choice(v, "device", DEVICES)),
)


def load_ini(path: Path) -> configparser.ConfigParser:
    ini = configparser.ConfigParser()
    ini.optionxform = str  # preserve CamelCase keys like the reference ini
    if path.exists():
        ini.read_string(path.read_text())
    if not ini.has_section(INI_SECTION):
        ini.add_section(INI_SECTION)
    return ini


def merge_ini(opt: Opt, ini: configparser.ConfigParser) -> None:
    """Fill unset Opt fields from the ini (CLI wins, configure.rs:574-599)."""
    for ini_key, attr, parse in _INI_FIELDS:
        if ini.has_option(INI_SECTION, ini_key):
            raw = ini.get(INI_SECTION, ini_key)
            if getattr(opt, attr) is None:
                setattr(opt, attr, parse(raw))


def parse_and_configure(
    argv: Optional[Sequence[str]] = None, output: Optional[TextIO] = None,
) -> Opt:
    """Config resolution (configure.rs:380-613): parse the CLI, merge
    the ini under it, cap cores at what the machine has."""
    ns = build_parser().parse_args(argv)
    opt = _opt_from_namespace(ns)
    output = output or sys.stderr
    if not opt.no_conf:
        merge_ini(opt, load_ini(opt.conf_path()))
    # Cap cores at what the machine has (configure.rs:602-612).
    if opt.cores and opt.cores.isdigit() and int(opt.cores) > available_cores():
        output.write(
            f"W: Requested {opt.cores} cores, but only {available_cores()} available. Capped.\n"
        )
        opt.cores = "all"
    return opt
