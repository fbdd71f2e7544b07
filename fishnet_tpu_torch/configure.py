"""CLI / config layer of the port.

The port's copy of ``fishnet_tpu/configure.py``: the same commands
(run, configure, systemd, systemd-user, uci, verify-net, license), the
same flags under the same names and defaults (``--key-file``,
``--auto-update``, ``--engine-exe``, ``--mesh``, ``--metrics-port`` /
``--metrics-port-file``, ``--spans-dir`` / ``--spans-journal``,
``--fault-plan``, ``--drain-deadline``, ``--tenants`` and
``--lane-depth-limit`` among them, with their ini keys and errors), the
same precedence CLI > ``fishnet.ini`` (section ``[Fishnet]``) >
interactive first-run dialog, plus the port's ``--device cuda|cpu``.

Durations parse like the reference (configure.rs:323-342): ``90s``,
``2h``, ``1d``, ``500ms``, bare seconds.
"""

from __future__ import annotations

import argparse
import configparser
import io
import os
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence, TextIO
from urllib.parse import urlsplit

from fishnet_tpu_torch.version import __version__

DEFAULT_ENDPOINT = "https://lichess.org/fishnet"
INI_SECTION = "Fishnet"

COMMANDS = ("run", "configure", "systemd", "systemd-user", "uci",
            "verify-net", "license")
ENGINE_BACKENDS = ("tpu-nnue", "az-mcts", "uci", "mock")
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


def endpoint_is_development(endpoint: str) -> bool:
    """Any host other than lichess.org is a development endpoint
    (configure.rs:115-119)."""
    return urlsplit(endpoint).hostname != "lichess.org"


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


def parse_mesh(s: str) -> str:
    """``auto`` | ``off`` | explicit ``DATAxMODEL`` (e.g. ``4x2``)."""
    t = s.strip().lower()
    if t in ("auto", "off"):
        return t
    m = re.fullmatch(r"(\d+)x(\d+)", t)
    if m and int(m.group(1)) >= 1 and int(m.group(2)) >= 1:
        return t
    raise ConfigError(f"invalid mesh spec: {s!r} (use auto, off, or DATAxMODEL)")


def parse_backlog(s: str) -> float:
    """``short`` = 30 s, ``long`` = 1 h, else a duration
    (configure.rs:240-276)."""
    if s == "short":
        return 30.0
    if s == "long":
        return 3600.0
    return parse_duration(s)


def parse_toggle(s: str) -> Optional[bool]:
    """Lenient y/n parsing for dialog answers (configure.rs:352-363).
    Returns None for the empty string (take the default); raises on
    unrecognized input."""
    t = s.strip().lower()
    if t in ("y", "j", "yes", "yep", "yay", "true", "t", "1", "ok"):
        return True
    if t in ("n", "no", "nop", "nope", "nay", "f", "false", "0"):
        return False
    if t == "":
        return None
    raise ConfigError(f"not a yes/no answer: {s!r}")


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

    #: None = bare invocation (no command), which runs the client.
    #: Distinct from an explicit ``run``: the first-run dialog triggers
    #: for bare invocations only (configure.rs:421-423).
    command: Optional[str] = None
    verbose: int = 0
    auto_update: bool = False
    conf: Optional[str] = None
    no_conf: bool = False
    key: Optional[str] = None
    key_file: Optional[str] = None
    endpoint: Optional[str] = None
    cores: Optional[str] = None
    max_backoff: Optional[float] = None
    user_backlog: Optional[float] = None
    system_backlog: Optional[float] = None
    stats_file: Optional[str] = None
    no_stats_file: bool = False
    engine: Optional[str] = None
    #: The UCI engine executable for ``--engine uci``.
    engine_exe: Optional[str] = None
    nnue_file: Optional[str] = None
    #: Policy+value net checkpoint (.npz) for --engine az-mcts.
    az_net_file: Optional[str] = None
    microbatch: Optional[int] = None
    pipeline: Optional[int] = None
    #: Scheduler threads driving the shared search pool (the host
    #: parallelism tier). Default one per core, as in the JAX package:
    #: the dispatch coalescer fuses their groups' steps into few device
    #: dispatches.
    search_threads: Optional[int] = None
    #: Worker (pull-loop) count. None = auto: the batched device engines
    #: (tpu-nnue, az-mcts) run many pull loops per core over one shared
    #: service; the mock engine keeps the reference's one worker per core.
    search_concurrency: Optional[int] = None
    #: Per-batch deadline budget in seconds (None = no deadline).
    batch_deadline: Optional[float] = None
    #: Where the evaluator runs: "cuda" (default; no GPU is an error) or
    #: "cpu" (the plain versions, never chosen silently).
    device: Optional[str] = None
    #: Device-mesh policy of the serving evaluator: "auto" (every visible
    #: GPU, shards placed from the coalescer, when more than one is
    #: visible), "off" (one device), or an explicit "DATAxMODEL" such as
    #: "4x2".
    mesh: Optional[str] = None
    #: Telemetry exposition port (doc/observability.md). None = no
    #: exporter (the default); 0 = an ephemeral port (logged at
    #: startup); otherwise the port /metrics binds on.
    metrics_port: Optional[int] = None
    #: File to write the exporter's BOUND port to once it is listening
    #: (one decimal integer), for ``--metrics-port 0``. None = none.
    metrics_port_file: Optional[str] = None
    #: Directory for span flight-recorder JSONL dumps
    #: (doc/observability.md). None = the ``FISHNET_SPANS_DIR`` /
    #: ``FISHNET_SPANS_FILE`` environment, falling back to a
    #: ``fishnet-spans/`` directory under the system tempdir — never
    #: the process working directory.
    spans_dir: Optional[str] = None
    #: Batch-span journal file: every batch-trace span (the per-work-
    #: unit lifecycle, not the device path) is appended and flushed
    #: line-by-line, so a SIGKILLed process's final spans survive.
    #: None = journaling off.
    spans_journal: Optional[str] = None
    #: Deterministic fault plan (resilience/faults.py grammar). None =
    #: fault injection off (the default; sites pay one flag check).
    fault_plan: Optional[str] = None
    #: Graceful-drain deadline in seconds: on SIGTERM the client stops
    #: acquiring and flushes in-flight batches for at most this long
    #: before aborting the rest upstream and exiting 0. None = the 25 s
    #: default (chosen to fit under Kubernetes' 30 s
    #: terminationGracePeriodSeconds).
    drain_deadline: Optional[float] = None
    #: Concurrent acquire streams (sched/frontend.py). >1 wires the
    #: multi-tenant front end: priority lanes, DRR fairness, admission
    #: control + load shedding. None/1 = the classic single stream.
    tenants: Optional[int] = None
    #: Admission-control high watermark: queued throughput-lane
    #: positions past which analysis batches are shed (accounted abort;
    #: the server reassigns). None = the shed policy default.
    lane_depth_limit: Optional[int] = None

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
        if self.resolved_engine() in ("tpu-nnue", "az-mcts"):
            return min(256, 32 * self.resolved_cores())
        return self.resolved_cores()

    def resolved_device(self) -> str:
        return self.device or "cuda"

    def resolved_mesh(self) -> str:
        return self.mesh or "auto"

    def resolved_command(self) -> str:
        return self.command or "run"

    def resolved_fault_plan(self) -> Optional[str]:
        return self.fault_plan or os.environ.get("FISHNET_FAULT_PLAN") or None

    def resolved_drain_deadline(self) -> float:
        return self.drain_deadline if self.drain_deadline is not None else 25.0

    def resolved_tenants(self) -> int:
        return self.tenants if self.tenants is not None else 1

    def is_systemd(self) -> bool:
        return self.command in ("systemd", "systemd-user")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fishnet_tpu_torch",
        description="Distributed GPU-batched chess analysis for lichess.org "
                    "(the PyTorch/CUDA port of fishnet-tpu).",
    )
    p.add_argument("--version", action="version",
                   version=f"fishnet-tpu-torch {__version__}")
    p.add_argument("command", nargs="?", choices=COMMANDS, default=None,
                   help="run (default): the fishnet client | configure: the "
                        "configuration dialog | systemd | systemd-user: print "
                        "a unit file | uci: serve the engine over UCI on "
                        "stdin/stdout | verify-net: check a .nnue file against "
                        "the native evaluator | license")
    p.add_argument("-v", "--verbose", action="count", default=0, help="Increase verbosity.")
    p.add_argument("--auto-update", action="store_true", help="Install updates on startup and periodically.")
    p.add_argument("--conf", help="Configuration file (default: fishnet.ini).")
    p.add_argument("--no-conf", action="store_true", help="Do not use a configuration file.")
    p.add_argument("-k", "--key", "--apikey", dest="key", help="Fishnet key.")
    p.add_argument("--key-file", help="File containing the fishnet key.")
    p.add_argument("--endpoint", help=f"HTTP endpoint (default: {DEFAULT_ENDPOINT}).")
    p.add_argument("--cores", "--threads", dest="cores", help="Worker count: a number, auto (n-1), or all.")
    p.add_argument("--max-backoff", help="Maximum randomized backoff when idle (default 30s).")
    p.add_argument("--user-backlog", help="Join user queue only if backlog is older than this (e.g. 120s, short, long).")
    p.add_argument("--system-backlog", help="Join system queue only if backlog is older than this (e.g. 2h).")
    p.add_argument("--stats-file", help="File for local statistics (default: ~/.fishnet-tpu-stats).")
    p.add_argument("--no-stats-file", action="store_true", help="Do not record local statistics.")
    p.add_argument("--engine", choices=ENGINE_BACKENDS, default=None,
                   help="Engine backend: tpu-nnue (default; batched GPU "
                        "evaluator), az-mcts (batched PUCT MCTS over a "
                        "policy+value net on the GPU), uci (a UCI engine "
                        "subprocess, --engine-exe) or mock.")
    p.add_argument("--engine-exe", help="UCI engine executable for --engine uci.")
    p.add_argument("--nnue-file", help="Path to HalfKAv2_hm .nnue weights (default: random, seed 0).")
    p.add_argument("--az-net-file", default=None,
                   help="Policy+value net checkpoint (.npz) for --engine "
                        "az-mcts (default: random, seed 0).")
    p.add_argument("--microbatch", type=int, default=None, help="Eval microbatch size (default 1024).")
    p.add_argument("--pipeline", type=int, default=None,
                   help="In-flight device batches per driver thread (default 2).")
    p.add_argument("--search-threads", type=int, default=None,
                   help="Scheduler threads driving the search pool "
                        "(default: one per core).")
    p.add_argument("--search-concurrency", type=int, default=None,
                   help="Concurrent position analyses (worker pull loops). "
                        "Default: 32 per core (at most 256) for tpu-nnue "
                        "and az-mcts, 1 per core for mock.")
    p.add_argument("--batch-deadline", default=None,
                   help="Per-batch deadline budget (duration, e.g. 120s): "
                        "batches older than this are flushed as partial "
                        "analyses. Default: no deadline.")
    p.add_argument("--device", choices=DEVICES, default=None,
                   help="Where the evaluator runs (default cuda; no GPU is "
                        "an error, never a silent CPU run).")
    p.add_argument("--mesh", default=None,
                   help="Device mesh for the serving evaluator: auto (default; "
                        "shard eval batches over all visible devices), off "
                        "(single device), or DATAxMODEL (e.g. 4x2).")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="Serve live telemetry (/metrics Prometheus text, "
                        "/json, /healthz) on this port; 0 picks an "
                        "ephemeral port. Default: off.")
    p.add_argument("--metrics-port-file", default=None,
                   help="Write the bound metrics port to this file once "
                        "listening (pairs with --metrics-port 0).")
    p.add_argument("--spans-dir", default=None,
                   help="Directory for span flight-recorder JSONL dumps "
                        "(fishnet-spans-<pid>.jsonl). Default: "
                        "$FISHNET_SPANS_DIR, else <tempdir>/fishnet-spans.")
    p.add_argument("--spans-journal", default=None,
                   help="Append every batch-trace span to this JSONL file "
                        "(flushed per line) so spans recorded after the "
                        "last scrape survive a SIGKILL. Default: off.")
    p.add_argument("--fault-plan", default=None,
                   help="Deterministic fault plan (resilience/faults.py "
                        "grammar), e.g. 'seed=7;net.acquire:nth=2:error'. "
                        "Testing aid — never set in production. "
                        "Default: fault injection off "
                        "(FISHNET_FAULT_PLAN is the env fallback).")
    p.add_argument("--drain-deadline", default=None,
                   help="Graceful-drain deadline (duration, e.g. 25s): on "
                        "SIGTERM, flush in-flight batches for at most this "
                        "long before aborting the rest upstream (accounted; "
                        "the server reassigns) and exiting 0. Default: 25s.")
    p.add_argument("--tenants", type=int, default=None,
                   help="Concurrent acquire streams (multi-tenant front "
                        "end with priority lanes, per-tenant fairness, and "
                        "admission control). Default: 1 (the classic "
                        "single stream). FISHNET_NO_MULTITENANT=1 forces "
                        "single-stream.")
    p.add_argument("--lane-depth-limit", type=int, default=None,
                   help="Admission-control high watermark: queued "
                        "analysis-lane positions past which bulk batches "
                        "are shed (accounted abort; the server reassigns). "
                        "Default: the shed policy's built-in watermark.")
    return p


def _opt_from_namespace(ns: argparse.Namespace) -> Opt:
    opt = Opt(command=ns.command, verbose=ns.verbose,
              auto_update=ns.auto_update, conf=ns.conf, no_conf=ns.no_conf,
              key_file=ns.key_file, no_stats_file=ns.no_stats_file,
              stats_file=ns.stats_file, engine_exe=ns.engine_exe,
              nnue_file=ns.nnue_file, engine=ns.engine, device=ns.device,
              az_net_file=ns.az_net_file)
    if ns.conf and ns.no_conf:
        raise ConfigError("--conf conflicts with --no-conf")
    if ns.key and ns.key_file:
        raise ConfigError("--key conflicts with --key-file")
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
    if ns.mesh is not None:
        opt.mesh = parse_mesh(ns.mesh)
    if ns.metrics_port is not None:
        opt.metrics_port = _parse_port(str(ns.metrics_port))
    if ns.metrics_port_file is not None:
        opt.metrics_port_file = ns.metrics_port_file
    if ns.spans_dir is not None:
        opt.spans_dir = ns.spans_dir
    if ns.spans_journal is not None:
        opt.spans_journal = ns.spans_journal
    if ns.fault_plan is not None:
        opt.fault_plan = _parse_fault_plan(ns.fault_plan)
    if ns.drain_deadline is not None:
        opt.drain_deadline = parse_duration(ns.drain_deadline)
        if opt.drain_deadline <= 0:
            raise ConfigError("--drain-deadline must be positive")
    if ns.tenants is not None:
        if ns.tenants < 1:
            raise ConfigError("--tenants must be >= 1")
        opt.tenants = ns.tenants
    if ns.lane_depth_limit is not None:
        if ns.lane_depth_limit < 1:
            raise ConfigError("--lane-depth-limit must be >= 1")
        opt.lane_depth_limit = ns.lane_depth_limit
    return opt


def _parse_fault_plan(value: str) -> str:
    """Validate a fault-plan spec at config time so a typo fails with a
    ConfigError instead of a traceback at first injection."""
    from fishnet_tpu_torch.resilience.faults import FaultPlan, FaultPlanError

    try:
        FaultPlan.parse(value)
    except FaultPlanError as err:
        raise ConfigError(f"invalid --fault-plan: {err}") from err
    return value


def _parse_port(value: str) -> int:
    try:
        port = int(value)
    except ValueError as err:
        raise ConfigError(f"invalid port: {value!r}") from err
    if not 0 <= port <= 65535:
        raise ConfigError("metrics port must be in 0..65535 (0 = ephemeral)")
    return port


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
    ("EngineExe", "engine_exe", str),
    ("NnueFile", "nnue_file", str),
    ("AzNetFile", "az_net_file", str),
    ("Mesh", "mesh", parse_mesh),
    ("SearchThreads", "search_threads", lambda v: _positive_int(v, "SearchThreads")),
    ("SearchConcurrency", "search_concurrency",
     lambda v: _positive_int(v, "SearchConcurrency")),
    ("BatchDeadline", "batch_deadline", parse_duration),
    ("Device", "device", lambda v: _choice(v, "device", DEVICES)),
    ("MetricsPort", "metrics_port", lambda v: _parse_port(v)),
    ("MetricsPortFile", "metrics_port_file", str),
    ("SpansDir", "spans_dir", str),
    ("SpansJournal", "spans_journal", str),
    ("FaultPlan", "fault_plan", _parse_fault_plan),
    ("DrainDeadline", "drain_deadline", parse_duration),
    ("Tenants", "tenants", lambda v: _positive_int(v, "Tenants")),
    ("LaneDepthLimit", "lane_depth_limit",
     lambda v: _positive_int(v, "LaneDepthLimit")),
)


def load_ini(path: Path) -> configparser.ConfigParser:
    ini = configparser.ConfigParser()
    ini.optionxform = str  # preserve CamelCase keys like the reference ini
    if path.exists():
        ini.read_string(path.read_text())
    if not ini.has_section(INI_SECTION):
        ini.add_section(INI_SECTION)
    return ini


def write_ini(ini: configparser.ConfigParser, path: Path) -> None:
    buf = io.StringIO()
    ini.write(buf)
    path.write_text(buf.getvalue())


def merge_ini(opt: Opt, ini: configparser.ConfigParser) -> None:
    """Fill unset Opt fields from the ini (CLI wins, configure.rs:574-599)."""
    for ini_key, attr, parse in _INI_FIELDS:
        if ini.has_option(INI_SECTION, ini_key):
            raw = ini.get(INI_SECTION, ini_key)
            if getattr(opt, attr) is None:
                setattr(opt, attr, parse(raw))


# ---------------------------------------------------------------------------
# Interactive dialog (configure.rs:420-572)
# ---------------------------------------------------------------------------

INTRO = r"""#   _________         .    .
#  (..       \_    ,  |\  /|
#   \       O  \  /|  \ \/ /
#    \______    \/ |   \  /      _____ _     _     _   _      _
#       vvvv\    \ |   /  |     |  ___(_)___| |__ | \ | | ___| |_
#       \^^^^  ==   \_/   |     | |_  | / __| '_ \|  \| |/ _ \ __|
#        `\_   ===    \.  |     |  _| | \__ \ | | | |\  |  __/ |_
#        / /\_   \ /      |     |_|   |_|___/_| |_|_| \_|\___|\__| {version} (gpu)
#        |/   \_  \|      /
#               \________/      Distributed GPU chess analysis for lichess.org
""".format(version=__version__)


KeyCheck = Callable[[str, str], Optional[str]]
"""(endpoint, key) -> None if valid, else an error message. Network check."""


def run_dialog(
    opt: Opt,
    ini: configparser.ConfigParser,
    *,
    input_fn: Callable[[], str],
    output: TextIO,
    key_check: Optional[KeyCheck] = None,
) -> None:
    """First-run / ``configure`` dialog: endpoint -> key -> cores ->
    backlog (configure.rs:425-559). Mutates ``ini`` in place; the caller
    merges and writes it."""

    def ask(prompt: str) -> str:
        output.write(prompt)
        output.flush()
        line = input_fn()
        if line == "":  # EOF: stdin closed, e.g. piped invocation
            raise ConfigError("stdin closed during configuration dialog")
        return line.strip()

    endpoint = opt.endpoint or (
        ini.get(INI_SECTION, "Endpoint") if ini.has_option(INI_SECTION, "Endpoint") else DEFAULT_ENDPOINT
    )

    # Step 1: key (with optional live validation; '!' suffix skips it,
    # configure.rs:437-492).
    while True:
        if ini.has_option(INI_SECTION, "Key"):
            masked = "*" * len(ini.get(INI_SECTION, "Key"))
            raw = ask(f"Personal fishnet key (append ! to force, default: keep {masked}): ")
            required = False
        elif endpoint_is_development(endpoint):
            raw = ask("Personal fishnet key (append ! to force, probably not required): ")
            required = False
        else:
            raw = ask("Personal fishnet key (append ! to force, https://lichess.org/get-fishnet): ")
            required = True
        if not raw:
            if required:
                output.write("Key required.\n")
                continue
            break
        check = key_check
        if raw.endswith("!"):
            raw, check = raw[:-1], None
        try:
            key = parse_key(raw)
        except ConfigError as err:
            output.write(f"Invalid: {err}\n")
            continue
        if check is not None:
            err_msg = check(endpoint, key)
            if err_msg is not None:
                output.write(f"Invalid: {err_msg}\n")
                continue
        ini.set(INI_SECTION, "Key", key)
        break

    # Step 2: cores (configure.rs:494-523).
    all_cores = available_cores()
    auto = resolve_cores("auto")
    while True:
        raw = ask(f"\nNumber of worker cores (default {auto}, max {all_cores}): ")
        try:
            spec = parse_cores(raw) if raw else "auto"
        except ConfigError as err:
            output.write(f"Invalid: {err}\n")
            continue
        if spec.isdigit() and int(spec) > all_cores:
            output.write(f"At most {all_cores} logical cores available on your machine.\n")
            continue
        ini.set(INI_SECTION, "Cores", spec)
        break

    # Step 3: backlog (configure.rs:525-553).
    output.write(
        "\nYou can choose to not join unless a backlog is building up. Examples:\n"
        "* Rented server exclusively for fishnet: choose no\n"
        "* Running on a laptop: choose yes\n"
    )
    while True:
        raw = ask("Would you prefer to keep your client idle? (default: no) ")
        try:
            answer = parse_toggle(raw)
        except ConfigError:
            continue
        if answer:
            ini.set(INI_SECTION, "UserBacklog", "short")
            ini.set(INI_SECTION, "SystemBacklog", "long")
        else:
            ini.set(INI_SECTION, "UserBacklog", "0")
            ini.set(INI_SECTION, "SystemBacklog", "0")
        break


def parse_and_configure(
    argv: Optional[Sequence[str]] = None,
    *,
    input_fn: Optional[Callable[[], str]] = None,
    output: Optional[TextIO] = None,
    key_check: Optional[KeyCheck] = None,
    write: bool = True,
) -> Opt:
    """Full config resolution (configure.rs:380-613): parse the CLI, read
    the key file, maybe run the dialog (``input_fn`` reads one answer,
    stdin by default; ``write`` saves the ini it fills), merge the ini
    under the CLI, cap cores at what the machine has."""
    ns = build_parser().parse_args(argv)
    opt = _opt_from_namespace(ns)
    output = output or sys.stderr

    if not opt.is_systemd() and opt.key_file:
        opt.key = parse_key(Path(opt.key_file).read_text().strip())

    use_conf = opt.command == "configure" or (opt.command != "license" and not opt.no_conf)
    if use_conf:
        ini = load_ini(opt.conf_path())
        file_found = opt.conf_path().exists()
        # The dialog triggers for bare invocations and `configure` only:
        # never for `run`, `uci` (stdin belongs to the GUI's handshake)
        # or the non-interactive `verify-net`.
        if (not file_found and opt.command not in ("run", "uci", "verify-net")) or opt.command == "configure":
            if input_fn is None:
                input_fn = sys.stdin.readline
            output.write(INTRO)
            output.write("\n### Configuration\n\n")
            run_dialog(opt, ini, input_fn=input_fn, output=output, key_check=key_check)
            if write:
                write_ini(ini, opt.conf_path())
                output.write(f"Configuration saved to {opt.conf_path()}.\n")
        if not opt.is_systemd():
            merge_ini(opt, ini)

    # Cap cores at what the machine has (configure.rs:602-612).
    if opt.cores and opt.cores.isdigit() and int(opt.cores) > available_cores():
        output.write(
            f"W: Requested {opt.cores} cores, but only {available_cores()} available. Capped.\n"
        )
        opt.cores = "all"
    return opt
