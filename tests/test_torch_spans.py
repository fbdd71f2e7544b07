"""The port's span flight recorder (fishnet_tpu_torch.telemetry.spans)
and its span sites against the JAX package's, on the CPU.

The same ``record`` calls give the same record shape in both packages;
the dump header, the journal and the dump locations are the JAX ones;
SIGUSR2 dumps from a subprocess. Both clients run the same jobs of
``tests/fake_server.py`` with telemetry on (the mock engine: the batch
traces are the client's): every submitted batch has the same trace id
and the same tree (one ``acquire`` root, its ``schedule`` child, one
``queue_wait`` per position, one ``submit``, and at two tenants one
``admit``); with telemetry off the port records nothing. An AST scan of
both packages lists every ``(module, stage)`` a ``record(`` call names:
the port's equals the JAX package's minus the sites of its unported
modules, and every port site is gated as its JAX site is. The single
sites (``recover``, ``drain``, ``mcts_collect``, the split host's
``dispatch_issue``) carry the JAX fields on the same inputs, and
``/spans`` answers with the JAX body. Durations are never compared."""

import ast
import asyncio
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from fishnet_tpu import telemetry as jax_telemetry
from fishnet_tpu.client import Client as JaxClient
from fishnet_tpu.engine.mock import MockEngineFactory as JaxMock
from fishnet_tpu.nnue.jax_eval import params_from_weights as jax_params
from fishnet_tpu.nnue.weights import NnueWeights as JaxWeights
from fishnet_tpu.resilience import drain as jax_drain
from fishnet_tpu.resilience.supervisor import (
    ServiceSupervisor as JaxSupervisor,
)
from fishnet_tpu.rpc import host as jax_host_mod
from fishnet_tpu.rpc.host import _HostNnueBackend as JaxHostBackend
from fishnet_tpu.search import mcts as jax_mcts
from fishnet_tpu.telemetry import critical_path as cp
from fishnet_tpu.telemetry import spans as jax_spans
from fishnet_tpu.telemetry import tracing as jax_tracing
from fishnet_tpu.utils.logger import Logger as JaxLogger
from fishnet_tpu_torch import telemetry
from fishnet_tpu_torch.client import Client
from fishnet_tpu_torch.engine.mock import MockEngineFactory
from fishnet_tpu_torch.nnue.torch_eval import params_from_weights
from fishnet_tpu_torch.nnue.weights import NnueWeights
from fishnet_tpu_torch.resilience import drain
from fishnet_tpu_torch.resilience.supervisor import (
    ServiceSupervisor,
    ladder_for,
)
from fishnet_tpu_torch.rpc import host as port_host_mod
from fishnet_tpu_torch.rpc.host import _HostNnueBackend
from fishnet_tpu_torch.search import mcts
from fishnet_tpu_torch.telemetry import exporter as exporter_mod
from fishnet_tpu_torch.telemetry import spans, tracing
from fishnet_tpu_torch.telemetry.spans import RECORDER
from fishnet_tpu_torch.utils.logger import Logger
from tests.fake_server import VALID_KEY, FakeServer
from tests.test_torch_mcts import ProjectionEval, workload
from tests.test_torch_rpc import _segment

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def telemetry_off_after():
    yield
    telemetry.disable()
    jax_telemetry.disable()
    drain.reset()
    jax_drain.reset()


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _since(recorder, t0):
    # spans() rounds t to 6 decimals — allow the round-down.
    return [s for s in recorder.spans() if s["t"] >= t0 - 1e-4]


def _fields(span):
    """A span without its duration and clock (never compared)."""
    return {k: v for k, v in span.items() if k not in ("t", "dur_ms")}


# -- the recorder ---------------------------------------------------------------


def test_contract_constants_equal_the_jax_module():
    assert spans.STAGES == jax_spans.STAGES
    assert spans.EVENT_STAGES == jax_spans.EVENT_STAGES
    assert spans.FORMAT == jax_spans.FORMAT == "fishnet-spans/2"
    assert spans.JOURNAL_FORMAT == jax_spans.JOURNAL_FORMAT
    assert spans.DEFAULT_CAPACITY == jax_spans.DEFAULT_CAPACITY
    assert spans._GLOBAL_TRACE.pattern == jax_spans._GLOBAL_TRACE.pattern


def _calls(mod_tracing):
    """One record-call script, run with either package's contexts."""
    root = mod_tracing.TraceContext("1.1", "1.1")
    child = mod_tracing.TraceContext("1.1", "1.2", "1.1")
    batch = mod_tracing.batch_root("wk000007")
    return [
        ("pack", dict(trace=root, group=0, n=3, rows=12)),
        ("device_step", dict(trace=child, group=0, n=3)),
        ("coalesce", dict(trace=child, links=[("2.1", "2.2"), ("3.1", "3.2")],
                          width=3, groups=[0, 1, 2], n=9, shard=0)),
        ("acquire", dict(trace=batch, batch="wk000007")),
        ("postprocess", dict(group=1, n=2, op="harvest")),
        ("drain", dict(reason="sigterm", deadline_s=10.0)),
    ]


def test_records_have_the_jax_shape():
    """The same record() calls: the same dicts (keys, rounding of t,
    trace fields — parent_id omitted on a root, links as lists), in
    the same order, durations aside."""
    got = []
    for rec_cls, mod_tracing in ((spans.SpanRecorder, tracing),
                                 (jax_spans.SpanRecorder, jax_tracing)):
        rec = rec_cls(capacity=16)
        started = 1234.5678912345
        for stage, kw in _calls(mod_tracing):
            rec.record(stage, started, **kw)
            started += 0.25
        got.append([_fields(s) for s in rec.spans()])
        assert all(s["t"] == round(s["t"], 6) for s in rec.spans())
    assert got[0] == got[1]
    assert "parent_id" not in got[0][0]
    assert got[0][2]["links"] == [["2.1", "2.2"], ["3.1", "3.2"]]


def test_ring_keeps_the_newest_capacity_spans():
    for rec_cls in (spans.SpanRecorder, jax_spans.SpanRecorder):
        rec = rec_cls(capacity=4)
        for i in range(10):
            rec.record("pack", time.monotonic(), i=i)
        assert [s["i"] for s in rec.spans()] == [6, 7, 8, 9]


def test_dump_header_equals_the_jax_header(tmp_path):
    headers = []
    for rec_cls in (spans.SpanRecorder, jax_spans.SpanRecorder):
        rec = rec_cls()
        for stage in spans.STAGES:
            rec.record(stage, time.monotonic(), n=1)
        path = tmp_path / f"{rec_cls.__module__}.jsonl"
        assert rec.dump(str(path), reason="test") == str(path)
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        header, body = lines[0], lines[1:]
        assert header["spans"] == len(body) == len(spans.STAGES)
        assert {s["stage"] for s in body} == set(spans.STAGES)
        headers.append(header)
    assert headers[0].keys() == headers[1].keys()
    assert headers[0]["format"] == "fishnet-spans/2"
    assert headers[0]["reason"] == "test" and headers[0]["seq"] == 1


@pytest.mark.parametrize("env", ["file", "dir", "neither"])
def test_dump_path_order_is_file_then_dir_then_tempdir(tmp_path, monkeypatch,
                                                       env):
    monkeypatch.delenv("FISHNET_SPANS_FILE", raising=False)
    monkeypatch.delenv("FISHNET_SPANS_DIR", raising=False)
    name = f"fishnet-spans-{os.getpid()}.jsonl"
    if env == "file":
        monkeypatch.setenv("FISHNET_SPANS_FILE", str(tmp_path / "x.jsonl"))
        monkeypatch.setenv("FISHNET_SPANS_DIR", str(tmp_path / "d"))
        want = str(tmp_path / "x.jsonl")
    elif env == "dir":
        monkeypatch.setenv("FISHNET_SPANS_DIR", str(tmp_path / "d"))
        want = str(tmp_path / "d" / name)
    else:
        want = os.path.join(tempfile.gettempdir(), "fishnet-spans", name)
    assert spans.SpanRecorder().default_path() == want
    assert jax_spans.SpanRecorder().default_path() == want
    if env == "dir":
        # The directory need not exist: dump() makes it.
        assert spans.SpanRecorder().dump(reason="t") == want
        assert json.loads(Path(want).read_text().splitlines()[0])[
            "reason"] == "t"


def test_journal_takes_batch_trace_spans_only(tmp_path):
    """Only spans of a batch trace (a blake2b digest trace id) reach the
    journal; step-trace and untraced spans stay in the ring. The lines
    are the JAX journal's."""
    out = []
    for rec_cls, mod_tracing in ((spans.SpanRecorder, tracing),
                                 (jax_spans.SpanRecorder, jax_tracing)):
        path = tmp_path / rec_cls.__module__ / "journal.jsonl"
        rec = rec_cls()
        rec.journal_to(str(path))
        rec.record("acquire", 10.0, trace=mod_tracing.batch_root("wk000001"),
                   batch="wk000001")
        rec.record("pack", 10.5, trace=mod_tracing.new_trace(), group=0, n=1,
                   rows=4)
        rec.record("postprocess", 11.0, group=0, n=1, op="harvest")
        rec.record("submit", 11.5,
                   trace=mod_tracing.TraceContext(
                       mod_tracing.trace_id_for_batch("wk000001"), "9.9",
                       mod_tracing.trace_id_for_batch("wk000001")),
                   batch="wk000001")
        rec.journal_close()
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert len(rec.spans()) == 4
        out.append(lines)
    for lines in out:
        header, body = lines[0], lines[1:]
        assert header["format"] == spans.JOURNAL_FORMAT
        assert [s["stage"] for s in body] == ["acquire", "submit"]
    assert out[0][0].keys() == out[1][0].keys()
    assert [_fields(s) for s in out[0][1:]] == [_fields(s)
                                                 for s in out[1][1:]]


_SIGUSR2_CHILD = r"""
import os, signal, sys, time
sys.path.insert(0, %r)
from fishnet_tpu_torch.telemetry import spans
for stage in spans.STAGES:
    spans.RECORDER.record(stage, time.monotonic())
assert spans.install_signal_dump()
os.kill(os.getpid(), signal.SIGUSR2)
print("dumped", flush=True)
"""


def test_sigusr2_dumps_from_a_subprocess(tmp_path):
    path = tmp_path / "sig-spans.jsonl"
    env = dict(os.environ, FISHNET_SPANS_FILE=str(path))
    proc = subprocess.run(
        [sys.executable, "-c", _SIGUSR2_CHILD % str(ROOT)], env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert lines[0]["format"] == "fishnet-spans/2"
    assert lines[0]["reason"] == "SIGUSR2"
    assert {s["stage"] for s in lines[1:]} == set(spans.STAGES)


# -- the exporter -----------------------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as res:
            return res.status, res.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def test_spans_trace_and_profile_routes_serve_the_jax_bodies():
    """``/spans`` serves the JAX body; ``/trace`` the recorder's rings as
    the JAX exporter's Chrome trace; ``/profile`` the JAX profiler's
    503 hint while the plane is off; and no route is left unported."""
    from fishnet_tpu.telemetry import profiler as jax_profiler
    from fishnet_tpu.telemetry.trace_export import validate_chrome_trace

    telemetry.enable()
    t0 = time.monotonic()
    RECORDER.record("acquire", t0, trace=tracing.batch_root("wk000042"),
                    batch="wk000042")
    exporter = exporter_mod.MetricsExporter(port=0)
    try:
        status, body = _get(f"{exporter.url}/spans")
        assert status == 200
        doc = json.loads(body)
        assert set(doc) == {"pid", "monotonic_to_epoch", "spans"}
        assert doc["pid"] == os.getpid()
        assert doc["monotonic_to_epoch"] == round(RECORDER.epoch_offset, 6)
        mine = [s for s in doc["spans"] if s.get("batch") == "wk000042"]
        assert mine and mine[-1]["span_id"] == tracing.trace_id_for_batch(
            "wk000042")
        status, body = _get(f"{exporter.url}/trace")
        assert status == 200
        trace = json.loads(body)
        validate_chrome_trace(trace)
        assert any(e["ph"] == "X" and e["name"] == "acquire"
                   and e["args"].get("batch") == "wk000042"
                   for e in trace["traceEvents"])
        assert _get(f"{exporter.url}/profile") == (
            503, jax_profiler.render_endpoint("")[2])
        assert exporter_mod.NOT_PORTED == {}
    finally:
        exporter.close()
        telemetry.disable()


# -- the client's batch traces -------------------------------------------------

#: Analysis jobs of tests/fake_server.py (a skipped ply included).
JOBS = [
    dict(moves="e2e4 e7e5 g1f3"),
    dict(moves="d2d4 d7d5 c2c4 e7e6", skip_positions=[1]),
    dict(moves="g1f3"),
]


async def _client_run(port: bool, tenants: int = 1):
    cls, mock, logger = ((Client, MockEngineFactory, Logger) if port
                         else (JaxClient, JaxMock, JaxLogger))
    async with FakeServer() as server:
        lichess = server.lichess
        ids = [lichess.add_analysis_job(**job) for job in JOBS]
        client = cls(endpoint=server.endpoint, key=VALID_KEY, cores=1,
                     engine_factory=mock(), logger=logger(verbose=0),
                     max_backoff=0.2, tenants=tenants)
        await client.start()
        deadline = time.monotonic() + 60
        while not all(i in lichess.analyses for i in ids):
            assert time.monotonic() < deadline, "no analysis submitted"
            await asyncio.sleep(0.02)
        await client.stop()
        return ids


def _batch_trees(recorder, t0, ids):
    """Per submitted batch: its trace id and its spans' (stage, parent
    relation) counts."""
    got = {}
    spans_ = [s for s in _since(recorder, t0) if "trace_id" in s]
    traces = cp.group_traces(spans_)
    for batch_id in ids:
        tid = tracing.trace_id_for_batch(batch_id)
        tree = traces.get(tid, [])
        ids_in = {s["span_id"]: s["stage"] for s in tree}
        shape = Counter(
            (s["stage"], ids_in.get(s.get("parent_id"), "-"))
            for s in tree)
        got[batch_id] = (tid, shape, cp.orphan_spans(tree))
    return got


@pytest.mark.parametrize("tenants", [1, 2])
def test_batch_trees_equal_the_jax_client(tenants):
    """Both clients on the same jobs with telemetry on: each submitted
    batch has the same trace id and tree in both packages — one
    ``acquire`` root (span_id == trace_id), its ``schedule`` child, one
    ``queue_wait`` per searched position under ``schedule``, one
    ``submit`` under the root, and at two tenants one ``admit`` under
    the root — with no orphan."""
    trees = []
    for port, mod in ((False, jax_telemetry), (True, telemetry)):
        mod.enable()
        t0 = time.monotonic()
        try:
            ids = asyncio.run(_client_run(port, tenants))
        finally:
            mod.disable()
        recorder = RECORDER if port else jax_spans.RECORDER
        trees.append(_batch_trees(recorder, t0, ids))
    ref, got = trees
    assert list(got) == list(ref)
    for (batch_id, (tid, shape, orphans)), job in zip(got.items(), JOBS):
        assert (tid, shape) == ref[batch_id][:2]
        assert orphans == []
        positions = len(job["moves"].split()) + 1 - len(
            job.get("skip_positions", []))
        want = {("acquire", "-"): 1, ("schedule", "acquire"): 1,
                ("queue_wait", "schedule"): positions,
                ("submit", "acquire"): 1}
        if tenants > 1:
            want[("admit", "acquire")] = 1
        assert dict(shape) == want


def test_the_port_records_nothing_with_telemetry_off():
    t0 = time.monotonic()
    asyncio.run(_client_run(True, tenants=2))
    assert _since(RECORDER, t0) == []


# -- site parity -------------------------------------------------------------------

#: JAX span sites whose modules the port does not have yet: none since
#: the fleet position tier's probe was ported. (The JAX cluster modules
#: record no span, nor do cost and the profiler, which the port has.)
UNPORTED_SITES = set()
#: Port modules that hold part of a JAX module: the coalescer and the
#: async pipeline live in search/service.py there.
PORT_HOME = {"search/coalesce.py": "search/service.py"}
#: The one site the JAX package records without the telemetry gate.
UNGATED = {("rpc/client.py", "rpc_wait")}


def _site_scan(pkg: Path):
    """[(module, stage, gated)] of every span ``record(`` call: a call on
    a receiver named like the recorder (``_SPANS``, ``RECORDER``), its
    stage a string or a module constant; gated when an enclosing ``if``
    tests ``tel`` or a call of ``enabled()``."""
    sites = []
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(pkg).as_posix()
        if rel.startswith(("telemetry/", "analysis/")):
            continue
        tree = ast.parse(path.read_text())
        consts = {t.id: n.value.value for n in tree.body
                  if isinstance(n, ast.Assign)
                  and isinstance(n.value, ast.Constant)
                  for t in n.targets if isinstance(t, ast.Name)}
        parents = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "record" and node.args):
                continue
            recv = ast.unparse(node.func.value).upper()
            if "SPANS" not in recv and "RECORDER" not in recv:
                continue
            arg = node.args[0]
            stage = (arg.value if isinstance(arg, ast.Constant)
                     else consts.get(getattr(arg, "id", None)))
            gated, up = False, parents.get(node)
            while up is not None and not gated:
                if isinstance(up, ast.If):
                    test = ast.walk(up.test)
                    gated = any(
                        (isinstance(n, ast.Name) and n.id == "tel")
                        or (isinstance(n, ast.Attribute)
                            and n.attr == "enabled")
                        for n in test)
                up = parents.get(up)
            sites.append((PORT_HOME.get(rel, rel), stage, gated))
    return sites


def test_every_jax_site_of_a_ported_module_has_its_port_site():
    ref = _site_scan(ROOT / "fishnet_tpu")
    got = _site_scan(ROOT / "fishnet_tpu_torch")
    assert all(stage for _, stage, _ in ref + got)
    want = Counter((m, s) for m, s, _ in ref if (m, s) not in UNPORTED_SITES)
    assert Counter((m, s) for m, s, _ in got) == want
    assert {(m, s) for m, s, _ in ref} >= UNPORTED_SITES
    # The gate: every site under it but rpc_wait, in both packages.
    for sites in (ref, got):
        assert {(m, s) for m, s, g in sites if not g} == UNGATED


# -- single sites --------------------------------------------------------------------


class _Svc:
    def __init__(self, psqt_path):
        self.psqt_path = psqt_path


def test_recover_carries_the_jax_fields():
    """Three supervised builds (the third after two rapid deaths, one
    rung down) record ``recover`` with the same rung and respawn fields
    in both packages."""
    got = []
    for sup, mod, rec in (
            (JaxSupervisor(lambda req: _Svc(req or "xla")), jax_telemetry,
             jax_spans.RECORDER),
            (ServiceSupervisor(lambda req: _Svc(req),
                               rungs=ladder_for("cpu")),
             telemetry, RECORDER)):
        mod.enable()
        t0 = time.monotonic()
        for _ in range(3):
            sup.build()
        got.append([_fields(s) for s in _since(rec, t0)
                    if s["stage"] == "recover"])
        mod.disable()
    assert got[0] == got[1]
    assert [(s["rung"], s["respawn"]) for s in got[1]] == [
        ("xla", 0), ("xla", 1), ("host-material", 1)]


def test_drain_carries_the_jax_fields():
    got = []
    for mod, dmod, rec in ((jax_telemetry, jax_drain, jax_spans.RECORDER),
                           (telemetry, drain, RECORDER)):
        mod.enable()
        t0 = time.monotonic()
        assert dmod.begin("sigterm", deadline=10.0)
        assert not dmod.begin("sigint")  # idempotent: one span
        got.append([_fields(s) for s in _since(rec, t0)
                    if s["stage"] == "drain"])
        mod.disable()
        dmod.reset()
    assert got[0] == got[1]
    assert [(s["reason"], s["deadline_s"]) for s in got[1]] == [
        ("sigterm", 10.0)]


def test_mcts_collect_carries_the_jax_fields():
    """tests/test_torch_mcts.py's concurrent workload on both pools with
    the same evaluator: the same sequence of ``mcts_collect`` spans
    (n, trees, collisions)."""
    got = []
    for module, mod, rec in ((jax_mcts, jax_telemetry, jax_spans.RECORDER),
                             (mcts, telemetry, RECORDER)):
        pool = module.MctsPool({}, module.MctsConfig(batch_capacity=64),
                               evaluator=ProjectionEval(seed=3))
        mod.enable()
        t0 = time.monotonic()
        try:
            workload(pool, "concurrent")
        finally:
            mod.disable()
            pool.close()
        got.append([_fields(s) for s in _since(rec, t0)
                    if s["stage"] == "mcts_collect"])
    assert got[0] == got[1] and len(got[1]) > 3
    assert set(got[1][0]) == {"stage", "thread", "n", "trees",
                              "collisions"}


@pytest.mark.parametrize("sizes", [(40,), (17, 40)], ids=["1seg", "2segs"])
def test_host_dispatch_issue_carries_the_jax_fields(sizes, monkeypatch):
    """The split host's NNUE dispatch on the same segments records
    ``dispatch_issue`` with the JAX host's width, n, slots and fill. Each
    host records into a recorder of its own, so the JAX package's
    process-wide recorder keeps no host span without a ``seq`` (the
    JAX service's overlap report pairs every ``dispatch_issue`` it holds
    by ``seq``)."""
    rng = np.random.default_rng(sum(sizes))
    segs = [_segment(rng, k) for k in sizes]
    recorders = (jax_spans.SpanRecorder(), spans.SpanRecorder())
    monkeypatch.setattr(jax_host_mod, "_SPANS", recorders[0])
    monkeypatch.setattr(port_host_mod, "_SPANS", recorders[1])
    got = []
    for backend, mod, rec in (
            (JaxHostBackend(jax_params(JaxWeights.random(seed=5))),
             jax_telemetry, recorders[0]),
            (_HostNnueBackend(params_from_weights(NnueWeights.random(seed=5),
                                                  "cpu"),
                              torch.device("cpu")), telemetry, recorders[1])):
        mod.enable()
        t0 = time.monotonic()
        try:
            backend._run(segs)
        finally:
            mod.disable()
        got.append([_fields(s) for s in _since(rec, t0)
                    if s["stage"] == "dispatch_issue"])
    got[0] = [dict(s, thread=got[1][0]["thread"]) for s in got[0]]
    assert got[0] == got[1]
    n = sum(sizes)
    slots = max(32, 1 << (n - 1).bit_length())
    assert got[1] == [{"stage": "dispatch_issue", "thread": got[1][0]["thread"],
                       "width": len(sizes), "n": n, "slots": slots,
                       "fill": n / slots}]


# -- the flags and the run process ---------------------------------------------------


@pytest.mark.parametrize("argv,ini", [
    (["run", "--no-conf", "--spans-dir", "d"], None),
    (["run", "--no-conf", "--spans-dir", "d", "--spans-journal", "j.jsonl"],
     None),
    (["run"], "SpansDir = e\nSpansJournal = k.jsonl\n"),
    (["run", "--spans-dir", "d"], "SpansDir = e\n"),
    (["run", "--no-conf"], None),
])
def test_spans_flags_resolve_as_in_the_jax_package(tmp_path, argv, ini):
    from fishnet_tpu import configure as jax_configure
    from fishnet_tpu_torch import configure

    if ini is not None:
        conf = tmp_path / "fishnet.ini"
        conf.write_text("[Fishnet]\n" + ini)
        argv = argv + ["--conf", str(conf)]
    port = configure.parse_and_configure(argv)
    ref = jax_configure.parse_and_configure(argv, write=False)
    assert (port.spans_dir, port.spans_journal) == (ref.spans_dir,
                                                   ref.spans_journal)


def test_run_dumps_on_sigusr2_and_on_drain(tmp_path):
    """``run --engine mock --device cpu --metrics-port 0 --spans-dir D
    --spans-journal J`` on one job: ``/spans`` holds the job's batch
    tree, SIGUSR2 writes a fishnet-spans/2 dump into D, the journal
    holds the batch-trace spans, and SIGTERM records the ``drain`` span
    and a dump with reason "drain"; the process exits 0."""
    import signal

    from chip_smoke import FakeServer as StdlibServer

    spans_dir, journal = tmp_path / "spans", tmp_path / "journal.jsonl"
    port_file = tmp_path / "metrics.port"
    with StdlibServer() as server:
        job = server.lichess.add_analysis_job(moves="e2e4 e7e5")
        cmd = [sys.executable, "-m", "fishnet_tpu_torch", "run", "--no-conf",
               "--no-stats-file", "--endpoint", server.endpoint, "--key",
               VALID_KEY, "--cores", "1", "--engine", "mock", "--device",
               "cpu", "--max-backoff", "1", "--metrics-port", "0",
               "--metrics-port-file", str(port_file), "--spans-dir",
               str(spans_dir), "--spans-journal", str(journal)]
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        env.pop("FISHNET_SPANS_DIR", None)
        env.pop("FISHNET_SPANS_FILE", None)
        proc = subprocess.Popen(cmd, cwd=tmp_path, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            deadline = time.monotonic() + 120
            while job not in server.lichess.analyses:
                assert proc.poll() is None, proc.communicate()[0][-3000:]
                assert time.monotonic() < deadline, "no analysis submitted"
                time.sleep(0.05)
            url = f"http://127.0.0.1:{int(port_file.read_text())}"
            tid = tracing.trace_id_for_batch(job)
            deadline = time.monotonic() + 30
            while True:
                doc = json.loads(_get(f"{url}/spans")[1])
                tree = [s for s in doc["spans"] if s.get("trace_id") == tid]
                if any(s["stage"] == "submit" for s in tree):
                    break
                assert time.monotonic() < deadline, tree
                time.sleep(0.05)
            dump = spans_dir / f"fishnet-spans-{proc.pid}.jsonl"
            proc.send_signal(signal.SIGUSR2)
            deadline = time.monotonic() + 30
            while not dump.exists():
                assert time.monotonic() < deadline, "no SIGUSR2 dump"
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    shape = Counter(s["stage"] for s in tree)
    assert shape == {"acquire": 1, "schedule": 1, "queue_wait": 3,
                     "submit": 1}
    assert cp.orphan_spans(tree) == []
    headers, body = [], []
    for line in dump.read_text().splitlines():
        rec = json.loads(line)
        (headers if "format" in rec else body).append(rec)
    assert [h["reason"] for h in headers] == ["SIGUSR2", "drain"]
    assert all(h["format"] == "fishnet-spans/2" for h in headers)
    assert [s["reason"] for s in body if s["stage"] == "drain"] == ["sigterm"]
    lines = [json.loads(ln) for ln in journal.read_text().splitlines()]
    assert lines[0]["format"] == spans.JOURNAL_FORMAT
    assert Counter(s["stage"] for s in lines[1:]
                   if s.get("trace_id") == tid) == shape
