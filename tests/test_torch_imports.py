"""The port imports torch, numpy and the standard library only: nothing of
jax, flax, optax, orbax, aiohttp, cryptography or the JAX package
fishnet_tpu, and its entry points never fall back to the CPU on their own.
Its packaging lists every subpackage.

The import check runs in a subprocess: this test process has imported
jax already (tests/conftest.py). With those imports blocked, the
subprocess serves UCI, then runs the ``run`` client (mock engine, CPU)
against the standard-library fake lichess server of chip_smoke.py until
it has submitted its one job, and drains on SIGINT."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "aiohttp", "cryptography",
           "fishnet_tpu")

_BLOCKED_RUN = r"""
import importlib, io, pkgutil, runpy, sys

BLOCKED = %r


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None


sys.meta_path.insert(0, Blocker())
import fishnet_tpu_torch

names = [m.name for m in pkgutil.walk_packages(
    fishnet_tpu_torch.__path__, "fishnet_tpu_torch.")]
for name in ("search.eval_cache", "models.az", "models.az_encoding",
             "search.mcts", "search.az_plane", "engine.az_engine", "train",
             "train.model", "train.trainer", "train.az_trainer",
             "train.checkpoint", "train.data", "train.selfplay",
             "parallel", "parallel.mesh", "train.sharding", "telemetry",
             "telemetry.registry", "telemetry.exporter", "telemetry.spans",
             "telemetry.tracing", "resilience",
             "resilience.faults", "resilience.accounting",
             "resilience.drain", "resilience.shedding", "resilience.soak",
             "sched.frontend", "control", "control.signals",
             "control.actuators", "control.controller", "telemetry.stitch",
             "telemetry.fleet", "cluster", "cluster.proxy",
             "cluster.supervisor", "cluster.chaos", "cluster.position_tier",
             "configure", "__main__", "engine.uci", "systemd", "verify_net",
             "update", "utils.ed25519"):
    assert "fishnet_tpu_torch." + name in names, names
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
print("imported", len(names), "modules", flush=True)
sys.argv = ["fishnet_tpu_torch", "uci", "--device", "cpu",
            "--microbatch", "64"]
try:
    runpy.run_module("fishnet_tpu_torch", run_name="__main__")
except SystemExit as exit_:
    assert exit_.code == 0, exit_.code

import os, signal, threading, time
from chip_smoke import VALID_KEY, FakeServer

with FakeServer() as server:
    job = server.lichess.add_analysis_job(moves="e2e4 e7e5")

    def interrupt_when_submitted():
        deadline = time.monotonic() + 60
        while job not in server.lichess.analyses and time.monotonic() < deadline:
            time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGINT)

    threading.Thread(target=interrupt_when_submitted, daemon=True).start()
    sys.argv = ["fishnet_tpu_torch", "run", "--device", "cpu", "--engine",
                "mock", "--no-conf", "--no-stats-file", "--cores", "1",
                "--endpoint", server.endpoint, "--key", VALID_KEY,
                "--max-backoff", "1"]
    try:
        runpy.run_module("fishnet_tpu_torch", run_name="__main__")
    except SystemExit as exit_:
        assert exit_.code == 0, exit_.code
    parts = server.lichess.analyses[job]["analysis"]
    assert len(parts) == 3 and all("score" in p for p in parts), parts
print("submitted", job, flush=True)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("clean", flush=True)
"""


def test_port_imports_and_serves_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN % (BLOCKED,)],
        input="uci\nisready\nquit\n", capture_output=True, text=True,
        cwd=ROOT, timeout=240, env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "imported" in out and "clean" in out
    assert "id name fishnet-tpu-torch" in out
    assert "uciok" in out and "readyok" in out
    assert "submitted wk000000" in out


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_forbidden_import_anywhere_in_the_port():
    files = sorted((ROOT / "fishnet_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [
        (str(f.relative_to(ROOT)), root)
        for f in files for root in _imported_roots(f) if root in BLOCKED
    ]
    assert not bad, bad


def test_entry_points_raise_without_a_gpu(monkeypatch, capsys, tmp_path):
    import torch

    from fishnet_tpu_torch.__main__ import main
    from fishnet_tpu_torch.device import resolve_device
    from fishnet_tpu_torch.nnue.torch_eval import params_from_weights
    from fishnet_tpu_torch.nnue.weights import NnueWeights
    from fishnet_tpu_torch.search.service import SearchService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchService(weights=NnueWeights.random(seed=0), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    w = NnueWeights.random(seed=0)
    w.save(str(tmp_path / "w.nnue"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_weights(w)
    assert resolve_device("cpu") == torch.device("cpu")
    # `run` (and `uci`) without --device cpu refuse to start; so does
    # `run --engine az-mcts`, and its service and plane.
    for args in (["run"], ["uci"], ["run", "--engine", "az-mcts"]):
        assert main(args + ["--no-conf", "--no-stats-file", "--endpoint",
                            "http://127.0.0.1:9/fishnet"]) == 2
        assert "no CUDA device" in capsys.readouterr().err
    # So does `verify-net`, before it reads the net, and its library call.
    assert main(["verify-net", "--no-conf", "--nnue-file",
                 str(tmp_path / "w.nnue")]) == 2
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err and "layout" not in captured.out
    from fishnet_tpu_torch.verify_net import verify_net

    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify_net(str(tmp_path / "w.nnue"))
    from fishnet_tpu_torch.engine.az_engine import AzMctsService
    from fishnet_tpu_torch.models.az import AzConfig, init_az_params
    from fishnet_tpu_torch.search.az_plane import AzDispatchPlane
    from fishnet_tpu_torch.search.mcts import MctsConfig

    tiny = AzConfig(channels=16, blocks=2, value_hidden=16)
    cfg = MctsConfig(batch_capacity=64, az=tiny)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AzMctsService(init_az_params(0, tiny), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AzDispatchPlane(init_az_params(0, tiny), cfg, device="cuda")
    # So does the split plane's evaluator host (its --device is cuda by
    # default): it exits 2 before it serves any link.
    from fishnet_tpu_torch.rpc import host as rpc_host

    assert rpc_host.main(["--nnue-file", str(tmp_path / "w.nnue"),
                          "--dir", str(tmp_path / "rpc")]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "rpc").exists()
    assert rpc_host.main(["--az-seed", "0", "--dir", str(tmp_path / "rpc")]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "rpc").exists()
    # So do the trainers.
    from fishnet_tpu_torch.train import AzTrainer, Trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AzTrainer(cfg=tiny)
    # The scalar backend evaluates on the host and needs no device.
    svc = SearchService(weights=w, backend="scalar", pool_slots=8,
                        batch_capacity=64, tt_bytes=1 << 20)
    try:
        assert svc.device is None
    finally:
        svc.close()


def test_mesh_entry_points_raise_without_a_gpu(monkeypatch, capsys):
    """The serving mesh resolves CUDA devices or raises: "auto", an int
    and an explicit ``cuda`` list never quietly become CPU shards, nor
    does the legacy evaluator's default mesh; ``--mesh`` on the CPU
    refuses more devices than the one it has."""
    import torch

    from fishnet_tpu_torch.__main__ import main
    from fishnet_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for req in ("auto", None, 2, ["cuda:0", "cuda:0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.serving_devices(req)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    assert mesh.serving_devices("auto", "cpu") == [torch.device("cpu")]
    assert main(["uci", "--no-conf", "--mesh", "2x1"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert main(["uci", "--no-conf", "--device", "cpu", "--mesh", "1x2"]) == 2
    assert "--mesh 1x2 needs 2 devices, found 1" in capsys.readouterr().err


def test_packaging_lists_every_subpackage():
    """``pip install .`` ships what ``[tool.setuptools] packages`` lists:
    every directory of the port with an ``__init__.py`` is there, and so
    is the port's console script."""
    import tomllib

    with open(ROOT / "pyproject.toml", "rb") as fp:
        project = tomllib.load(fp)
    listed = set(project["tool"]["setuptools"]["packages"])
    found = {
        ".".join(init.parent.relative_to(ROOT).parts)
        for init in (ROOT / "fishnet_tpu_torch").rglob("__init__.py")
    }
    assert {"fishnet_tpu_torch.control", "fishnet_tpu_torch.cluster"} <= found
    assert found <= listed, sorted(found - listed)
    assert (project["project"]["scripts"]["fishnet-tpu-torch"]
            == "fishnet_tpu_torch.__main__:main")
