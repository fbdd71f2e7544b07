"""The port's command line as a whole against the JAX package's:
``python -m fishnet_tpu_torch <cmd>`` and ``python -m fishnet_tpu <cmd>``
as subprocesses with the same argv (the JAX one on ``JAX_PLATFORMS=cpu``)
for ``license``, ``systemd`` / ``systemd-user``, ``configure`` and a
failing ``verify-net``: the same exit code and the same standard output
byte for byte once the package name is replaced, but for the stated
divergences, each asserted by name (``DIVERGENCES``). Then
``verify_net`` itself on the CPU against the JAX package's on one
generated net: the same sample, the same values (== the native scalar
evaluator's) and the same stage lines."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fishnet_tpu import configure as jax_configure
from fishnet_tpu_torch import configure
from fishnet_tpu_torch.search import eval_cache

ROOT = Path(__file__).resolve().parent.parent

#: What the port does differently, each applied to the JAX package's
#: output to give the port's:
#: * ``device-flag``: the port's ``--device`` (the JAX package has none),
#:   carried by the unit's ExecStart;
#: * ``open-devices-az-mcts``: the port's unit leaves the devices open
#:   for ``--engine az-mcts``, which runs on the GPU (the JAX unit closes
#:   them for every engine but ``tpu-nnue``);
#: * ``closed-devices-cpu``: the port's unit closes them for
#:   ``--device cpu``.
DIVERGENCES = ("device-flag", "open-devices-az-mcts", "closed-devices-cpu")
CLOSED = {"systemd": "PrivateDevices=true\nDevicePolicy=closed\n",
          "systemd-user": "DevicePolicy=closed\n"}


def _run(package: str, argv, cwd, stdin: str = ""):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", package, *argv], input=stdin,
        capture_output=True, text=True, cwd=cwd, env=env, timeout=300)
    return proc.returncode, proc.stdout, proc.stderr


def _named(text: str) -> str:
    """The port's output with the JAX package's names."""
    return (text.replace("fishnet_tpu_torch", "fishnet_tpu")
            .replace("fishnet-tpu-torch", "fishnet-tpu"))


def _both(argv, cwd, port_extra=(), stdin=""):
    return (_run("fishnet_tpu", argv, cwd, stdin),
            _run("fishnet_tpu_torch", [*argv, *port_extra], cwd, stdin))


def test_license_as_in_the_jax_package(tmp_path):
    (jrc, jout, _), (rc, out, _) = _both(["license"], tmp_path)
    assert rc == jrc == 0
    assert _named(out) == jout
    assert out.startswith("fishnet-tpu-torch is free software")


UNIT_ARGVS = {
    "key-cores": (["--no-conf", "--key", "abc123", "--cores", "2"], (), ()),
    "az-mcts": (["--no-conf", "--engine", "az-mcts", "--az-net-file",
                 "tiny.npz"], (), ("open-devices-az-mcts",)),
    "device-cpu": (["--no-conf", "--engine", "tpu-nnue", "--key", "k1"],
                   ("--device", "cpu"), ("device-flag", "closed-devices-cpu")),
    "device-cpu-az-mcts": (["--no-conf", "--engine", "az-mcts"],
                           ("--device", "cpu"), ("device-flag",)),
    "key-file": (["--key-file", "key.txt", "--conf", "f.ini", "--engine",
                  "mock", "-vv", "--auto-update", "--max-backoff", "500ms",
                  "--drain-deadline", "10s", "--mesh", "off",
                  "--microbatch", "256", "--stats-file", "stats"], (), ()),
    "engine-uci": (["--no-conf", "--engine", "uci", "--engine-exe", "./sf",
                    "--search-concurrency", "3", "--pipeline", "2"], (), ()),
    "default-conf": (["--nnue-file", "w.nnue", "--user-backlog", "short",
                      "--system-backlog", "2h"], (), ()),
}


def _expected_unit(jax_unit: str, command: str, divergences,
                   port_extra) -> str:
    """The JAX package's unit with the named divergences applied."""
    unit = jax_unit
    for name in divergences:
        assert name in DIVERGENCES, name
        if name == "device-flag":
            unit = unit.replace(" run\n", f" {' '.join(port_extra)} run\n", 1)
        elif name == "open-devices-az-mcts":
            assert CLOSED[command] in unit
            unit = unit.replace(CLOSED[command], "")
        elif name == "closed-devices-cpu":
            assert CLOSED[command] not in unit
            unit = unit.replace("ProtectSystem=full\n",
                                CLOSED[command] + "ProtectSystem=full\n")
    return unit


@pytest.mark.parametrize("command", ["systemd", "systemd-user"])
@pytest.mark.parametrize("name", sorted(UNIT_ARGVS))
def test_systemd_units_as_in_the_jax_package(name, command, tmp_path):
    argv, port_extra, divergences = UNIT_ARGVS[name]
    (tmp_path / "key.txt").write_text("secret1\n")
    (tmp_path / "f.ini").write_text("[Fishnet]\n")
    # The default ini exists: without it a unit command opens the dialog.
    (tmp_path / "fishnet.ini").write_text("[Fishnet]\n")
    (jrc, jout, jerr), (rc, out, err) = _both(
        [command, *argv], tmp_path, port_extra)
    assert rc == jrc == 0, (err, jerr)
    assert _named(out) == _expected_unit(jout, command, divergences,
                                         port_extra)
    assert " -m fishnet_tpu_torch " in out
    exec_start = next(line for line in out.splitlines()
                      if line.startswith("ExecStart="))
    assert exec_start.endswith(" run")
    if "--device" in port_extra:
        assert "--device cpu run" in exec_start
    if "--key-file" in argv:  # the file, never the key read from it
        assert f"--key-file {tmp_path / 'key.txt'}" in exec_start
        assert "secret1" not in out
    engine = (argv[argv.index("--engine") + 1] if "--engine" in argv
              else "tpu-nnue")
    gpu = engine in ("tpu-nnue", "az-mcts") and "--device" not in port_extra
    assert ("DevicePolicy=closed" in out) == (not gpu)


def test_configure_as_in_the_jax_package(tmp_path):
    """``configure`` with scripted answers on stdin: the same exit code,
    the same (empty) standard output, the same ini bytes and the same
    prompts on stderr; the one difference is the intro banner, (gpu)
    where the JAX package says (tpu)."""
    answers = "badkey!!\nmykey99!\n2\nyes\n"
    outs = []
    for package in ("fishnet_tpu", "fishnet_tpu_torch"):
        conf = tmp_path / "fishnet.ini"
        conf.unlink(missing_ok=True)
        rc, out, err = _run(package, ["configure", "--conf", str(conf)],
                            tmp_path, answers)
        outs.append((rc, out, err, conf.read_bytes()))
    (jrc, jout, jerr, jini), (rc, out, err, ini) = outs
    assert rc == jrc == 0
    assert out == jout == ""
    assert ini == jini and b"Key = mykey99" in ini
    assert err.startswith(configure.INTRO) and jerr.startswith(
        jax_configure.INTRO)
    assert err[len(configure.INTRO):] == jerr[len(jax_configure.INTRO):]
    assert "Invalid: key expected to be alphanumeric" in err


def test_failing_verify_net_as_in_the_jax_package(tmp_path):
    """A net cut short by 512 bytes fails the layout stage in both, with
    the same report and the re-export hint, and exits 1. The port runs
    with ``--device cpu`` (``device-flag``: without it, it needs a GPU)."""
    from fishnet_tpu_torch.nnue.weights import NnueWeights

    path = tmp_path / "w.nnue"
    NnueWeights.random(seed=13).save(str(path))
    data = path.read_bytes()
    cut = tmp_path / "cut.nnue"
    cut.write_bytes(data[:-512])
    (jrc, jout, _), (rc, out, _) = _both(
        ["verify-net", "--no-conf", "--nnue-file", str(cut)], tmp_path,
        ("--device", "cpu"))
    assert rc == jrc == 1
    assert _named(out) == jout
    assert out.startswith("layout          FAIL  ")
    assert "re-export" in out and out.endswith("verify-net: FAIL\n")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread beside the other test processes (ROADMAP C10);
    the subprocesses get ``OMP_NUM_THREADS=1``."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fresh_port_cache():
    """The port's process-wide eval cache, reset around the test."""
    eval_cache.reset_cache()
    yield
    eval_cache.reset_cache()


def test_verify_net_as_in_the_jax_package(tmp_path, monkeypatch,
                                          fresh_port_cache):
    """``verify_net`` on one generated net, on the CPU: the port's and
    the JAX package's sample the same positions, evaluate them to the same
    values, which equal the native scalar evaluator's, and report the
    same stage lines."""
    from fishnet_tpu import verify_net as jax_verify
    from fishnet_tpu.nnue import jax_eval
    from fishnet_tpu_torch import verify_net as port_verify
    from fishnet_tpu_torch.nnue.weights import NnueWeights

    path = tmp_path / "w.nnue"
    NnueWeights.random(seed=13).save(str(path))
    seen = {}
    evaluate = jax_eval.evaluate_batch_jit

    def recording(params, feats, buckets):
        out = evaluate(params, feats, buckets)
        seen["values"] = np.asarray(out).astype(np.int64)
        return out

    monkeypatch.setattr(jax_eval, "evaluate_batch_jit", recording)
    jax_lines, port_lines, report = [], [], {}
    assert jax_verify.verify_net(str(path), positions=40, depth=2,
                                 log=jax_lines.append)
    assert port_verify.verify_net(str(path), positions=40, depth=2,
                                  log=port_lines.append, device="cpu",
                                  report=report)
    assert port_lines == jax_lines and len(port_lines) == 5
    assert report["fens"] == jax_verify._sample_fens(40, seed=1234)
    assert np.array_equal(report["device_values"], seen["values"])
    assert np.array_equal(report["device_values"], report["scalar_values"])
    # On the CPU no kernel launches; the service is on the plain rung.
    assert report["dense"] == report["packed"] == 0
    assert report["dispatches"] > 0 and report["rung"] == "xla"
