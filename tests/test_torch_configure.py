"""The port's configure.py against the JAX package's: the same `run`
command lines and the same fishnet.ini resolve to the same options.
The search-driver threads default to one per core in both packages;
the port's own choice, `--device`, is pinned beside them."""

import pytest

from fishnet_tpu import configure as jax_configure
from fishnet_tpu_torch import configure

ARGVS = {
    "bare": ["run", "--no-conf"],
    "flags": ["run", "--no-conf", "--endpoint", "http://127.0.0.1:9/fishnet",
              "--key", "abcdef", "--cores", "2", "--max-backoff", "5s",
              "--user-backlog", "short", "--system-backlog", "2h",
              "--engine", "mock", "--microbatch", "512",
              "--search-concurrency", "12", "--batch-deadline", "2m",
              "--no-stats-file", "-v"],
    "auto-cores": ["--no-conf", "--cores", "auto", "--engine", "tpu-nnue"],
}


def _resolved(opt):
    return (opt.resolved_command(), opt.resolved_endpoint(), opt.key,
            opt.resolved_cores(), opt.resolved_max_backoff(),
            opt.user_backlog, opt.system_backlog, opt.resolved_engine(),
            opt.resolved_microbatch(), opt.resolved_workers(),
            opt.batch_deadline, opt.no_stats_file, opt.verbose)


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_run_flags_resolve_as_in_the_jax_package(name):
    port = configure.parse_and_configure(ARGVS[name])
    ref = jax_configure.parse_and_configure(ARGVS[name], write=False)
    assert _resolved(port) == _resolved(ref)
    assert port.resolved_pipeline() == 2
    assert port.resolved_search_threads() == ref.resolved_search_threads() \
        == port.resolved_cores()
    assert port.resolved_device() == "cuda"


def test_ini_merges_under_the_command_line(tmp_path):
    ini = tmp_path / "fishnet.ini"
    ini.write_text(
        "[Fishnet]\nKey = inikey1\nEndpoint = http://127.0.0.1:8/fishnet\n"
        "Cores = 1\nMaxBackoff = 10s\nSearchConcurrency = 7\n"
        "SearchThreads = 2\nDevice = cpu\n"
    )
    argv = ["run", "--conf", str(ini), "--key", "clikey1"]
    port = configure.parse_and_configure(argv)
    ref = jax_configure.parse_and_configure(argv, write=False)
    assert _resolved(port) == _resolved(ref)
    assert port.key == "clikey1" and port.resolved_cores() == 1
    assert port.resolved_search_threads() == 2
    assert port.resolved_device() == "cpu"


@pytest.mark.parametrize("argv", [
    ["run", "--no-conf", "--microbatch", "0"],
    ["run", "--no-conf", "--max-backoff", "soon"],
    ["run", "--no-conf", "--key", "bad key"],
])
def test_bad_values_are_refused(argv):
    with pytest.raises(configure.ConfigError):
        configure.parse_and_configure(argv)


# -- the dialog, the key file, the toggle and the units, against JAX ---------

import dataclasses
import io

from fishnet_tpu import systemd as jax_systemd
from fishnet_tpu_torch import systemd


def _fields(opt) -> dict:
    """The Opt fields both packages have (the port adds ``device``)."""
    return {f.name: getattr(opt, f.name) for f in dataclasses.fields(opt)
            if f.name != "device"}


def _run_both(tmp_path, monkeypatch, argv, answers=(), key_check=None):
    """``parse_and_configure(argv)`` in each package with the same scripted
    answers and the same ini path (each run starts without the ini the
    other wrote): per package the Opt, the error raised (or None), what it
    wrote to its output (the intro banner cut), the ini bytes, and the keys
    the key check saw."""
    out = []
    for mod in (jax_configure, configure):
        monkeypatch.setattr(mod, "available_cores", lambda: 8)
        for ini in tmp_path.glob("*.ini"):
            ini.unlink()
        feed = iter(answers)
        seen = []

        def check(endpoint, key):
            seen.append((endpoint, key))
            return key_check(endpoint, key)

        text = io.StringIO()
        opt = err = None
        try:
            opt = mod.parse_and_configure(
                argv, input_fn=lambda: next(feed), output=text,
                key_check=check if key_check else None)
        except mod.ConfigError as e:
            err = str(e)
        ini = tmp_path / "fishnet.ini"
        prompts = text.getvalue()
        if prompts.startswith(mod.INTRO):
            prompts = prompts[len(mod.INTRO):]
        out.append((opt, err, prompts,
                    ini.read_bytes() if ini.exists() else None, seen))
    (jopt, jerr, jtext, jini, jseen), (opt, err, text, ini, seen) = out
    assert err == jerr
    assert text == jtext
    assert ini == jini
    assert seen == jseen
    if opt is not None:
        assert _fields(opt) == _fields(jopt)
    return opt, err, text, ini, seen


@pytest.mark.parametrize("answer", [
    "yes", "NAY", "", "  ok ", "j", "0", "maybe", "yess"])
def test_parse_toggle_as_in_the_jax_package(answer):
    def call(fn):
        try:
            return fn(answer)
        except (configure.ConfigError, jax_configure.ConfigError) as err:
            return str(err)

    assert call(configure.parse_toggle) == call(jax_configure.parse_toggle)


def test_the_intro_banner_names_the_gpu():
    """The one stated difference of the dialog's output: the port's banner
    says (gpu) and GPU where the JAX package's says (tpu) and TPU."""
    assert configure.INTRO == jax_configure.INTRO.replace(
        "(tpu)", "(gpu)").replace("TPU", "GPU")


def test_key_file_as_in_the_jax_package(tmp_path, monkeypatch):
    key_file = tmp_path / "key.txt"
    key_file.write_text("  secret123 \n")
    opt, *_ = _run_both(tmp_path, monkeypatch,
                        ["run", "--no-conf", "--key-file", str(key_file)])
    assert opt.key == "secret123" and opt.key_file == str(key_file)
    _, err, *_ = _run_both(tmp_path, monkeypatch,
                           ["--no-conf", "--key", "a", "--key-file", "x"])
    assert err == "--key conflicts with --key-file"
    # systemd units carry the file, not the key read from it.
    opt, *_ = _run_both(tmp_path, monkeypatch,
                        ["systemd", "--no-conf", "--key-file", str(key_file)])
    assert opt.key is None


def _rejects(endpoint, key):
    return "access denied" if key == "wrong" else None


DIALOGS = {
    # configure: an invalid key even with '!', then a forced one (no
    # network check), 2 cores, keep idle -> short/long backlog.
    "writes-ini": (["configure"], ["badkey!!", "mykey99!", "2", "yes"],
                   lambda e, k: "should not be called",
                   ["Key = mykey99", "Cores = 2", "UserBacklog = short",
                    "SystemBacklog = long"]),
    "key-check-rejects": (["configure", "--endpoint", "http://dev.example/f"],
                          ["wrong", "right1", "\n", "no"], _rejects,
                          ["Key = right1"]),
    "dev-endpoint-key-optional": (
        ["configure", "--endpoint", "http://localhost:1/f"],
        ["\n", "\n", "no"], None, ["UserBacklog = 0"]),
    "lichess-key-required": (["configure"], ["\n", "abc1!", "\n", "n"],
                             None, ["Key = abc1"]),
    "bare-invocation": ([], ["devkey1!", "2", "no"], None, ["Key = devkey1"]),
    "eof": (["configure"], [""], None, None),
}


@pytest.mark.parametrize("name", sorted(DIALOGS))
def test_dialog_as_in_the_jax_package(name, tmp_path, monkeypatch):
    """The first-run / configure dialog on scripted answers: the same
    prompts, the same ini bytes, the same keys checked, the same Opt."""
    argv, answers, key_check, wants = DIALOGS[name]
    conf = tmp_path / "fishnet.ini"
    opt, err, text, ini, seen = _run_both(
        tmp_path, monkeypatch, argv + ["--conf", str(conf)], answers,
        key_check)
    if wants is None:  # stdin closed during the dialog
        assert err == "stdin closed during configuration dialog"
        assert ini is None
        return
    assert err is None and text.startswith("\n### Configuration\n\n")
    assert f"Configuration saved to {conf}." in text
    for want in wants:
        assert want in ini.decode()
    if name == "key-check-rejects":
        assert [k for _, k in seen] == ["wrong", "right1"]
    if name == "dev-endpoint-key-optional":
        assert "Key" not in ini.decode().replace("UserBacklog", "")
    if name == "bare-invocation":
        assert opt.command is None and opt.resolved_command() == "run"
        assert opt.key == "devkey1"


@pytest.mark.parametrize("command", ["run", "uci", "verify-net", "license"])
def test_no_dialog_without_a_bare_invocation(command, tmp_path, monkeypatch):
    """`run`, `uci` and `verify-net` without an ini file never open the
    dialog (no prompt, no file), and `license` reads no ini at all."""
    conf = tmp_path / "fishnet.ini"
    opt, err, text, ini, _ = _run_both(
        tmp_path, monkeypatch, [command, "--conf", str(conf)],
        answers=())
    assert err is None and text == "" and ini is None
    assert opt.command == command


UNITS = {
    "system-tpu-nnue": ("systemd", dict(
        key="sekret1", cores="4", user_backlog=30.0, engine="tpu-nnue",
        auto_update=True, verbose=1)),
    "system-durations": ("systemd", dict(
        no_conf=True, max_backoff=0.5, microbatch=4096, no_stats_file=True)),
    "user-mock": ("systemd-user", dict(engine="mock", no_conf=True)),
}


@pytest.mark.parametrize("name", sorted(UNITS))
def test_systemd_units_as_in_the_jax_package(name, tmp_path):
    """The three unit tests of the JAX package on both packages' units:
    the same text once the package name is replaced."""
    command, kw = UNITS[name]
    if not kw.get("no_conf"):
        (tmp_path / "f.ini").write_text("[Fishnet]\n")
        kw = dict(kw, conf=str(tmp_path / "f.ini"))
    units = []
    for cfg, mod in ((jax_configure, jax_systemd), (configure, systemd)):
        out = io.StringIO()
        write = (mod.systemd_system if command == "systemd"
                 else mod.systemd_user)
        write(cfg.Opt(command=command, **kw), out)
        units.append(out.getvalue())
    jax_unit, unit = units
    assert unit.replace("-m fishnet_tpu_torch ", "-m fishnet_tpu ") == jax_unit
    assert "-m fishnet_tpu_torch " in unit
    if name == "system-tpu-nnue":
        for want in ("--key sekret1", "--cores 4", "--user-backlog 30s",
                     "--auto-update", " -v "):
            assert want in unit
        assert "PrivateDevices" not in unit
        assert unit.rstrip().endswith("WantedBy=multi-user.target")
    elif name == "system-durations":
        assert "--max-backoff 500ms" in unit and "--microbatch 4096" in unit
        assert "--no-stats-file" in unit
    else:
        assert "WantedBy=default.target" in unit
        assert "DevicePolicy=closed" in unit
