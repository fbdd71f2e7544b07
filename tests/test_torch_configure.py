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
