"""systemd unit-file generation.

The port's copy of ``fishnet_tpu/systemd.py`` (the reference's
src/systemd.rs:11-191): ``python -m fishnet_tpu_torch systemd`` /
``systemd-user`` print a hardened unit file whose ExecStart
reconstructs the exact CLI invocation (flags the user passed, paths
made absolute, the port's ``--device`` among them), so the service runs
with the same config. The unit text is the JAX package's with the
package name changed, but for one stated divergence: the JAX unit
closes the devices (``PrivateDevices``, ``DevicePolicy=closed``) for
every engine but ``tpu-nnue``; the port's leaves them open for the
engines that run on the GPU, ``tpu-nnue`` and ``az-mcts``, unless
``--device cpu`` (a closed policy would hide ``/dev/nvidia*``).
"""

from __future__ import annotations

import os
import shlex
import sys
from pathlib import Path
from typing import List, Optional, TextIO

from fishnet_tpu_torch.configure import Opt


def _unit_user() -> str:
    """User= value for the system unit: $USER when set, else the real
    account name from the password database (getpass checks LOGNAME/
    USER/LNAME/USERNAME then pwd) — a unit with a literal placeholder
    would fail to start at systemctl time."""
    user = os.environ.get("USER")
    if user:
        return user
    import getpass

    try:
        return getpass.getuser()
    except (KeyError, OSError):
        # No passwd entry for the uid (containers): nobody is the
        # conventional unprivileged fallback and at least names a real
        # account on any systemd host.
        return "nobody"


def _duration(seconds: float) -> str:
    """Serialize a duration so parse_duration round-trips it: integer
    seconds when whole, else milliseconds (parse_duration rejects
    fractional values)."""
    if seconds == int(seconds):
        return f"{int(seconds)}s"
    return f"{int(round(seconds * 1000))}ms"


def _exec_start(opt: Opt, *, absolute: bool) -> str:
    """Rebuild the CLI invocation (systemd.rs:119-191)."""
    if absolute:
        exe = [sys.executable, "-m", "fishnet_tpu_torch"]
    else:
        exe = [os.path.basename(sys.executable), "-m", "fishnet_tpu_torch"]

    def path(p: str) -> str:
        return str(Path(p).resolve()) if absolute else p

    args: List[str] = [shlex.quote(a) for a in exe]
    if opt.verbose:
        args.append("-" + "v" * opt.verbose)
    if opt.auto_update:
        args.append("--auto-update")

    if opt.no_conf:
        args.append("--no-conf")
    elif opt.conf is not None or absolute:
        args += ["--conf", shlex.quote(path(str(opt.conf_path())))]

    if opt.key_file is not None:
        args += ["--key-file", shlex.quote(path(opt.key_file))]
    elif opt.key is not None:
        args += ["--key", shlex.quote(opt.key)]

    if opt.endpoint is not None:
        args += ["--endpoint", shlex.quote(opt.endpoint)]
    if opt.cores is not None:
        args += ["--cores", shlex.quote(opt.cores)]
    if opt.max_backoff is not None:
        args += ["--max-backoff", _duration(opt.max_backoff)]
    if opt.user_backlog is not None:
        args += ["--user-backlog", _duration(opt.user_backlog)]
    if opt.system_backlog is not None:
        args += ["--system-backlog", _duration(opt.system_backlog)]
    if opt.stats_file is not None:
        args += ["--stats-file", shlex.quote(path(opt.stats_file))]
    if opt.no_stats_file:
        args.append("--no-stats-file")
    if opt.engine is not None:
        args += ["--engine", opt.engine]
    if opt.engine_exe is not None:
        args += ["--engine-exe", shlex.quote(path(opt.engine_exe))]
    if opt.nnue_file is not None:
        args += ["--nnue-file", shlex.quote(path(opt.nnue_file))]
    if opt.microbatch is not None:
        args += ["--microbatch", str(opt.microbatch)]
    if opt.az_net_file is not None:
        args += ["--az-net-file", shlex.quote(path(opt.az_net_file))]
    if opt.pipeline is not None:
        args += ["--pipeline", str(opt.pipeline)]
    if opt.search_threads is not None:
        args += ["--search-threads", str(opt.search_threads)]
    if opt.search_concurrency is not None:
        args += ["--search-concurrency", str(opt.search_concurrency)]
    if opt.mesh is not None:
        args += ["--mesh", opt.mesh]
    if opt.drain_deadline is not None:
        args += ["--drain-deadline", _duration(opt.drain_deadline)]
    if opt.device is not None:
        args += ["--device", opt.device]

    return " ".join(args)


def _needs_gpu(opt: Opt) -> bool:
    """The unit keeps the devices open for the engines that run on the
    GPU (``/dev/nvidia*``): ``tpu-nnue`` and ``az-mcts``, unless
    ``--device cpu``."""
    return (opt.resolved_engine() in ("tpu-nnue", "az-mcts")
            and opt.resolved_device() == "cuda")


def _timeout_stop(opt: Opt) -> str:
    """TimeoutStopSec aligned with the client's graceful drain: systemd
    sends SIGTERM (KillMode=mixed), the client drains within its
    deadline (flushing in-flight batches, then aborting the rest
    upstream) and exits 0 on its own — systemd's SIGKILL must only ever
    fire after that whole path has had its chance, so deadline + 15 s
    of margin for the flush/exit tail."""
    return f"TimeoutStopSec={int(opt.resolved_drain_deadline() + 15)}"


def systemd_system(opt: Opt, out: Optional[TextIO] = None) -> None:
    """Hardened system unit (systemd.rs:11-55). The GPU engines need
    device access, so the device policy stays open for them
    (``_needs_gpu``)."""
    out = out or sys.stdout
    gpu = _needs_gpu(opt)
    lines = [
        "[Unit]",
        "Description=Fishnet TPU client",
        "After=network-online.target",
        "Wants=network-online.target",
        "",
        "[Service]",
        f"ExecStart={_exec_start(opt, absolute=True)} run",
        "KillMode=mixed",
        _timeout_stop(opt),
        "WorkingDirectory=/tmp",
        f"User={_unit_user()}",
        "Nice=5",
        "CapabilityBoundingSet=",
        "PrivateTmp=true",
    ]
    if not gpu:
        lines += ["PrivateDevices=true", "DevicePolicy=closed"]
    lines += [
        "ProtectSystem=full",
        "NoNewPrivileges=true",
        "Restart=on-failure",
        "",
        "[Install]",
        "WantedBy=multi-user.target",
    ]
    out.write("\n".join(lines) + "\n")
    if out is sys.stdout and sys.stdout.isatty():
        cmd = _exec_start(opt, absolute=False)
        sys.stderr.write(
            "\n# Example usage:\n"
            f"# {cmd} systemd | sudo tee /etc/systemd/system/fishnet-tpu-torch.service\n"
            "# systemctl enable fishnet-tpu-torch.service\n"
            "# systemctl start fishnet-tpu-torch.service\n"
            "# Live view of log: journalctl --unit fishnet-tpu-torch --follow\n"
            f"# Prefer a user unit? {cmd} systemd-user\n"
        )


def systemd_user(opt: Opt, out: Optional[TextIO] = None) -> None:
    """User unit (systemd.rs:57-95)."""
    out = out or sys.stdout
    gpu = _needs_gpu(opt)
    lines = [
        "[Unit]",
        "Description=Fishnet TPU client",
        "After=network-online.target",
        "Wants=network-online.target",
        "",
        "[Service]",
        f"ExecStart={_exec_start(opt, absolute=True)} run",
        "KillMode=mixed",
        _timeout_stop(opt),
        "WorkingDirectory=/tmp",
        "Nice=5",
        "PrivateTmp=true",
    ]
    if not gpu:
        lines += ["DevicePolicy=closed"]
    lines += [
        "ProtectSystem=full",
        "Restart=on-failure",
        "",
        "[Install]",
        "WantedBy=default.target",
    ]
    out.write("\n".join(lines) + "\n")
    if out is sys.stdout and sys.stdout.isatty():
        cmd = _exec_start(opt, absolute=False)
        sys.stderr.write(
            "\n# Example usage:\n"
            f"# {cmd} systemd-user | tee ~/.config/systemd/user/fishnet-tpu-torch.service\n"
            "# systemctl enable --user fishnet-tpu-torch.service\n"
            "# systemctl start --user fishnet-tpu-torch.service\n"
            "# Live view of log: journalctl --user --user-unit fishnet-tpu-torch --follow\n"
        )
