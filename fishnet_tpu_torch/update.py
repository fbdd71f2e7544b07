"""Auto-update subsystem.

The port's copy of ``fishnet_tpu/update.py``: the same index schema,
checks, staging, promotion and drain-then-exec restart, the same
environment names and the same pinned key. Three things differ, each
because the port imports only torch, numpy and the standard library:
the index and the artifact are fetched over asyncio streams
(``net/api.HttpSession``, HTTPS through ``ssl``) instead of aiohttp; the
signature is checked by the standard-library verifier
``utils/ed25519.py`` instead of ``cryptography``; and the default
channel is the JAX package's bucket under its own prefix,
``.../fishnet-tpu-torch``, whose artifact carries ``fishnet_tpu_torch/``
and ``cpp/src`` at its top, so a port never unpacks the JAX package's
tarball over itself. The install root is the directory holding
``fishnet_tpu_torch/``, and the restart execs ``-m fishnet_tpu_torch``.

Equivalent of the reference's ``--auto-update`` flow
(src/main.rs:48-65, 179-199, 412-464): check a release index on startup
and every UPDATE_INTERVAL, and when a newer version exists, finish
draining work and re-``exec`` the process so the new code takes over.

The reference self-replaces a static binary from an S3 bucket
(src/main.rs:440-464, bucket ``fishnet-releases``); the equivalent here
is a DEFAULT static-HTTPS release channel with the same S3-compatible
layout, used whenever ``--auto-update`` is set: a JSON index names the
latest version plus a release tarball, its sha256, and a detached
Ed25519 signature over the tarball made with the release-signing key
(whose PUBLIC half is pinned below). The tarball is downloaded,
hash-verified, signature-verified, and unpacked over the installation
root before the drain-then-exec restart. The sha256 alone only protects
against truncation — it comes from the same unauthenticated index, so
the pinned-key signature is what makes bucket compromise ≠ RCE.
``FISHNET_TPU_UPDATE_URL`` overrides the channel (private mirrors, the
integration tests); only then may the index alternatively carry a
``command`` (e.g. a pip install) for environments that manage their own
packages — the default channel NEVER executes index-supplied commands.

Index schema, served at ``<channel>/index.json``::

    {"latest": "x.y.z",
     "artifact": "vX.Y.Z/fishnet-tpu-torch-vX.Y.Z.tar.gz",   # urljoin vs index
     "sha256": "<hex digest of the tarball>",
     "signature": "<hex Ed25519 sig over the tarball bytes>",
     "command": ["pip", "install", ...]}   # env-override channels only

The port's artifact carries ``fishnet_tpu_torch/`` and ``cpp/src`` at
its top level (the port builds its kernels and native core from the
sources at first use).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import sys
import tarfile
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from fishnet_tpu_torch.utils.logger import Logger
from fishnet_tpu_torch.version import __version__, user_agent

#: Periodic re-check cadence (main.rs:179: every 5 h, with jitter applied
#: by the caller's select loop).
UPDATE_INTERVAL_SECONDS = 5 * 60 * 60

UPDATE_URL_ENV = "FISHNET_TPU_UPDATE_URL"

#: Default release channel (S3-compatible static HTTPS, the layout the
#: reference's self_update consumes from its own bucket). Engaged only
#: when the caller opts in (--auto-update passes allow_default=True);
#: the env override always wins.
DEFAULT_CHANNEL = (
    "https://fishnet-tpu-releases.s3.dualstack.eu-west-3.amazonaws.com"
    "/fishnet-tpu-torch"
)

#: Ed25519 public key pinned in the client; the private half lives only
#: in the release pipeline's secret store (tools/sign_release.py is the
#: signing side). Artifacts from the DEFAULT channel must verify against
#: this key — a compromised bucket can then serve stale or broken
#: indexes, but not code we will execute. Override channels may supply
#: their own key via FISHNET_TPU_UPDATE_PUBKEY (hex).
SIGNING_PUBKEY_HEX = (
    "e7aa856c36f1f3f9b2a415b9d1bef208f5ceacdc9b0ecefb993a36a46c6e7733"
)

UPDATE_PUBKEY_ENV = "FISHNET_TPU_UPDATE_PUBKEY"


def verify_signature(data: bytes, signature_hex: str, pubkey_hex: str) -> None:
    """Raise ValueError if ``signature_hex`` is not a valid Ed25519
    signature over ``data`` by ``pubkey_hex`` (``utils/ed25519.py``). A
    signature that cannot be checked (malformed hex, a bad point) is
    treated exactly like a bad one."""
    from fishnet_tpu_torch.utils import ed25519

    try:
        key, sig = bytes.fromhex(pubkey_hex), bytes.fromhex(signature_hex)
    except ValueError:
        key = sig = b""
    if not ed25519.verify(key, data, sig):
        raise ValueError(
            "release artifact signature does not verify against the "
            "pinned release key"
        )


async def _fetch(url: str, timeout: float) -> bytes:
    """The body of a GET of ``url`` (HTTP or HTTPS, on asyncio streams);
    raises on a connection failure, the timeout or an error status."""
    from fishnet_tpu_torch.net.api import HttpSession

    session = HttpSession({"User-Agent": user_agent()}, timeout)
    try:
        resp = await session.get(url)
    finally:
        session.close()
    resp.raise_for_status()
    return resp.body


def parse_version(v: str) -> tuple:
    return tuple(int(p) for p in v.strip().lstrip("v").split("."))


@dataclass
class UpdateStatus:
    checked: bool
    current: str
    latest: Optional[str] = None
    updated: bool = False
    command: Optional[List[str]] = None
    #: Release-tarball channel fields (the default path): artifact URL
    #: resolved against the index URL, its required sha256, and the
    #: detached Ed25519 signature (required on the default channel).
    artifact: Optional[str] = None
    sha256: Optional[str] = None
    signature: Optional[str] = None
    #: True when the index came from the built-in DEFAULT channel (no
    #: explicit url, no env override) — the trust decisions key off this:
    #: signature mandatory, index `command` never executed.
    from_default: bool = False
    #: Verified, fully-extracted staging directory awaiting promotion
    #: (set when apply_update ran with defer_promote=True).
    staged: Optional[Path] = None
    #: True when defer_promote postponed the actual install (staged
    #: tarball promotion OR legacy command execution) to the caller's
    #: post-drain path.
    deferred: bool = False

    @property
    def update_available(self) -> bool:
        return self.latest is not None and parse_version(self.latest) > parse_version(self.current)


async def check_for_update(
    url: Optional[str] = None, allow_default: bool = False
) -> UpdateStatus:
    """Fetch the release index (one GET; artifact/command ride along so
    apply_update doesn't re-fetch a possibly changed index). Source
    precedence: explicit ``url`` > ``FISHNET_TPU_UPDATE_URL`` > the
    default channel (only with ``allow_default``, i.e. --auto-update).
    Returns ``checked=False`` when no source applies (the common
    zero-egress deployment without --auto-update)."""
    from urllib.parse import urljoin

    explicit = url or os.environ.get(UPDATE_URL_ENV)
    from_default = False
    if not explicit and allow_default:
        url = DEFAULT_CHANNEL + "/index.json"
        from_default = True
    else:
        url = explicit
    if not url:
        return UpdateStatus(checked=False, current=__version__)
    index = json.loads(await _fetch(url, 30.0))
    artifact = index.get("artifact")
    return UpdateStatus(
        checked=True,
        current=__version__,
        latest=index.get("latest"),
        command=index.get("command"),
        artifact=urljoin(url, artifact) if artifact else None,
        sha256=index.get("sha256"),
        signature=index.get("signature"),
        from_default=from_default,
    )


def default_install_root() -> Path:
    """Where release tarballs unpack: the directory containing the
    ``fishnet_tpu_torch`` package (the tarball carries
    ``fishnet_tpu_torch/`` and ``cpp/src`` at its top level)."""
    return Path(__file__).resolve().parent.parent


async def download_and_verify(
    artifact_url: str, sha256: str, dest: Path,
    signature: Optional[str] = None, pubkey_hex: Optional[str] = None,
    require_signature: bool = False,
) -> Path:
    """Fetch the release tarball to ``dest``; require the announced
    sha256 (truncation/corruption guard) and — whenever a pubkey applies
    — a valid Ed25519 signature over the tarball bytes. The sha256 comes
    from the same unauthenticated index as the artifact, so only the
    pinned-key signature authenticates the release; ``require_signature``
    (the default channel) makes a missing signature fatal rather than
    skippable."""
    data = await _fetch(artifact_url, 600.0)
    digest = hashlib.sha256(data)
    tmp = dest.with_suffix(".part")
    tmp.write_bytes(data)
    if digest.hexdigest() != sha256.lower():
        tmp.unlink(missing_ok=True)
        raise ValueError(
            f"release artifact hash mismatch: got {digest.hexdigest()}, "
            f"index announced {sha256}"
        )
    if require_signature and not signature:
        tmp.unlink(missing_ok=True)
        raise ValueError(
            "release index carries no signature; the default channel "
            "requires artifacts signed by the pinned release key"
        )
    if signature and pubkey_hex:
        try:
            verify_signature(tmp.read_bytes(), signature, pubkey_hex)
        except Exception:
            tmp.unlink(missing_ok=True)
            raise
    tmp.rename(dest)
    return dest


def _validate_member(member: "tarfile.TarInfo") -> None:
    """Manual stand-in for tarfile's ``filter='data'`` on interpreters
    predating extraction filters (3.9–3.11 early patch levels): reject
    path traversal, absolute names, links, and special files. Regular
    files and directories only — exactly what CI's artifact layout
    contains."""
    name = member.name
    if Path(name).is_absolute() or ".." in Path(name).parts:
        raise ValueError(f"release member has unsafe path: {name!r}")
    if not (member.isfile() or member.isdir()):
        raise ValueError(
            f"release member {name!r} is not a regular file or directory "
            f"(type {member.type!r})"
        )
    # Match the 'data' filter's mode sanitization: no setuid/setgid/
    # sticky, no group/other write, from an untrusted archive.
    member.mode &= 0o755


def install_tarball(tar_path: Path, staging: Path) -> None:
    """Unpack a verified release tarball into a STAGING directory.
    ``filter='data'`` rejects path traversal, links, and device nodes
    outright (the 'all engine input is carefully validated' stance of
    the reference, applied to our own update channel); interpreters
    without extraction filters get the explicit member validation above
    instead of silently failing every update cycle. Staging keeps a
    mid-extract failure (disk full, rejected member) from leaving the
    live tree mixed-version — nothing touches it until promote_staged.
    """
    with tarfile.open(tar_path, "r:gz") as tar:
        if hasattr(tarfile, "data_filter"):
            tar.extractall(staging, filter="data")
        else:
            members = tar.getmembers()
            for m in members:
                _validate_member(m)
            tar.extractall(staging, members=members)


def promote_staged(staging: Path, install_root: Path) -> None:
    """Move a fully-extracted staging tree into place, one atomic
    os.replace per file. Rename (not truncate-in-place) is what keeps a
    still-running process safe: its dlopen'ed native libraries and
    imported modules hold the OLD inodes, which persist unlinked until
    process exit — extracting directly over the live tree would
    truncate mapped .so files and SIGBUS the engine mid-drain. Callers
    promote only when idle: at startup (nothing loaded yet) or after
    the drain completes, right before the exec restart.

    A validation pre-pass rejects file/directory type collisions BEFORE
    any file moves, so the common mid-walk failures cannot leave a
    mixed-version tree (a crash mid-promotion still can — per-file
    rename is as atomic as a portable install gets)."""
    files = [p for p in sorted(staging.rglob("*")) if p.is_file()]
    for src in files:
        rel = src.relative_to(staging)
        dest = install_root / rel
        if dest.exists() and dest.is_dir():
            raise IsADirectoryError(
                f"release file {rel} collides with an existing directory"
            )
        probe = install_root
        for part in rel.parts[:-1]:
            probe = probe / part
            if probe.exists() and not probe.is_dir():
                raise NotADirectoryError(
                    f"release path {rel} crosses existing file {probe}"
                )
    for src in files:
        dest = install_root / src.relative_to(staging)
        dest.parent.mkdir(parents=True, exist_ok=True)
        os.replace(src, dest)
    import shutil

    shutil.rmtree(staging, ignore_errors=True)


async def apply_update(
    url: Optional[str] = None,
    logger: Optional[Logger] = None,
    allow_default: bool = False,
    install_root: Optional[Path] = None,
    defer_promote: bool = False,
) -> UpdateStatus:
    """Check and, when newer, install: download + sha256-verify + unpack
    the release tarball into staging (default channel), or run the
    index's update command (legacy/pip deployments). With
    ``defer_promote`` the verified staging dir is returned in
    ``status.staged`` instead of being promoted — the periodic updater
    promotes only after the drain completes, so the live process never
    has files swapped under it while work is in flight. Restart is the
    caller's job — after draining, like main.rs:257-259."""
    logger = logger or Logger()
    status = await check_for_update(url, allow_default=allow_default)
    if not status.checked:
        logger.debug("Auto-update: no update source configured.")
        return status
    if not status.update_available:
        logger.fishnet_info(f"fishnet-tpu-torch {__version__} is up to date.")
        return status
    if status.artifact and status.sha256:
        logger.fishnet_info(f"Updating to {status.latest} ...")
        root = install_root or default_install_root()
        staging = root / f".fishnet-tpu-torch-staging-{status.latest}"
        import shutil

        # A previous run may have staged this version and been stopped
        # before promoting; extracting over the stale tree would merge
        # files a re-cut artifact no longer contains.
        shutil.rmtree(staging, ignore_errors=True)
        # Default channel: the pinned key is mandatory. Override
        # channels (tests, private mirrors): verify only when the
        # operator configured a key for it.
        pubkey = (
            SIGNING_PUBKEY_HEX if status.from_default
            else os.environ.get(UPDATE_PUBKEY_ENV)
        )
        # Wherever a key applies, an index that OMITS the signature must
        # fail — otherwise a hostile mirror downgrades verification by
        # simply not announcing one.
        require_sig = status.from_default or bool(pubkey)
        with tempfile.TemporaryDirectory(prefix="fishnet-tpu-torch-update-") as td:
            try:
                tar = await download_and_verify(
                    status.artifact, status.sha256,
                    Path(td) / "release.tar.gz",
                    signature=status.signature,
                    pubkey_hex=pubkey,
                    require_signature=require_sig,
                )
                install_tarball(tar, staging)
            except Exception as err:  # noqa: BLE001 - keep running on bad updates
                logger.error(f"Update download/verify failed: {err}")
                import shutil

                shutil.rmtree(staging, ignore_errors=True)
                return status
        if defer_promote:
            status.staged = staging
            status.deferred = True
        else:
            promote_staged(staging, root)
        status.updated = True
        return status
    if status.command:
        if status.from_default:
            # Executing an index-supplied argv from the DEFAULT channel
            # would turn bucket takeover into RCE on every --auto-update
            # worker; only operator-configured channels (explicit url /
            # FISHNET_TPU_UPDATE_URL) are trusted that far.
            logger.error(
                "Update index from the default channel carries a `command`; "
                "refusing to execute it (only FISHNET_TPU_UPDATE_URL "
                "channels may use command-based updates)."
            )
            return status
        if defer_promote:
            # The live environment must not be mutated while work is in
            # flight: the caller runs the command after its drain, like
            # the tarball promotion.
            status.deferred = True
            status.updated = True
            return status
        logger.fishnet_info(f"Updating to {status.latest} ...")
        proc = await asyncio.create_subprocess_exec(*status.command)
        rc = await proc.wait()
        if rc != 0:
            logger.error(f"Update command failed with exit code {rc}.")
            return status
        status.updated = True
    return status


#: Set on exec so the restarted process doesn't loop forever when the
#: update command succeeded but didn't actually change the installed
#: version (wrong env, source checkout, ...).
_ATTEMPT_ENV = "FISHNET_TPU_UPDATE_ATTEMPTED"


def restart_process(logger: Logger, target_version: Optional[str] = None) -> None:
    """Replace this process with a fresh invocation of the same argv
    (main.rs:412-438, Unix exec path)."""
    logger.fishnet_info("Restarting ...")
    if target_version:
        os.environ[_ATTEMPT_ENV] = target_version
    os.execv(sys.executable,
             [sys.executable, "-m", "fishnet_tpu_torch", *sys.argv[1:]])


def auto_update(logger: Logger) -> UpdateStatus:
    """Startup-time check (main.rs:48-65). Blocking wrapper; the periodic
    re-check runs inside the supervisor loop via ``check_for_update``.
    --auto-update is the opt-in that engages the DEFAULT release channel
    (env override still wins inside check_for_update)."""
    logger.fishnet_info("Checking for updates (--auto-update) ...")
    try:
        status = asyncio.run(apply_update(logger=logger, allow_default=True))
    except Exception as err:
        logger.error(f"Failed to check for updates: {err}")
        return UpdateStatus(checked=False, current=__version__)
    if status.updated:
        if os.environ.get(_ATTEMPT_ENV) == status.latest:
            logger.error(
                f"Update to {status.latest} ran but the installed version is "
                f"still {__version__}; not restarting again."
            )
            return status
        restart_process(logger, status.latest)
    return status
