"""The port's auto-update (``fishnet_tpu_torch/update.py``) on a
standard-library release channel: the thirteen tests of
``tests/test_update_channel.py`` and the three update tests of
``tests/test_configure.py`` (no source, a local server, drain-then-exec),
with the install root in ``tmp_path``; the tarball checks held to the JAX
functions' decisions on the same tarballs; and the standard-library
Ed25519 verifier (``fishnet_tpu_torch/utils/ed25519.py``) held to
``cryptography``'s, which signs in the test."""

import asyncio
import hashlib
import io
import json
import random
import sys
import tarfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey,
    Ed25519PublicKey,
)

from fishnet_tpu import update as jax_update
from fishnet_tpu_torch import update as update_mod
from fishnet_tpu_torch.utils import ed25519
from fishnet_tpu_torch.utils.logger import Logger

pytestmark = pytest.mark.anyio

ARTIFACT = "v99.0.0/fishnet-tpu-torch.tar.gz"


def make_release_tarball() -> bytes:
    """A minimal release artifact in the port's layout
    (``fishnet_tpu_torch/`` at the top level)."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        data = b"__version__ = '99.0.0'\n"
        info = tarfile.TarInfo("fishnet_tpu_torch/_release_marker.py")
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))
    return buf.getvalue()


class FakeChannel:
    """A static release channel on the standard library's HTTP server, on
    a thread: ``/channel/index.json`` (``index()``'s JSON) and the
    tarball. A context manager, sync or async."""

    def __init__(self, latest="99.0.0", sha256=None, tarball=None):
        self.tarball = tarball if tarball is not None else make_release_tarball()
        self.sha256 = sha256 or hashlib.sha256(self.tarball).hexdigest()
        self.latest = latest
        self.index_hits = 0
        self.artifact_hits = 0

    def index(self) -> dict:
        return {"latest": self.latest, "artifact": ARTIFACT,
                "sha256": self.sha256}

    def __enter__(self):
        channel = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self):
                if self.path == "/channel/index.json":
                    channel.index_hits += 1
                    body = json.dumps(channel.index()).encode()
                elif self.path == "/channel/" + ARTIFACT:
                    channel.artifact_hits += 1
                    body = channel.tarball
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.base = f"http://127.0.0.1:{self._httpd.server_address[1]}/channel"
        return self

    def __exit__(self, *exc):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)

    async def __aenter__(self):
        return self.__enter__()

    async def __aexit__(self, *exc):
        self.__exit__(*exc)


# -- the thirteen tests of tests/test_update_channel.py ----------------------


async def test_check_download_verify_install(tmp_path, monkeypatch):
    monkeypatch.delenv(update_mod.UPDATE_URL_ENV, raising=False)
    async with FakeChannel() as ch:
        status = await update_mod.apply_update(
            url=f"{ch.base}/index.json", install_root=tmp_path)
        assert status.checked and status.update_available
        assert status.updated
        assert ch.index_hits == 1 and ch.artifact_hits == 1
        marker = tmp_path / "fishnet_tpu_torch" / "_release_marker.py"
        assert marker.read_bytes() == b"__version__ = '99.0.0'\n"


async def test_hash_mismatch_refuses_install(tmp_path, monkeypatch):
    monkeypatch.delenv(update_mod.UPDATE_URL_ENV, raising=False)
    async with FakeChannel(sha256="0" * 64) as ch:
        status = await update_mod.apply_update(
            url=f"{ch.base}/index.json", install_root=tmp_path)
        assert status.checked and status.update_available
        assert not status.updated
        assert not (tmp_path / "fishnet_tpu_torch").exists()


async def test_default_channel_engages_only_with_auto_update(monkeypatch):
    monkeypatch.delenv(update_mod.UPDATE_URL_ENV, raising=False)
    async with FakeChannel(latest="0.0.1") as ch:  # older: no install
        monkeypatch.setattr(update_mod, "DEFAULT_CHANNEL", ch.base)
        status = await update_mod.check_for_update()
        assert not status.checked
        status = await update_mod.check_for_update(allow_default=True)
        assert status.checked and status.latest == "0.0.1"
        assert not status.update_available


async def test_env_override_beats_default_channel(monkeypatch):
    async with FakeChannel(latest="0.0.2") as ch:
        monkeypatch.setattr(
            update_mod, "DEFAULT_CHANNEL", "http://127.0.0.1:1/nowhere")
        monkeypatch.setenv(update_mod.UPDATE_URL_ENV, f"{ch.base}/index.json")
        status = await update_mod.check_for_update(allow_default=True)
        assert status.checked and status.latest == "0.0.2"


def _tarball(*members) -> bytes:
    """A gzip tarball of (TarInfo, data or None) members."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for info, data in members:
            if data is not None:
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
            else:
                tar.addfile(info)
    return buf.getvalue()


async def test_traversal_artifact_rejected(tmp_path, monkeypatch):
    """A tarball member escaping the install root is never written."""
    monkeypatch.delenv(update_mod.UPDATE_URL_ENV, raising=False)
    evil = _tarball((tarfile.TarInfo("../escape.txt"), b"evil"))
    async with FakeChannel(tarball=evil) as ch:
        root = tmp_path / "root"
        root.mkdir()
        status = await update_mod.apply_update(
            url=f"{ch.base}/index.json", install_root=root)
        assert not status.updated
        assert not (root / "escape.txt").exists()
        assert not (tmp_path / "escape.txt").exists()


async def test_defer_promote_stages_without_touching_root(tmp_path, monkeypatch):
    monkeypatch.delenv(update_mod.UPDATE_URL_ENV, raising=False)
    async with FakeChannel() as ch:
        status = await update_mod.apply_update(
            url=f"{ch.base}/index.json", install_root=tmp_path,
            defer_promote=True)
        assert status.updated and status.deferred
        assert status.staged is not None and status.staged.exists()
        assert not (tmp_path / "fishnet_tpu_torch").exists()
        update_mod.promote_staged(status.staged, tmp_path)
        assert (tmp_path / "fishnet_tpu_torch" / "_release_marker.py").exists()
        assert not status.staged.exists()  # staging consumed


def _sign(data: bytes, seed: int = None):
    """(public key hex, signature hex) of ``data`` under a fresh key
    (``seed``: a seeded one), signed by ``cryptography``."""
    key = (Ed25519PrivateKey.generate() if seed is None else
           Ed25519PrivateKey.from_private_bytes(
               random.Random(seed).randbytes(32)))
    pub = key.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw)
    return pub.hex(), key.sign(data).hex()


class SignedChannel(FakeChannel):
    def __init__(self, signature=None, **kw):
        super().__init__(**kw)
        self.signature = signature

    def index(self) -> dict:
        body = super().index()
        if self.signature:
            body["signature"] = self.signature
        return body


async def test_default_channel_requires_signature(tmp_path, monkeypatch):
    """An unsigned index from the default channel is never installed,
    sha256 notwithstanding."""
    monkeypatch.delenv(update_mod.UPDATE_URL_ENV, raising=False)
    async with SignedChannel() as ch:
        monkeypatch.setattr(update_mod, "DEFAULT_CHANNEL", ch.base)
        status = await update_mod.apply_update(
            allow_default=True, install_root=tmp_path)
        assert status.checked and status.update_available
        assert not status.updated
        assert not (tmp_path / "fishnet_tpu_torch").exists()


async def test_default_channel_accepts_pinned_signature(tmp_path, monkeypatch):
    monkeypatch.delenv(update_mod.UPDATE_URL_ENV, raising=False)
    tarball = make_release_tarball()
    pub, sig = _sign(tarball)
    async with SignedChannel(tarball=tarball, signature=sig) as ch:
        monkeypatch.setattr(update_mod, "DEFAULT_CHANNEL", ch.base)
        monkeypatch.setattr(update_mod, "SIGNING_PUBKEY_HEX", pub)
        status = await update_mod.apply_update(
            allow_default=True, install_root=tmp_path)
        assert status.updated
        assert (tmp_path / "fishnet_tpu_torch" / "_release_marker.py").exists()


async def test_default_channel_rejects_wrong_signature(tmp_path, monkeypatch):
    monkeypatch.delenv(update_mod.UPDATE_URL_ENV, raising=False)
    tarball = make_release_tarball()
    pub, _ = _sign(tarball)
    _, wrong_sig = _sign(b"some other artifact")
    async with SignedChannel(tarball=tarball, signature=wrong_sig) as ch:
        monkeypatch.setattr(update_mod, "DEFAULT_CHANNEL", ch.base)
        monkeypatch.setattr(update_mod, "SIGNING_PUBKEY_HEX", pub)
        status = await update_mod.apply_update(
            allow_default=True, install_root=tmp_path)
        assert not status.updated
        assert not (tmp_path / "fishnet_tpu_torch").exists()


class CommandChannel(FakeChannel):
    def __init__(self, command):
        super().__init__()
        self.command = command

    def index(self) -> dict:
        return {"latest": "99.0.0", "command": self.command}


async def test_default_channel_never_runs_index_command(tmp_path, monkeypatch):
    """An index `command` from the default channel is refused outright."""
    monkeypatch.delenv(update_mod.UPDATE_URL_ENV, raising=False)
    marker = tmp_path / "pwned"
    async with CommandChannel(["touch", str(marker)]) as ch:
        monkeypatch.setattr(update_mod, "DEFAULT_CHANNEL", ch.base)
        status = await update_mod.apply_update(allow_default=True)
        assert not status.updated
        assert not marker.exists()


async def test_operator_pinned_key_enforced_on_override(tmp_path, monkeypatch):
    """FISHNET_TPU_UPDATE_PUBKEY on a private mirror: omitting the
    signature fails (no silent downgrade), a valid one installs."""
    tarball = make_release_tarball()
    pub, sig = _sign(tarball)
    async with SignedChannel(tarball=tarball) as ch:  # unsigned index
        monkeypatch.setenv(update_mod.UPDATE_URL_ENV, f"{ch.base}/index.json")
        monkeypatch.setenv(update_mod.UPDATE_PUBKEY_ENV, pub)
        status = await update_mod.apply_update(install_root=tmp_path)
        assert not status.updated
    async with SignedChannel(tarball=tarball, signature=sig) as ch:
        monkeypatch.setenv(update_mod.UPDATE_URL_ENV, f"{ch.base}/index.json")
        monkeypatch.setenv(update_mod.UPDATE_PUBKEY_ENV, pub)
        status = await update_mod.apply_update(install_root=tmp_path)
        assert status.updated


def test_validate_member_sanitizes_modes():
    info = tarfile.TarInfo("fishnet_tpu_torch/x.py")
    info.mode = 0o6777  # setuid+setgid+world-writable
    update_mod._validate_member(info)
    assert info.mode == 0o755


async def test_defer_promote_defers_legacy_command(monkeypatch, tmp_path):
    """A command-index update does not run the command mid-flight when the
    caller asked for deferral."""
    monkeypatch.delenv(update_mod.UPDATE_URL_ENV, raising=False)
    marker = tmp_path / "ran"
    async with CommandChannel(["touch", str(marker)]) as ch:
        status = await update_mod.apply_update(
            url=f"{ch.base}/index.json", defer_promote=True)
        assert status.updated and status.deferred
        assert status.command == ["touch", str(marker)]
        assert not marker.exists()


# -- the three update tests of tests/test_configure.py -----------------------


def test_update_noop_without_source(monkeypatch):
    monkeypatch.delenv(update_mod.UPDATE_URL_ENV, raising=False)
    status = asyncio.run(update_mod.check_for_update())
    assert not status.checked
    assert not status.update_available


async def test_update_against_local_server(tmp_path):
    marker = tmp_path / "updated.txt"
    async with CommandChannel(["touch", str(marker)]) as ch:
        url = f"{ch.base}/index.json"
        status = await update_mod.check_for_update(url)
        assert status.checked and status.update_available
        ch.index_hits = 0
        status = await update_mod.apply_update(url)
        assert status.updated
        assert ch.index_hits == 1  # index fetched once, command rode along
        ch.index = lambda: {"latest": "0.0.1", "command": ch.command}
        status = await update_mod.check_for_update(url)
        assert not status.update_available
    assert marker.exists()


def test_update_drain_then_exec_restart(tmp_path, monkeypatch):
    """The exec restart: with a newer version on the index, auto_update
    runs the update command, then replaces the process with the same
    argv under ``-m fishnet_tpu_torch``, with the attempt marker set so an
    update that changed nothing cannot restart in a loop."""
    import os

    marker = tmp_path / "updated.txt"
    with CommandChannel(["touch", str(marker)]) as ch:
        monkeypatch.setenv(update_mod.UPDATE_URL_ENV, f"{ch.base}/index.json")
        monkeypatch.delenv(update_mod._ATTEMPT_ENV, raising=False)
        monkeypatch.setattr(sys, "argv", ["fishnet-tpu-torch", "--cores", "2"])
        execs = []
        monkeypatch.setattr(
            update_mod.os, "execv", lambda exe, argv: execs.append((exe, argv)))
        status = update_mod.auto_update(Logger())
        assert status.updated and marker.exists()
        assert execs == [(sys.executable, [
            sys.executable, "-m", "fishnet_tpu_torch", "--cores", "2"])]
        assert os.environ[update_mod._ATTEMPT_ENV] == "99.0.0"
        execs.clear()
        status = update_mod.auto_update(Logger())
        assert status.updated and execs == []


# -- the tarball checks against the JAX functions ----------------------------


def _member(name, kind=tarfile.REGTYPE, mode=0o644, linkname=""):
    info = tarfile.TarInfo(name)
    info.type, info.mode, info.linkname = kind, mode, linkname
    return info


MEMBERS = {
    "file": (_member("fishnet_tpu_torch/a.py"), b"a = 1\n"),
    "dir": (_member("fishnet_tpu_torch/sub", tarfile.DIRTYPE, 0o777), None),
    "setuid": (_member("fishnet_tpu_torch/x.py", mode=0o6777), b"x\n"),
    "traversal": (_member("../escape.txt"), b"evil"),
    "nested-traversal": (_member("fishnet_tpu_torch/../../up.txt"), b"up"),
    "absolute": (_member("/tmp/absolute.txt"), b"abs"),
    "symlink": (_member("fishnet_tpu_torch/link", tarfile.SYMTYPE,
                        linkname="/etc/passwd"), None),
    "hardlink": (_member("fishnet_tpu_torch/hard", tarfile.LNKTYPE,
                         linkname="fishnet_tpu_torch/a.py"), None),
    "device": (_member("fishnet_tpu_torch/dev", tarfile.CHRTYPE), None),
    "fifo": (_member("fishnet_tpu_torch/fifo", tarfile.FIFOTYPE), None),
}


def _decision(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as err:  # noqa: BLE001 - the decision is the type
        return ("raised", type(err).__name__)


@pytest.mark.parametrize("name", sorted(MEMBERS))
def test_validate_member_decides_as_in_the_jax_package(name):
    info, _ = MEMBERS[name]
    mine, theirs = tarfile.TarInfo.frombuf(info.tobuf(), "utf-8", "strict"), \
        tarfile.TarInfo.frombuf(info.tobuf(), "utf-8", "strict")
    assert (_decision(update_mod._validate_member, mine)
            == _decision(jax_update._validate_member, theirs))
    assert mine.mode == theirs.mode


@pytest.mark.parametrize("name", sorted(MEMBERS))
def test_install_tarball_decides_as_in_the_jax_package(name, tmp_path):
    """Each member beside a regular file, unpacked by each package into a
    staging directory of its own: the same outcome, the same files."""
    tar = tmp_path / "release.tar.gz"
    tar.write_bytes(_tarball(MEMBERS["file"], MEMBERS[name]))
    outcomes = []
    for mod, where in ((update_mod, "port"), (jax_update, "jax")):
        staging = tmp_path / where
        outcome = _decision(mod.install_tarball, tar, staging)
        files = sorted(
            (str(p.relative_to(staging)), p.is_file(), p.stat().st_mode & 0o7777)
            for p in staging.rglob("*")) if staging.exists() else []
        outcomes.append((outcome, files))
    assert outcomes[0] == outcomes[1]
    assert not (tmp_path / "escape.txt").exists()


@pytest.mark.parametrize("version", [
    "v1.2.3", "0.1.0", "99.0.0", " v10.0.0 ", "1.2", "1", "x.y", "", "1..2"])
def test_parse_version_as_in_the_jax_package(version):
    assert (_decision(update_mod.parse_version, version)
            == _decision(jax_update.parse_version, version))


# -- the Ed25519 verifier against cryptography --------------------------------


def _flip(data: bytes, bit: int) -> bytes:
    out = bytearray(data)
    out[bit // 8] ^= 1 << (bit % 8)
    return bytes(out)


def _cryptography_accepts(pub: bytes, msg: bytes, sig: bytes) -> bool:
    try:
        Ed25519PublicKey.from_public_bytes(pub).verify(sig, msg)
    except (InvalidSignature, ValueError):
        return False
    return True


@pytest.mark.parametrize("seed", range(64))
def test_ed25519_agrees_with_cryptography(seed):
    """A seeded key signs a seeded message (cryptography); the verifier
    accepts exactly what cryptography accepts: the signature, and the same
    with one bit flipped in the signature, the message or the key."""
    rnd = random.Random(1000 + seed)
    msg = rnd.randbytes(rnd.randrange(0, 300))
    pub_hex, sig_hex = _sign(msg, seed=seed)
    pub, sig = bytes.fromhex(pub_hex), bytes.fromhex(sig_hex)
    cases = [(pub, msg, sig),
             (pub, msg, _flip(sig, rnd.randrange(512))),
             (_flip(pub, rnd.randrange(256)), msg, sig)]
    if msg:
        cases.append((pub, _flip(msg, rnd.randrange(8 * len(msg))), sig))
    got = [ed25519.verify(*case) for case in cases]
    assert got == [_cryptography_accepts(*case) for case in cases]
    assert got[0] and not any(got[1:])
    # The update path's wrapper: a bad signature raises, exactly like one
    # that cannot be checked.
    update_mod.verify_signature(msg, sig_hex, pub_hex)
    for bad in (cases[1][2].hex(), "zz", sig_hex[:-2]):
        with pytest.raises(ValueError):
            update_mod.verify_signature(msg, bad, pub_hex)


def test_ed25519_refuses_s_plus_l():
    """S + L satisfies the group equation, but S >= L is refused (RFC 8032
    §5.1.7): the signature is not malleable."""
    msg = b"fishnet-tpu-torch release"
    pub_hex, sig_hex = _sign(msg, seed=7)
    pub, sig = bytes.fromhex(pub_hex), bytes.fromhex(sig_hex)
    s = int.from_bytes(sig[32:], "little")
    malleable = sig[:32] + (s + ed25519.L).to_bytes(32, "little")
    assert ed25519.verify(pub, msg, sig)
    assert not ed25519.verify(pub, msg, malleable)
    assert not _cryptography_accepts(pub, msg, malleable)


def test_ed25519_rejects_a_non_canonical_r():
    """A signature whose R is the neutral element: canonically encoded it
    verifies (here and in cryptography); encoded as y = 1 + p, with S made
    for that encoding, the group equation holds too, and the verifier
    refuses it."""
    seed = bytes(range(32))
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    pub = ed25519._encode(ed25519._mul(a, ed25519.BASE))
    assert pub == Ed25519PrivateKey.from_private_bytes(seed).public_key(
        ).public_bytes(serialization.Encoding.Raw, serialization.PublicFormat.Raw)
    msg = b"non-canonical R"

    def signed(r_bytes: bytes) -> bytes:
        k = int.from_bytes(hashlib.sha512(r_bytes + pub + msg).digest(),
                           "little") % ed25519.L
        return r_bytes + (k * a % ed25519.L).to_bytes(32, "little")

    canonical = signed((1).to_bytes(32, "little"))
    non_canonical = signed((1 + ed25519.P).to_bytes(32, "little"))
    assert ed25519.verify(pub, msg, canonical)
    assert _cryptography_accepts(pub, msg, canonical)
    assert not ed25519.verify(pub, msg, non_canonical)
    assert not _cryptography_accepts(pub, msg, non_canonical)
