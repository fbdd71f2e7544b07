"""ctypes binding to the native chess core, compiled by the port.

The sources are the repository's ``cpp/src`` — the rules, the search
and the fiber pool that the JAX package loads as ``cpp/libfishnetcore.so``
(C ABI 11) — but the port compiles its own library from them at first
use, into ``chess/build/libfishnetcore-<hash>.so`` beside this module
(the hash covers the sources, the flags and the host CPU, so an edited
source or a checkout copied to another machine never loads a stale
library), and loads that one.

Why its own build (ROADMAP C7): ``make -C cpp`` compiles with ``$CXX``,
and a host may point ``CXX`` at a toolchain that links libstdc++
statically into shared libraries. The GPU host's environment does:
a core built there carries a second copy of the C++ runtime whose
symbols are exported, some of them GNU-unique. Next to
torch, which loads the system ``libstdc++.so.6``, the two runtimes then
share part of their ``std::locale`` state, and the first number that
``Position::fen`` formats through ``std::ostringstream`` reads a facet
the other runtime never set up: a segfault, in whichever order torch
and the core are loaded. So the port compiles with the ``g++`` on
``PATH`` and ignores ``CXX``/``CXXFLAGS``/``LDFLAGS``; links the C++
runtime as the shared library torch uses; hides anything a static
archive would bring (``--exclude-libs,ALL``); and keeps its own
GNU-unique objects private (``-fno-gnu-unique``), so that it shares no
runtime state with torch, nor with the JAX package's copy of the core
when a test process loads both.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

_SRC_DIR = Path(__file__).resolve().parent.parent.parent / "cpp" / "src"
BUILD_DIR = Path(__file__).resolve().parent / "build"
#: The Makefile's sources and optimisation flags, plus the isolation
#: flags above.
SOURCES = ("bitboard", "position", "nnue", "hce", "search", "pool", "capi")
CXX_FLAGS = (
    "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
    "-fno-gnu-unique", "-Wl,--exclude-libs,ALL",
)

_lib: Optional[ctypes.CDLL] = None
_held: Optional[ctypes.PyDLL] = None
_lib_lock = threading.Lock()

#: Expected C ABI version (cpp/src/capi.cpp fc_abi_version). A library
#: built from different-era sources must be rejected, not loaded: ctypes
#: has no signature checking, so a mismatched argument layout corrupts
#: memory silently.
ABI_VERSION = 11


class NativeCoreError(RuntimeError):
    pass


def library_path(name: str = "libfishnetcore",
                 files: Optional[Sequence[Path]] = None) -> Path:
    """Where this host's build of the current sources lives: by default
    the core's (every source and header of ``cpp/src``)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    if files is None:
        files = [p for p in sorted(_SRC_DIR.glob("*"))
                 if p.suffix in (".cpp", ".h")]
    for path in files:
        digest.update(path.name.encode() + path.read_bytes())
    try:  # -march=native: a library is only good for the CPU it was built on
        cpu = Path("/proc/cpuinfo").read_text()
        digest.update(" ".join(sorted({l for l in cpu.splitlines()
                                       if l.startswith(("model name", "flags"))}))
                      .encode())
    except OSError:
        pass
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str = "libfishnetcore",
          sources: Optional[Sequence[Path]] = None) -> Path:
    """Compile a library with the flags above — by default the core —
    unless this host's build of the current sources exists. One process
    builds; concurrent ones wait on a file lock and then find the
    library. The port's own host-side sources (the eval cache's
    tables) build here too."""
    if sources is None:
        sources = [_SRC_DIR / f"{src}.cpp" for src in SOURCES]
        out = library_path()
    else:
        out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        compiler = shutil.which("g++")
        if compiler is None:
            raise NativeCoreError(f"g++ not found: {name} cannot be built")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *CXX_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeCoreError(
                f"failed to build {name}: {proc.stderr[-2000:]}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return out


def _declare(lib: ctypes.CDLL) -> None:
    """The core's position and NNUE signatures, on ``lib``."""
    lib.fc_init.restype = ctypes.c_int
    lib.fc_variant_supported.argtypes = [ctypes.c_int]
    lib.fc_variant_supported.restype = ctypes.c_int
    lib.fc_pos_new.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.fc_pos_new.restype = ctypes.c_void_p
    lib.fc_pos_clone.argtypes = [ctypes.c_void_p]
    lib.fc_pos_clone.restype = ctypes.c_void_p
    lib.fc_pos_free.argtypes = [ctypes.c_void_p]
    lib.fc_pos_play_uci.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fc_pos_play_uci.restype = ctypes.c_int
    lib.fc_pos_fen.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.fc_pos_fen.restype = ctypes.c_int
    lib.fc_pos_turn.argtypes = [ctypes.c_void_p]
    lib.fc_pos_turn.restype = ctypes.c_int
    lib.fc_pos_is_check.argtypes = [ctypes.c_void_p]
    lib.fc_pos_is_check.restype = ctypes.c_int
    lib.fc_pos_halfmove.argtypes = [ctypes.c_void_p]
    lib.fc_pos_halfmove.restype = ctypes.c_int
    lib.fc_pos_fullmove.argtypes = [ctypes.c_void_p]
    lib.fc_pos_fullmove.restype = ctypes.c_int
    lib.fc_pos_hash.argtypes = [ctypes.c_void_p]
    lib.fc_pos_hash.restype = ctypes.c_uint64
    lib.fc_pos_outcome.argtypes = [ctypes.c_void_p]
    lib.fc_pos_outcome.restype = ctypes.c_int
    lib.fc_pos_parse_uci.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.fc_pos_parse_uci.restype = ctypes.c_int
    lib.fc_pos_legal_moves.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.fc_pos_legal_moves.restype = ctypes.c_int
    lib.fc_perft.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fc_perft.restype = ctypes.c_uint64

    lib.fc_nnue_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.fc_nnue_load.restype = ctypes.c_void_p
    lib.fc_nnue_free.argtypes = [ctypes.c_void_p]
    lib.fc_nnue_evaluate.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.fc_nnue_evaluate.restype = ctypes.c_int
    lib.fc_pos_features.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.fc_pos_features.restype = ctypes.c_int
    lib.fc_pos_psqt_bucket.argtypes = [ctypes.c_void_p]
    lib.fc_pos_psqt_bucket.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """Load (building if necessary) the native core library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = build()
        lib = ctypes.CDLL(str(path))
        lib.fc_abi_version.restype = ctypes.c_int
        abi = lib.fc_abi_version()
        if abi != ABI_VERSION:
            raise NativeCoreError(
                f"{path} has C ABI {abi}, the port binds ABI {ABI_VERSION}")

        _declare(lib)
        lib.fc_init()
        _lib = lib
        return lib


def load_held() -> ctypes.PyDLL:
    """The core again, through a handle whose calls keep the interpreter
    lock. For short calls made many times in a row on a busy thread —
    a search's host-side board walks, the pool TT fills of the bounds
    tier —, where releasing and retaking the lock around every call of
    a few microseconds costs more than the call, and lets every other
    thread in between. The caller declares any pool signatures it uses
    on it, as on ``load()``'s handle."""
    global _held
    if _held is not None:
        return _held
    load()  # builds, checks the ABI and initialises the core once
    with _lib_lock:
        if _held is None:
            lib = ctypes.PyDLL(str(build()))
            _declare(lib)
            _held = lib
        return _held
