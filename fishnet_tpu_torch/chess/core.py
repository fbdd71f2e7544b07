"""ctypes binding to the native chess core (cpp/libfishnetcore.so).

The reference delegates chess rules to the shakmaty library
(src/queue.rs:524-552); here the same single implementation of the rules
serves both the Python scheduler (legality replay, batch expansion) and
the native search engine — no duplicated rules logic.

The library is built with ``make -C cpp``. This module locates it next to
the repo's ``cpp/`` directory and (re)builds it on demand if missing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_CPP_DIR = Path(__file__).resolve().parent.parent.parent / "cpp"
_LIB_PATH = _CPP_DIR / "libfishnetcore.so"

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

#: Expected C ABI version (cpp/src/capi.cpp fc_abi_version). A library
#: built from different-era sources must be rejected, not loaded: ctypes
#: has no signature checking, so a mismatched argument layout corrupts
#: memory silently.
ABI_VERSION = 11


class NativeCoreError(RuntimeError):
    pass


def _build() -> None:
    """(Re)build the library. `make` is a cheap no-op when up to date, so
    this runs on every first load — a stale .so surviving C++ source
    changes would otherwise be loaded silently."""
    try:
        subprocess.run(
            ["make", "-C", str(_CPP_DIR), "libfishnetcore.so"],
            check=True,
            capture_output=True,
            text=True,
        )
    except (subprocess.CalledProcessError, OSError) as err:
        # No toolchain (packaged deployment): fall back to whatever
        # prebuilt library _candidate_libraries finds — native or a CPU
        # tier. Only surface the build error when nothing loadable exists.
        candidates = [_LIB_PATH, *_CPP_DIR.glob("libfishnetcore-*.so")]
        if any(p.exists() for p in candidates):
            return
        stderr = getattr(err, "stderr", "") or str(err)
        raise NativeCoreError(
            f"failed to build native core: {stderr[-2000:]}"
        ) from err


def _candidate_libraries() -> list:
    """Libraries to try, best first: FISHNET_TPU_CORE_LIB env >
    host-built -march=native library > best CPU-feature tier (v4, then v3
    with fast PEXT, then v2 — mirroring the reference's tier selection and
    AMD slow-PEXT heuristic, assets.rs:86-126). Later candidates are
    fallbacks for earlier ones that fail the ABI handshake (e.g. a
    stale host build next to freshly shipped tiers)."""
    override = os.environ.get("FISHNET_TPU_CORE_LIB")
    if override:
        path = Path(override)
        if not path.exists():
            raise NativeCoreError(
                f"FISHNET_TPU_CORE_LIB points to a missing file: {override}"
            )
        return [path]  # explicit override: no silent fallback
    candidates = []
    if _LIB_PATH.exists():
        candidates.append(_LIB_PATH)
    from fishnet_tpu_torch.chess.cpu import detect

    tier = detect().best_tier()
    tiers = {
        "v4": ["v4", "v3", "v2"],
        "v3": ["v3", "v2"],
        "v2": ["v2"],
        "arm64": ["arm64"],
    }.get(tier, [])
    # Tier libraries live in cpp/ (source checkout) or in the package's
    # own _native/ (pip/pipx wheel install, where cpp/ doesn't exist) —
    # setup.py's build hook copies `make tiers` output there.
    native_dir = Path(__file__).resolve().parent.parent / "_native"
    for t in tiers:
        for base in (_CPP_DIR, native_dir):
            path = base / f"libfishnetcore-{t}.so"
            if path.exists():
                candidates.append(path)
    if not candidates:
        raise NativeCoreError(
            "no native core library found (build with `make -C cpp` or ship "
            "`make tiers` artifacts)"
        )
    return candidates


def load() -> ctypes.CDLL:
    """Load (building if necessary) the native core library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        _build()
        lib = None
        mismatches = []
        for path in _candidate_libraries():
            try:
                candidate = ctypes.CDLL(str(path))
            except OSError as err:
                # Truncated file / wrong arch / missing deps: skip to the
                # next candidate instead of aborting the fallback chain.
                mismatches.append(f"{path} (unloadable: {err})")
                continue
            try:
                candidate.fc_abi_version.restype = ctypes.c_int
                abi = candidate.fc_abi_version()
            except AttributeError:
                abi = -1
            if abi == ABI_VERSION:
                lib = candidate
                break
            mismatches.append(f"{path} (ABI {abi})")
        if lib is None:
            raise NativeCoreError(
                f"no native core with ABI version {ABI_VERSION} found; "
                f"rejected: {', '.join(mismatches)} — rebuild with "
                "`make -C cpp` or ship matching tier libraries"
            )

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

        lib.fc_init()
        _lib = lib
        return lib
