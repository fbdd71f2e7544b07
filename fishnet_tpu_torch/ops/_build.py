"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with
``nvcc`` alone (no PyTorch headers, so a build takes seconds) into
``build/lib<name>-<hash>.so`` beside this module, at first use; the
hash of the source keys the file, so an edited source never loads a
stale library. Nothing is built when a module is imported: the CPU
tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

#: Hopper with its architecture-specific features (wgmma, setmaxnreg).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: Compiler output (ptxas register and shared-memory report) per kernel
#: built by this process.
build_logs: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or PATH)")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> List[Path]:
    """Compile every named kernel that is not built yet, one ``nvcc``
    process per source, all started together. Returns the library
    paths; raises ``KernelBuildError`` with the compiler's output if
    any build fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failures = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failures:
        raise KernelBuildError("\n".join(failures))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if
    needed. Thread-safe; each library is loaded once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (path,) = build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
