"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc for ``sm_90a`` into a shared
library with a plain C interface, ``_build/<name>-<hash>.so``. The hash
covers the source, every ``csrc`` header it includes and the flags, so an
edited source or header rebuilds and an unchanged one loads the library
already built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()  # guards _name_locks
_name_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME/CUDA_PATH, then PATH, then PyTorch's CUDA_HOME."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes, transitively."""
    out = [CSRC_DIR / f"{name}.cu"]
    for path in out:
        for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
            dep = path.parent / inc.decode()
            if dep not in out:
                out.append(dep)
    return out


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, verbose: bool = False) -> dict:
    """Compile ``csrc/<name>.cu`` unless it is built already (``verbose``
    always compiles). Returns {"path", "seconds", "log"}; ``log`` holds
    ptxas' register and shared-memory report when ``verbose``.
    Raises RuntimeError with the compiler's output if the build fails."""
    lib = library_path(name)
    if lib.exists() and not verbose:
        return {"path": str(lib), "seconds": 0.0, "log": "cached"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    log = proc.stdout.decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return {"path": str(lib), "seconds": time.perf_counter() - t0, "log": log}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed.
    A build holds its own source's lock only: a launch from a library
    already loaded never waits behind another source's build (the index's
    tier warm-up builds in a background thread)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build(name)
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib


def is_loaded(name: str) -> bool:
    """Whether this process has loaded ``csrc/<name>.cu``'s library."""
    return name in _loaded
