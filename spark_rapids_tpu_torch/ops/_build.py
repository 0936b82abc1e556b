"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/kernels/`` at the repo root, named by a hash of
its source, the shared headers and the flags, so an edit rebuilds and an
unchanged source is reused. A lock file serialises builds across
processes. Nothing builds at import: the first call that needs a kernel
builds it, and ``build_all`` builds every source at once, one ``nvcc``
each, in parallel.

This module has no counterpart in the JAX package, where XLA compiled
the Pallas kernels.
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
from typing import Dict, List

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load",
           "library_path"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" \
    / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_NVCC_TIMEOUT_S = 900

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is, once built; the key
    covers the shared headers (``csrc/*.cuh``) too."""
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def _compile(names: List[str]) -> Dict[str, str]:
    """Compile the named sources that are not built yet, all at once;
    returns each compiled source's compiler output."""
    logs: Dict[str, str] = {}
    if all(library_path(n).exists() for n in names):
        return logs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            todo = [n for n in names if not library_path(n).exists()]
            procs = []
            for n in todo:
                tmp = library_path(n).with_suffix(f".tmp{os.getpid()}")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{n}.cu")]
                procs.append((n, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for n, tmp, p in procs:
                try:
                    out, _ = p.communicate(timeout=_NVCC_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, _ = p.communicate()
                    out += f"\nnvcc timed out after {_NVCC_TIMEOUT_S} s"
                logs[n] = out
                if p.returncode == 0:
                    os.replace(tmp, library_path(n))
                else:
                    failed.append(f"{n}.cu:\n{out}")
            if failed:
                raise RuntimeError("nvcc failed for "
                                   + "\n".join(failed))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return logs


def build_all() -> Dict[str, str]:
    """Build every source in ``csrc/`` (one nvcc each, in parallel) and
    return ``{name: compiler output}`` for those compiled now."""
    return _compile(sorted(p.stem for p in CSRC.glob("*.cu")))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            _compile([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
