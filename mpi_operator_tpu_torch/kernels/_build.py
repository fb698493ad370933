"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each source under ``csrc/`` becomes its own shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers: a file that includes
them takes minutes to compile, a plain one seconds). Libraries land in
``kernels/build/<name>-<hash>/``, keyed by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads at once. All
missing libraries are compiled in parallel, one ``nvcc`` per source.

Nothing here runs on import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

# one entry per CUDA source; later slices add theirs here
SOURCES = {"flash_attention": "flash_attention.cu"}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the port's "
            "CUDA kernels are built from source at first use"
        )
    return found


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, SOURCES[name])
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}", f"lib{name}.so")


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile every named library that is not built yet, all ``nvcc``
    processes at once. Returns seconds spent per library built (empty when
    all were cached). Raises with the compiler's output on failure."""
    pending = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
        log = open(out + ".log", "w")
        pending[name] = (
            subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
            log, tmp, out, time.perf_counter(),
        )
    seconds = {}
    failed = []
    for name, (proc, log, tmp, out, t0) in pending.items():
        # bounded: a compile that hangs is a build failure, not a stall
        try:
            rc = proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        finally:
            log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            with open(out + ".log") as f:
                failed.append(f"nvcc failed for {name} (rc {rc}):\n{f.read()}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas=-v``: registers, shared memory and
    spills per kernel) from the build of ``name``, or '' if it was not built
    in this checkout."""
    path = _lib_path(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_lib_path(name))
        _loaded[name] = lib
    return lib
