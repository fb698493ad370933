"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``.cu`` source under ``csrc/`` becomes its own shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers: a file that
includes them takes minutes to compile, a plain one seconds). Libraries land
in ``kernels/build/<name>-<hash>/``, keyed by a hash of the source, of every
``csrc/`` header it includes (``#include "..."``, followed recursively) and
of the flags, so an edit to any of them rebuilds and an unchanged tree loads
at once. All missing libraries are compiled in parallel, one ``nvcc`` per
source. The TMA descriptors the kernels take are encoded by libcuda's
``cuTensorMapEncodeTiled``, which the sources reach through the CUDA runtime
(``cudaGetDriverEntryPoint``), so nothing links against ``libcuda``.

``runtime/compile_cache.configure`` moves the libraries to a persistent
directory (:func:`set_build_dir`): the worker contract's
``TPUJOB_COMPILE_CACHE_DIR``. Several ranks or processes may build into one
directory at once: the process that compiles a library holds its lock
file meanwhile, so one runs ``nvcc`` and the others then load what it
built; each compiles into a temp path of its own and moves the library into place
atomically. Per process, each library counts once in :func:`build_stats`:
a hit when it was already built, a miss when this process built it.

Nothing here runs on import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import secrets
import shutil
import socket
import subprocess
import time
from typing import Dict, Iterable, List

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

# one entry per CUDA source; later slices add theirs here
SOURCES = {"flash_attention": "flash_attention.cu", "span_mark": "span_mark.cu",
           "optim": "optim.cu", "rmsnorm": "rmsnorm.cu"}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
]

_loaded: Dict[str, ctypes.CDLL] = {}
_build_dir = BUILD_DIR
_stats = {"hits": 0, "misses": 0}
_counted: set = set()  # libraries this process has counted in _stats
LOCK_TIMEOUT_S = 1800  # a lock is held at most one nvcc (900 s) long


def build_dir() -> str:
    """Where libraries are built and loaded from (``BUILD_DIR`` unless
    :func:`set_build_dir` moved it)."""
    return _build_dir


def set_build_dir(path: str) -> None:
    """Build and load libraries under ``path`` from now on. Libraries this
    process already loaded stay loaded."""
    global _build_dir
    _build_dir = path


def build_stats() -> Dict[str, int]:
    """This process's library hits (loaded as built) and misses (built
    here), each library counted once."""
    return dict(_stats)


def _count(name: str, kind: str) -> None:
    if name not in _counted:
        _counted.add(name)
        _stats[kind] += 1


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


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> List[str]:
    """The source of library ``name`` and every file under ``csrc/`` that it
    includes with quotes, followed recursively: the files its build reads."""
    found: List[str] = []
    todo = [SOURCES[name]]
    while todo:
        rel = todo.pop()
        if rel in found:
            continue
        found.append(rel)
        with open(os.path.join(CSRC, rel), "rb") as f:
            todo.extend(m.decode() for m in _LOCAL_INCLUDE.findall(f.read()))
    return sorted(found)


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for rel in sources(name):
        with open(os.path.join(CSRC, rel), "rb") as f:
            h.update(rel.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_build_dir, f"{name}-{h.hexdigest()[:16]}", f"lib{name}.so")


@contextlib.contextmanager
def _locked(paths: Iterable[str]):
    """Hold an exclusive lock on each ``<path>.lock`` (in sorted order, so
    two processes building several libraries cannot deadlock); raise after
    ``LOCK_TIMEOUT_S`` seconds of waiting for one."""
    with contextlib.ExitStack() as stack:
        for path in sorted(paths):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            f = stack.enter_context(open(path + ".lock", "w"))
            deadline = time.monotonic() + LOCK_TIMEOUT_S
            while True:
                try:
                    fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    break
                except BlockingIOError:
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"another process held {path}.lock for "
                                           f"{LOCK_TIMEOUT_S} s") from None
                    time.sleep(0.2)
            stack.callback(fcntl.flock, f, fcntl.LOCK_UN)
        yield


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile every named library that is not built yet, all ``nvcc``
    processes at once. Returns seconds spent per library built (empty when
    all were cached). Raises with the compiler's output on failure."""
    names = list(names)
    if all(os.path.exists(_lib_path(name)) for name in names):
        for name in names:
            _count(name, "hits")
        return {}
    with _locked(_lib_path(name) for name in names):
        return _build_locked(names)


def _build_locked(names: List[str]) -> Dict[str, float]:
    pending = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):  # built, maybe by the process that held the lock
            _count(name, "hits")
            continue
        # a temp path of this process's own, even across hosts sharing the dir
        tmp = f"{out}.{socket.gethostname()}.{os.getpid()}.{secrets.token_hex(4)}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
        log = open(tmp + ".log", "w")
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
        os.replace(tmp + ".log", out + ".log")
        if rc != 0:
            with open(out + ".log") as f:
                failed.append(f"nvcc failed for {name} (rc {rc}):\n{f.read()}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        _count(name, "misses")
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


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def kernel_resources(log: str, kernels: Iterable[str]) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes per compiled kernel, read from a ptxas
    ``-v`` log (``build_log``). ``kernels`` are the kernels' names in the
    source; a template instance is keyed as ``name<arg,...>`` by its integer
    template arguments, e.g. ``flash_fwd_kernel<128>``."""
    out: Dict[str, Dict[str, int]] = {}
    key = None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            key = None
            mangled = m.group(1)
            for base in kernels:
                at = mangled.find(f"{len(base)}{base}")
                if at < 0:
                    continue
                rest = mangled[at + len(str(len(base))) + len(base):]
                args = re.match(r"I((?:Li\d+E)+)E", rest)
                ints = re.findall(r"Li(\d+)E", args.group(1)) if args else []
                key = f"{base}<{','.join(ints)}>" if ints else base
                out[key] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
                break
            continue
        if key is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            out[key]["spill_stores"] = int(m.group(1))
            out[key]["spill_loads"] = int(m.group(2))
        m = _PTXAS_REGS.search(line)
        if m:
            out[key]["registers"] = int(m.group(1))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_lib_path(name))
        _loaded[name] = lib
    return lib


def typed_library(name: str, signatures: Dict[str, list], error_string: str) -> ctypes.CDLL:
    """:func:`library` ``name`` with its entry points typed, once per loaded
    library: each of ``signatures`` takes its argument types and returns an
    int (a launch returns a CUDA error code, 0 for success), and the export
    ``error_string`` names such a code for :func:`check`."""
    lib = library(name)
    if not getattr(lib, "_typed", False):
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib._error_string = getattr(lib, error_string)
        lib._error_string.argtypes = [ctypes.c_int]
        lib._error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def check(lib, rc: int, what: str) -> None:
    """Raise ``RuntimeError`` if a launch of ``what`` in ``lib`` (a
    :func:`typed_library`) returned the CUDA error ``rc``."""
    if rc:
        msg = lib._error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")
