"""Persistent kernel cache: warm restarts load the built kernels instead of
running ``nvcc`` again.

Port of ``mpi_operator_tpu/runtime/compile_cache.py``, with the same worker
contract: the executor owns a node-local directory that survives the pod,
injects it as ``$TPUJOB_COMPILE_CACHE_DIR`` (gated on the job's
``spec.compile_cache``, projected as ``$TPUJOB_COMPILE_CACHE``), and the
worker calls :func:`configure_from_env` at bootstrap
(``runtime/bootstrap.initialize``). The port has no XLA, so what is cached
is what a cold start compiles: the ``nvcc``-built kernel libraries
(``kernels/_build.py``). :func:`configure` points their build at
``<dir>/<cache_namespace()>/``; without the env they stay in the package's
``kernels/build/``.

- The namespace holds the torch version, the CUDA version and ``sm_90a``,
  so mixed-version nodes during a rolling upgrade never share a directory
  and a dead version's subdir can be deleted whole. Inside it a library is
  keyed by a hash of its sources and flags (``_build._lib_path``), so an
  edited kernel is built afresh, never loaded stale.
- Several ranks or processes on one directory: the one that compiles a
  library holds its lock file meanwhile, compiles into a temp path of its
  own and moves the library into place atomically; the others wait and
  load it.
- A hit is a library loaded without ``nvcc``, a miss one built by this
  process (each library counts once per process): :func:`cache_stats`
  rides the ``compile_cache`` field of the step-stats blob
  (``runtime/stepstats.py``), so the operator tells a warm restart from a
  cold one.
- An unwritable root degrades to the package's own build dir, with a
  warning; a worker never dies over it.

``python -m mpi_operator_tpu_torch.runtime.compile_cache --smoke`` runs two
processes on one fresh directory: the first builds (misses), the second
runs no ``nvcc`` (hits, no misses); each reports its set-up seconds. On a
machine without a card the children build but load nothing.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Mapping, Optional

from mpi_operator_tpu_torch.kernels import _build

log = logging.getLogger("tpujob.compilecache")

# the executor→worker contract (the JAX package's names)
ENV_CACHE_DIR = "TPUJOB_COMPILE_CACHE_DIR"
ENV_CACHE_ENABLED = "TPUJOB_COMPILE_CACHE"

ARCH = "sm_90a"  # the target every library is compiled for (_build.NVCC_FLAGS)

_configured_dir: Optional[str] = None


def cache_namespace(torch_version: Optional[str] = None,
                    cuda_version: Optional[str] = None, arch: str = ARCH) -> str:
    """The version-scoped subdir the libraries live under. Args are
    injectable for tests; the defaults describe this process."""
    if torch_version is None or cuda_version is None:
        import torch

        torch_version = torch_version or torch.__version__
        cuda_version = cuda_version or str(torch.version.cuda)
    safe = "".join(c if c.isalnum() or c in "._-" else "_"
                   for c in f"{torch_version}-cuda{cuda_version}-{arch}")
    return f"torch-{safe}"


def configure(root: str) -> str:
    """Build and load the kernel libraries under ``root/<cache_namespace()>``
    from now on. Returns that directory (the package's build dir when it
    cannot be created)."""
    global _configured_dir
    cache_dir = os.path.join(os.path.abspath(root), cache_namespace())
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        log.warning("compile cache dir %s not creatable; building into %s", cache_dir,
                    _build.BUILD_DIR, exc_info=True)
        cache_dir = _build.BUILD_DIR
    _build.set_build_dir(cache_dir)
    _configured_dir = cache_dir
    return cache_dir


def configure_from_env(env: Optional[Mapping[str, str]] = None) -> Optional[str]:
    """Bootstrap-time entry point: configure from ``$TPUJOB_COMPILE_CACHE_DIR``
    when the executor injected one; a no-op (returns None) otherwise."""
    env = os.environ if env is None else env
    root = env.get(ENV_CACHE_DIR, "")
    if not root:
        return None
    return configure(root)


def is_configured() -> bool:
    return _configured_dir is not None


def cache_dir() -> Optional[str]:
    return _configured_dir


def cache_stats() -> Dict[str, int]:
    """This process's hits (libraries loaded as they were built) and misses
    (libraries it built): a warm restart shows hits and no misses."""
    return _build.build_stats()


def _reset_for_tests() -> None:
    global _configured_dir
    _configured_dir = None
    _build.set_build_dir(_build.BUILD_DIR)
    _build._stats.update(hits=0, misses=0)
    _build._counted.clear()
    _build._loaded.clear()


# ---------------------------------------------------------------------------
# the smoke
# ---------------------------------------------------------------------------

# one worker's cold start: configure from the env, then build and load every
# kernel library, as the first train step would
_CHILD_SRC = """
import json, sys, time
sys.path.insert(0, {repo!r})
t0 = time.perf_counter()
import torch
from mpi_operator_tpu_torch.kernels import _build
from mpi_operator_tpu_torch.runtime import compile_cache
compile_cache.configure_from_env()
_build.build()
if torch.cuda.is_available():
    for name in _build.SOURCES:
        _build.library(name)
print(json.dumps({{"setup_s": time.perf_counter() - t0, "cache": compile_cache.cache_stats(),
                  "dir": compile_cache.cache_dir()}}))
"""


def smoke(root: Optional[str] = None) -> Dict[str, object]:
    """Two processes on one fresh cache directory (``root``, else a temp
    dir): the first must miss, the second must hit with no miss. Returns
    both runs' set-up seconds and counts, and ``ok`` iff the bars hold."""
    import subprocess
    import sys
    import tempfile

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out: Dict[str, object] = {"metric": "compile_cache_smoke", "ok": False}
    with tempfile.TemporaryDirectory(prefix="tpujob-cc-smoke-") as tmp:
        env = dict(os.environ, **{ENV_CACHE_DIR: root or tmp})
        runs = []
        for _ in range(2):
            proc = subprocess.run([sys.executable, "-c", _CHILD_SRC.format(repo=repo)],
                                  env=env, capture_output=True, text=True, timeout=1200)
            if proc.returncode != 0:
                out["error"] = proc.stderr[-2000:]
                return out
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    cold, warm = runs
    out.update(cold_setup_s=cold["setup_s"], warm_setup_s=warm["setup_s"],
               cold_cache=cold["cache"], warm_cache=warm["cache"], dir=cold["dir"])
    out["ok"] = bool(cold["cache"]["misses"] > 0 and cold["cache"]["hits"] == 0
                     and warm["cache"]["hits"] > 0 and warm["cache"]["misses"] == 0)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="tpu-compile-cache",
        description="Persistent kernel-library cache (see the module docstring); --smoke "
                    "runs the two-process warm-restart check.",
    )
    ap.add_argument("--smoke", action="store_true",
                    help="two processes on one fresh cache dir: the second must run no nvcc")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    if args.smoke:
        out = smoke()
        print(json.dumps(out), flush=True)
        return 0 if out["ok"] else 1
    ap.print_help()
    return 2


if __name__ == "__main__":
    import sys

    sys.exit(main())
