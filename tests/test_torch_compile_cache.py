"""The port's persistent kernel cache (``runtime/compile_cache.py``) on the
CPU, with a stub ``nvcc`` (this machine has none): the stub writes the
library file and logs its call, so a hit is a build that ran no stub.

- The namespace names the torch version, the CUDA version and ``sm_90a``,
  and is stable for one process; unset env → the package's build dir.
- A cold process misses, a warm one hits and runs no ``nvcc``; the counts
  ride the step-stats blob's ``compile_cache`` field (the JAX blob's keys).
- Two processes building one library at once into one dir run ``nvcc``
  once: one misses, the other waits for the lock and hits.
- ``--smoke`` (two processes on one dir) passes with the stub.
"""

import json
import os
import stat
import subprocess
import sys
import textwrap

import pytest

from mpi_operator_tpu.runtime import compile_cache as jcompile_cache
from mpi_operator_tpu_torch.kernels import _build
from mpi_operator_tpu_torch.runtime import compile_cache, stepstats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """A CUDA_HOME whose bin/nvcc writes its -o file after STUB_SLEEP
    seconds and appends one line per call to the returned log."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    calls = tmp_path / "nvcc_calls.log"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import os, sys, time
        time.sleep(float(os.environ.get("STUB_SLEEP", "0")))
        out = sys.argv[sys.argv.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"not a real library")
        with open({str(calls)!r}, "a") as f:
            f.write(out + "\\n")
        print("ptxas info    : Used 1 registers")
        """))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(home))
    yield calls
    compile_cache._reset_for_tests()


def _n_calls(log):
    return len(log.read_text().splitlines()) if log.exists() else 0


def test_namespace_names_the_versions_and_is_stable():
    ns = compile_cache.cache_namespace("2.11.0+cu128", "12.8")
    assert ns == "torch-2.11.0_cu128-cuda12.8-sm_90a"
    assert compile_cache.cache_namespace() == compile_cache.cache_namespace()
    assert compile_cache.cache_namespace("2.11.0+cu128", "12.9") != ns
    assert compile_cache.cache_namespace("2.12.0", "12.8") != ns
    assert (compile_cache.ENV_CACHE_DIR, compile_cache.ENV_CACHE_ENABLED) == \
        (jcompile_cache.ENV_CACHE_DIR, jcompile_cache.ENV_CACHE_ENABLED)


def test_unset_env_keeps_the_package_build_dir():
    assert compile_cache.configure_from_env({}) is None
    assert not compile_cache.is_configured() and compile_cache.cache_dir() is None
    assert _build.build_dir() == _build.BUILD_DIR
    assert "compile_cache" not in stepstats.StepStatsRecorder().snapshot()


def test_cold_process_misses_warm_process_hits_without_nvcc(tmp_path, stub_nvcc):
    root = tmp_path / "cache"
    where = compile_cache.configure_from_env({compile_cache.ENV_CACHE_DIR: str(root)})
    assert where == str(root / compile_cache.cache_namespace()) == compile_cache.cache_dir()
    n = len(_build.SOURCES)  # every library builds: the kernels and the span marks
    assert set(_build.build()) == set(_build.SOURCES)
    assert compile_cache.cache_stats() == {"hits": 0, "misses": n}
    assert _build._lib_path("flash_attention").startswith(where + os.sep)
    assert os.path.exists(_build._lib_path("flash_attention"))
    assert "Used 1 registers" in _build.build_log("flash_attention")
    blob = stepstats.StepStatsRecorder().snapshot()
    assert blob["compile_cache"] == {"hits": 0, "misses": n}
    assert _build.build() == {}  # counted once per process
    assert compile_cache.cache_stats() == {"hits": 0, "misses": n}

    compile_cache._reset_for_tests()  # a relaunched process
    compile_cache.configure(str(root))
    assert _build.build() == {}
    assert compile_cache.cache_stats() == {"hits": n, "misses": 0}
    assert _n_calls(stub_nvcc) == n
    assert [f for f in os.listdir(os.path.dirname(_build._lib_path("flash_attention")))
            if f.endswith(".tmp")] == []


_BUILD_IN_DIR = """
import json, sys
sys.path.insert(0, {repo!r})
from mpi_operator_tpu_torch.kernels import _build
from mpi_operator_tpu_torch.runtime import compile_cache
compile_cache.configure({root!r})
_build.build()
print(json.dumps(compile_cache.cache_stats()))
"""


def test_two_processes_on_one_dir_run_nvcc_once(tmp_path, stub_nvcc):
    env = dict(os.environ, STUB_SLEEP="1.5")
    src = _BUILD_IN_DIR.format(repo=REPO, root=str(tmp_path / "cache"))
    procs = [subprocess.Popen([sys.executable, "-c", src], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    stats = sorted((json.loads(o.strip().splitlines()[-1]) for o, _ in outs),
                   key=lambda s: s["hits"])
    n = len(_build.SOURCES)
    assert stats == [{"hits": 0, "misses": n}, {"hits": n, "misses": 0}]
    assert _n_calls(stub_nvcc) == n


def test_smoke_passes_with_a_stub_nvcc(tmp_path, stub_nvcc):
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.runtime.compile_cache", "--smoke"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    n = len(_build.SOURCES)
    assert out["ok"] and out["cold_cache"] == {"hits": 0, "misses": n}
    assert out["warm_cache"] == {"hits": n, "misses": 0}
    assert _n_calls(stub_nvcc) == n
