"""The port's kernel build, on the CPU (no nvcc is needed to key or parse).

A library is keyed by its source, every ``csrc/`` header it includes and the
flags, so an edit to any of them loads a fresh build and never a stale one;
and the ptxas report that ``chip_smoke.py`` prints is read back per kernel.
"""

import os
import shutil

from mpi_operator_tpu_torch.kernels import _build


def test_sources_follow_quoted_includes():
    assert _build.sources("flash_attention") == ["flash_attention.cu", "hopper.cuh"]


def test_library_path_follows_every_included_file(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    base = _build._lib_path("flash_attention")

    (csrc / "unrelated.cuh").write_text("// included by nothing\n")
    assert _build._lib_path("flash_attention") == base

    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// an edit to the header alone\n")
    edited = _build._lib_path("flash_attention")
    assert edited != base

    (csrc / "nested.cuh").write_text("#pragma once\n")
    with open(csrc / "hopper.cuh", "a") as f:
        f.write('#include "nested.cuh"\n')
    nested = _build._lib_path("flash_attention")
    assert "nested.cuh" in _build.sources("flash_attention") and nested != edited
    with open(csrc / "nested.cuh", "a") as f:
        f.write("// an edit two includes down\n")
    assert _build._lib_path("flash_attention") != nested

    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-DX"])
    assert _build._lib_path("flash_attention") != nested
    assert os.path.dirname(os.path.dirname(base)) == _build.BUILD_DIR


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a9c197a7_18_flash_attention_cu_48fe48b520flash_bwd_dkv_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a9c197a7_18_flash_attention_cu_48fe48b520flash_bwd_dkv_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiiiff
    8 bytes stack frame, 40 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a9c197a7_18_flash_attention_cu_48fe48b519flash_bwd_dq_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16iiiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__a9c197a7_18_flash_attention_cu_48fe48b519flash_bwd_dq_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16iiiiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 132 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__a9c197a7_18_flash_attention_cu_48fe48b516flash_fwd_kernelILi128ELi1EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 138 registers, used 1 barriers
"""


def test_kernel_resources_reads_registers_and_spills_per_instance():
    res = _build.kernel_resources(
        PTXAS_LOG, ["flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"],
    )
    assert res == {
        "flash_bwd_dkv_kernel<128>": {"registers": 255, "spill_stores": 40, "spill_loads": 36},
        "flash_bwd_dq_kernel<64>": {"registers": 132, "spill_stores": 0, "spill_loads": 0},
        "flash_fwd_kernel<128,1>": {"registers": 138, "spill_stores": 0, "spill_loads": 0},
    }
    # a kernel not asked for is not reported, and dq is not mistaken for dkv
    assert _build.kernel_resources(PTXAS_LOG, ["flash_bwd_dq_kernel"]) == {
        "flash_bwd_dq_kernel<64>": {"registers": 132, "spill_stores": 0, "spill_loads": 0},
    }
