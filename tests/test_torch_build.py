"""The port's kernel build helpers (``chainermn_torch.ops._cuda``) that run
without ``nvcc``: which headers name a library, and the ptxas report."""

import re
import shutil

import pytest

from chainermn_torch.ops import _cuda


def test_each_source_hashes_only_the_headers_it_includes():
    """flash_common.cuh includes mma_sync.cuh, so the flash sources hash
    both; fused_ce.cu includes wgmma.cuh, which includes mma_sync.cuh."""
    assert [h.name for h in _cuda._headers(_cuda._CSRC / "flash_fwd.cu")] \
        == ["flash_common.cuh", "mma_sync.cuh"]
    assert [h.name for h in _cuda._headers(_cuda._CSRC / "flash_bwd.cu")] \
        == ["flash_common.cuh", "mma_sync.cuh"]
    assert [h.name for h in _cuda._headers(_cuda._CSRC / "fused_ce.cu")] \
        == ["mma_sync.cuh", "wgmma.cuh"]


@pytest.mark.parametrize("header, renamed", [
    ("flash_common.cuh", {"flash_fwd", "flash_bwd"}),
    ("mma_sync.cuh", {"flash_fwd", "flash_bwd", "fused_ce"}),
    ("wgmma.cuh", {"fused_ce"}),
])
def test_a_header_edit_renames_only_the_libraries_that_include_it(
        tmp_path, monkeypatch, header, renamed):
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda._CSRC, csrc)
    monkeypatch.setattr(_cuda, "_CSRC", csrc)
    before = {name: _cuda._target(name) for name in _cuda.SOURCES}
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    after = {name: _cuda._target(name) for name in _cuda.SOURCES}
    assert {name for name in _cuda.SOURCES
            if after[name] != before[name]} == renamed


@pytest.mark.parametrize("header, helpers", [
    ("mma_sync.cuh", ("smem_u32", "cp_async16", "cp_async4",
                      "cp_async_commit", "cp_async_wait", "ldsm_x4",
                      "ldsm_x4_t", "mma_bf16", "ex2", "pack_bf16")),
    ("wgmma.cuh", ("mbar_init", "mbar_fence_init", "mbar_arrive",
                   "mbar_arrive_expect_tx", "mbar_try_wait", "mbar_wait",
                   "tma_prefetch", "tma_load_2d", "smem_desc_sw128",
                   "wgmma_fence", "wgmma_commit", "wgmma_wait",
                   "wgmma_m64n256k16_bf16", "setmaxnreg_dec",
                   "setmaxnreg_inc")),
])
def test_the_tensor_core_helpers_are_defined_once(header, helpers):
    """The PTX wrappers live in their header only (mma.sync's in
    mma_sync.cuh, wgmma's, TMA's and the mbarriers' in wgmma.cuh): the
    sources that include them define none of them again."""
    for fn in helpers:
        pattern = re.compile(r"__device__\s+__forceinline__\s+\w+\s+"
                             + fn + r"\(")
        defined = [path.name for path in sorted(_cuda._CSRC.iterdir())
                   if pattern.search(path.read_text())]
        assert defined == [header], (fn, defined)


def test_a_variant_build_has_its_own_library():
    shipped = _cuda._target("flash_fwd")
    lifted = _cuda._target("flash_fwd", ("FLASH_FWD_MIN_CTAS=1",))
    assert lifted != shipped
    assert lifted.parent == shipped.parent


REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113flash_fwd_mmaILi64EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113flash_fwd_mmaILi64EEEvNS_6ParamsE
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 568 bytes cmem[0]
ptxas info    : Function properties for _ZN12_GLOBAL__N_16helperEv
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113flash_fwd_fmaILi64EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113flash_fwd_fmaILi64EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 568 bytes cmem[0]
"""


def test_ptxas_report_gives_registers_and_spills_per_kernel():
    usage = _cuda.parse_ptxas(REPORT)
    mma = "_ZN12_GLOBAL__N_113flash_fwd_mmaILi64EEEvNS_6ParamsE"
    fma = "_ZN12_GLOBAL__N_113flash_fwd_fmaILi64EEEvNS_6ParamsE"
    # a device function with no register line of its own is no kernel
    assert sorted(usage) == sorted([mma, fma])
    assert usage[mma] == {"registers": 128, "spill_stores": 8,
                          "spill_loads": 12}
    assert usage[fma] == {"registers": 72, "spill_stores": 0,
                          "spill_loads": 0}


def test_the_ce_backward_layout_can_be_chosen_by_a_define():
    """``chip_smoke.py`` builds fused_ce.cu with the define it names for
    the CE backward's other row layout; the source must honour it."""
    import chip_smoke

    (define,) = chip_smoke.CE_LAYOUT
    macro, value = define.split("=")
    text = (_cuda._CSRC / "fused_ce.cu").read_text()
    assert f"#ifndef {macro}" in text
    assert f"#if {macro} == {value}" in text
    assert _cuda._target("fused_ce", (define,)) != _cuda._target("fused_ce")


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd"])
def test_the_register_cap_can_be_lifted_by_a_define(name):
    """``chip_smoke.py`` also builds the flash kernels with the define it
    names; the source must honour it."""
    import chip_smoke

    (define,) = chip_smoke.LIFTED_CAPS[name]
    macro = define.split("=")[0]
    text = (_cuda._CSRC / _cuda.SOURCES[name]).read_text()
    assert f"#ifndef {macro}" in text
    assert f"DP <= 64 ? {macro} : 1" in text


def test_launches_are_counted_per_input_dtype():
    """The f32 inputs run other kernel bodies than the bf16 ones, so the
    count of each launch is also kept under its input dtype."""
    import torch

    _cuda.reset_launches()
    try:
        _cuda._launched(0, "flash_fwd", torch.float32)
        _cuda._launched(0, "flash_fwd", torch.bfloat16)
        _cuda._launched(0, "ce_dw", torch.bfloat16)
        assert _cuda.launches()["flash_fwd"] == 2
        assert _cuda.launches(torch.float32) == dict(
            flash_fwd=1, flash_bwd=0, ce_fwd=0, ce_dh=0, ce_dw=0)
        assert _cuda.launches(torch.bfloat16) == dict(
            flash_fwd=1, flash_bwd=0, ce_fwd=0, ce_dh=0, ce_dw=1)
        with pytest.raises(RuntimeError, match="cudaError_t 700"):
            _cuda._launched(700, "ce_fwd", torch.float32)
        assert _cuda.launches()["ce_fwd"] == 0
        with pytest.raises(KeyError):
            _cuda.launches(torch.float16)
        _cuda.reset_launches()
        assert not any(_cuda.launches(torch.float32).values())
    finally:
        _cuda.reset_launches()
