"""The port's kernel build helpers (``chainermn_torch.ops._cuda``) that run
without ``nvcc``: which headers name a library, and the ptxas report."""

import shutil

import pytest

from chainermn_torch.ops import _cuda


def test_each_source_hashes_only_the_headers_it_includes():
    assert [h.name for h in _cuda._headers(_cuda._CSRC / "flash_fwd.cu")] \
        == ["flash_common.cuh"]
    assert [h.name for h in _cuda._headers(_cuda._CSRC / "flash_bwd.cu")] \
        == ["flash_common.cuh"]
    assert _cuda._headers(_cuda._CSRC / "fused_ce.cu") == []


def test_a_header_edit_renames_only_the_libraries_that_include_it(
        tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda._CSRC, csrc)
    monkeypatch.setattr(_cuda, "_CSRC", csrc)
    before = {name: _cuda._target(name) for name in _cuda.SOURCES}
    header = csrc / "flash_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _cuda._target(name) for name in _cuda.SOURCES}
    assert after["fused_ce"] == before["fused_ce"]
    assert after["flash_fwd"] != before["flash_fwd"]
    assert after["flash_bwd"] != before["flash_bwd"]


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
