# How the port's CUDA libraries are named and what their sources share,
# on the CPU (no nvcc here: nothing is built).  A library's file name
# carries a digest of its source and of every header under csrc/, so that
# an edited header never loads a stale library; the Hopper building blocks
# live once, in csrc/hopper_tiles.cuh, and both sources include it.

import re
import shutil

from aiko_services_tpu_torch.ops import kernels

HEADER = "hopper_tiles.cuh"
# what the sources share: defined in the header, in no source
SHARED = ("smem_u32", "cp_async_16", "cp_async_4", "cp_async_commit",
          "cp_async_wait", "fence_async_shared", "wgmma_fence",
          "wgmma_commit", "wgmma_wait_all", "fence_operands", "wgmma_ss",
          "wgmma_rs_t", "pack_bf16", "exp2_approx", "to_a_fragments",
          "SwizzledTile", "load_tile_async", "stage_rows", "store_rows",
          "align_1024", "allow_smem", "aligned16", "TypeTag", "dispatch",
          "check_sizes")


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    return csrc


def _paths():
    return {name: kernels._library_path(name)
            for name in kernels.KERNEL_SOURCES}


def test_library_path_is_stable_for_unchanged_sources(tmp_path,
                                                      monkeypatch):
    before = _paths()
    _copy_csrc(tmp_path, monkeypatch)
    assert _paths() == before
    assert len(set(before.values())) == len(before)


def test_an_edited_header_changes_every_library_path(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = _paths()
    header = csrc / HEADER
    header.write_text(header.read_text() + "\n// edited\n")
    after = _paths()
    assert all(after[name] != before[name] for name in before)
    # a new header counts too
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(_paths()[name] != after[name] for name in after)


def test_an_edited_source_changes_only_its_library_path(tmp_path,
                                                        monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = _paths()
    source = csrc / kernels.KERNEL_SOURCES["flash_attention"]
    source.write_text(source.read_text() + "\n// edited\n")
    after = _paths()
    assert after["flash_attention"] != before["flash_attention"]
    assert after["flash_attention_backward"] == (
        before["flash_attention_backward"])


def test_both_sources_include_the_shared_header_and_copy_none_of_it():
    header = (kernels.CSRC_DIR / HEADER).read_text()
    for name in SHARED:
        assert re.search(rf"\b{name}\s*[(<{{]", header), name
    for source in kernels.KERNEL_SOURCES.values():
        text = (kernels.CSRC_DIR / source).read_text()
        assert f'#include "{HEADER}"' in text, source
        for name in SHARED:
            # a definition starts a line: a return type, then the name
            assert not re.search(
                rf"^(?:template <[^>]*>\s*)?(?:__device__ "
                rf"__forceinline__ |struct |bool |cudaError_t )\S*\s*"
                rf"{name}\b", text, re.M), (source, name)
