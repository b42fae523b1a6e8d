"""The port's kernel build (``horovod_tpu_torch._build``) without ``nvcc``:
which inputs name a library, and the one shared header of the sources.

A library is named by a hash of what it is built from. The sources
include ``csrc/hopper.cuh``, so a header edit must name a new library
for every source, or a checkout would load a library built from the old
header.
"""

import re
import shutil

import pytest

from horovod_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", copy)
    return copy


def test_sources_are_the_cu_files_only(csrc):
    assert _build.sources() == ["conv_bn", "flash_attention",
                                "paged_attention"]
    assert (csrc / "hopper.cuh").exists()


@pytest.mark.parametrize("edited", ["hopper.cuh", "conv_bn.cu"])
def test_library_paths_follow_their_inputs(csrc, edited):
    before = {n: _build._lib_path(n) for n in _build.sources()}
    path = csrc / edited
    path.write_text(path.read_text() + "\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.sources()}
    if edited.endswith(".cuh"):
        assert all(after[n] != before[n] for n in before)
    else:
        assert {n for n in before if after[n] != before[n]} == {"conv_bn"}
    assert all(p.parent == _build.BUILD_DIR for p in after.values())


def test_a_new_header_names_new_libraries(csrc):
    before = {n: _build._lib_path(n) for n in _build.sources()}
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(_build._lib_path(n) != before[n] for n in before)


def _device_functions(text):
    return set(re.findall(
        r"__device__ __forceinline__ [\w:<>*&\s]+?\b(\w+)\(", text))


def test_tensor_core_sources_share_the_header_helpers():
    """flash_attention.cu and conv_bn.cu include hopper.cuh and define
    none of its helpers again."""
    header = (_build.CSRC_DIR / "hopper.cuh").read_text()
    helpers = _device_functions(header)
    assert {"cp_async16", "wgmma_ss", "wgmma_rs", "sw128_desc",
            "fence_proxy_async", "load_tile_bf16"} <= helpers
    for name in ("flash_attention", "conv_bn"):
        text = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert '#include "hopper.cuh"' in text
        assert not helpers & _device_functions(text), name
