"""CPU tests of how the port's CUDA kernels are built and launched: the
library's name follows every header a source includes. Nothing here runs
nvcc."""
import pytest

from repro_torch.kernels import _build


def _tree(tmp_path, header="#define A 1\n"):
    inc = tmp_path / "include"
    inc.mkdir()
    (inc / "common.cuh").write_text('#pragma once\n#include "leaf.cuh"\n')
    (inc / "leaf.cuh").write_text(header)
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "common.cuh"\n'
                   'extern "C" int f() { return A; }\n')
    return src, inc


def test_library_name_follows_an_included_header(tmp_path, monkeypatch):
    src, inc = _tree(tmp_path)
    monkeypatch.setitem(_build.SOURCES, "probe", src)
    monkeypatch.setattr(_build, "INCLUDE_DIR", inc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    before = _build.library_path("probe")
    assert before == _build.library_path("probe")
    (inc / "leaf.cuh").write_text("#define A 2\n")     # a nested header
    after = _build.library_path("probe")
    assert after != before and after.parent == before.parent
    assert [p.name for p in _build.includes(src)] == ["common.cuh",
                                                      "leaf.cuh"]


def test_a_missing_header_is_an_error(tmp_path, monkeypatch):
    src, inc = _tree(tmp_path)
    monkeypatch.setattr(_build, "INCLUDE_DIR", inc)
    (inc / "leaf.cuh").unlink()
    with pytest.raises(FileNotFoundError, match="leaf.cuh"):
        _build.includes(src)


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_every_kernel_source_resolves_its_headers(name):
    headers = [p.name for p in _build.includes(_build.SOURCES[name])]
    expect = [] if name == "fused_variation" else ["mma_tf32.cuh"]
    assert headers == expect
    assert _build.library_path(name).name.startswith(f"lib{name}-")


@pytest.mark.parametrize("name,symbol", [
    ("flash_attention", "flash_fwd_kernel"),
    ("flash_attention_bwd", "flash_bwd_dkdv_kernel"),
    ("flash_attention_bwd", "flash_bwd_dq_kernel"),
    ("ssd_chunk", "ssd_chunk_kernel"),
    ("fused_variation", "fused_variation_kernel")])
def test_device_symbols_the_trace_reads_are_defined(name, symbol):
    """chip_smoke.py finds the kernels in a profiler trace by these names."""
    assert f"{symbol}(" in _build.SOURCES[name].read_text()
