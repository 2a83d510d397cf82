"""CPU tests of how the port's CUDA kernels are built and launched: the
library's name follows every header a source includes. Nothing here runs
nvcc."""
import importlib.util
import re
from pathlib import Path

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
    expect = ([] if name in ("fused_variation", "delay_chain")
              else ["wgmma_bf16.cuh", "mma_tf32.cuh"]
              if name.endswith("_bf16") else ["mma_tf32.cuh"])
    assert headers == expect
    assert _build.library_path(name).name.startswith(f"lib{name}-")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("symbol", _chip_smoke().KERNEL_SYMBOLS)
def test_device_symbols_the_trace_reads_are_defined(symbol):
    """chip_smoke.py finds the kernels in a profiler trace by these names:
    each is a __global__ function of one kernel source."""
    kernel = re.compile(r"__global__\s[^;{}]*\b" + symbol + r"\(")
    assert [n for n, src in _build.SOURCES.items()
            if kernel.search(src.read_text())], symbol
