"""The port's kernel build names each library by a digest of everything the
kernel compiles from: every file under its ``csrc/`` directory and the
flags, and keeps each library's ptxas report beside it.  No ``nvcc`` is
needed: only library names are computed and a saved log is read."""
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "toy" / "csrc"
    d.mkdir(parents=True)
    (d / "toy.cu").write_text('#include "toy.cuh"\nextern "C" int f();\n')
    (d / "toy.cuh").write_text("#pragma once\nconstexpr int K = 1;\n")
    monkeypatch.setitem(_build.SOURCES, "toy", d / "toy.cu")
    monkeypatch.setattr(_build, "NVCC_FLAGS", list(_build.NVCC_FLAGS))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return d


def test_target_is_stable_when_nothing_changes(csrc):
    assert _build._target("toy") == _build._target("toy")
    assert _build._target("toy").parent == _build.BUILD_DIR


def test_target_changes_when_only_a_header_changes(csrc):
    before = _build._target("toy")
    (csrc / "toy.cuh").write_text("#pragma once\nconstexpr int K = 2;\n")
    assert _build._target("toy") != before


@pytest.mark.parametrize("change", ["source", "new_header", "flag"])
def test_target_changes_with_what_the_kernel_compiles_from(csrc, change):
    before = _build._target("toy")
    if change == "source":
        (csrc / "toy.cu").write_text('#include "toy.cuh"\n')
    elif change == "new_header":
        (csrc / "more.cuh").write_text("#pragma once\n")
    else:
        _build.NVCC_FLAGS.append("-lineinfo")
    assert _build._target("toy") != before


def test_ptxas_report_reads_the_log_saved_beside_the_library(csrc):
    assert _build.build_log("toy") == "" and _build.ptxas_report("toy") == []
    log = _build._target("toy").with_suffix(".log")
    log.parent.mkdir(parents=True)
    log.write_text(
        "ptxas info    : Compiling entry function '_Z4toyKv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z4toyKv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 384 bytes cmem[0]\n")
    assert _build.ptxas_report("toy") == [
        "_Z4toyKv: Used 40 registers, 384 bytes cmem[0]; 0 bytes stack "
        "frame, 0 bytes spill stores, 0 bytes spill loads"]


def test_every_kernel_source_exists_and_is_named_apart():
    targets = {name: _build._target(name) for name in _build.SOURCES}
    assert len(set(targets.values())) == len(targets)
    for name, src in _build.SOURCES.items():
        assert src.is_file() and src.parent.name == "csrc"
        assert targets[name].name.startswith(f"lib{name}-")
