"""The port's kernel build (unast_tpu_torch/ops/build.py) keys each library
by every file of csrc/, so an edit to a header that a kernel source
includes rebuilds the library instead of loading a stale one. Runs on a
copy of csrc/ and needs no nvcc."""

import shutil

import pytest

from unast_tpu_torch.ops import build


@pytest.fixture
def csrc(tmp_path):
    return shutil.copytree(build.CSRC, tmp_path / "csrc")


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_library_path_changes_when_a_header_changes(csrc, name):
    assert build.library_path(name, csrc) == build.library_path(name)
    header = csrc / "sm90.cuh"
    header.write_bytes(header.read_bytes() + b"\n// one more line\n")
    edited = build.library_path(name, csrc)
    assert edited != build.library_path(name)
    assert build.library_path(name, csrc) == edited   # same bytes, same key


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_library_path_changes_when_a_file_is_added(csrc, name):
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path(name, csrc) != build.library_path(name)


def test_libraries_of_one_tree_have_distinct_paths():
    paths = {build.library_path(name) for name in build.SOURCES}
    assert len(paths) == len(build.SOURCES)


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in for nvcc: prints a ptxas-style line naming its output,
    writes the output, and fails on a source whose name holds 'wgmma'."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo "ptxas info : Used 42 registers for $2"\n'
                    'case "$3" in *wgmma*) exit 1;; esac\ntouch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")


def test_compile_all_gives_each_job_its_code_and_output(fake_nvcc, tmp_path):
    jobs = {name: (build.CSRC / src, tmp_path / f"{name}.so")
            for name, src in build.SOURCES.items()}
    done = build.compile_all(jobs)
    assert done["flash_attn_fwd_f32"][0] == 0
    assert done["flash_attn_fwd_wgmma"][0] != 0
    for name, (_, log) in done.items():
        assert f"Used 42 registers for {tmp_path / name}.so" in log


def test_build_all_keeps_each_log_and_raises_on_a_failed_build(fake_nvcc):
    with pytest.raises(RuntimeError, match="nvcc failed for flash_attn_fwd_wgmma"):
        build.build_all()
    f32, wgmma = (build.library_path(name) for name in
                  ("flash_attn_fwd_f32", "flash_attn_fwd_wgmma"))
    assert f32.exists() and not wgmma.exists()
    for lib in (f32, wgmma):
        assert "Used 42 registers" in lib.with_name(lib.name + ".log").read_text()
    assert build.library("flash_attn_fwd_f32") == f32   # built: no nvcc again
