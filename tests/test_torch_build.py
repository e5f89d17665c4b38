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
