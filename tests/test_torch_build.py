"""The port's kernel build, on the CPU (no nvcc): the shared library's
name hashes every source and every header of ``csrc/``, so an edited
header is rebuilt, while only the ``.cu`` files are compiled."""

import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the build module reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_only_the_cu_files_are_compiled(csrc):
    assert _build.sources() and all(p.suffix == ".cu"
                                    for p in _build.sources())
    assert "hopper.cuh" in [p.name for p in _build.headers()]
    assert not set(_build.sources()) & set(_build.headers())


@pytest.mark.parametrize("name", ["hopper.cuh", "grouped_matmul.cu",
                                  "flash_attention.cu"])
def test_library_path_follows_an_edit(csrc, name):
    before = _build.library_path()
    assert _build.library_path() == before
    assert before.parent == _build.BUILD_DIR
    path = csrc / name
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build.library_path() != before


def test_library_path_follows_a_new_header(csrc):
    before = _build.library_path()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path() != before


def test_every_entry_point_is_bound_with_its_arity():
    """Every C entry point of ``csrc/*.cu`` (``extern "C" int``) has a
    signature in ``_build.SIGNATURES`` with its number of arguments, and
    every signature names an entry point of the sources (a missing or
    extra argument would shift every pointer after it)."""
    import re
    entries = {}
    for src in _build.sources():
        text = src.read_text()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            entries[name] = len([p for p in params.split(",") if p.strip()])
    assert entries == {name: len(types)
                       for name, types in _build.SIGNATURES.items()}
