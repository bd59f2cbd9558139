"""The kernels' build cache (``layoutdit_tpu_torch/ops/_build.py``): the
library's file name is keyed on its source, on the headers the sources
include and on the flags, so an edited header rebuilds every kernel and
an unchanged tree loads what it built. No nvcc needed: ``CSRC`` and
``BUILD_DIR`` point at a temporary directory."""

import re

import pytest

from layoutdit_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "helpers.cuh"\n__global__ void k() {}\n')
    (src / "helpers.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


@pytest.mark.parametrize("edit", ["header", "source", "new header", "header removed"])
def test_target_changes_with_what_the_build_reads(csrc, edit):
    before = _build._target("k")
    assert before.name.startswith("k-") and before.suffix == ".so"
    assert _build._target("k") == before  # deterministic
    if edit == "header":
        (csrc / "helpers.cuh").write_text("#pragma once\n// edited\n")
    elif edit == "source":
        (csrc / "k.cu").write_text('#include "helpers.cuh"\n__global__ void k2() {}\n')
    elif edit == "new header":
        (csrc / "more.cuh").write_text("#pragma once\n")
    else:
        (csrc / "helpers.cuh").unlink()
    assert _build._target("k") != before


def test_target_ignores_other_sources_and_files(csrc):
    before = _build._target("k")
    (csrc / "other.cu").write_text("__global__ void other() {}\n")
    (csrc / "notes.txt").write_text("not read by nvcc\n")
    assert _build._target("k") == before


def test_a_built_target_loads_without_nvcc(csrc, monkeypatch):
    def no_nvcc():
        raise AssertionError("nvcc started for a library that is built")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    out = _build._target("k")
    out.parent.mkdir(parents=True)
    out.write_bytes(b"")
    assert _build._start("k") == (out, None)
    (csrc / "helpers.cuh").write_text("#pragma once\n// edited\n")
    with pytest.raises(AssertionError, match="nvcc started"):
        _build._start("k")  # the header changed: a new target, so a build


def test_every_included_header_is_in_the_digest():
    """The digest covers ``csrc/*.cuh``: every header a kernel source
    includes with quotes must be one of those."""
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    for name in _build.KERNELS:
        src = (_build.CSRC / f"{name}.cu").read_text()
        for inc in re.findall(r'#include\s+"([^"]+)"', src):
            assert inc in headers, f"{name}.cu includes {inc}, which the digest does not read"
    for header in headers:
        for inc in re.findall(r'#include\s+"([^"]+)"', (_build.CSRC / header).read_text()):
            assert inc in headers, f"{header} includes {inc}, which the digest does not read"
