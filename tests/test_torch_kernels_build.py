"""When olavm_tpu_torch.kernels rebuilds a library: `_stale` treats the
library's own .cu and every csrc/*.cuh as its sources. Runs on the CPU with
CSRC and BUILD_DIR pointed at a temporary directory; nothing is compiled."""

import os

import pytest

from olavm_tpu_torch import kernels
import torch_threads  # noqa: F401  (torch's share of the cores)


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", build)
    for name in kernels.SOURCES:
        (csrc / f"{name}.cu").write_text("")
    for header in ("goldilocks.cuh", "poseidon_perm.cuh"):
        (csrc / header).write_text("")
    for name in kernels.SOURCES:
        (build / f"lib{name}.so").write_text("")
    # every source a minute older than every library
    for p in csrc.iterdir():
        os.utime(p, (1_000_000, 1_000_000))
    for p in build.iterdir():
        os.utime(p, (1_000_060, 1_000_060))
    return csrc, build


def _stale():
    return {n for n in kernels.SOURCES if kernels._stale(n)}


def test_fresh_libraries_are_not_stale(tree):
    assert _stale() == set()


@pytest.mark.parametrize("header", ["goldilocks.cuh", "poseidon_perm.cuh"])
def test_a_touched_header_makes_every_library_stale(tree, header):
    os.utime(tree[0] / header, (1_000_120, 1_000_120))
    assert _stale() == set(kernels.SOURCES)


def test_a_new_header_makes_every_library_stale(tree):
    new = tree[0] / "extra.cuh"
    new.write_text("")
    os.utime(new, (1_000_120, 1_000_120))
    assert _stale() == set(kernels.SOURCES)


def test_a_touched_source_makes_only_its_library_stale(tree):
    os.utime(tree[0] / "ntt.cu", (1_000_120, 1_000_120))
    assert _stale() == {"ntt"}


def test_a_missing_library_is_stale(tree):
    (tree[1] / "libposeidon.so").unlink()
    assert _stale() == {"poseidon"}
