"""The port's native state directory (``pacmensl_tpu_torch/native``).

The cases of ``tests/test_native.py`` against the port's directory: the
library builds with g++ into ``pacmensl_tpu_torch/_build`` (a failed
build raises, there is no fallback), insert and lookup semantics, growth
and rehash, the native ``sub2ind`` against numpy's, the numpy plain
version against the native one on the same keys, and both against the
reference package's directory.
"""
import numpy as np
import pytest

from pacmensl_tpu.native.fastset import FastSet as JFastSet
import pacmensl_tpu_torch  # noqa: F401
from pacmensl_tpu_torch.native import build
from pacmensl_tpu_torch.native.fastset import (FastSet, PlainSet,
                                               sub2ind_native)
from pacmensl_tpu_torch.sys import indexing

DIRECTORIES = [FastSet, PlainSet]


def test_native_library_builds():
    lib = build.load()
    assert lib is not None
    built = list(build.BUILD_DIR.glob("fastset_*.so"))
    assert built and build.BUILD_DIR.name == "_build"


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails is an error, not a quiet numpy fallback."""
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(build.NativeBuildError):
        FastSet()
    assert not list(tmp_path.iterdir())      # no torn library left behind


@pytest.mark.parametrize("cls", DIRECTORIES)
def test_insert_and_lookup_semantics(cls):
    s = cls()
    new = s.insert([5, 7, 5, -1, 9, 7])
    assert new.tolist() == [True, True, False, False, True, False]
    assert len(s) == 3
    assert s.lookup([5, 7, 9, 11, -3]).tolist() == [0, 1, 2, -1, -1]
    assert s.insert([9, 100]).tolist() == [False, True]
    assert s.lookup([100])[0] == 3


@pytest.mark.parametrize("cls", DIRECTORIES)
def test_insert_growth_rehash(cls):
    rng = np.random.default_rng(0)
    keys = rng.choice(10_000_000, size=50_000, replace=False)
    s = cls(capacity_hint=8)
    assert s.insert(keys).all() and len(s) == keys.size
    assert (s.lookup(keys) == np.arange(keys.size)).all()
    assert not s.insert(keys).any()


def test_sub2ind_native_matches_numpy():
    rng = np.random.default_rng(1)
    nmax = np.array([7, 3, 11, 5])
    states = rng.integers(-2, 14, size=(1000, 4))
    np.testing.assert_array_equal(sub2ind_native(nmax, states),
                                  indexing.sub2ind(nmax, states))


def test_plain_version_matches_native_and_reference():
    rng = np.random.default_rng(2)
    dirs = [FastSet(), PlainSet(), JFastSet()]
    for _ in range(2):
        ks = rng.integers(-5, 5000, size=2000)
        out = [d.insert(ks) for d in dirs]
        for o in out[1:]:
            np.testing.assert_array_equal(o, out[0])
    probe = rng.integers(-5, 6000, size=3000)
    got = [d.lookup(probe) for d in dirs]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    assert len(dirs[0]) == len(dirs[1]) == len(dirs[2])
