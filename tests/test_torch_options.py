"""The port's PETSc-style options (``sys/options.py``) against the
reference package's on the same token lists and environment, and
``set_from_options`` setting the same attributes in both packages'
transient solvers."""
import pytest

torch = pytest.importorskip("torch")

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.sys.options import Options as JOptions  # noqa: E402
import pacmensl_tpu_torch as pt  # noqa: E402

TOKENS = [
    ["-fsp_verbosity", "2", "-fsp_log_events"],
    ["-ts_type", "cn", "-ode_rtol", "-1e-3", "-x", "-5", "--flag"],
    ["positional", "-a", "-b", "value", "-c"],
    ["-n", "-3.5e-2", "-m", "--", "-k", "0"],
    [],
]


@pytest.mark.parametrize("argv", TOKENS)
def test_from_argv_matches_reference(argv):
    assert pt.Options.from_argv(argv).as_dict() == \
        JOptions.from_argv(argv).as_dict()


def test_typed_getters_match_reference():
    argv = ["-i", "7", "-f", "2.5", "-yes", "-no", "off", "-z", "0"]
    o, j = pt.Options.from_argv(argv), JOptions.from_argv(argv)
    for key in ("i", "f", "yes", "no", "z", "missing"):
        assert o.has(key) == j.has(key)
        assert o.get(key) == j.get(key)
        assert o.get(key, "d") == j.get(key, "d")
        assert o.get_bool(key) == j.get_bool(key)
        assert o.get_bool(key, True) == j.get_bool(key, True)
    assert o.get_int("i") == j.get_int("i") == 7
    assert o.get_int("missing", 3) == j.get_int("missing", 3) == 3
    assert o.get_float("f") == j.get_float("f") == 2.5
    assert o.get_float("missing", 1.5) == j.get_float("missing", 1.5)
    for opts in (o, j):
        opts.set("-w", 4)
        opts.update(type(opts)({"i": "8"}))
    assert o.as_dict() == j.as_dict()
    assert o.get_int("-w") == 4 and o.get_int("i") == 8
    assert repr(o) == repr(j)


def test_from_env_matches_reference(monkeypatch):
    monkeypatch.setenv("PACMENSL_OPT_FSP_VERBOSITY", "3")
    monkeypatch.setenv("PACMENSL_OPT_TS_TYPE", "cn")
    monkeypatch.setenv("OTHER_OPT_X", "1")
    got = pt.Options.from_env().as_dict()
    assert got == JOptions.from_env().as_dict()
    assert got["fsp_verbosity"] == "3" and got["ts_type"] == "cn"
    assert "x" not in got
    assert pt.Options.from_env("OTHER_OPT_").as_dict() == \
        JOptions.from_env("OTHER_OPT_").as_dict() == {"x": "1"}


SETTINGS = [
    ["-fsp_partitioning_type", "graph", "-fsp_repart_approach", "repart",
     "-fsp_verbosity", "2", "-fsp_log_events", "0"],
    ["-fsp_odes_type", "petsc", "-ts_type", "CN", "-fsp_backend", "ell"],
    ["-ode_rtol", "1e-8", "-ode_atol", "1e-12", "-fsp_odes_type", "cvode"],
    ["-ode_atol", "1e-13"],
    [],
]


@pytest.mark.parametrize("argv", SETTINGS)
def test_set_from_options_matches_reference(argv):
    s = pt.FspSolverMultiSinks(device="cpu").set_from_options(
        pt.Options.from_argv(argv))
    j = pm.FspSolverMultiSinks().set_from_options(JOptions.from_argv(argv))
    assert s.partitioning.value == j.partitioning.value
    assert s.repart_approach.value == j.repart_approach.value
    assert s.verbosity == j.verbosity
    assert s.log_events == j.log_events
    assert str(s.odes_type) == str(j.odes_type) or \
        s.odes_type.value == j.odes_type.value
    assert s.ts_type == getattr(j, "ts_type", "rk")
    assert s.backend == j.backend
    assert s.ode_rtol == j.ode_rtol and s.ode_atol == j.ode_atol


def test_set_from_options_reads_argv(monkeypatch):
    monkeypatch.setattr("sys.argv", ["prog", "-ts_type", "bdf",
                                     "-fsp_odes_type", "petsc"])
    s = pt.FspSolverMultiSinks(device="cpu").SetFromOptions()
    assert s.ts_type == "bdf"
    assert s.odes_type == pt.ODESolverType.PETSC


def test_set_from_options_rejects_unknown_backend():
    with pytest.raises(pt.SetupError):
        pt.FspSolverMultiSinks(device="cpu").set_from_options(
            pt.Options.from_argv(["-fsp_backend", "dense"]))
