"""The port's entry points (``pacmensl_tpu_torch/examples/``,
``pacmensl_tpu_torch/tools/``) against the JAX package's scripts
(``examples/*.py``, ``tools/*.py``, loaded by path), on the host at a cut
time:

* each example and each ``bench_configs`` config, run with ``-device
  cpu`` and the same options as the reference script: the distributions
  within 2 * fsp_tol in L1 (by state), and within 1e-8 where both end on
  the same states (the same for each species' marginal CSV).  At the cut
  the repressilator's two adaptive stages and transcr_reg_6d expand
  their bounds (checked), and the fixed stages start from the expanded
  bounds of their adaptive stages and keep them; hog1p_5d does not
  expand before its signal rises;
* the same output files by name, the marginal CSVs one column, the
  per-step CSVs with the reference's header and five columns;
* ``-device cuda`` raises :class:`SetupError` on a host without CUDA.

The reference scripts' JIT compiles dominate the time, so each
configuration runs once in the reference package: ``bench_configs``'s
repressilator, hog1p and transcr6d configs and the flagship are the
examples' configurations (the reference's functions are the same code),
so the port's are held bitwise to its examples, which are held to the
reference.  ``tests/test_torch_bench_configs.py`` holds the two configs
of their own (sens_hog1p, stationary_rep) to the reference's functions.
"""
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.examples import hog1p as t_hog1p  # noqa: E402
from pacmensl_tpu_torch.examples import repressilator as t_rep  # noqa: E402
from pacmensl_tpu_torch.examples import (  # noqa: E402
    scaling_sweep as t_sweep, transcr_reg_6d as t_tr6)
from pacmensl_tpu_torch.tools import bench_configs as t_bench  # noqa: E402
from pacmensl_tpu_torch.tools import dryrun as t_dry  # noqa: E402
from pacmensl_tpu_torch.tools import ell_bench as t_ell  # noqa: E402
from pacmensl_tpu_torch.tools import flagship as t_flag  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the cut: the examples' time and tolerance
T_CUT, TOL = 0.001, 1.0e-4
PERF_HEADER = "# model_time,step_h,m_or_order,n_eqs,epoch_wall"


def _load(rel):
    """The JAX package's script at ``rel`` as a module."""
    name = "ref_" + rel.replace("/", "_").replace(".py", "")
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _by_state(d):
    order = np.lexsort(np.asarray(d.states).T[::-1])
    return np.asarray(d.states)[order], np.asarray(d.p)[order]


def _same_law(jd, td, tol):
    """L1 by state within 2 tol; within 1e-8 on the same states."""
    js, jp = _by_state(jd)
    ts, tp = _by_state(td)
    if np.array_equal(js, ts):
        assert np.abs(jp - tp).max() <= 1e-8
        return True
    keys = {tuple(s): v for s, v in zip(js, jp)}
    l1 = 0.0
    for s, v in zip(ts, tp):
        l1 += abs(v - keys.pop(tuple(s), 0.0))
    l1 += sum(abs(v) for v in keys.values())
    assert l1 <= 2 * tol
    return False


def _same_csvs(jdir, tdir, names, same_states, tol):
    """Each marginal CSV of ``names``: one column, within 2 tol in L1
    (1e-8 where both solves end on the same states)."""
    for name in names:
        jm = np.loadtxt(os.path.join(jdir, name), delimiter=",", ndmin=1)
        tm = np.loadtxt(os.path.join(tdir, name), delimiter=",", ndmin=1)
        n = max(jm.size, tm.size)
        jm, tm = np.pad(jm, (0, n - jm.size)), np.pad(tm, (0, n - tm.size))
        if same_states:
            assert np.abs(jm - tm).max() <= 1e-8, name
        else:
            assert np.abs(jm - tm).sum() <= 2 * tol, name


def _perf_csv(path):
    with open(path) as f:
        assert f.readline().strip() == PERF_HEADER
    rows = np.loadtxt(path, delimiter=",", ndmin=2)
    assert rows.shape[1] == 5 and rows.shape[0] > 0


# ------------------------------------------------------------ examples
@pytest.fixture(scope="module")
def repressilator(tmp_path_factory):
    jdir = tmp_path_factory.mktemp("jax_rep")
    tdir = tmp_path_factory.mktemp("torch_rep")
    argv = ["-t_final", str(T_CUT), "-fsp_tol", str(TOL)]
    ref = _load("examples/repressilator.py")
    jruns, stage = {}, ref.run_stage

    def recorded(name, *args):
        jruns[name] = stage(name, *args)
        return jruns[name]
    ref.run_stage = recorded
    ref.main(argv + ["-out_dir", str(jdir)])
    truns = t_rep.main(argv + ["-out_dir", str(tdir), "-device", "cpu"])
    return jdir, tdir, jruns, truns


@pytest.mark.parametrize("stage", t_rep.STAGES)
def test_repressilator_stage_matches_the_reference(repressilator, stage):
    jdir, tdir, jruns, truns = repressilator
    s, d, wall = truns[stage]
    assert isinstance(s, pt.FspSolverMultiSinks) and wall > 0
    same = _same_law(jruns[stage][0], d, TOL)
    b = pt.models.repressilator()
    start = b.bounds if stage.endswith("custom") else b.bounds_hyperrec
    if stage.startswith("adaptive"):
        assert (d.bounds >= start).all() and (d.bounds > start).any()
        np.testing.assert_array_equal(d.bounds, jruns[stage][0].bounds)
    else:
        # the adaptive stage's final bounds: no expansion
        adaptive = truns[stage.replace("fixed", "adaptive")][1]
        np.testing.assert_array_equal(d.bounds, adaptive.bounds)
    _same_csvs(jdir, tdir, [f"repressilator_marginal_{i}_{stage}.csv"
                            for i in range(3)], same, TOL)
    _perf_csv(os.path.join(tdir, f"repressilator_perf_{stage}.csv"))


def test_repressilator_writes_the_reference_files(repressilator):
    jdir, tdir, _, _ = repressilator
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert len(os.listdir(tdir)) == 16


@pytest.fixture(scope="module")
def examples(tmp_path_factory):
    """The port's hog1p and transcr_reg_6d examples against the
    reference's: ``{script: (jax dir, torch dir, (solver, distribution,
    wall))}``."""
    out = {}
    argv = ["-t_final", str(T_CUT), "-fsp_tol", str(TOL)]
    for script, port in (("examples/hog1p.py", t_hog1p),
                         ("examples/transcr_reg_6d.py", t_tr6)):
        jdir = tmp_path_factory.mktemp("jax")
        tdir = tmp_path_factory.mktemp("torch")
        _load(script).main(argv + ["-out_dir", str(jdir)])
        out[script] = (jdir, tdir, port.main(
            argv + ["-out_dir", str(tdir), "-device", "cpu"]))
    return out


@pytest.mark.parametrize("script,files", [
    ("examples/hog1p.py",
     [f"hog1p_marginal_{i}.csv" for i in range(5)] + ["hog1p_perf.csv"]),
    ("examples/transcr_reg_6d.py",
     [f"transcr6d_marginal_{i}.csv" for i in range(6)]),
])
def test_example_matches_the_reference(examples, script, files):
    jdir, tdir, (s, d, wall) = examples[script]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) \
        == sorted(files)
    marg = [f for f in files if "marginal" in f]
    # the reference's distribution is its marginal CSVs: the same
    # states give the same marginals within 1e-8
    _same_csvs(jdir, tdir, marg, True, TOL)
    assert abs(d.sum() - 1.0) <= TOL and wall > 0
    if script == "examples/transcr_reg_6d.py":
        start = pt.models.transcription_regulation_6d().bounds
        assert (d.bounds >= start).all() and (d.bounds > start).any()
    for f in files:
        if f.endswith("_perf.csv"):
            _perf_csv(tdir / f)


def _bitwise(d1, d2):
    assert np.array_equal(d1.states, d2.states)
    assert np.array_equal(d1.p, d2.p)


def test_flagship_is_the_first_stage(repressilator, capsys):
    _, _, _, truns = repressilator
    opts = pt.Options.from_argv(["-fsp_tol", str(TOL)])
    s, d, wall = t_flag.run_once(opts, T_CUT, TOL, device="cpu")
    _bitwise(d, truns["adaptive_custom"][1])
    walls = t_flag.main(["-t_final", str(T_CUT), "-repeat", "2",
                         "-device", "cpu"])
    assert len(walls) == 2
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "walls: ")


@pytest.mark.parametrize("config,example", [
    ("repressilator", "adaptive_custom"),
    ("hog1p", "examples/hog1p.py"),
    ("transcr6d", "examples/transcr_reg_6d.py"),
])
def test_bench_config_is_the_example(repressilator, examples, config,
                                     example):
    runs = t_bench.main([config, "-t_final", str(T_CUT), "-device", "cpu"])
    assert len(runs) == 1
    s, d, wall = runs[0]
    want = (repressilator[3][example][1] if config == "repressilator"
            else examples[example][2][1])
    _bitwise(d, want)


def test_bench_config_repeat():
    runs = t_bench.main(["repressilator", "-repeat", "2", "-t_final",
                         str(T_CUT),
                         "-device", "cpu"])
    assert len(runs) == 2
    assert np.array_equal(runs[0][1].p, runs[1][1].p)


# ---------------------------------------------------------------- tools
def test_ell_bench_times_the_action(capsys):
    out = t_ell.main(["0.2", "-device", "cpu"])
    assert out["states"] > 1000 and out["nnz"] > out["states"]
    assert out["us"] > 0 and out["gnnz_per_s"] > 0
    assert "not ported" in capsys.readouterr().err


def test_dryrun_entry_is_one_box_action():
    fn, args = t_dry.entry("cpu")
    out = fn(*args)
    # the generator conserves mass: dp and the sinks sum to 0
    assert abs(float(out.p.sum() + out.sinks.sum())) <= 1e-12
    assert float(out.p.abs().sum()) > 0


@pytest.mark.parametrize("main,argv", [
    (t_rep.main, []), (t_hog1p.main, []), (t_tr6.main, []),
    (t_flag.main, []), (t_ell.main, []), (t_sweep.main, []),
    (t_dry.main, []), (t_bench.main, ["repressilator"]),
])
def test_cuda_without_a_card_raises(main, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(pt.SetupError):
        main(argv + ["-device", "cuda", "-out_dir", str(tmp_path)])
