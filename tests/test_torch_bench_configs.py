"""The two ``bench_configs`` configs that no example runs, against the
JAX package's ``tools/bench_configs.py`` (loaded by path) on the host:
the forward sensitivities of hog1p (``-model3d``, cut in time) and the
stationary solve.  The reference's config functions print their
distribution; the test takes it from their ``_report``.

* ``sens_hog1p``: the same states, ``p`` and each ``dP/dtheta_j`` within
  1e-8 (by state).
* ``stationary_rep``: the config's code on the birth-death process in
  both packages (each package's ``models.repressilator`` replaced for the
  call) at sfsp_tol = 1e-7: the same states, ``pi`` within 1e-8 by state
  and 2 * sfsp_tol in L1, each sink at most sfsp_tol.  On the
  repressilator itself no meaningful limit can be had on the host: a
  tolerance both packages reach within a minute (0.5 and above) leaves
  the two laws on different sets, 0.04-0.6 apart in L1 where 2 *
  sfsp_tol is 1-2, and 0.08 takes minutes (115,155 states).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.tools import bench_configs as t_bench  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the stationary config's tolerance on the birth-death process
STAT_TOL = 1.0e-7


def _reference(config, argv, model=None):
    """The reference config's (distribution, solver); ``model``: the name
    of the model that stands for the repressilator."""
    spec = importlib.util.spec_from_file_location(
        "ref_bench_configs", ROOT / "tools/bench_configs.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    got = {}

    def report(tag, wall, d, s):
        got["d"], got["s"] = d, s
    ref._report = report
    models = ref.pm.models
    held = models.repressilator
    if model is not None:
        models.repressilator = getattr(models, model)
    try:
        ref.CONFIGS[config](ref.pm.Options.from_argv(argv))
    finally:
        models.repressilator = held
    return got["d"], got["s"]


def _sorted(d, a):
    return np.asarray(a)[..., np.lexsort(np.asarray(d.states).T[::-1])]


def test_sens_hog1p_matches_the_reference():
    argv = ["-t_final", "0.05", "-model3d"]
    jd, _ = _reference("sens_hog1p", argv)
    (s, d, wall), = t_bench.main(["sens_hog1p", "-device", "cpu"] + argv)
    assert isinstance(d, pt.SensDiscreteDistribution) and wall > 0
    np.testing.assert_array_equal(_sorted(d, d.states.T),
                                  _sorted(jd, np.asarray(jd.states).T))
    np.testing.assert_allclose(_sorted(d, d.p), _sorted(jd, jd.p),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(_sorted(d, d.dp), _sorted(jd, jd.dp),
                               rtol=0, atol=1e-8)


def test_stationary_rep_holds_the_tolerance_as_the_reference(monkeypatch):
    argv = ["-sfsp_tol", str(STAT_TOL)]
    jd, js = _reference("stationary_rep", argv, model="birth_death")
    monkeypatch.setattr(pt.models, "repressilator", pt.models.birth_death)
    (s, d, wall), = t_bench.main(["stationary_rep", "-device", "cpu"]
                                 + argv)
    assert isinstance(d, pt.DiscreteDistribution) and wall > 0
    for law, sinks in ((d, s.sinks_), (jd, js.sinks_)):
        assert abs(float(np.sum(law.p)) - 1.0) <= 1e-12
        assert (np.asarray(sinks) <= STAT_TOL).all()
    np.testing.assert_array_equal(_sorted(d, d.states.T),
                                  _sorted(jd, np.asarray(jd.states).T))
    diff = np.abs(_sorted(d, d.p) - _sorted(jd, jd.p))
    assert diff.max() <= 1e-8
    assert diff.sum() <= 2 * STAT_TOL
