"""The port's smFISH likelihoods and PDO on the CPU.

The seven cases of the reference package's ``tests/test_smfish.py`` (the
reference test_smfish.cpp's hand-computable oracle: uniform p = 0.1 over
10 states and 5 observations give ll = 5 log(0.1)), then the port against
the reference package on one shared seeded sensitivity distribution:
likelihood, gradient and the PDO's outputs bitwise equal (the same numpy
arithmetic in the same order)."""
import numpy as np
import pytest

pytest.importorskip("torch")

import pacmensl_tpu.smfish.snapshot as jsn  # noqa: E402
from pacmensl_tpu.pdo.pdo import Pdo as JPdo  # noqa: E402
from pacmensl_tpu.sensfsp.sens_distribution import (  # noqa: E402
    SensDiscreteDistribution as JSensDist)
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.fsp.distribution import (  # noqa: E402
    DiscreteDistribution)
from pacmensl_tpu_torch.sensfsp.sens_distribution import (  # noqa: E402
    SensDiscreteDistribution)
from pacmensl_tpu_torch.smfish.snapshot import (  # noqa: E402
    SmFishSnapshot, SmFishSnapshotGradient, SmFishSnapshotLogLikelihood,
    smfish_gradient, smfish_loglikelihood)
from pacmensl_tpu_torch.pdo.pdo import Pdo  # noqa: E402


def test_loglikelihood_uniform_oracle():
    states = np.arange(10).reshape(-1, 1)
    dist = DiscreteDistribution(t=1.0, states=states, p=np.full(10, 0.1))
    data = SmFishSnapshot(np.array([[0], [2], [4], [6], [8]]))
    assert smfish_loglikelihood(data, dist) == pytest.approx(5 * np.log(0.1))
    assert smfish_loglikelihood(data, dist, use_base_2=True) == \
        pytest.approx(5 * np.log2(0.1))


def test_repeated_observations_fold_into_frequencies():
    data = SmFishSnapshot(np.array([[1], [1], [2]]))
    assert data.num_observations == 2
    assert sorted(data.frequencies.tolist()) == [1, 2]


def test_unobserved_state_clamps():
    states = np.arange(3).reshape(-1, 1)
    dist = DiscreteDistribution(t=0.0, states=states, p=[1.0, 0.0, 0.0])
    data = SmFishSnapshot(np.array([[1]]))   # observed state has p = 0
    assert smfish_loglikelihood(data, dist) == pytest.approx(np.log(1e-16))


def test_marginalized_likelihood():
    states = np.array([[0, 0], [0, 1], [1, 0], [1, 1]])
    dist = DiscreteDistribution(t=0.0, states=states,
                                p=[0.1, 0.2, 0.3, 0.4])
    data = SmFishSnapshot(np.array([[0], [1]]))
    ll = smfish_loglikelihood(data, dist, measured_species=[0])
    assert ll == pytest.approx(np.log(0.3) + np.log(0.7))


def test_gradient_matches_finite_difference():
    """The gradient from the sensitivities is the central difference of
    the likelihood along dp, rel 1e-6."""
    rng = np.random.default_rng(0)
    states = np.arange(6).reshape(-1, 1)
    p = rng.random(6)
    p /= p.sum()
    dp = rng.standard_normal((2, 6)) * 0.01
    dist = SensDiscreteDistribution(t=0.0, states=states, p=p, dp=dp)
    data = SmFishSnapshot(np.array([[0], [3], [5]]), [2, 1, 4])
    grad = smfish_gradient(data, dist)
    eps = 1e-7
    for j in range(2):
        dp_ = DiscreteDistribution(t=0.0, states=states, p=p + eps * dp[j])
        dm_ = DiscreteDistribution(t=0.0, states=states, p=p - eps * dp[j])
        fd = (smfish_loglikelihood(data, dp_)
              - smfish_loglikelihood(data, dm_)) / (2 * eps)
        assert grad[j] == pytest.approx(fd, rel=1e-6)


def test_pdo_identity_kernel_preserves_marginal():
    states = np.arange(5).reshape(-1, 1)
    p = np.array([0.1, 0.2, 0.3, 0.2, 0.2])
    dist = DiscreteDistribution(t=0.0, states=states, p=p)
    ident = Pdo(lambda y, x: (y == x).astype(float), y_max=4)
    np.testing.assert_allclose(ident.apply(dist), p)
    assert ident.loglikelihood([2, 2, 4], dist) == pytest.approx(
        2 * np.log(0.3) + np.log(0.2))


def test_pdo_binomial_loss_kernel():
    """Binomial detection with efficiency 0.5: the distorted mean halves."""
    from scipy.stats import binom
    states = np.arange(11).reshape(-1, 1)
    p = np.zeros(11)
    p[10] = 1.0
    dist = DiscreteDistribution(t=0.0, states=states, p=p)
    py = Pdo(lambda y, x: binom.pmf(y, x, 0.5), y_max=10).apply(dist)
    assert np.arange(11) @ py == pytest.approx(5.0)


def _shared():
    """A seeded sensitivity distribution over a 3-species grid, in both
    packages, and seeded observations of species 1 and 2 (some outside
    the distribution's states)."""
    rng = np.random.default_rng(11)
    g = np.stack(np.meshgrid(np.arange(3), np.arange(7), np.arange(6),
                             indexing="ij"), -1).reshape(-1, 3)
    p = rng.random(g.shape[0])
    p /= p.sum()
    dp = rng.standard_normal((2, g.shape[0])) * 0.01
    obs = rng.integers(0, 9, size=(40, 2))
    port = SensDiscreteDistribution(t=3.0, states=g, p=p, dp=dp)
    ref = JSensDist(t=3.0, states=g, p=p, dp=dp)
    return port, ref, obs


@pytest.mark.parametrize("base2", [False, True])
def test_likelihood_and_gradient_match_the_reference_package(base2):
    port, ref, obs = _shared()
    tdata, jdata = SmFishSnapshot(obs), jsn.SmFishSnapshot(obs)
    np.testing.assert_array_equal(tdata.observations, jdata.observations)
    np.testing.assert_array_equal(tdata.frequencies, jdata.frequencies)
    for ms in ([1, 2], [2]):
        o = obs[:, :len(ms)] if len(ms) == 1 else obs
        td, jd = SmFishSnapshot(o), jsn.SmFishSnapshot(o)
        assert SmFishSnapshotLogLikelihood(td, port, ms, base2) == \
            jsn.smfish_loglikelihood(jd, ref, ms, base2)
        np.testing.assert_array_equal(
            SmFishSnapshotGradient(td, port, ms, base2),
            jsn.smfish_gradient(jd, ref, ms, base2))


def test_pdo_matches_the_reference_package():
    from scipy.stats import binom
    port, ref, obs = _shared()

    def kern(y, x):
        return binom.pmf(y, x, 0.7)
    tp, jp = Pdo(kern, y_max=8, species=1), JPdo(kern, y_max=8, species=1)
    np.testing.assert_array_equal(tp.matrix(np.arange(7)),
                                  jp.matrix(np.arange(7)))
    np.testing.assert_array_equal(tp.apply(port), jp.apply(ref))
    np.testing.assert_array_equal(tp.apply_sens(port), jp.apply_sens(ref))
    assert tp.loglikelihood(obs[:, 0], port) == \
        jp.loglikelihood(obs[:, 0], ref)
    assert pt.Pdo is Pdo and pt.SmFishSnapshot is SmFishSnapshot
