"""Bundled models of the PyTorch port against the reference package:
propensities, time coefficients and constraint functions on a shared state
grid (rtol 1e-12), and the arrays that define each bundle (exact); for the
sensitivity bundles also the derivative propensities and time
coefficients (rtol 1e-12)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import pacmensl_tpu as pm  # noqa: E402
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.interop import bundle_arrays  # noqa: E402

NAMES = ["poisson", "birth_death", "telegraph", "toggle", "repressilator",
         "hog1p_3d", "hog1p_5d", "transcr_reg_6d", "hog1p_3d_sens",
         "hog1p_5d_sens"]
TIMES = [0.0, 1.0, 30.0, 120.0, 1800.0]


def _grid(S, seed):
    """Shared states: a seeded random grid plus the origin."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 14, size=(400, S)).astype(np.int64)
    return np.vstack([np.zeros((1, S), np.int64), x])


@pytest.mark.parametrize("name", NAMES)
def test_bundle_matches_reference(name):
    jb = pm.models.ALL_MODELS[name]()
    tb = pt.models.ALL_MODELS[name]()

    ja, ta = bundle_arrays(jb), bundle_arrays(tb)
    assert ja.keys() == ta.keys()
    for k in ja:
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)

    S = jb.model.num_species
    x = _grid(S, seed=NAMES.index(name))
    for states_j, states_t in (
            (jnp.asarray(x), torch.as_tensor(x)),
            (jnp.asarray(x, jnp.float64),
             torch.as_tensor(x, dtype=torch.float64))):
        for r in range(jb.model.num_reactions):
            want = np.asarray(jb.model.propensity(states_j, r), np.float64)
            got = pt.models.ALL_MODELS[name]().model.propensity(states_t, r)
            assert got.dtype == torch.float64
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                       atol=0, err_msg=f"reaction {r}")

    for t in TIMES:
        np.testing.assert_allclose(
            tb.model.coefficients(t).numpy(),
            np.asarray(jb.model.coefficients(t)), rtol=1e-12, atol=0,
            err_msg=f"t = {t}")

    jcs = pm.ConstraintSet(jb.constraint, jb.bounds, jb.expansion_factors,
                           S)
    tcs = pt.ConstraintSet(tb.constraint, tb.bounds, tb.expansion_factors,
                           S)
    np.testing.assert_array_equal(
        tcs.values(torch.as_tensor(x)).numpy(),
        np.asarray(jcs.values_fn(jnp.asarray(x))))
    assert len(tcs.components) == len(jcs.components)
    for jc, tc in zip(jcs.components, tcs.components):
        np.testing.assert_array_equal(tc(torch.as_tensor(x)).numpy(),
                                      np.asarray(jc(jnp.asarray(x))))
    np.testing.assert_array_equal(tcs.all_satisfied(x),
                                  np.asarray(jcs.all_satisfied(x)))
    np.testing.assert_array_equal(
        tcs.derive_box_bounds(S, tb.x0), jcs.derive_box_bounds(S, jb.x0))
    np.testing.assert_array_equal(tcs.expanded_bounds(np.ones(len(
        tcs.bounds), bool)), jcs.expanded_bounds(np.ones(len(jcs.bounds),
                                                         bool)))


@pytest.mark.parametrize("name", ["poisson_sens", "telegraph",
                                  "hog1p_3d_sens", "hog1p_5d_sens"])
def test_sens_bundle_derivatives_match_reference(name):
    jm = getattr(pm.models, name)().model
    tm = getattr(pt.models, name)().model
    assert isinstance(tm, pt.SensModel)
    assert tm.num_parameters == jm.num_parameters
    x = _grid(jm.num_species, seed=7)
    for j in range(jm.num_parameters):
        if jm.d_propensity is not None:
            for r in range(jm.num_reactions):
                want = np.asarray(jm.d_propensity(jnp.asarray(x), j, r),
                                  np.float64).reshape(-1)
                got = tm.d_propensity(torch.as_tensor(x), j, r)
                np.testing.assert_allclose(
                    np.broadcast_to(got.numpy(), want.shape), want,
                    rtol=1e-12, atol=0, err_msg=f"j = {j}, reaction {r}")
        if jm.d_t_coeff is not None:
            for t in TIMES:
                np.testing.assert_allclose(
                    np.asarray(tm.d_t_coeff(j, t), np.float64),
                    np.asarray(jm.d_t_coeff(j, t), np.float64), rtol=1e-12)
    base = tm.base_model()
    assert type(base) is pt.Model and base.tv_reactions == tm.tv_reactions
