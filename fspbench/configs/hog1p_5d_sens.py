"""The hog1p 5-species network with its derivative propensities in the
sensitivity parameters of ``hog1p_5d_sens.json``: the propensities and
time coefficients are ``hog1p_5d.py``'s, loaded from beside this file.
``d_propensity(x, j, r, k)`` is d d_r(x) / d theta_j, theta = (trans,
gamma1): trans enters reactions 5 and 6 (trans x1, trans x2), gamma1
reaction 7 (gamma1 x3), each linearly, so the derivative is the state
factor without its rate."""
import importlib.util
from pathlib import Path

import torch

_spec = importlib.util.spec_from_file_location(
    "fspbench_net_hog1p_5d_base", Path(__file__).with_name("hog1p_5d.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)

propensity = _base.propensity
t_coeff = _base.t_coeff

#: parameter j -> {reaction: the species whose count the rate multiplies}
_LINEAR = ({5: 1, 6: 2}, {7: 3})


def d_propensity(x, j, r, k):
    """d d_r(x) / d theta_j at ``x [n, 5]`` (float64), rates ``k``; zero
    off the parameter's reactions."""
    species = _LINEAR[j].get(r)
    if species is None:
        return torch.zeros_like(x[:, 0])
    return x[:, species].clone()
