"""Probabilistic distortion operator (PDO).

Counterpart of ``pacmensl_tpu/pdo/pdo.py``.  The reference declares this
component but never implements it (``src/Pdo/Pdo.h:20-33`` with an empty
``Pdo.cpp``); the reference package's implementation, kept here: a
conditional kernel ``C(y | x)`` mapping true counts of one species to
noisy observations, as a dense column-stochastic matrix over an
observation grid, applied to FSP distributions and their sensitivities,
plus the distorted log-likelihood.  Host numpy throughout.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..fsp.distribution import DiscreteDistribution
from ..sensfsp.sens_distribution import SensDiscreteDistribution, PROB_CLAMP


class Pdo:
    """Distortion kernel C(y | x) on a single measured species.

    ``kernel(y, x) -> P(observe y | true count x)`` must be vectorized
    over numpy arrays; ``y_max`` bounds the observation grid.
    """

    def __init__(self, kernel: Callable, y_max: int, species: int = 0):
        self.kernel = kernel
        self.y_max = int(y_max)
        self.species = int(species)

    def matrix(self, x_values: np.ndarray) -> np.ndarray:
        """Column-stochastic distortion matrix [y_max+1, len(x_values)]."""
        y = np.arange(self.y_max + 1)
        C = np.asarray(self.kernel(y[:, None], x_values[None, :]),
                       dtype=np.float64)
        s = C.sum(axis=0, keepdims=True)
        return C / np.maximum(s, PROB_CLAMP)

    def apply(self, dist: DiscreteDistribution) -> np.ndarray:
        """Distorted observation distribution P(y) = sum_x C(y|x) p(x)."""
        marg = dist.marginal(self.species)
        C = self.matrix(np.arange(marg.shape[0]))
        return C @ marg

    def apply_sens(self, dist: SensDiscreteDistribution) -> np.ndarray:
        """Distorted sensitivities [n_par, y_max+1]."""
        out = []
        for j in range(dist.num_parameters):
            sm = dist.sens_marginal(j, self.species)
            C = self.matrix(np.arange(sm.shape[0]))
            out.append(C @ sm)
        return np.stack(out)

    def loglikelihood(self, observations, dist: DiscreteDistribution,
                      frequencies: Optional[np.ndarray] = None) -> float:
        """Log-likelihood of observed counts under the distorted law
        (counts above ``y_max`` are read as ``y_max``, as in the reference
        package)."""
        obs = np.asarray(observations, np.int64).reshape(-1)
        if frequencies is None:
            frequencies = np.ones_like(obs)
        py = self.apply(dist)
        py = np.maximum(py, PROB_CLAMP)
        obs = np.clip(obs, 0, py.shape[0] - 1)
        return float(np.asarray(frequencies) @ np.log(py[obs]))
