"""smFISH snapshot data and likelihoods.

Counterpart of ``pacmensl_tpu/smfish/snapshot.py`` (reference
``SmFishSnapshot`` + ``SmFishSnapshotLogLikelihood`` /
``SmFishSnapshotGradient``, ``src/SmFish/SmFishSnapshot.{h,cpp}``):
single-cell observation counts with frequencies, the log-likelihood of the
data under an FSP distribution marginalized onto the measured species, and
its parameter gradient from a sensitivity distribution.  The probability
clamp (1e-16) and optional base-2 logs mirror the reference
(SmFishSnapshot.cpp:149-205, :206-291).  Host numpy throughout: the
distributions are host arrays.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..sys import indexing
from ..fsp.distribution import DiscreteDistribution
from ..sensfsp.sens_distribution import SensDiscreteDistribution, PROB_CLAMP


class SmFishSnapshot:
    """Observations [n_cells or n_unique, n_measured_species]."""

    def __init__(self, observations, frequencies: Optional[Sequence] = None):
        observations = np.atleast_2d(np.asarray(observations, np.int64))
        if frequencies is None:
            observations, inv = indexing.unique_states(observations)
            frequencies = np.bincount(inv)
        self.observations = observations
        self.frequencies = np.asarray(frequencies, np.int64).reshape(-1)
        if self.frequencies.shape[0] != self.observations.shape[0]:
            raise ValueError("observations/frequencies length mismatch")
        self._key_bounds = self.observations.max(axis=0)
        keys = indexing.sub2ind(self._key_bounds, self.observations)
        order = np.argsort(keys)
        self._sorted_keys = keys[order]
        self._sorted_pos = order

    @property
    def num_observations(self) -> int:
        return self.observations.shape[0]

    def observation_index(self, states) -> np.ndarray:
        """Index of each state among the observations, -1 if unobserved
        (reference GetObservationIndex)."""
        states = np.atleast_2d(np.asarray(states, np.int64))
        keys = indexing.sub2ind(self._key_bounds, states)
        out = np.full(keys.shape, -1, np.int64)
        valid = keys >= 0
        pos = np.searchsorted(self._sorted_keys, keys[valid])
        pos = np.clip(pos, 0, self._sorted_keys.size - 1)
        hit = self._sorted_keys[pos] == keys[valid]
        out[valid] = np.where(hit, self._sorted_pos[pos], -1)
        return out

    def predicted_probabilities(self, dist: DiscreteDistribution,
                                measured_species=None) -> np.ndarray:
        """Marginalize the FSP distribution onto the observations."""
        k = self._observed(dist, measured_species)
        obs = k >= 0
        return np.bincount(k[obs], weights=dist.p[obs],
                           minlength=self.num_observations)

    def _observed(self, dist, measured_species) -> np.ndarray:
        """Each state's observation index on the measured species."""
        if measured_species is None:
            measured_species = np.arange(dist.num_species)
        proj = dist.states[:, np.asarray(measured_species, np.int64)]
        return self.observation_index(proj)


def smfish_loglikelihood(data: SmFishSnapshot,
                         dist: DiscreteDistribution,
                         measured_species=None,
                         use_base_2: bool = False) -> float:
    """Reference SmFishSnapshotLogLikelihood."""
    pred = data.predicted_probabilities(dist, measured_species)
    logs = np.log2 if use_base_2 else np.log
    return float(data.frequencies @ logs(np.maximum(pred, PROB_CLAMP)))


def smfish_gradient(data: SmFishSnapshot,
                    dist: SensDiscreteDistribution,
                    measured_species=None,
                    use_base_2: bool = False) -> np.ndarray:
    """Reference SmFishSnapshotGradient: d log L / d theta_j."""
    pred = np.maximum(
        data.predicted_probabilities(dist, measured_species), PROB_CLAMP)
    k = data._observed(dist, measured_species)
    obs = k >= 0
    grad = np.empty(dist.num_parameters)
    denom = pred * (np.log(2.0) if use_base_2 else 1.0)
    for j in range(dist.num_parameters):
        pred_s = np.bincount(k[obs], weights=dist.dp[j][obs],
                             minlength=data.num_observations)
        grad[j] = data.frequencies @ (pred_s / denom)
    return grad


# Reference-style aliases
SmFishSnapshotLogLikelihood = smfish_loglikelihood
SmFishSnapshotGradient = smfish_gradient
