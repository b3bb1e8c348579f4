"""DiscreteDistribution: the FSP solver output.

Counterpart of ``pacmensl_tpu/fsp/distribution.py`` (reference
``DiscreteDistribution``, ``src/Fsp/DiscreteDistribution.{h,cpp}``):
(time, states, probabilities) with weighted averages and 1-D marginals,
serializable to ``.npz`` with the reference package's keys (``t``,
``states``, ``p``, ``bounds``, ``sinks``), so a checkpoint written by either
package loads in the other.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


@dataclass
class DiscreteDistribution:
    t: float
    states: np.ndarray              # [n, n_species] int
    p: np.ndarray                   # [n] float
    bounds: Optional[np.ndarray] = None   # FSP constraint bounds at t
    sinks: Optional[np.ndarray] = None    # sink masses at t

    def __post_init__(self):
        self.states = np.atleast_2d(np.asarray(self.states))
        if torch.is_tensor(self.p):
            self.p = self.p.detach().cpu().numpy()
        self.p = np.asarray(self.p).reshape(-1)
        if self.states.shape[0] != self.p.shape[0]:
            raise ValueError("states/p length mismatch")

    @property
    def num_states(self) -> int:
        return self.p.shape[0]

    @property
    def num_species(self) -> int:
        return self.states.shape[1]

    def sum(self) -> float:
        return float(self.p.sum())

    def weighted_average(self, weight_fn: Callable) -> float:
        """<f> = sum_x f(x) p(x) (reference WeightedAverage); ``weight_fn``
        takes the states as a CPU int64 tensor."""
        w = torch.as_tensor(weight_fn(torch.as_tensor(self.states)))
        return float(w.reshape(-1).to(torch.float64).numpy() @ self.p)

    def mean(self, species: int) -> float:
        return float(self.states[:, species] @ self.p)

    def marginal(self, species: int) -> np.ndarray:
        """1-D marginal via bincount (reference Compute1DMarginal)."""
        x = self.states[:, species]
        return np.bincount(x, weights=self.p, minlength=int(x.max()) + 1)

    # ------------------------------------------------------- checkpoint ---
    def save(self, path: str) -> None:
        np.savez_compressed(
            path, t=self.t, states=self.states, p=self.p,
            bounds=self.bounds if self.bounds is not None else np.zeros(0),
            sinks=self.sinks if self.sinks is not None else np.zeros(0))

    @classmethod
    def load(cls, path: str) -> "DiscreteDistribution":
        with np.load(path) as z:
            bounds = z["bounds"] if z["bounds"].size else None
            sinks = z["sinks"] if z["sinks"].size else None
            return cls(t=float(z["t"]), states=z["states"], p=z["p"],
                       bounds=bounds, sinks=sinks)
