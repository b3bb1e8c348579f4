"""SensDiscreteDistribution: distribution + parameter sensitivities.

Counterpart of ``pacmensl_tpu/sensfsp/sens_distribution.py`` (reference
``SensDiscreteDistribution``, ``src/SensFsp/SensDiscreteDistribution.
{h,cpp}``): probabilities plus one sensitivity vector per parameter,
per-parameter weighted averages and 1-D sensitivity marginals, and the
Fisher information matrix ``F_ij = sum_x s_i(x) s_j(x) / max(p(x),
1e-16)`` (``ComputeFIM``, SensDiscreteDistribution.cpp:216-271).  Its
``.npz`` checkpoint has the reference package's keys (``dp`` beside the
plain distribution's), so either package loads the other's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..fsp.distribution import DiscreteDistribution

#: probability clamp used by the reference's FIM and likelihoods
PROB_CLAMP = 1.0e-16


@dataclass
class SensDiscreteDistribution(DiscreteDistribution):
    dp: Optional[np.ndarray] = None      # [n_par, n] sensitivities

    def __post_init__(self):
        super().__post_init__()
        if self.dp is not None:
            if torch.is_tensor(self.dp):
                self.dp = self.dp.detach().cpu().numpy()
            self.dp = np.asarray(self.dp)
            self.dp = self.dp.reshape(self.dp.shape[0], -1)
            if self.dp.shape[1] != self.num_states:
                raise ValueError("dp/p length mismatch")

    @property
    def num_parameters(self) -> int:
        return 0 if self.dp is None else self.dp.shape[0]

    def sens_weighted_average(self, j: int, weight_fn: Callable) -> float:
        """sum_x f(x) s_j(x); ``weight_fn`` takes the states as a CPU int64
        tensor."""
        w = torch.as_tensor(weight_fn(torch.as_tensor(self.states)))
        return float(w.reshape(-1).to(torch.float64).numpy() @ self.dp[j])

    def sens_marginal(self, j: int, species: int) -> np.ndarray:
        """Compute1DSensMarginal analogue."""
        x = self.states[:, species]
        return np.bincount(x, weights=self.dp[j],
                           minlength=int(x.max()) + 1)

    def compute_fim(self) -> np.ndarray:
        """Fisher information (reference ComputeFIM)."""
        pc = np.maximum(self.p, PROB_CLAMP)
        sw = self.dp / pc[None, :]            # s_i / p
        return sw @ self.dp.T

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, t=self.t, states=self.states, p=self.p,
            bounds=self.bounds if self.bounds is not None else np.zeros(0),
            sinks=self.sinks if self.sinks is not None else np.zeros(0),
            dp=self.dp if self.dp is not None else np.zeros((0, 0)))

    @classmethod
    def load(cls, path: str) -> "SensDiscreteDistribution":
        with np.load(path) as z:
            return cls(t=float(z["t"]), states=z["states"], p=z["p"],
                       bounds=z["bounds"] if z["bounds"].size else None,
                       sinks=z["sinks"] if z["sinks"].size else None,
                       dp=z["dp"] if z["dp"].size else None)
