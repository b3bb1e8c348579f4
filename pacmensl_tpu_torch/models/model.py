"""Reaction-network model descriptions.

Counterpart of ``pacmensl_tpu/models/model.py`` (reference ``Model`` and
``SensModel``, ``src/Models/Model.h:63-99``,
``src/Models/SensModel.h:58-97``).

Propensities factorize as ``a_r(t, x) = c_r(t) * d_r(x)`` where the time
coefficient ``c_r(t)`` applies only to reactions listed in
``tv_reactions``; the others use ``c_r = 1`` with all rate constants folded
into the state factor (reference ``FspMatrixBase::Action``,
``src/Matrix/FspMatrixBase.cpp:36-62``).

The stoichiometry is stored with rows = reactions (``[n_reactions,
n_species]``).  Propensities are batched torch functions
``propensity(states[n, S], reaction) -> rates[n]`` that run on whatever
device the states tensor lives on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..sys.errors import ModelError

#: propensity(states[n, S], reaction: int) -> rates[n]
PropFun = Callable[..., torch.Tensor]
#: t_coeff(t: float) -> coefficients[n_reactions]
TcoefFun = Callable[[float], torch.Tensor]


@dataclass
class Model:
    """A stochastic reaction network (reference ``Model``, Model.h:63-99)."""

    stoichiometry: np.ndarray          # [n_reactions, n_species] int
    propensity: PropFun                # state-dependent factors d_r(x)
    t_coeff: Optional[TcoefFun] = None  # time coefficients c_r(t)
    tv_reactions: Sequence[int] = ()   # reactions whose c_r varies with time
    species_names: Optional[Sequence[str]] = None

    def __post_init__(self):
        self.stoichiometry = np.atleast_2d(
            np.asarray(self.stoichiometry, dtype=np.int64))
        self.tv_reactions = tuple(int(r) for r in self.tv_reactions)
        if self.tv_reactions and self.t_coeff is None:
            raise ModelError("tv_reactions given but t_coeff is None")
        bad = [r for r in self.tv_reactions
               if not 0 <= r < self.num_reactions]
        if bad:
            raise ModelError(f"tv_reactions out of range: {bad}")

    @property
    def num_species(self) -> int:
        return self.stoichiometry.shape[1]

    @property
    def num_reactions(self) -> int:
        return self.stoichiometry.shape[0]

    def coefficients(self, t, dtype=torch.float64) -> torch.Tensor:
        """Full coefficient vector at time ``t`` on the host: c_r(t) for
        tv reactions, 1.0 for time-invariant ones."""
        ones = torch.ones(self.num_reactions, dtype=dtype)
        if not self.tv_reactions:
            return ones
        c = torch.as_tensor(self.t_coeff(float(t)), dtype=dtype).reshape(-1)
        mask = torch.zeros(self.num_reactions, dtype=torch.bool)
        mask[list(self.tv_reactions)] = True
        return torch.where(mask, c, ones)

    def propensities(self, states, dtype=torch.float64) -> torch.Tensor:
        """Evaluate all state factors: returns [n_states, n_reactions]."""
        states = torch.as_tensor(states)
        cols = [torch.as_tensor(self.propensity(states, r)).to(dtype)
                .reshape(-1) for r in range(self.num_reactions)]
        return torch.stack(cols, dim=1)


@dataclass
class SensModel(Model):
    """Model with parameter sensitivities (reference ``SensModel``,
    SensModel.h:58-97).

    The derivative of the generator w.r.t. parameter j splits as
    ``d_j A = (d_j c)·A_r  +  c·(d_j A_r)``, captured by:

    * ``d_t_coeff(j, t) -> [n_reactions]`` derivatives of the time
      coefficients, restricted to ``dtcoef_sparsity[j]``;
    * ``d_propensity(states, j, r) -> rates[n]`` derivatives of the state
      factors, restricted to ``dprop_sparsity[j]``.

    Sparsity lists name the reactions with a structurally nonzero
    derivative for each parameter (reference ``dprop_x_sp_`` /
    ``dprop_t_sp_``).
    """

    num_parameters: int = 0
    d_t_coeff: Optional[Callable] = None        # (j, t) -> [n_reactions]
    dtcoef_sparsity: Sequence[Sequence[int]] = ()
    d_propensity: Optional[Callable] = None     # (states, j, r) -> [n]
    dprop_sparsity: Sequence[Sequence[int]] = ()

    def __post_init__(self):
        super().__post_init__()
        if self.num_parameters <= 0:
            raise ModelError("SensModel requires num_parameters > 0")
        self.dtcoef_sparsity = tuple(tuple(int(r) for r in s)
                                     for s in self.dtcoef_sparsity)
        self.dprop_sparsity = tuple(tuple(int(r) for r in s)
                                    for s in self.dprop_sparsity)
        if self.d_t_coeff is not None and \
                len(self.dtcoef_sparsity) != self.num_parameters:
            raise ModelError("dtcoef_sparsity must have one entry per "
                             "parameter")
        if self.d_propensity is not None and \
                len(self.dprop_sparsity) != self.num_parameters:
            raise ModelError("dprop_sparsity must have one entry per "
                             "parameter")

    def base_model(self) -> Model:
        return Model(self.stoichiometry, self.propensity, self.t_coeff,
                     self.tv_reactions, self.species_names)
