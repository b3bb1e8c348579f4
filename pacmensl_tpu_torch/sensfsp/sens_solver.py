"""SensFspSolverMultiSinks: the forward-sensitivity FSP driver.

Counterpart of ``pacmensl_tpu/sensfsp/sens_solver.py`` (reference
``SensFspSolverMultiSinks``, ``src/SensFsp/SensFspSolverMultiSinks.
{h,cpp}``) on the box backend and one device: the transient driver's
solve -> check sinks -> expand -> resume loop, integrating the
probability and every parameter sensitivity, all vectors expanded with
the same map on growth (reference :333-422).

The solution is the stacked :class:`~..ops.vecops.FspVector` of
:mod:`..ops.sens_operator` (p then s_1..s_Np, and their sinks); the
stop-check and the expansion read the probability's sinks only
(:meth:`_base_sinks`).  The stacked system is linear, so either
integrator runs it; BDF (CVODE) is the default, as in the reference
package.  The sink check is the transient driver's.

Not ported here (ROADMAP): a solve over a ``mesh`` (A13), the compressed
backend (A9: where the reference package migrates, the driver raises
:class:`StateSpaceError` as the transient one does), RK/CN (A8) and the
axis-reordered rebuild (A2a).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.model import SensModel
from ..sys.errors import SetupError, StateSpaceError
from ..ops.sens_operator import SensOperator
from ..ops.vecops import FspVector
from ..solvers.base import ODESolverType
from ..fsp.solver import FspSolverMultiSinks
from .sens_distribution import SensDiscreteDistribution


class SensFspSolverMultiSinks(FspSolverMultiSinks):
    """Forward-sensitivity FSP solver (p plus dp/dtheta_j)."""

    def __init__(self, backend: str = "box",
                 odes_type=ODESolverType.CVODE, device=None, mesh=None):
        super().__init__(backend=backend, odes_type=odes_type,
                         device=device, mesh=mesh)
        self._init_sens: Optional[np.ndarray] = None

    # ---------------------------------------------------------- settings
    def set_mesh(self, mesh) -> "SensFspSolverMultiSinks":
        if mesh is not None:
            raise SetupError(
                "a sensitivity solve over a mesh is not ported yet "
                "(ROADMAP A13); solve on one device")
        return super().set_mesh(None)

    def set_model(self, model) -> "SensFspSolverMultiSinks":
        if not isinstance(model, SensModel):
            raise SetupError("SensFspSolverMultiSinks requires a SensModel")
        self.model = model
        self._set_up = False
        return self

    def set_initial_distribution(self, x0, p0=None, dp0=None
                                 ) -> "SensFspSolverMultiSinks":
        """Initial states, probabilities and sensitivities ``dp0
        [n_parameters, n_init]`` (zeros by default), or a distribution
        with sensitivities (``dp``) to restart from, such as a
        :class:`SensDiscreteDistribution` of either package."""
        if hasattr(x0, "states") and hasattr(x0, "dp"):
            super().set_initial_distribution(x0)
            dp0 = x0.dp
        else:
            super().set_initial_distribution(x0, p0)
        n_par = self.model.num_parameters if self.model else 0
        if dp0 is None:
            dp0 = np.zeros((n_par, self._init_probs.shape[0]))
        self._init_sens = np.atleast_2d(np.asarray(dp0, dtype=np.float64))
        if self._init_sens.shape != (n_par, self._init_probs.shape[0]):
            raise SetupError(
                f"dp0 must be [n_parameters={n_par}, n_init_states]")
        return self

    # ------------------------------------------------------------- build
    def _build_operator(self):
        self._ode_solver = None     # its basis has the old capacity
        self._operator = None       # free the old operators first
        self._operator = SensOperator(self.model, self._space,
                                      dtype=self.dtype)

    def _initial_vector(self) -> FspVector:
        idx = self._space.state2index(self._init_states)
        if (idx < 0).any():
            raise StateSpaceError(
                "initial states outside the FSP state space")
        n, n_c = self._space.size, self.constraints.num_constraints
        m = 1 + self.model.num_parameters
        p = np.zeros((m, n), dtype=np.float64)
        p[0, idx] = self._init_probs
        p[1:, idx] = self._init_sens
        self.sinks_ = np.zeros((n_c,), np.float64)
        return FspVector(
            p=torch.as_tensor(p.reshape(-1), dtype=self.dtype,
                              device=self.device),
            sinks=torch.zeros(m * n_c, dtype=self.dtype,
                              device=self.device))

    def _embed_old(self, old_shape) -> FspVector:
        """p and every sensitivity zero-padded by the same map
        (reference SensFspSolverMultiSinks.cpp:371-402)."""
        m = 1 + self.model.num_parameters
        rows = self._y.p.view(m, -1)
        p = torch.cat([self._space.embed_old(rows[k], old_shape)
                       for k in range(m)])
        return FspVector(p=p, sinks=self._y.sinks)

    # ------------------------------------------------------------ output
    def _make_distribution(self) -> SensDiscreteDistribution:
        with self.events.timed("DistributionExtract"):
            m = 1 + self.model.num_parameters
            rows = self._y.p.view(m, -1)
            vals = [self._space.extract_valid(rows[k]) for k in range(m)]
            return SensDiscreteDistribution(
                t=self._t_now, states=self._space.states(), p=vals[0],
                dp=np.stack(vals[1:]),
                bounds=self.constraints.bounds.copy(),
                sinks=self._base_sinks(self._y).cpu().numpy())
