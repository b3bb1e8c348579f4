"""SensFspSolverMultiSinks: the forward-sensitivity FSP driver.

Counterpart of ``pacmensl_tpu/sensfsp/sens_solver.py`` (reference
``SensFspSolverMultiSinks``, ``src/SensFsp/SensFspSolverMultiSinks.
{h,cpp}``) on the box and the compressed (ELL) backend, on one device or
over the ranks of a ``mesh`` (every sub-operator sharded, as the
reference package's ``sens_solver.py:73-95`` shards them):
the transient solver's solve -> check sinks -> expand -> resume loop,
integrating the probability and every parameter sensitivity, all vectors
expanded with the same map on growth (reference :333-422), and carried
over together where a box solve migrates to the compressed backend.

The solution is the stacked :class:`~..ops.vecops.FspVector` of
:mod:`..ops.sens_operator` (p then s_1..s_Np, and their sinks); the
stop-check and the expansion read the probability's sinks only
(:meth:`_base_sinks`).  The stacked system is linear, so either
integrator runs it; BDF (CVODE) is the default, as in the reference
package.  The sink check is the transient driver's.

``odes_type="petsc"`` runs the TS method of ``set_ts_type`` on the
stacked vector (RK's and CN's error norms, as BDF's, cover every row).
The box runs in the transient driver's axis order: its operators take the
permuted model (the derivative propensities included), and the reordered
rebuild carries p and every s_j by the same map, the rows of the stacked
vector (reference ``sens_solver.py:207-230``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.model import SensModel
from ..sys.errors import SetupError
from ..ops.sens_operator import SensOperator
from ..solvers.base import ODESolverType
from ..fsp.solver import FspSolverMultiSinks
from .sens_distribution import SensDiscreteDistribution


class SensFspSolverMultiSinks(FspSolverMultiSinks):
    """Forward-sensitivity FSP solver (p plus dp/dtheta_j)."""

    def __init__(self, backend: str = "auto",
                 odes_type=ODESolverType.CVODE, device=None, mesh=None,
                 **kw):
        super().__init__(backend=backend, odes_type=odes_type,
                         device=device, mesh=mesh, **kw)
        self._init_sens: Optional[np.ndarray] = None

    # ---------------------------------------------------------- settings
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
        self._operator = SensOperator(self._model_int, self._space,
                                      dtype=self.dtype, device=self.device,
                                      mesh=self.mesh)
        self._log_halo(self._operator.exchange)

    def _vector_rows(self) -> int:
        return 1 + self.model.num_parameters

    def _init_values(self) -> np.ndarray:
        return np.vstack([self._init_probs[None, :], self._init_sens])

    # ------------------------------------------------------------ output
    def _make_distribution(self) -> SensDiscreteDistribution:
        with self.events.timed("DistributionExtract"):
            states, rows = self._valid_rows()
            return SensDiscreteDistribution(
                t=self._t_now, states=states, p=rows[0], dp=rows[1:],
                bounds=self.constraints.bounds.copy(),
                sinks=self._base_sinks(self._y).cpu().numpy())
