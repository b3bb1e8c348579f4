"""FspSolverMultiSinks: the transient FSP driver.

Counterpart of ``pacmensl_tpu/fsp/solver.py`` (reference
``src/Fsp/FspSolverMultiSinks.{h,cpp}``) on the dense-box backend with the
Krylov integrator (time-invariant models) and the BDF integrator with
matrix-free GMRES (time-varying models).  It owns the constrained state space, the CME operator
and the integrator, and runs the solve -> check sinks -> expand -> scatter
-> resume loop (``Advance_``, FspSolverMultiSinks.cpp:62-224):

  * ``CheckFspTolerance_`` (:576-611) -> the per-sink stop-check called by
    the integrator after every step; expansion flags come back as the
    running max of per-sink excesses (SolveResult.viol_excess);
  * state-space expansion -> bound growth and a mask/BFS rebuild;
  * ``ExpandVec`` (PetscWrap.cpp:26-56) -> a zero-pad embedding when the
    box capacity grows, nothing within capacity;
  * PETSc event logging -> :class:`~..sys.events.EventLog` with the same
    phase names.

With a ``mesh`` (:func:`~..parallel.mesh.make_mesh`) the box is split
into axis-0 slabs over the ranks of a ``torch.distributed`` group, as the
reference splits its state set over MPI ranks: every rank runs this
solver, holds the whole state space and its slab of every box vector,
and decides from all-reduced values only (``ops/vecops.py``), so all take
the same steps.  Axis 0 of the capacity is padded to a multiple of the
rank count; expansion gathers ``p``, embeds it and takes the new slab;
the distribution is gathered on every rank.

The compressed (ELL) backend, the RK and CN integrators and the axis
reordering of the reference package are not ported yet (ROADMAP): where
the reference package would migrate to the ELL backend, this driver
raises :class:`StateSpaceError`.
"""
from __future__ import annotations

import time
import warnings
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device
from ..models.model import Model
from ..sys.errors import SetupError, IntegratorError, StateSpaceError
from ..sys.events import (EventLog, StepTrace, EVT_SETUP, EVT_PARTITION,
                          EVT_MATGEN, EVT_ODESOLVE, EVT_RHS, EVT_SCATTER,
                          EVT_TOTAL, EVT_STEPS, EVT_REJECTED)
from ..statespace.constraints import ConstraintSet
from ..statespace.box_space import (BoxStateSpace, MAX_BOX_ELEMS,
                                    _round_capacity)
from ..ops.box_operator import BoxOperator
from ..ops import vecops as vo
from ..ops.vecops import FspVector
from ..parallel.mesh import gather_global, shard_fsp_vector
from ..solvers.base import ODESolverType, STATUS_OK, STATUS_FSP_STOP
from ..solvers.bdf import BdfSolver
from ..solvers.krylov import KrylovSolver
from .distribution import DiscreteDistribution

#: vector-memory budget on the host, in bytes (the reference package's
#: default); on a CUDA device the budget is half the device memory
_HOST_MEM_BUDGET = 8.0e9


class FspSolverMultiSinks:
    """Transient CME solver with multi-sink adaptive FSP truncation."""

    def __init__(self,
                 backend: str = "box",
                 odes_type: Union[ODESolverType, str] = "auto",
                 device=None, mesh=None):
        """``device`` defaults to the mesh's where a ``mesh`` is given,
        else to ``"cuda"``."""
        if backend not in ("box", "auto"):
            raise SetupError(
                f"backend {backend!r} is not ported yet: only the dense box "
                "backend exists (compressed ELL backend: ROADMAP A9)")
        self.backend = backend
        self._device_arg = device
        self.set_mesh(mesh)
        self.dtype = DEFAULT_DTYPE
        self.set_odes_type(odes_type)

        self.model: Optional[Model] = None
        self.constraints: Optional[ConstraintSet] = None
        self._init_states: Optional[np.ndarray] = None
        self._init_probs: Optional[np.ndarray] = None
        self._pending_constraint_fn = None
        self.krylov_dim_range = (25, 60)
        self.ode_rtol: Optional[float] = None
        self.ode_atol = 1.0e-14
        self.verbosity = 0
        self.events = EventLog()
        self.step_trace = StepTrace()

        self._space: Optional[BoxStateSpace] = None
        self._operator: Optional[BoxOperator] = None
        self._ode_solver: Optional[Union[KrylovSolver, BdfSolver]] = None
        self._ode_solver_key = None
        self._y: Optional[FspVector] = None
        self._t_now = 0.0
        self._t_prev_epoch: Optional[float] = None
        self._set_up = False
        self.sinks_: Optional[np.ndarray] = None

    # ---------------------------------------------------------- settings
    def set_mesh(self, mesh) -> "FspSolverMultiSinks":
        """Split the box over ``mesh``'s ranks (None: one device), the
        analogue of the reference running on several MPI ranks."""
        dev = self._device_arg
        if mesh is not None:
            if dev is not None and resolve_device(dev) != mesh.device:
                raise SetupError(f"device {dev!r} is not the mesh's device "
                                 f"{mesh.device}")
            dev = mesh.device
        self.mesh = mesh
        self.device = resolve_device("cuda" if dev is None else dev)
        self._set_up = False
        return self

    def set_model(self, model) -> "FspSolverMultiSinks":
        self.model = model
        return self

    def set_constraints(self, fn, bounds, expansion_factors=None
                        ) -> "FspSolverMultiSinks":
        """Custom constraint function + bounds (reference
        SetConstraintFunctions + SetInitialBounds)."""
        ns = self.model.num_species if self.model is not None else None
        self.constraints = ConstraintSet(fn, bounds, expansion_factors, ns)
        self._set_up = False
        return self

    def set_constraint_functions(self, fn) -> "FspSolverMultiSinks":
        """Set only the constraint function, keeping bounds if present
        (call before set_initial_bounds when the custom constraint count
        differs from the species count)."""
        if self.constraints is not None:
            self.constraints = ConstraintSet(
                fn, self.constraints.bounds,
                self.constraints.expansion_factors)
        else:
            self._pending_constraint_fn = fn
        self._set_up = False
        return self

    def set_initial_bounds(self, bounds) -> "FspSolverMultiSinks":
        """Constraint bounds; coordinate-wise constraints unless a custom
        function was set."""
        fn = self._pending_constraint_fn
        if self.constraints is not None and self.constraints.fn is not None:
            fn = self.constraints.fn
        if fn is not None:
            factors = (self.constraints.expansion_factors
                       if self.constraints is not None and
                       len(self.constraints.expansion_factors) == len(bounds)
                       else None)
            self.constraints = ConstraintSet(fn, bounds, factors)
        else:
            ns = self.model.num_species if self.model is not None else None
            self.constraints = ConstraintSet(None, bounds, None, ns)
        self._set_up = False
        return self

    def set_expansion_factors(self, factors) -> "FspSolverMultiSinks":
        if self.constraints is None:
            raise SetupError("set bounds before expansion factors")
        self.constraints = ConstraintSet(
            self.constraints.fn, self.constraints.bounds, factors,
            self.constraints.num_species)
        return self

    def set_initial_distribution(self, x0, p0=None) -> "FspSolverMultiSinks":
        """Initial states + probabilities, or a distribution to restart
        from (anything with ``states``, ``p`` and ``bounds``, such as a
        :class:`DiscreteDistribution` of either package)."""
        if hasattr(x0, "states") and hasattr(x0, "p"):
            self._init_states = np.atleast_2d(
                np.asarray(x0.states, dtype=np.int64))
            self._init_probs = np.asarray(x0.p, dtype=np.float64).reshape(-1)
            bounds = getattr(x0, "bounds", None)
            # restart adopts the snapshot's FSP bounds so its states fit
            if bounds is not None and self.constraints is not None \
                    and len(bounds) == len(self.constraints.bounds):
                self.constraints = self.constraints.with_bounds(
                    np.maximum(self.constraints.bounds, bounds))
        else:
            self._init_states = np.atleast_2d(np.asarray(x0, dtype=np.int64))
            if p0 is None:
                raise SetupError("p0 required with explicit states")
            self._init_probs = np.asarray(p0, dtype=np.float64).reshape(-1)
        if self._init_probs.shape[0] != self._init_states.shape[0]:
            raise SetupError("x0/p0 length mismatch")
        self._set_up = False
        return self

    def set_odes_type(self, odes_type) -> "FspSolverMultiSinks":
        """Pick the integrator; ``"auto"`` resolves at set-up to KRYLOV for
        time-invariant models and CVODE (BDF) for time-varying ones, as in
        the reference package.  PETSC (RK, CN) is not ported yet."""
        if isinstance(odes_type, str) and odes_type.strip().lower() == "auto":
            self.odes_type = "auto"
            return self
        self.odes_type = (odes_type if isinstance(odes_type, ODESolverType)
                          else ODESolverType.from_string(str(odes_type)))
        return self

    def _resolve_odes_type(self) -> ODESolverType:
        if self.odes_type != "auto":
            if self.odes_type in (ODESolverType.KRYLOV, ODESolverType.EPIC) \
                    and self.model is not None and self.model.tv_reactions:
                warnings.warn(
                    "KRYLOV on a time-varying model freezes c(t) at each "
                    "step's midpoint; use CVODE for tight tolerances",
                    RuntimeWarning, stacklevel=3)
            return self.odes_type
        return (ODESolverType.CVODE
                if self.model is not None and self.model.tv_reactions
                else ODESolverType.KRYLOV)

    def set_ode_tolerances(self, rtol, atol) -> "FspSolverMultiSinks":
        """BDF tolerances (``rtol=None`` keeps the integrator's default)."""
        self.ode_rtol = None if rtol is None else float(rtol)
        self.ode_atol = float(atol)
        self._ode_solver = None
        return self

    def set_krylov_dim_range(self, m_min, m_max) -> "FspSolverMultiSinks":
        self.krylov_dim_range = (int(m_min), int(m_max))
        return self

    def set_verbosity(self, level: int) -> "FspSolverMultiSinks":
        self.verbosity = int(level)
        return self

    # -------------------------------------------------------------- setup
    def _box_elem_budget(self) -> float:
        """Box elements the integrator's vectors may take (reference
        ``_box_elem_budget``): the Krylov integrator keeps m_max + 2
        box-sized vectors alive; BDF its GMRES basis (restart + 1), the
        difference array (q_max + 3) and its work vectors with a margin,
        the reference package's count."""
        if self.device.type == "cuda":
            mem = 0.5 * torch.cuda.get_device_properties(
                self.device).total_memory
        else:
            mem = _HOST_MEM_BUDGET
        if self._resolve_odes_type() in (ODESolverType.KRYLOV,
                                         ODESolverType.EPIC):
            vecs = self.krylov_dim_range[1] + 2
        else:
            restart = BdfSolver.__init__.__kwdefaults__["gmres_restart"]
            vecs = restart + 1 + 8 + 11
        return mem / (vecs * torch.finfo(self.dtype).bits / 8)

    def _choose_backend(self) -> str:
        return "box"

    def _should_leave_box(self, new_bounds) -> bool:
        """The reference package's test (``_should_leave_box``) for
        migrating to the compressed backend: the grown box's fresh
        capacity would exceed the memory budget, or the constraint set
        fills under 0.1% of a large box."""
        cs_new = self.constraints.with_bounds(new_bounds)
        box = cs_new.derive_box_bounds(self.model.num_species,
                                       self._init_states)
        need = [_round_capacity(int(b) + 1, int(q))
                for b, q in zip(box, self.pad_quanta_for_space())]
        cap = float(np.prod(np.asarray(need, np.float64)))
        if cap > min(float(MAX_BOX_ELEMS), self._box_elem_budget()):
            return True
        tight_new = float(np.prod(np.asarray(box, np.float64) + 1.0))
        box_cur = self.constraints.derive_box_bounds(
            self.model.num_species, self._init_states)
        tight_cur = float(np.prod(np.asarray(box_cur, np.float64) + 1.0))
        return tight_new > 2.0e6 and \
            self._space.num_states < 0.001 * tight_cur

    def set_up(self) -> "FspSolverMultiSinks":
        if self.model is None:
            raise SetupError("SetUp called before model was set")
        if self.constraints is None:
            raise SetupError("SetUp called before bounds were set")
        if self._init_states is None:
            raise SetupError("SetUp called before initial distribution")
        if self._init_states.shape[1] != self.model.num_species:
            raise SetupError("initial states do not match model species")
        odes = self._resolve_odes_type()
        if odes == ODESolverType.PETSC:
            raise SetupError(
                "ODE solver 'petsc' (RK, CN) is not ported yet (ROADMAP "
                "A8); use odes_type='cvode' or 'krylov'")

        self._ode_solver = None
        self._operator = None
        with self.events.timed(EVT_SETUP):
            self._backend_used = self._choose_backend()
            with self.events.timed(EVT_PARTITION):
                self._build_space()
            with self.events.timed(EVT_MATGEN):
                self._build_operator()
            self._y = self._initial_vector()
        self._set_up = True
        return self

    def pad_quanta_for_space(self) -> np.ndarray:
        """Capacity quanta per axis: axis 0 divides by the rank count."""
        pad_quanta = np.ones(self.model.num_species, np.int64)
        if self.mesh is not None:
            pad_quanta[0] = self.mesh.size
        return pad_quanta

    def _build_space(self):
        self._space = BoxStateSpace(self.model.stoichiometry,
                                    self.constraints, self._init_states,
                                    device=self.device,
                                    pad_quanta=self.pad_quanta_for_space())
        self._space.events = self.events   # MaskBFS sub-timer

    def _build_operator(self):
        self._ode_solver = None     # its basis has the old capacity
        self._operator = None       # free the old fields first
        self._operator = BoxOperator(self.model, self._space,
                                     dtype=self.dtype, mesh=self.mesh)
        if self._operator.sharded is not None:
            self.events.add_count(
                "HaloValuesPerMatvec",
                self._operator.sharded.comm_values_per_matvec())
        if self.verbosity:
            print(f"[fsp] box operator: capacity {tuple(self._space.shape)}"
                  f" ({float(np.prod(self._space.shape)):.3g} elems)",
                  flush=True)

    def _initial_vector(self) -> FspVector:
        idx = self._space.state2index(self._init_states)
        if (idx < 0).any():
            raise StateSpaceError(
                "initial states outside the FSP state space")
        n_c = self.constraints.num_constraints
        p = np.zeros(self._space.size, dtype=np.float64)
        p[idx] = self._init_probs
        self.sinks_ = np.zeros((n_c,), np.float64)
        return self._place(FspVector(
            p=torch.as_tensor(p, dtype=self.dtype, device=self.device),
            sinks=torch.zeros(n_c, dtype=self.dtype, device=self.device)))

    def _place(self, y: FspVector) -> FspVector:
        """This rank's part of a vector over the whole box: its slab of
        ``p``, so only the owner of a state holds its mass."""
        if self.mesh is None:
            return y
        return shard_fsp_vector(y, self._space.shape, self.mesh)

    def _global_p(self) -> torch.Tensor:
        """``p`` over the whole box (gathered from every rank)."""
        if self.mesh is None:
            return self._y.p
        return gather_global(self._y.p, self.mesh)

    # -------------------------------------------------------------- solve
    def _make_ode_solver(self, fsp_tol: float, t_final: float):
        n_sinks = self.constraints.num_constraints

        if fsp_tol > 0:
            def stop_check(t, y, forgiven):
                # reference CheckFspTolerance_ (FspSolverMultiSinks.cpp:
                # 576-611): sink_i exceeds its share of the tolerance
                # budget pro-rated by t/t_final.  ``forgiven`` subtracts
                # the excess already lost when the epoch started: growing
                # the space cannot reclaim it, so re-tripping on it would
                # stop every resumed epoch on its first step.  p's sinks
                # lead y's (the closure holds no reference to the driver,
                # so a dropped solver is freed at once)
                sinks = y.sinks[:n_sinks].cpu().numpy()      # host sync
                excess = sinks * n_sinks - fsp_tol * (t / t_final)
                if forgiven is not None:
                    excess = excess - forgiven
                return excess
        else:
            stop_check = None

        odes = self._resolve_odes_type()
        if odes in (ODESolverType.KRYLOV, ODESolverType.EPIC):
            return KrylovSolver(self._operator.action,
                                m_min=self.krylov_dim_range[0],
                                m_max=self.krylov_dim_range[1],
                                rhs_cost=self._operator.local_mv_flops(),
                                stop_check=stop_check, n_sinks=n_sinks)
        if odes == ODESolverType.CVODE:
            return BdfSolver(self._operator.action,
                             rtol=self.ode_rtol, atol=self.ode_atol,
                             stop_check=stop_check, n_sinks=n_sinks)
        raise SetupError(
            f"ODE solver {odes.value!r} is not ported yet (RK/CN: ROADMAP "
            "A8)")

    def _expand(self, to_expand: np.ndarray, rounds: int = 1):
        """Grow the flagged bounds, rebuild the mask, and rebuild the
        operator only if the box capacity grew (reference Advance_
        expansion block, :114-211)."""
        new_bounds = self.constraints.expanded_bounds(to_expand)
        for _ in range(rounds - 1):      # escalated growth (thrash guard)
            new_bounds = self.constraints.with_bounds(
                new_bounds).expanded_bounds(to_expand)
        if self.verbosity:
            print(f"[fsp] t = {self._t_now:.4g}: expanding to bounds "
                  f"{new_bounds.tolist()}")
        with self.events.timed("LeaveBoxCheck"):
            leave = self._should_leave_box(new_bounds)
        if leave:
            raise StateSpaceError(
                f"at t = {self._t_now:.6g} the box for bounds "
                f"{new_bounds.tolist()} outgrows the box backend's memory "
                "budget or fill floor; the reference package migrates to "
                "the compressed (ELL) backend there, which is not ported "
                "yet (ROADMAP A9)")
        n_before = self._space.num_states
        with self.events.timed(EVT_PARTITION):
            old_shape = self._space.shape
            self._space.set_bounds(new_bounds)
            self.constraints = self._space.constraints
            self._escalate_if_stuck(n_before, to_expand)
            capacity_grew = tuple(self._space.shape) != tuple(old_shape)
        with self.events.timed(EVT_MATGEN):
            if capacity_grew:
                self._build_operator()
            else:
                self._operator.refresh_data()
        with self.events.timed(EVT_SCATTER):
            if capacity_grew:
                # within capacity the newly valid states already hold
                # zeros
                self._y = self._embed_old(old_shape)
        if self.verbosity:
            print(f"[fsp] new state count: {self.num_states}")

    def _embed_old(self, old_shape) -> FspVector:
        """The solution zero-padded from the box of ``old_shape`` into
        the grown one; a sharded p is gathered, embedded and re-sliced."""
        return self._place(FspVector(
            p=self._space.embed_old(self._global_p(), old_shape),
            sinks=self._y.sinks))

    def _base_sinks(self, y: FspVector) -> torch.Tensor:
        """The sinks of the probability part of ``y``, the ones the
        stop-check and the expansion read: its leading ``n_c`` sinks (all
        of them in a transient solve; a sensitivity solve's stacked
        vector holds the sensitivities' after them)."""
        return y.sinks[:self.constraints.num_constraints]

    def _escalate_if_stuck(self, n_before: int, to_expand) -> None:
        """If growing the flagged bounds added no states, grow all bounds
        until the space does grow.  A flagged bound can be unreachable
        because other constraints cap it (a product constraint capped by
        the coordinate bounds); the reference would grow it forever
        without admitting a state."""
        if self._space.num_states > n_before:
            return
        growable = self.constraints.expansion_factors > 0.0
        for _ in range(64):
            new_bounds = self.constraints.expanded_bounds(growable)
            self._space.set_bounds(new_bounds)
            self.constraints = self._space.constraints
            if self._space.num_states > n_before:
                return
        raise StateSpaceError(
            "FSP expansion cannot add states: all growable bounds "
            f"exhausted (bounds={self.constraints.bounds.tolist()})")

    def _advance(self, t_final: float, fsp_tol: float) -> None:
        """The solve/check/expand loop (reference Advance_).

        Consecutive epochs that advance time by under 1% of the interval
        compound the growth (up to 4 rounds per expansion), as in the
        reference package; the truncation guarantee does not depend on the
        growth schedule."""
        t_start = self._t_now
        rapid = 0
        with self.events.timed(EVT_TOTAL), vo.reductions_over(self.mesh):
            status = STATUS_FSP_STOP
            solver_key = (fsp_tol, t_final)
            if self._ode_solver_key != solver_key:
                self._ode_solver = None
            while status == STATUS_FSP_STOP:
                if self._ode_solver is None:
                    self._ode_solver = self._make_ode_solver(fsp_tol,
                                                             t_final)
                    self._ode_solver_key = solver_key
                solver = self._ode_solver
                if fsp_tol > 0:
                    t_fg = time.perf_counter()
                    # already-lost sink mass beyond the pro-rated budget at
                    # epoch start, forgiven by the stop-check.  The slack
                    # keeps the resumed excess strictly negative, so
                    # rounding cannot re-trip the stop on the first step;
                    # it loosens the bound by at most 1e-3 * fsp_tol plus
                    # a few ulps of the sink scale.
                    n_sinks = self.constraints.num_constraints
                    sinks_now = (np.asarray(self.sinks_, np.float64)
                                 if self.sinks_ is not None else
                                 self._base_sinks(self._y).cpu().numpy())
                    excess_now = (sinks_now * n_sinks -
                                  fsp_tol * (self._t_now / t_final))
                    eps = float(torch.finfo(self.dtype).eps)
                    slack = (64.0 * eps * np.maximum(np.abs(sinks_now)
                                                     * n_sinks, fsp_tol)
                             + 1.0e-3 * fsp_tol / n_sinks)
                    forgiven = np.maximum(0.0, excess_now) + slack
                    self.events.add("StopCheckPrep",
                                    time.perf_counter() - t_fg)
                else:
                    forgiven = None
                with self.events.timed(EVT_ODESOLVE):
                    res = solver.solve(self._y, self._t_now, t_final,
                                       stop_aux=forgiven)
                status = res.status
                if status not in (STATUS_OK, STATUS_FSP_STOP):
                    raise IntegratorError(
                        f"ODE solver failed (status {status}) at "
                        f"t = {res.t}")
                self._y = res.y
                self._t_now = float(res.t)
                with self.events.timed("HostFetch"):
                    self.sinks_ = self._base_sinks(res.y).cpu().numpy()
                self.step_trace.record_epoch(
                    res.stats.n_steps,
                    res.trace.arrays() if res.trace is not None else None,
                    self.num_states)
                n_mv = res.stats.n_matvecs
                self.events.add_count(
                    EVT_RHS, n_mv,
                    flops=n_mv * self._operator.local_mv_flops())
                self.events.add_count(EVT_STEPS, res.stats.n_steps)
                self.events.add_count(EVT_REJECTED, res.stats.n_rejected)
                if status == STATUS_FSP_STOP:
                    viol = np.asarray(res.viol_excess)
                    to_expand = viol >= 0.0
                    if not to_expand.any():
                        to_expand[np.argmax(viol)] = True
                    t_before = (self._t_prev_epoch
                                if self._t_prev_epoch is not None
                                else t_start)
                    if self._t_now - t_before < \
                            0.01 * max(t_final - t_start, 1e-300):
                        rapid += 1
                    else:
                        rapid = 0
                    self._t_prev_epoch = self._t_now
                    self._expand(to_expand, rounds=min(1 + rapid, 4))

    def solve(self, t_final: float, fsp_tol: float = 1.0e-4,
              t_init: float = 0.0) -> DiscreteDistribution:
        """Reference Solve (FspSolverMultiSinks.cpp:619-643)."""
        if not self._set_up:
            self.set_up()
        self._y = self._initial_vector()
        self._t_now = float(t_init)
        self._advance(float(t_final), float(fsp_tol))
        return self._make_distribution()

    def solve_tspan(self, tspan: Sequence[float], fsp_tol: float = 1.0e-4,
                    t_init: float = 0.0) -> List[DiscreteDistribution]:
        """Reference SolveTspan: outputs at each time point, advancing
        segment by segment."""
        if not self._set_up:
            self.set_up()
        self._y = self._initial_vector()
        self._t_now = float(t_init)
        out = []
        for t in tspan:
            self._advance(float(t), float(fsp_tol))
            out.append(self._make_distribution())
        return out

    def clear_state(self) -> None:
        self._set_up = False
        self._space = None
        self._operator = None
        self._ode_solver = None
        self._y = None

    # ------------------------------------------------------------ output
    @property
    def num_states(self) -> int:
        return self._space.num_states if self._space is not None else 0

    def _make_distribution(self) -> DiscreteDistribution:
        with self.events.timed("DistributionExtract"):
            return DiscreteDistribution(
                t=self._t_now, states=self._space.states(),
                p=self._space.extract_valid(self._global_p()),
                bounds=self.constraints.bounds.copy(),
                sinks=self._y.sinks.cpu().numpy())

    def get_event_log(self) -> EventLog:
        return self.events

    def reduce_component_timing(self):
        """Reference ReduceComponentTiming parity."""
        return self.events.reduce()

    # CamelCase aliases for users coming from the reference
    SetMesh = set_mesh
    SetModel = set_model
    SetInitialBounds = set_initial_bounds
    SetConstraintFunctions = set_constraint_functions
    SetExpansionFactors = set_expansion_factors
    SetInitialDistribution = set_initial_distribution
    SetOdesType = set_odes_type
    SetKrylovDimRange = set_krylov_dim_range
    SetOdeTolerances = set_ode_tolerances
    SetVerbosity = set_verbosity
    SetUp = set_up
    Solve = solve
    SolveTspan = solve_tspan
    ClearState = clear_state
    ReduceComponentTiming = reduce_component_timing
