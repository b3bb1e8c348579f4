"""FspSolverMultiSinks: the transient FSP driver.

Counterpart of ``pacmensl_tpu/fsp/solver.py`` (reference
``src/Fsp/FspSolverMultiSinks.{h,cpp}``) on the dense-box and the
compressed backend, with the Krylov integrator (time-invariant models),
the BDF integrator with matrix-free GMRES (time-varying models) and the
reference's pluggable TS methods under ``odes_type="petsc"``
(:meth:`FspSolverMultiSinks.set_ts_type`: Dormand-Prince RK, CN or BDF).
Runtime flags come from :class:`~..sys.options.Options`
(:meth:`FspSolverMultiSinks.set_from_options`).  It owns the constrained state space, the CME operator
and the integrator, and runs the solve -> check sinks -> expand -> scatter
-> resume loop (``Advance_``, FspSolverMultiSinks.cpp:62-224):

  * ``CheckFspTolerance_`` (:576-611) -> the per-sink stop-check called by
    the integrator after every step; expansion flags come back as the
    running max of per-sink excesses (SolveResult.viol_excess);
  * state-space expansion -> bound growth and a mask/BFS rebuild;
  * ``ExpandVec`` (PetscWrap.cpp:26-56) -> a zero-pad embedding when the
    box capacity grows, nothing within capacity;
  * PETSc event logging -> :class:`~..sys.events.EventLog` with the same
    phase names; while :meth:`set_up`, :meth:`solve` and
    :meth:`solve_tspan` run, the log is the active one, so the spans
    below the driver (operator actions, GMRES, host syncs) record into it.

With a ``mesh`` (:func:`~..parallel.mesh.make_mesh`) the box is split
into axis-0 slabs over the ranks of a ``torch.distributed`` group, as the
reference splits its state set over MPI ranks: every rank runs this
solver, holds the whole state space and its slab of every box vector,
and decides from all-reduced values only (``ops/vecops.py``), so all take
the same steps.  Axis 0 of the capacity is padded to a multiple of the
rank count; expansion gathers ``p``, embeds it and takes the new slab;
the distribution is gathered on every rank.

The compressed (ELL) backend (``backend="ell"``,
:class:`~..statespace.state_set.StateSet` and
:class:`~..ops.ell_operator.EllOperator`): its expansion is the state
set's frontier BFS, an optional re-ordering by the partitioner when the
set grew by more than ``lb_threshold``, an operator re-assembly and an
index scatter of the solution.  With a mesh every rank builds the same
state set, from the all-reduced sinks, and holds block ``r`` of the
padded state list (:class:`~..parallel.halo_ell.ShardedEllOperator`);
re-ordering, assembly and scatter run on the gathered vector.  ``backend="auto"``
routes (:meth:`_choose_backend`) and a box solve migrates to the
compressed backend mid-solve (:meth:`_should_leave_box`,
:meth:`_migrate_box_to_ell`) where the box outgrows the memory budget, or
under ``"auto"`` where its fill falls below :data:`BOX_FILL_FLOOR`.

The box lays its species axes out in the reference package's order
(:mod:`..statespace.permute`): by descending extent, derived from the
user-order extents at set-up and again where a capacity outgrowth finds
the order stale (:meth:`_box_reorder_needed`).  The solve then runs on a
permuted model, constraint set and initial states (:attr:`_model_int`,
:attr:`_init_int`), the rebuild carries the solution on the device
(:meth:`_rebuild_box_reordered`), and the output, the compressed backend
and the user's setters see user order.  ``preallocate`` water-fills the
box's capacity up-front (:meth:`_prealloc_budget`).
"""
from __future__ import annotations

import os
import warnings
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device
from ..models.model import Model
from ..sys.errors import SetupError, IntegratorError, StateSpaceError
from ..sys.events import (EventLog, StepTrace, EVT_SETUP, EVT_PARTITION,
                          EVT_MATGEN, EVT_ODESOLVE, EVT_RHS, EVT_SCATTER,
                          EVT_TOTAL, EVT_STEPS, EVT_REJECTED, EVT_REORDER,
                          active)
from ..statespace.constraints import ConstraintSet
from ..statespace.box_space import (BoxStateSpace, MAX_BOX_ELEMS,
                                    _round_capacity, _round_fine)
from ..statespace.permute import (choose_axis_order, permute_box,
                                  permute_constraints, permute_model)
from ..statespace.partitioner import (PartitioningApproach,
                                      PartitioningType, StatePartitioner)
from ..statespace.state_set import StateSet
from ..ops.box_operator import BoxOperator
from ..ops.ell_operator import EllOperator
from ..ops import vecops as vo
from ..ops.vecops import FspVector
from ..parallel.halo_ell import ShardedEllOperator
from ..parallel.mesh import gather_rows, shard_rows, slab_rows
from ..solvers.base import ODESolverType, STATUS_OK, STATUS_FSP_STOP
from ..solvers.bdf import BdfSolver
from ..solvers.cn import CNSolver
from ..solvers.krylov import KrylovSolver
from ..solvers.rk import RKSolver
from ..sys.options import Options
from .distribution import DiscreteDistribution

#: vector-memory budget on the host, in bytes (the reference package's
#: default); on a CUDA device the budget is half the device memory.  The
#: reference package's ``PACMENSL_BOX_MEM_BUDGET`` (bytes) overrides both.
_HOST_MEM_BUDGET = 8.0e9

#: The fill floor: a box solve under ``backend="auto"`` migrates to the
#: compressed backend where its states fill less than this share of the
#: tight box.  It is the ratio of the two backends' costs per matvec,
#: (K3's time per box element) / (the ELL action's time per state),
#: measured by chip_smoke.py phase 10b at the repressilator's final state
#: set on an NVIDIA H100 80GB HBM3 at a 700 W power limit: K3 116.2 us on
#: the 211x316x211 box (8.3 ps per element), the ELL action 239.7 us at
#: 1,193,406 states (201 ps per state), ratio 0.041.  (The reference
#: package's 0.001 was the TPU's ratio.)  The same run puts the
#: repressilator's final fill, 1,193,406 states in 14.07M box elements,
#: at 0.085, above the floor: on a card custom constraints start on the
#: box (:meth:`FspSolverMultiSinks._choose_backend`).
BOX_FILL_FLOOR = 0.041

#: ``odes_type="petsc"``: the TS methods by name (reference TsFsp
#: ``-ts_type``, ``pacmensl_tpu/fsp/solver.py:971-991``)
TS_TYPES = {"rk": RKSolver, "rk45": RKSolver, "dp5": RKSolver,
            "cn": CNSolver, "theta": CNSolver, "trapezoid": CNSolver,
            "bdf": BdfSolver, "beuler": BdfSolver}


class FspSolverMultiSinks:
    """Transient CME solver with multi-sink adaptive FSP truncation."""

    def __init__(self,
                 backend: str = "auto",
                 odes_type: Union[ODESolverType, str] = "auto",
                 device=None, mesh=None, preallocate="auto"):
        """``backend``: ``"box"``, ``"ell"`` or ``"auto"``
        (:meth:`_choose_backend`).  ``device`` defaults to the mesh's
        where a ``mesh`` is given, else to ``"cuda"``.  ``preallocate``:
        the box's capacity, True (eager: water-filled up-front), False or
        ``"auto"`` (the capacity ladder; :meth:`_prealloc_budget`)."""
        if backend not in ("box", "ell", "auto"):
            raise SetupError(f"unknown backend {backend!r} (box, ell or "
                             "auto)")
        if preallocate not in (True, False, "auto"):
            raise SetupError(f"unknown preallocate {preallocate!r} (True, "
                             "False or 'auto')")
        self.backend = backend
        self.preallocate = preallocate
        self._device_arg = device
        self.set_mesh(mesh)
        self.dtype = DEFAULT_DTYPE
        self.set_odes_type(odes_type)
        self.partitioning = PartitioningType.BLOCK
        self.repart_approach = PartitioningApproach.FROMSCRATCH
        #: re-order the compressed state set only when it grew by this
        #: factor since the last ordering (reference lb_threshold_,
        #: StateSetBase.h:111, StateSetConstrained.cpp:213-218)
        self.lb_threshold = 1.2

        self.model: Optional[Model] = None
        self.constraints: Optional[ConstraintSet] = None
        self._init_states: Optional[np.ndarray] = None
        self._init_probs: Optional[np.ndarray] = None
        self._pending_constraint_fn = None
        self.krylov_dim_range = (25, 60)
        self.ode_rtol: Optional[float] = None
        self.ode_atol = 1.0e-14
        self.verbosity = 0
        #: the TS method ``odes_type="petsc"`` runs (:data:`TS_TYPES`)
        self.ts_type = "rk"
        #: record the optional event counts (the halo's values per
        #: matvec) and the spans below the driver; the phase timers
        #: always run
        self.log_events = True
        self.events = EventLog()
        self.step_trace = StepTrace()

        self._backend_used: Optional[str] = None
        self._space: Optional[Union[BoxStateSpace, StateSet]] = None
        self._operator = None
        self._ode_solver: Optional[Union[KrylovSolver, BdfSolver]] = None
        self._ode_solver_key = None
        self._n_last_partition = 0
        self._y: Optional[FspVector] = None
        self._t_now = 0.0
        self._t_prev_epoch: Optional[float] = None
        self._set_up = False
        self.sinks_: Optional[np.ndarray] = None
        #: the box's internal species order (internal axis j = user
        #: species ``_axis_order[j]``) and its inverse; None in user order
        self._axis_order: Optional[np.ndarray] = None
        self._axis_inv: Optional[np.ndarray] = None
        self._int_model: Optional[Model] = None
        self._int_init: Optional[np.ndarray] = None
        #: the user's constraint set while the solve runs a permuted one
        self._user_constraints: Optional[ConstraintSet] = None
        #: every axis order the box took since set-up: ``(t, order)``, t
        #: None at set-up and the epoch's time at each reordered rebuild
        #: (the identity where user order applies)
        self.axis_orders_: List[tuple] = []

    # ---------------------------------------------------------- settings
    def set_mesh(self, mesh) -> "FspSolverMultiSinks":
        """Split the state space over ``mesh``'s ranks (None: one
        device), the analogue of the reference running on several MPI
        ranks: the box into axis-0 slabs, the compressed state list into
        contiguous blocks."""
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
        self._restore_user_order()
        ns = self.model.num_species if self.model is not None else None
        self.constraints = ConstraintSet(fn, bounds, expansion_factors, ns)
        self._set_up = False
        return self

    def set_constraint_functions(self, fn) -> "FspSolverMultiSinks":
        """Set only the constraint function, keeping bounds if present
        (call before set_initial_bounds when the custom constraint count
        differs from the species count)."""
        self._restore_user_order()
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
        self._restore_user_order()
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
        the reference package.  PETSC runs the TS method of
        :meth:`set_ts_type`."""
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

    def set_ts_type(self, name: str) -> "FspSolverMultiSinks":
        """The TS method of ``odes_type="petsc"`` (reference
        ``TsFsp::SetTsType``, ``-ts_type``): ``"rk"`` (explicit
        Dormand-Prince 5(4); also ``"rk45"``, ``"dp5"``), ``"cn"``
        (trapezoid with matrix-free GMRES; also ``"theta"``,
        ``"trapezoid"``) or ``"bdf"`` (also ``"beuler"``).  An unknown name
        raises :class:`SetupError` at set-up."""
        self.ts_type = str(name).strip().lower()
        self._ode_solver = None
        return self

    def set_from_options(self, opts: Optional[Options] = None
                         ) -> "FspSolverMultiSinks":
        """Settings from PETSc-style options (reference SetFromOptions,
        FspSolverMultiSinks.cpp:523-574; default: ``sys.argv``), the keys
        of ``pacmensl_tpu/fsp/solver.py:270-292``."""
        opts = opts or Options.from_argv()
        if opts.has("fsp_partitioning_type"):
            self.set_load_balancing_method(opts.get("fsp_partitioning_type"))
        if opts.has("fsp_repart_approach"):
            self.set_repart_approach(opts.get("fsp_repart_approach"))
        if opts.has("fsp_verbosity"):
            self.verbosity = opts.get_int("fsp_verbosity")
        if opts.has("fsp_log_events"):
            self.log_events = opts.get_bool("fsp_log_events")
        if opts.has("fsp_odes_type"):
            self.set_odes_type(opts.get("fsp_odes_type"))
        if opts.has("ts_type"):
            self.set_ts_type(opts.get("ts_type"))
        if opts.has("fsp_backend"):
            backend = opts.get("fsp_backend")
            if backend not in ("box", "ell", "auto"):
                raise SetupError(f"unknown backend {backend!r} (box, ell "
                                 "or auto)")
            self.backend = backend
            self._set_up = False
        if opts.has("ode_rtol") or opts.has("ode_atol"):
            self.set_ode_tolerances(opts.get_float("ode_rtol", self.ode_rtol),
                                    opts.get_float("ode_atol", self.ode_atol))
        return self

    def set_verbosity(self, level: int) -> "FspSolverMultiSinks":
        self.verbosity = int(level)
        return self

    def set_load_balancing_method(self, ptype) -> "FspSolverMultiSinks":
        """The compressed state set's ordering (reference
        ``SetLoadBalancingMethod``): BLOCK keeps the insertion order,
        GRAPH and HYPERGRAPH re-order it for locality."""
        self.partitioning = (ptype if isinstance(ptype, PartitioningType)
                             else PartitioningType.from_string(str(ptype)))
        if self.partitioning == PartitioningType.HIERARCHICAL:
            raise SetupError("HIERARCHICAL partitioning is not supported "
                             "(unsupported in the reference as well)")
        return self

    def set_repart_approach(self, approach) -> "FspSolverMultiSinks":
        """How a re-ordering treats the existing order (reference
        ``PartitioningApproach``): FROMSCRATCH recomputes it,
        REPARTITION and REFINE keep it."""
        self.repart_approach = (
            approach if isinstance(approach, PartitioningApproach)
            else PartitioningApproach.from_string(str(approach)))
        return self

    # -------------------------------------------------------------- setup
    def _box_elem_budget(self) -> float:
        """Box elements the integrator's vectors may take (reference
        ``_box_elem_budget``): the Krylov integrator keeps m_max + 2
        box-sized vectors alive; every other integrator is counted as BDF
        is, the reference package's count (its non-Krylov branch): the
        GMRES basis (restart + 1), the difference array (q_max + 3) and
        work vectors with a margin.  RK holds its seven stages and a few
        temporaries, CN two GMRES bases in turn, both within that count:
        RK's solve of the repressilator to t = 10 peaked at 1.58 GiB of
        device memory, Krylov's at 7.24 (chip_smoke.py 11a and phase 4 on
        an H100 80GB HBM3 at 700 W)."""
        if "PACMENSL_BOX_MEM_BUDGET" in os.environ:
            mem = float(os.environ["PACMENSL_BOX_MEM_BUDGET"])
        elif self.device.type == "cuda":
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
        """``"auto"``: the box, unless the constraints are custom and the
        box does not pay on this device, or the box would not fit the
        memory budget (reference ``_choose_backend``).  On the host,
        custom constraints go to the compressed backend, as in the
        reference package off the TPU.  On a card they start on the box,
        and :meth:`_should_leave_box` moves the solve to the compressed
        backend once its fill falls below :data:`BOX_FILL_FLOOR`.  A mesh
        follows the same rule on its device."""
        if self.backend != "auto":
            return self.backend
        if self.constraints.fn is not None and self.device.type != "cuda":
            return "ell"
        box = self.constraints.derive_box_bounds(self.model.num_species,
                                                 self._init_states)
        size = float(np.prod(np.asarray(box, np.float64) + 1.0))
        if size > min(float(MAX_BOX_ELEMS), self._box_elem_budget()):
            return "ell"
        return "box"

    def _should_leave_box(self, new_bounds) -> bool:
        """Whether a box solve migrates to the compressed backend before
        growing to ``new_bounds`` (reference ``_should_leave_box``): the
        grown box's fresh capacity would exceed the memory budget, or,
        under ``backend="auto"`` only, the constraint set fills less than
        the fill floor of the tight box of the current bounds, which is
        large (over 2e6 elements after growth).  A solve with
        ``backend="box"`` keeps the box above the floor: the floor is a
        speed choice, the budget a limit."""
        if self._backend_used != "box":
            return False
        cs_new = self.constraints.with_bounds(new_bounds)
        box = cs_new.derive_box_bounds(self.model.num_species,
                                       self._init_int)
        rnd = self._capacity_rounding()
        need = [rnd(int(b) + 1, int(q))
                for b, q in zip(box, self.pad_quanta_for_space())]
        cap = float(np.prod(np.asarray(need, np.float64)))
        if cap > self._capacity_budget():
            return True
        if self.backend != "auto":
            return False
        tight_new = float(np.prod(np.asarray(box, np.float64) + 1.0))
        box_cur = self.constraints.derive_box_bounds(
            self.model.num_species, self._init_int)
        tight_cur = float(np.prod(np.asarray(box_cur, np.float64) + 1.0))
        return tight_new > 2.0e6 and \
            self._space.num_states < BOX_FILL_FLOOR * tight_cur

    def _capacity_rounding(self):
        """The box's rounding of an extent to a capacity axis: eager
        capacity's multiples of 8, else the ladder."""
        return (_round_fine if getattr(self._space, "prealloc_budget", None)
                is not None else _round_capacity)

    def _capacity_budget(self) -> float:
        """Box elements the capacity may take: eager capacity's budget
        (a share per row of the solution), else the element budget."""
        pre = getattr(self._space, "prealloc_budget", None)
        return (pre if pre is not None
                else min(float(MAX_BOX_ELEMS), self._box_elem_budget()))

    def _box_reorder_needed(self, new_bounds) -> bool:
        """Whether growing the box to ``new_bounds`` rebuilds it in a new
        axis order (reference ``_box_reorder_needed``, conditions (a) and
        (b); (c) is the TPU tile budget's): the grown extents outgrow the
        capacity, and (a) the order derived from the grown user-order
        extents is not the current one, or (b) growing in the current
        order would exceed the element budget while a fresh build fits.
        (a) compares orders derived from user-order extents: the
        reference package derives one from the internal extents, and on
        tied extents :func:`~..statespace.permute.choose_axis_order`
        names another permutation of the ties, so it rebuilds at every
        outgrowth with an identity transpose."""
        if self._backend_used != "box":
            return False
        S = self.model.num_species
        box = self.constraints.with_bounds(new_bounds).derive_box_bounds(
            S, self._init_int)
        ext = np.asarray(box, np.int64) + 1
        if all(int(e) <= int(c) for e, c in zip(ext, self._space.shape)):
            return False        # within capacity: no rebuild
        inv = np.argsort(self._current_order())
        if not np.array_equal(self._order_for(ext[inv]),
                              self._current_order()):
            return True
        quanta = self.pad_quanta_for_space()
        budget = self._capacity_budget()
        rnd = self._capacity_rounding()
        clamped = [max(rnd(int(e), int(q)), int(c))
                   for e, q, c in zip(ext, quanta, self._space.shape)]
        fresh = [rnd(int(e), int(q)) for e, q in zip(ext, quanta)]
        return (float(np.prod(np.asarray(clamped, np.float64))) > budget
                >= float(np.prod(np.asarray(fresh, np.float64))))

    @staticmethod
    def _order_for(user_extents) -> np.ndarray:
        """The box's axis order for these user-order extents (the
        identity where :func:`choose_axis_order` keeps user order)."""
        order = choose_axis_order(user_extents)
        return (np.arange(len(user_extents), dtype=np.int64)
                if order is None else order)

    def _current_order(self) -> np.ndarray:
        return (self._axis_order if self._axis_inv is not None
                else np.arange(self.model.num_species, dtype=np.int64))

    def _rebuild_box_reordered(self, new_bounds, n_before, to_expand
                               ) -> None:
        """Rebuild the box at ``new_bounds`` in the order derived from
        them, and carry every row of the solution over on the device
        (reference ``_reorder_prep`` + ``_rebuild_box_reordered``): a
        state's coordinates are its identity, so the old box embeds into
        the new one as slice, permute, zero-pad
        (:func:`~..statespace.permute.permute_box`), each value keeping
        its bits.  The new space is built with the old extents as a floor
        and its BFS seeded with the transposed old mask, which is then
        unioned in (:meth:`BoxStateSpace.absorb_mask`): a fresh closure
        can miss states an earlier one held.  Over a mesh the rows are
        gathered, permuted and cut into slabs again."""
        if self.verbosity:
            print(f"[fsp] t = {self._t_now:.4g}: re-deriving the box's axis "
                  "order at capacity growth")
        old = self._space
        E1 = np.asarray(old._box_bounds, np.int64) + 1   # internal extents
        o1 = self._current_order()
        with self.events.timed(EVT_MATGEN):
            rows = self._global_p().view(self._vector_rows(), *old.shape)
            sinks, old_mask = self._y.sinks, old.mask
            self._y = self._space = self._operator = self._ode_solver = None
            self._restore_user_order()
            self.constraints = self.constraints.with_bounds(new_bounds)
            o2 = self._order_for(self.constraints.derive_box_bounds(
                self.model.num_species, self._init_states) + 1)
            # new internal axis j <- old internal axis axes[j]
            inv1 = np.argsort(o1)
            axes = [int(inv1[int(u)]) for u in o2]

            def carried(box, shape):
                return permute_box(box, E1, axes, shape)
            self._build_space(floor=E1[axes],
                              seed_mask_fn=lambda shape: carried(old_mask,
                                                                 shape))
            self._space.absorb_mask(carried(old_mask, self._space.shape))
            self._escalate_if_stuck(n_before, to_expand)
            self._build_operator()
        with self.events.timed(EVT_SCATTER):
            shape = self._space.shape
            p = torch.cat([carried(r, shape).reshape(-1) for r in rows])
            self._y = self._place(FspVector(p=p, sinks=sinks))

    def _migrate_box_to_ell(self) -> None:
        """Switch a running box solve to the compressed backend, carrying
        over its states and every row of its solution (reference package
        ``_migrate_box_to_ell``).  The box's tensors are freed before the
        state set and its operator are built.  Over a mesh every rank
        gathers the slabs and builds the same state set, and then keeps
        its block of it."""
        if self.verbosity:
            print(f"[fsp] t = {self._t_now:.4g}: the box exceeds the "
                  "budget or the fill floor, migrating to the compressed "
                  "backend")
        states, rows = self._valid_rows()          # user order
        sinks = self._y.sinks
        self._y = self._space = self._operator = self._ode_solver = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._restore_user_order()    # the compressed backend's order
        self._backend_used = "ell"
        self._space = StateSet(self.model.stoichiometry, self.constraints,
                               init_states=states)
        self._space.expand()
        self._maybe_partition(force=True)
        self._build_operator()
        # the solution as [rows, n_pad] in the set's order
        p = np.zeros((rows.shape[0], self._operator.n_pad))
        p[:, self._space.state2index(states)] = rows
        self._y = self._place(FspVector(
            p=torch.as_tensor(p.reshape(-1), dtype=self.dtype,
                              device=self.device), sinks=sinks))

    def set_up(self) -> "FspSolverMultiSinks":
        if self.model is None:
            raise SetupError("SetUp called before model was set")
        if self.constraints is None:
            raise SetupError("SetUp called before bounds were set")
        if self._init_states is None:
            raise SetupError("SetUp called before initial distribution")
        if self._init_states.shape[1] != self.model.num_species:
            raise SetupError("initial states do not match model species")
        if self._resolve_odes_type() == ODESolverType.PETSC:
            self._ts_class()

        self._restore_user_order()
        self._set_up = False
        self.axis_orders_ = []
        self._ode_solver = None
        self._operator = None
        with self._logging(), self.events.timed(EVT_SETUP):
            self._backend_used = self._choose_backend()
            with self.events.timed(EVT_PARTITION):
                self._build_space()
            with self.events.timed(EVT_MATGEN):
                self._build_operator()
            self._y = self._initial_vector()
        self._set_up = True
        return self

    def _logging(self):
        """The block in which :func:`~..sys.events.span` records into
        :attr:`events` (into nothing where ``log_events`` is off)."""
        return active(self.events if self.log_events else None)

    def pad_quanta_for_space(self) -> np.ndarray:
        """Capacity quanta per axis: axis 0 divides by the rank count."""
        pad_quanta = np.ones(self.model.num_species, np.int64)
        if self.mesh is not None:
            pad_quanta[0] = self.mesh.size
        return pad_quanta

    # ---------------------------------------------------------- axis order
    @property
    def _model_int(self) -> Model:
        """The model in the box's internal species order (the user's in
        user order and on the compressed backend)."""
        return self._int_model if self._int_model is not None else self.model

    @property
    def _init_int(self) -> np.ndarray:
        """The initial states in the box's internal species order."""
        return (self._int_init if self._int_init is not None
                else self._init_states)

    def _restore_user_order(self) -> None:
        """Leave the box's internal species order: the user's constraint
        function back, with the current bounds and expansion factors, so
        a later set-up never wraps a wrapped callable (reference
        ``_setup_axis_order``, :668-672)."""
        if self._axis_inv is not None:
            cur, user = self.constraints, self._user_constraints
            self.constraints = ConstraintSet(
                user.fn, cur.bounds, cur.expansion_factors,
                user.num_species, box_cache=user._box_cache)
        self._axis_order = self._axis_inv = None
        self._int_model = self._int_init = self._user_constraints = None

    def _setup_axis_order(self) -> None:
        """Lay the box's species axes out by descending extent of the
        user-order box (reference ``_setup_axis_order``): permute the
        model, the constraint set and the initial states where that order
        is not the user's.  Over a mesh every rank derives it from the
        same replicated bounds; the ranks check that they agree, since
        ranks on different boxes would hang in their first exchange."""
        self._restore_user_order()
        S = self.model.num_species
        order = self._order_for(self.constraints.derive_box_bounds(
            S, self._init_states) + 1)
        if self.mesh is not None and self.mesh.size > 1:
            mine = torch.as_tensor(order, device=self.mesh.device)
            every = self.mesh.all_gather(mine[None]).cpu().numpy()
            if not (every == order[None, :]).all():
                raise StateSpaceError(
                    f"the ranks derived different box axis orders: "
                    f"{every.tolist()}")
        self.axis_orders_.append((self._t_now if self._set_up else None,
                                  order.tolist()))
        if self.verbosity:
            print(f"[fsp] box axis order (by extent): {order.tolist()}")
        if (order == np.arange(S)).all():
            return
        self._axis_order = order
        self._axis_inv = np.argsort(order)
        self._user_constraints = self.constraints
        self._int_model = permute_model(self.model, order)
        self.constraints = permute_constraints(self.constraints, order, S)
        self._int_init = self._init_states[:, order]

    def _prealloc_budget(self) -> Optional[float]:
        """Eager capacity's element budget under ``preallocate=True``
        (reference ``_build_space``, :700-745), shared by the solution's
        rows; None for the capacity ladder, which ``False`` and ``"auto"``
        take on every device (eager capacity took 2.2-2.4x the ladder's
        wall on hog1p_5d on an H100 80GB HBM3: PERF.md §6)."""
        if self.preallocate is not True:
            return None
        # the solution stacks its rows (a sensitivity solve's p and each
        # s_j) as one vector: each row gets its share of the budget
        return min(self._box_elem_budget() / self._vector_rows(),
                   float(MAX_BOX_ELEMS))

    def _growable_axes(self) -> np.ndarray:
        """The box axes eager capacity water-fills (reference
        :730-744): under coordinate constraints those with a growing
        bound; under custom ones those whose extent grows when every
        growable bound grows (hog1p's gene axis is capped by a bound that
        never grows)."""
        cs, S = self.constraints, self.model.num_species
        if cs.fn is None:
            return cs.expansion_factors > 0
        grown = cs.with_bounds(cs.expanded_bounds(cs.expansion_factors > 0))
        return (grown.derive_box_bounds(S, self._init_int)
                > cs.derive_box_bounds(S, self._init_int))

    def _build_space(self, floor=None, seed_mask_fn=None):
        """The state space of the current bounds: on the box, in the axis
        order of their extents, ``floor`` and ``seed_mask_fn`` as
        :class:`BoxStateSpace` takes them (the reordered rebuild's)."""
        if self._backend_used == "box":
            self._setup_axis_order()
            budget = self._prealloc_budget()
            self._space = BoxStateSpace(
                self._model_int.stoichiometry, self.constraints,
                self._init_int, device=self.device,
                pad_quanta=self.pad_quanta_for_space(),
                prealloc_budget=budget,
                growable_axes=(None if budget is None
                               else self._growable_axes()),
                extent_floor=floor, seed_mask_fn=seed_mask_fn)
            self._space.events = self.events   # MaskBFS sub-timer
        else:
            self._space = StateSet(self.model.stoichiometry,
                                   self.constraints,
                                   init_states=self._init_states)
            self._space.expand()
            self._maybe_partition(force=True)

    def _maybe_partition(self, force: bool = False) -> bool:
        """Re-order the compressed state set where it grew by more than
        ``lb_threshold`` since its last ordering (reference: a re-partition
        when the set grew by over 20%, StateSetConstrained.cpp:213-218).
        On one device only the partitioner's ordering is used: BLOCK keeps
        the insertion order, GRAPH and HYPERGRAPH re-order for the
        gather's locality.  Over a mesh rank r then holds the r-th
        contiguous block of the order, so the ordering also sets the
        halo each rank exchanges.  The box's layout is its coordinates:
        nothing to do there."""
        if self._backend_used == "box":
            return False
        n = self._space.num_states
        if not force and n <= self.lb_threshold * self._n_last_partition:
            return False
        self._n_last_partition = n
        if self.partitioning == PartitioningType.BLOCK:
            return False
        part = StatePartitioner(self.partitioning, self.repart_approach)
        prev = (np.arange(n)
                if self.repart_approach != PartitioningApproach.FROMSCRATCH
                else None)
        n_parts = self.mesh.size if self.mesh is not None else 1
        res = part.partition(self._space.states, self.model.stoichiometry,
                             n_parts, state2index=self._space.state2index,
                             prev_order=prev, need_boundaries=False)
        self._check_same_order(res.order)
        self._space.reorder(res.order)
        if self.verbosity:
            print(f"[fsp] re-ordered {n} states "
                  f"({self.partitioning.value}/"
                  f"{self.repart_approach.value})")
        return True

    def _check_same_order(self, order: np.ndarray) -> None:
        """Over a mesh every rank orders the same state set on its own
        (the reference package once for the whole mesh); the ranks
        all-gather a checksum of their orders and raise
        :class:`StateSpaceError` where they differ, since ranks on
        different orders would exchange the wrong halos."""
        if self.mesh is None or self.mesh.size == 1:
            return
        w = np.arange(1, order.shape[0] + 1, dtype=np.int64)
        mine = torch.tensor([[order.shape[0], int(order.sum()),
                              int((order * w % 1000003).sum())]],
                            dtype=torch.int64, device=self.mesh.device)
        every = self.mesh.all_gather(mine).cpu().numpy()
        if not (every == every[:1]).all():
            raise StateSpaceError(
                f"the ranks ordered the state set differently "
                f"({self.partitioning.value}; checksums {every.tolist()})")

    def _build_operator(self):
        self._ode_solver = None     # its basis has the old capacity
        self._operator = None       # free the old fields first
        if self._backend_used == "ell":
            if self.mesh is not None:
                self._operator = ShardedEllOperator(
                    self.model, self._space, self.mesh, dtype=self.dtype)
                self._log_halo(self._operator)
            else:
                self._operator = EllOperator(self.model, self._space,
                                             dtype=self.dtype,
                                             device=self.device)
            return
        self._operator = BoxOperator(self._model_int, self._space,
                                     dtype=self.dtype, mesh=self.mesh)
        self._log_halo(self._operator.sharded)
        if self.verbosity:
            print(f"[fsp] box operator: capacity {tuple(self._space.shape)}"
                  f" ({float(np.prod(self._space.shape)):.3g} elems)",
                  flush=True)

    def _log_halo(self, exchange) -> None:
        """Count the values a matvec sends across ranks (the reference's
        ``HaloValuesPerMatvec``)."""
        if exchange is not None and self.log_events:
            self.events.add_count("HaloValuesPerMatvec",
                                  exchange.comm_values_per_matvec())

    def _vector_rows(self) -> int:
        """Rows of the solution vector: 1 (p); the sensitivity solve
        stacks p and each sensitivity."""
        return 1

    def _init_values(self) -> np.ndarray:
        """``[rows, n_init]`` values of the solution rows at the initial
        states."""
        return self._init_probs[None, :]

    def _initial_vector(self) -> FspVector:
        idx = self._space.state2index(
            self._init_int if self._backend_used == "box"
            else self._init_states)
        if (idx < 0).any():
            raise StateSpaceError(
                "initial states outside the FSP state space")
        n_c = self.constraints.num_constraints
        m = self._vector_rows()
        n = (self._space.size if self._backend_used == "box"
             else self._operator.n_pad)
        p = np.zeros((m, n), dtype=np.float64)
        p[:, idx] = self._init_values()
        self.sinks_ = np.zeros((n_c,), np.float64)
        return self._place(FspVector(
            p=torch.as_tensor(p.reshape(-1), dtype=self.dtype,
                              device=self.device),
            sinks=torch.zeros(m * n_c, dtype=self.dtype,
                              device=self.device)))

    def _place(self, y: FspVector) -> FspVector:
        """This rank's part of a vector over the whole state space: its
        slab of the box, or its block of the state list, of each row of
        ``p``, so only the owner of a state holds its mass."""
        if self.mesh is None:
            return y
        if self._backend_used == "box":
            slab_rows(self._space.shape, self.mesh)    # axis 0 divides
        return FspVector(p=shard_rows(y.p, self._vector_rows(), self.mesh),
                         sinks=y.sinks)

    def _global_p(self) -> torch.Tensor:
        """``p`` over the whole state space, row after row (gathered from
        every rank)."""
        if self.mesh is None:
            return self._y.p
        return gather_rows(self._y.p, self._vector_rows(), self.mesh)

    # -------------------------------------------------------------- solve
    def _make_ode_solver(self, fsp_tol: float, t_final: float):
        n_sinks = self.constraints.num_constraints

        if fsp_tol > 0:
            def stop_check(t, y, forgiven):
                # reference CheckFspTolerance_ (FspSolverMultiSinks.cpp:
                # 576-611): sink_i exceeds its share of the tolerance
                # budget pro-rated by t/t_final.  ``forgiven`` (on y's
                # device) subtracts the excess already lost when the epoch
                # started: growing the space cannot reclaim it, so
                # re-tripping on it would stop every resumed epoch on its
                # first step.  p's sinks lead y's.  The excess stays on
                # the device for the integrator to fetch.  (The closure
                # holds no reference to the driver, so a dropped solver is
                # freed at once.)
                excess = y.sinks[:n_sinks] * n_sinks - fsp_tol * (t / t_final)
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
        cls = BdfSolver if odes == ODESolverType.CVODE else self._ts_class()
        return cls(self._operator.action, rtol=self.ode_rtol,
                   atol=self.ode_atol, stop_check=stop_check,
                   n_sinks=n_sinks)

    def _ts_class(self):
        """The integrator of :attr:`ts_type` (``odes_type="petsc"``)."""
        cls = TS_TYPES.get(self.ts_type)
        if cls is None:
            raise SetupError(f"unknown ts_type {self.ts_type!r} (supported: "
                             "rk, cn/theta/trapezoid, bdf/beuler)")
        return cls

    def _expand(self, to_expand: np.ndarray, rounds: int = 1):
        """Grow the flagged bounds and the state space with them, and
        carry the solution over (reference Advance_ expansion block,
        :114-211).  The box rebuilds its mask, and its operator only if
        the capacity grew; the compressed set expands by BFS, may be
        re-ordered, and its operator is re-assembled."""
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
            with self.events.timed(EVT_PARTITION):
                self._migrate_box_to_ell()
        if self._backend_used == "box":
            self._expand_box(new_bounds, to_expand)
        else:
            self._expand_ell(new_bounds, to_expand)
        if self.verbosity:
            print(f"[fsp] new state count: {self.num_states}")

    def _expand_box(self, new_bounds, to_expand) -> None:
        n_before = self._space.num_states
        if self._box_reorder_needed(new_bounds):
            with self.events.timed(EVT_REORDER), \
                    self.events.timed(EVT_PARTITION):
                self._rebuild_box_reordered(new_bounds, n_before, to_expand)
            return
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

    def _expand_ell(self, new_bounds, to_expand) -> None:
        n_before = self._space.num_states
        with self.events.timed(EVT_PARTITION):
            states_old = self._space.copy_states()
            bounds_old = self.constraints.bounds
            self._space.set_bounds(new_bounds)
            self.constraints = self._space.constraints
            self._space.expand(old_bounds=bounds_old)
            self._escalate_if_stuck(n_before, to_expand)
            self._maybe_partition()
        with self.events.timed(EVT_MATGEN):
            if self._operator.reassemble():
                self._ode_solver = None     # its storage has the old size
        with self.events.timed(EVT_SCATTER):
            self._y = self._scatter_ell(states_old)

    def _scatter_ell(self, states_old: np.ndarray) -> FspVector:
        """Every row of the solution at its states' new indices, zero
        elsewhere (reference ``ExpandVec``, PetscWrap.cpp:26-56).  Where
        the set kept its order (no re-ordering) the old indices are the
        identity prefix and this is a zero-pad, or nothing within
        capacity: entries past the states stay exactly zero.  Over a mesh
        the rows are gathered, scattered and cut into blocks again."""
        m = self._vector_rows()
        n_old, n_pad = states_old.shape[0], self._operator.n_pad
        idx = self._space.state2index(states_old)
        in_place = bool((idx == np.arange(n_old)).all())
        if in_place and self._y.p.numel() == m * self._operator.local_n:
            return self._y
        rows = self._global_p().view(m, -1)
        p = rows.new_zeros((m, n_pad))
        if in_place:
            p[:, :rows.shape[1]] = rows
        else:
            p[:, torch.as_tensor(idx, device=p.device)] = rows[:, :n_old]
        return self._place(FspVector(p=p.reshape(-1), sinks=self._y.sinks))

    def _embed_old(self, old_shape) -> FspVector:
        """Every row of the solution zero-padded from the box of
        ``old_shape`` into the grown one; a sharded p is gathered,
        embedded and re-sliced."""
        rows = self._global_p().view(self._vector_rows(), -1)
        p = torch.cat([self._space.embed_old(r, old_shape) for r in rows])
        return self._place(FspVector(p=p, sinks=self._y.sinks))

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
            prev_bounds = self.constraints.bounds
            new_bounds = self.constraints.expanded_bounds(growable)
            self._space.set_bounds(new_bounds)
            self.constraints = self._space.constraints
            if self._backend_used == "ell":
                self._space.expand(old_bounds=prev_bounds)
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
                    with self.events.timed("StopCheckPrep"):
                        forgiven = self._forgiven(fsp_tol, t_final)
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
                self.sinks_ = vo.to_host(self._base_sinks(res.y),
                                         "EpochSinks")
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

    def _forgiven(self, fsp_tol: float, t_final: float) -> torch.Tensor:
        """The already-lost sink mass beyond the pro-rated budget at
        epoch start, forgiven by the stop-check.  The slack keeps the
        resumed excess strictly negative, so rounding cannot re-trip the
        stop on the first step; it loosens the bound by at most 1e-3 *
        fsp_tol plus a few ulps of the sink scale."""
        n_sinks = self.constraints.num_constraints
        sinks_now = (np.asarray(self.sinks_, np.float64)
                     if self.sinks_ is not None else
                     vo.to_host(self._base_sinks(self._y), "InitialSinks"))
        excess_now = (sinks_now * n_sinks -
                      fsp_tol * (self._t_now / t_final))
        eps = float(torch.finfo(self.dtype).eps)
        slack = (64.0 * eps * np.maximum(np.abs(sinks_now) * n_sinks,
                                         fsp_tol)
                 + 1.0e-3 * fsp_tol / n_sinks)
        return torch.as_tensor(np.maximum(0.0, excess_now) + slack,
                               dtype=self.dtype, device=self.device)

    def solve(self, t_final: float, fsp_tol: float = 1.0e-4,
              t_init: float = 0.0) -> DiscreteDistribution:
        """Reference Solve (FspSolverMultiSinks.cpp:619-643)."""
        if not self._set_up:
            self.set_up()
        with self._logging():
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
        with self._logging():
            self._y = self._initial_vector()
            self._t_now = float(t_init)
            out = []
            for t in tspan:
                self._advance(float(t), float(fsp_tol))
                out.append(self._make_distribution())
            return out

    def clear_state(self) -> None:
        self._restore_user_order()
        self._set_up = False
        self._space = None
        self._operator = None
        self._ode_solver = None
        self._y = None

    # ------------------------------------------------------------ output
    @property
    def num_states(self) -> int:
        return self._space.num_states if self._space is not None else 0

    def _valid_rows(self):
        """(states [n, S] in user species order, the solution's rows at
        them [rows, n]) on the host, the states in the space's order."""
        m = self._vector_rows()
        if self._backend_used == "box":
            rows = self._global_p().view(m, -1)
            states = self._space.states()
            if self._axis_inv is not None:
                states = states[:, self._axis_inv]   # back to user order
            return states, np.stack(
                [self._space.extract_valid(r) for r in rows])
        states = self._space.copy_states()
        return states, self._global_p().view(m, -1)[:, :states.shape[0]
                                                   ].cpu().numpy()

    def _make_distribution(self) -> DiscreteDistribution:
        with self.events.timed("DistributionExtract"):
            states, rows = self._valid_rows()
            return DiscreteDistribution(
                t=self._t_now, states=states, p=rows[0],
                bounds=self.constraints.bounds.copy(),
                sinks=self._base_sinks(self._y).cpu().numpy())

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
    SetTsType = set_ts_type
    SetFromOptions = set_from_options
    SetOdeTolerances = set_ode_tolerances
    SetVerbosity = set_verbosity
    SetLoadBalancingMethod = set_load_balancing_method
    SetRepartApproach = set_repart_approach
    SetUp = set_up
    Solve = solve
    SolveTspan = solve_tspan
    ClearState = clear_state
    ReduceComponentTiming = reduce_component_timing
