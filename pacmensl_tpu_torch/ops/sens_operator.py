"""Sensitivity CME operators.

Counterpart of ``pacmensl_tpu/ops/sens_operator.py`` (reference
``SensFspMatrix<T>``, ``src/SensFsp/SensFspMatrix.h:44-209``) on both
backends.  The derivative of the generator w.r.t. parameter j splits as

    d_j A(t) = [d_j c(t)] x A   (+)   c(t) x [d_j A_r]

i.e. one operator built with the derivative time coefficients over the
``dtcoef_sparsity[j]`` reactions (``dcxA``), plus one built with the
derivative propensities over the ``dprop_sparsity[j]`` reactions
(``cxdA``).  Both are ordinary operators of the space's backend
restricted to a reaction subset (``BoxOperator(enable_reactions=...)`` on
a box, ``EllOperator(enable_reactions=...)`` on a compressed state set,
re-assembled with it every epoch), sinks included.

The forward-sensitivity system

    d/dt [p, s_1..s_Np] = [A p, A s_1 + (d_1 A) p, ...]

is linear in the stacked vector.  The port stacks it as one
:class:`~.vecops.FspVector`: ``p`` is the contiguous ``[(1 + Np) n]``
vector (p, then s_1..s_Np) and ``sinks`` the ``[(1 + Np) n_c]`` sinks
(p's, then each s_j's), so the integrators and GMRES run on it unchanged
and BDF's error norm counts the sensitivities, as the reference package's
does over all leaves.  :meth:`SensOperator.action` views them as ``[1 +
Np, n]``: on the box one batched launch of the box kernel (K9, the
counterpart of the reference's ``vmap``) for ``A p`` and every ``A s_j``
together, written straight into the output's rows, and one launch per
non-empty derivative operator.  K9 is bitwise one launch per vector.  The
model's time coefficients c(t), and each ``dcxA[j]``'s derivative ones,
are computed once for each distinct ``t`` (a BDF step applies the
operator at one ``t``), in one ``ModelCoefficients`` span, kept with that
``t`` and handed to every sub-operator (:meth:`SensOperator.coefficients`).

On the box without a mesh the stacked action is also the action of BDF's
capturable corrector map (:class:`~.box_operator.ShiftedAction`):
:meth:`SensOperator.stage` writes c(t), the derivative coefficients and
the bounds into every sub-operator's kernel buffer once per step,
:meth:`SensOperator.capture_key` holds every sub-operator's, and the
action writes ``p`` into a given output, so GMRES replays each Arnoldi
iteration of a sensitivity solve, the K9 launch, the derivative launches
and their adds included, from a CUDA graph (:mod:`.gmres`).

With a ``mesh`` every sub-operator is sharded over its ranks, as the
reference package's meshed sensitivity solve is
(``pacmensl_tpu/sensfsp/sens_solver.py:73-95``): box operators on each
rank's slab, compressed ones as
:class:`~..parallel.halo_ell.ShardedEllOperator`; the stacked vector holds
the rank's slab or block of each of its rows.  On the box over two or
more ranks an action makes one halo exchange (K9w's, of every vector's
edge planes) and one all-reduce (of every operator's sink partials,
concatenated); the derivative operators act on ``p`` with K9w's halos of
vector 0 and add their sinks after the all-reduce, in the order of one
all-reduce each.

Each :meth:`SensOperator.action` run eagerly or captured is one
``SensAction`` span (c(t) where it is new, the base action, the derivative
part, the adds) holding one ``SensDerivative`` span (the loop over
parameters and its adds; over ranks, the derivative slab actions).  Each
action, a replayed one too, adds (1 + Np) x the state set's size and
(1 + Np) x the constraint count to the counters ``SensActionStates`` and
``SensActionSinks`` of the active event log (through
:func:`~..sys.events.tally`, which a graph's replay runs again).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from ..models.model import Model, SensModel
from ..statespace.state_set import StateSet
from ..parallel.halo_ell import ShardedEllOperator
from ..sys.events import (EVT_COEFFS, EVT_SENS_ACTION, EVT_SENS_DERIVATIVE,
                          EVT_SENS_SINKS, EVT_SENS_STATES, count, span,
                          tally)
from .box_operator import BoxOperator
from .ell_operator import EllOperator
from .vecops import FspVector


def _coef_model(model: SensModel, j: int) -> Optional[Model]:
    """Model whose action is [d_j c(t)] x A restricted to its sparsity."""
    if model.d_t_coeff is None or not model.dtcoef_sparsity[j]:
        return None
    return Model(model.stoichiometry, model.propensity,
                 t_coeff=lambda t: model.d_t_coeff(j, t),
                 tv_reactions=model.dtcoef_sparsity[j])


def _prop_model(model: SensModel, j: int) -> Optional[Model]:
    """Model whose action is c(t) x [d_j A_r] restricted to its sparsity."""
    if model.d_propensity is None or not model.dprop_sparsity[j]:
        return None
    return Model(model.stoichiometry,
                 lambda x, r: model.d_propensity(x, j, r),
                 t_coeff=model.t_coeff,
                 tv_reactions=model.tv_reactions)


class SensCoefficients(NamedTuple):
    """The time coefficients of one ``t``: the model's full vector ``c``
    (the base and every ``cxdA[j]``), and ``dc[j]`` that of ``dcxA[j]``'s
    model (None where there is no such operator)."""
    c: torch.Tensor
    dc: List[Optional[torch.Tensor]]


class SensOperator:
    """A(t) plus its per-parameter derivative operators: box operators on
    a :class:`BoxStateSpace`, compressed ones on a :class:`StateSet` (on
    ``device``), each sharded over ``mesh``'s ranks where one is given."""

    def __init__(self, model: SensModel, space, dtype=torch.float64,
                 device=None, mesh=None):
        self.model = model
        self.space = space
        self.dtype = dtype
        self.n_par = model.num_parameters
        if isinstance(space, StateSet):
            def make(m, reactions=None):
                if mesh is not None:
                    return ShardedEllOperator(m, space, mesh, dtype=dtype,
                                              enable_reactions=reactions)
                return EllOperator(m, space, dtype=dtype, device=device,
                                   enable_reactions=reactions)
            self.base = make(model.base_model())
        else:
            self.base = BoxOperator(model.base_model(), space, dtype=dtype,
                                    mesh=mesh)
            # the derivative operators run in the base operator's kernel
            # mode and change it with it (refresh_data)
            mode = self.base.synth_mask

            def make(m, reactions=None):
                return BoxOperator(m, space, dtype=dtype, mesh=mesh,
                                   enable_reactions=reactions,
                                   synth_mask=mode)
        self.dcxA: List[Optional[object]] = []
        self.cxdA: List[Optional[object]] = []
        for j in range(self.n_par):
            cm = _coef_model(model, j)
            self.dcxA.append(make(cm, model.dtcoef_sparsity[j])
                             if cm is not None else None)
            pm = _prop_model(model, j)
            self.cxdA.append(make(pm, model.dprop_sparsity[j])
                             if pm is not None else None)
        #: the last coefficients computed, and their time
        self._coef_t = None
        self._coef: Optional[SensCoefficients] = None
        #: on the box without a mesh, the rows the derivative operators
        #: write their dp into (two where a parameter has both), so that
        #: an action allocates no vector (nor, captured, a graph's pool)
        self._dp = None
        if self.capturable:
            both = any(a is not None and b is not None
                       for a, b in zip(self.dcxA, self.cxdA))
            self._dp = torch.empty((1 + both, self.local_n), dtype=dtype,
                                   device=self.base.device)

    # ----------------------------------------------------- epoch machinery
    def sub_ops(self) -> list:
        return [self.base] + [o for o in self.dcxA if o is not None] + \
            [o for o in self.cxdA if o is not None]

    def refresh_data(self) -> None:
        """Re-snapshot every sub-operator's data after a within-capacity
        bounds change; where the base operator leaves the
        synthesized-mask mode, all leave it together."""
        self.base.refresh_data()
        for op in self.sub_ops()[1:]:
            op.refresh_data(synth_mask=self.base.synth_mask)

    def reassemble(self) -> bool:
        """Compressed backend: re-assemble every sub-operator after the
        state set changed; True when the capacity grew (the ladders
        depend on the state count only, so all grow together)."""
        return any([op.reassemble() for op in self.sub_ops()])

    @property
    def local_n(self) -> int:
        return self.base.local_n

    @property
    def n_pad(self) -> int:
        """Compressed backend: the padded state list's length."""
        return self.base.n_pad

    @property
    def exchange(self):
        """What sends values across ranks in a matvec (its
        ``comm_values_per_matvec``): the base operator's sharded box
        action or the sharded compressed base operator; None on one
        device."""
        if isinstance(self.base, ShardedEllOperator):
            return self.base
        return getattr(self.base, "sharded", None)

    @property
    def num_constraints(self) -> int:
        return self.base.num_constraints

    @property
    def device(self):
        return self.base.device

    # ------------------------------------------------------------------
    def coefficients(self, t) -> SensCoefficients:
        """The model's c(t) and each ``dcxA[j]``'s coefficients at ``t``,
        computed once for each new ``t`` in one ``ModelCoefficients``
        span."""
        if t != self._coef_t:
            with span(EVT_COEFFS):
                c = self.model.coefficients(t, self.dtype)
                dc = [op.model.coefficients(t, self.dtype)
                      if op is not None else None for op in self.dcxA]
            self._coef = SensCoefficients(c, dc)
            self._coef_t = t
        return self._coef

    @property
    def capturable(self) -> bool:
        """Whether :meth:`action` can run inside a CUDA graph
        (:class:`~.box_operator.ShiftedAction`): over box operators
        without a mesh."""
        return getattr(self.base, "capturable", False)

    def stage(self, t) -> None:
        """Write c(t), the derivative coefficients and this epoch's bounds
        into every sub-operator's kernel buffer where they changed, ahead
        of launches that do not pass them (a replayed CUDA graph's; box
        operators without a mesh)."""
        cs = self.coefficients(t)
        self.base.stage(t, cs.c)
        for j in range(self.n_par):
            if self.dcxA[j] is not None:
                self.dcxA[j].stage(t, cs.dc[j])
            if self.cxdA[j] is not None:
                self.cxdA[j].stage(t, cs.c)

    def capture_key(self) -> tuple:
        """Every sub-operator's :meth:`~.box_operator.BoxOperator.
        capture_key`, the base operator's with the scratch of its batched
        launch over the 1 + Np vectors."""
        return ((self.base.capture_key(1 + self.n_par),)
                + tuple(op.capture_key() for op in self.sub_ops()[1:]))

    def sens_action(self, j: int, t, y: FspVector, out=None) -> FspVector:
        """(d_j A)(t) y (reference SensAction, SensFspMatrix.h:195-209);
        ``out``: rows ``[k, n]`` to write the derivative operators' ``dp``
        into, one an operator (the sum into the first)."""
        cs = self.coefficients(t)
        ops = [(op, cj) for op, cj in ((self.dcxA[j], cs.dc[j]),
                                       (self.cxdA[j], cs.c))
               if op is not None]
        res = None
        for k, (op, cj) in enumerate(ops):
            d = op.action(t, y, c=cj, out=None if out is None else out[k])
            if res is None:
                res = d
            elif out is None:
                res = FspVector(p=res.p + d.p, sinks=res.sinks + d.sinks)
            else:
                res = FspVector(p=res.p.add_(d.p), sinks=res.sinks + d.sinks)
        if res is None:
            res = FspVector(p=torch.zeros_like(y.p),
                            sinks=torch.zeros_like(y.sinks))
        return res

    def _count_action(self) -> None:
        m = 1 + self.n_par
        count(EVT_SENS_STATES, m * self.space.num_states)
        count(EVT_SENS_SINKS, m * self.num_constraints)

    def action(self, t, y: FspVector, out=None) -> FspVector:
        """The forward-sensitivity generator on the stacked vector ``y``
        (``p [(1 + Np) n]``, ``sinks [(1 + Np) n_c]``); ``out``: where to
        write its ``p``."""
        n, nc, m = self.local_n, self.num_constraints, 1 + self.n_par
        tally(self._count_action)
        with span(EVT_SENS_ACTION):
            P = y.p.view(m, n)
            cs = self.coefficients(t)
            if out is None:
                out = torch.empty_like(y.p)
            sh = getattr(self.base, "sharded", None)
            if sh is not None and sh.halos:
                return self._action_over_ranks(t, P, cs, out)
            # A p and A s_j for all j in one launch, into the output's rows
            _, sinks = self.base.action_batched(t, P, c=cs.c,
                                                out=out.view(m, n))
            sinks = sinks.reshape(-1)
            pv = FspVector(p=P[0], sinks=y.sinks[:nc])
            with span(EVT_SENS_DERIVATIVE):
                for j in range(self.n_par):
                    if self.dcxA[j] is None and self.cxdA[j] is None:
                        continue
                    g = self.sens_action(j, t, pv, out=self._dp)
                    out[(j + 1) * n:(j + 2) * n].add_(g.p)
                    sinks[(j + 1) * nc:(j + 2) * nc].add_(g.sinks)
            return FspVector(p=out, sinks=sinks)

    def _action_over_ranks(self, t, P, cs: SensCoefficients,
                           out) -> FspVector:
        """:meth:`action` on the box over two or more ranks: one halo
        exchange and one all-reduce."""
        n, nc, m = self.local_n, self.num_constraints, 1 + self.n_par

        def slab_action(op, cj, p, out=None, halos=None):
            d = op.data()
            return op.sharded.apply(op.coefficients(t, cj), p, op.props,
                                    d.mask, d.viol, d.bounds, out, halos,
                                    reduce=False)
        _, sinks, (up, dn) = slab_action(self.base, cs.c, P, out.view(m, n))
        terms = []     # (j, dp, partial sinks) of each derivative operator
        with span(EVT_SENS_DERIVATIVE):
            for j in range(self.n_par):
                for op, cj in ((self.dcxA[j], cs.dc[j]),
                               (self.cxdA[j], cs.c)):
                    if op is not None:
                        gp, gs, _ = slab_action(op, cj, P[0],
                                                halos=(up[0], dn[0]))
                        terms.append((j, gp, gs))
        flat = torch.cat([sinks.reshape(-1)] + [gs for _, _, gs in terms])
        if flat.numel():
            self.base.sharded.mesh.all_reduce(flat)
        sinks = flat[:m * nc]
        # each parameter's derivative dp and sinks, summed as sens_action
        # sums them, then added to its row
        per = {}
        for k, (j, gp, _) in enumerate(terms):
            gs = flat[(m + k) * nc:(m + k + 1) * nc]
            got = per.get(j)
            per[j] = (gp, gs) if got is None else (got[0] + gp, got[1] + gs)
        for j, (gp, gs) in per.items():
            out[(j + 1) * n:(j + 2) * n].add_(gp)
            sinks[(j + 1) * nc:(j + 2) * nc].add_(gs)
        return FspVector(p=out, sinks=sinks)

    # ------------------------------------------------------------------
    def zero_vector(self) -> FspVector:
        m = 1 + self.n_par
        z = self.base.zero_vector()
        return FspVector(p=z.p.new_zeros(m * z.p.numel()),
                         sinks=z.sinks.new_zeros(m * z.sinks.numel()))

    def local_mv_flops(self) -> float:
        return self.base.local_mv_flops() * (1 + self.n_par)
