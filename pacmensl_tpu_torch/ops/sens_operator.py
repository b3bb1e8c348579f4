"""Sensitivity CME operators.

Counterpart of ``pacmensl_tpu/ops/sens_operator.py`` (reference
``SensFspMatrix<T>``, ``src/SensFsp/SensFspMatrix.h:44-209``) on the box
backend.  The derivative of the generator w.r.t. parameter j splits as

    d_j A(t) = [d_j c(t)] x A   (+)   c(t) x [d_j A_r]

i.e. one operator built with the derivative time coefficients over the
``dtcoef_sparsity[j]`` reactions (``dcxA``), plus one built with the
derivative propensities over the ``dprop_sparsity[j]`` reactions
(``cxdA``).  Both are ordinary box operators restricted to a reaction
subset (``BoxOperator(enable_reactions=...)``), sinks included.

The forward-sensitivity system

    d/dt [p, s_1..s_Np] = [A p, A s_1 + (d_1 A) p, ...]

is linear in the stacked vector.  The port stacks it as one
:class:`~.vecops.FspVector`: ``p`` is the contiguous ``[(1 + Np) n]``
vector (p, then s_1..s_Np) and ``sinks`` the ``[(1 + Np) n_c]`` sinks
(p's, then each s_j's), so the integrators and GMRES run on it unchanged
and BDF's error norm counts the sensitivities, as the reference package's
does over all leaves.  :meth:`SensOperator.action` views them as ``[1 +
Np, n]``: one launch of the box kernel for ``A p``, one batched launch
(K9, the counterpart of the reference's ``vmap``) for every ``A s_j``
written straight into the s rows, and one launch per non-empty derivative
operator.  The model's time coefficients are evaluated once per action
and handed to every launch.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..models.model import Model, SensModel
from .box_operator import BoxOperator
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


class SensOperator:
    """A(t) plus its per-parameter derivative operators, on one device."""

    def __init__(self, model: SensModel, space, dtype=torch.float64):
        self.model = model
        self.dtype = dtype
        self.n_par = model.num_parameters
        self.base = BoxOperator(model.base_model(), space, dtype=dtype)
        # the derivative operators run in the base operator's kernel mode
        # and change it with it (refresh_data)
        mode = self.base.synth_mask
        self.dcxA: List[Optional[BoxOperator]] = []
        self.cxdA: List[Optional[BoxOperator]] = []
        for j in range(self.n_par):
            cm = _coef_model(model, j)
            self.dcxA.append(
                BoxOperator(cm, space, dtype=dtype,
                            enable_reactions=model.dtcoef_sparsity[j],
                            synth_mask=mode) if cm is not None else None)
            pm = _prop_model(model, j)
            self.cxdA.append(
                BoxOperator(pm, space, dtype=dtype,
                            enable_reactions=model.dprop_sparsity[j],
                            synth_mask=mode) if pm is not None else None)

    # ----------------------------------------------------- epoch machinery
    def sub_ops(self) -> List[BoxOperator]:
        return [self.base] + [o for o in self.dcxA if o is not None] + \
            [o for o in self.cxdA if o is not None]

    def refresh_data(self) -> None:
        """Re-snapshot every sub-operator's data after a within-capacity
        bounds change; where the base operator leaves the
        synthesized-mask mode, all leave it together."""
        self.base.refresh_data()
        for op in self.sub_ops()[1:]:
            op.refresh_data(synth_mask=self.base.synth_mask)

    @property
    def local_n(self) -> int:
        return self.base.local_n

    @property
    def num_constraints(self) -> int:
        return self.base.num_constraints

    # ------------------------------------------------------------------
    def sens_action(self, j: int, t, y: FspVector, c=None) -> FspVector:
        """(d_j A)(t) y (reference SensAction, SensFspMatrix.h:195-209);
        ``c``: the model's coefficients at ``t`` where the caller holds
        them."""
        out = None
        if self.dcxA[j] is not None:
            out = self.dcxA[j].action(t, y)
        if self.cxdA[j] is not None:
            if c is None:
                c = self.model.coefficients(t, self.dtype)
            d = self.cxdA[j].action(t, y, c=c)
            out = d if out is None else FspVector(p=out.p + d.p,
                                                  sinks=out.sinks + d.sinks)
        if out is None:
            out = FspVector(p=torch.zeros_like(y.p),
                            sinks=torch.zeros_like(y.sinks))
        return out

    def action(self, t, y: FspVector) -> FspVector:
        """The forward-sensitivity generator on the stacked vector ``y``
        (``p [(1 + Np) n]``, ``sinks [(1 + Np) n_c]``)."""
        n, nc, m = self.local_n, self.num_constraints, 1 + self.n_par
        P = y.p.view(m, n)
        c = self.model.coefficients(t, self.dtype)
        out = torch.empty_like(y.p)
        pv = FspVector(p=P[0], sinks=y.sinks[:nc])
        base = self.base.action(t, pv, c=c, out=out[:n])
        # A s_j for all j in one launch, into the s rows
        _, s_sinks = self.base.action_batched(t, P[1:], c=c,
                                              out=out[n:].view(m - 1, n))
        sinks = torch.cat([base.sinks, s_sinks.reshape(-1)])
        for j in range(self.n_par):
            if self.dcxA[j] is None and self.cxdA[j] is None:
                continue
            g = self.sens_action(j, t, pv, c=c)
            out[(j + 1) * n:(j + 2) * n].add_(g.p)
            sinks[(j + 1) * nc:(j + 2) * nc].add_(g.sinks)
        return FspVector(p=out, sinks=sinks)

    # ------------------------------------------------------------------
    def zero_vector(self) -> FspVector:
        m = 1 + self.n_par
        z = self.base.zero_vector()
        return FspVector(p=z.p.new_zeros(m * z.p.numel()),
                         sinks=z.sinks.new_zeros(m * z.sinks.numel()))

    def local_mv_flops(self) -> float:
        return self.base.local_mv_flops() * (1 + self.n_par)
