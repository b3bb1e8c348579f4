"""Species-axis order of the dense box.

Counterpart of ``pacmensl_tpu/statespace/permute.py``.  A box's axis
order is free: a state's position in the box is pure layout.  The box
backend lays its species axes out by descending extent
(:func:`choose_axis_order`), the same order as the reference package, so
both packages run the same capacities, epochs and sums.  On the H100 the
order sets what axis 0 is: the slab axis of a sharded box, whose halo is
``w0`` planes of ``n / shape[0]`` elements each, and the rows of the
kernel's last axis.

This module rewrites a (model, constraints, initial states) problem into
an internal species order: stoichiometry columns and initial-state
columns permute, while propensity and constraint callables receive a
column-remapping view (:class:`_PermCols`) so user code keeps seeing its
own species indices.  The closed constraint forms the CUDA kernel
evaluates (``ConstraintSet.form``) name species too, so they are rewritten
to internal columns.  Constraint outputs (bounds, sinks) keep user order,
so the driver translates only the state columns of its output.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.model import Model, SensModel
from .constraints import ConstraintForm, ConstraintSet, coord


class _PermCols:
    """Column-remapping view of a ``[n, S]`` tensor: ``v[:, i]`` reads
    column ``inv[i]`` of the wrapped tensor.  It has the tensor's
    ``dtype``, ``device``, ``shape`` and ``is_floating_point()``, and
    ``.to(...)`` returns a view of the converted tensor: what the
    library's propensities and constraints use."""

    __slots__ = ("_x", "_inv")

    def __init__(self, x, inv):
        self._x = x
        self._inv = inv

    @property
    def dtype(self):
        return self._x.dtype

    @property
    def device(self):
        return self._x.device

    @property
    def shape(self):
        return self._x.shape

    def is_floating_point(self) -> bool:
        return self._x.is_floating_point()

    def to(self, *args, **kwargs) -> "_PermCols":
        return _PermCols(self._x.to(*args, **kwargs), self._inv)

    def __getitem__(self, key):
        if (isinstance(key, tuple) and len(key) == 2
                and isinstance(key[0], slice) and key[0] == slice(None)
                and isinstance(key[1], (int, np.integer))):
            return self._x[:, int(self._inv[key[1]])]
        raise TypeError(
            f"permuted state view supports only x[:, i] access, got {key!r}")


def choose_axis_order(box_extents) -> Optional[np.ndarray]:
    """The reference package's axis order: the largest extent on axis 0,
    the second and third largest on the last two axes (the second largest
    last), the rest in the middle, ties in index order; None where that
    is the current order.  Not idempotent on ties: applied to extents
    already in this order it may return another permutation of equal
    extents, so the driver compares orders derived from user-order
    extents."""
    ext = np.asarray(box_extents, dtype=np.int64)
    S = ext.shape[0]
    idx = np.argsort(-ext, kind="stable")
    if S <= 2:
        order = idx
    else:
        order = np.concatenate([idx[:1], idx[3:], idx[2:3], idx[1:2]])
    if (order == np.arange(S)).all():
        return None
    return order


def _wrap_cols(fn, inv):
    """Wrap a callable whose first argument is a states batch."""
    def wrapped(x, *args):
        return fn(_PermCols(x, inv), *args)
    return wrapped


def permute_model(model: Model, order) -> Model:
    """``model`` in internal species order ``order`` (internal axis j =
    user species ``order[j]``); the propensity, and a sensitivity model's
    ``d_propensity``, keep seeing user indices."""
    order = np.asarray(order, dtype=np.int64)
    inv = np.argsort(order)
    stoich = model.stoichiometry[:, order]
    names = (None if model.species_names is None
             else [model.species_names[int(s)] for s in order])
    if isinstance(model, SensModel):
        d_prop = (None if model.d_propensity is None
                  else _wrap_cols(model.d_propensity, inv))
        return SensModel(stoich, _wrap_cols(model.propensity, inv),
                         model.t_coeff, model.tv_reactions, names,
                         num_parameters=model.num_parameters,
                         d_t_coeff=model.d_t_coeff,
                         dtcoef_sparsity=model.dtcoef_sparsity,
                         d_propensity=d_prop,
                         dprop_sparsity=model.dprop_sparsity)
    return Model(stoich, _wrap_cols(model.propensity, inv),
                 model.t_coeff, model.tv_reactions, names)


def permute_form(form: ConstraintForm, inv) -> ConstraintForm:
    """``form`` over internal columns: user species i is internal column
    ``inv[i]``."""
    def col(d):
        return int(inv[int(d)])
    return ConstraintForm(
        weights=tuple((col(d), int(w)) for d, w in form.weights),
        products=tuple((int(u), col(i), col(j))
                       for u, i, j in form.products),
        gate=(None if form.gate is None
              else (col(form.gate[0]), int(form.gate[1]))))


def permute_constraints(cs: ConstraintSet, order,
                        num_species: int) -> ConstraintSet:
    """A constraint set whose function, components and form read
    internally ordered coordinates; the order of its outputs (bounds,
    sinks) is unchanged.  The default coordinate constraints become
    explicit user-column getters, so their outputs stay in user species
    order.  The function carries its components and form as attributes,
    so a set rebuilt from it (``ConstraintSet(cs.fn, ...)``) stays
    permuted."""
    order = np.asarray(order, dtype=np.int64)
    inv = np.argsort(order)
    if cs.fn is None:
        # constraint i = user species i = internal column inv[i]
        cols = [int(inv[i]) for i in range(num_species)]

        def fn(x):
            return x[:, cols]
        fn.components = tuple((lambda x, _c=c: x[:, _c]) for c in cols)
        fn.form = tuple(coord(c) for c in cols)
    else:
        fn = _wrap_cols(cs.fn, inv)
        comps = getattr(cs.fn, "components", None)
        if comps is not None:
            fn.components = tuple(_wrap_cols(c, inv) for c in comps)
        if cs.form is not None:
            fn.form = tuple(permute_form(f, inv) for f in cs.form)
    return ConstraintSet(fn, cs.bounds, cs.expansion_factors, num_species)


def permute_box(box: torch.Tensor, extents, axes, shape) -> torch.Tensor:
    """A box-shaped tensor of another layout carried into this one: cut to
    the old box's ``extents``, axes transposed (new axis j = old axis
    ``axes[j]``), zero-padded to ``shape``.  Every value keeps its state,
    bit for bit."""
    v = box[tuple(slice(0, int(e)) for e in extents)].permute(*axes)
    out = box.new_zeros(tuple(int(s) for s in shape))
    out[tuple(slice(0, int(e)) for e in v.shape)] = v
    return out
