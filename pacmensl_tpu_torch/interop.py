"""Carrying state between the reference package and the port.

Neither direction imports JAX: distributions cross as numpy arrays (or the
``.npz`` checkpoint both packages write), and bundles are compared through
the numpy arrays that define them.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .fsp.distribution import DiscreteDistribution
from .sensfsp.sens_distribution import SensDiscreteDistribution


def distribution_from_reference(obj_or_npz) -> DiscreteDistribution:
    """A port distribution from a reference-package distribution object or
    from the path of a ``.npz`` checkpoint written by either package."""
    if isinstance(obj_or_npz, (str, os.PathLike)):
        return DiscreteDistribution.load(obj_or_npz)
    o = obj_or_npz
    bounds = getattr(o, "bounds", None)
    sinks = getattr(o, "sinks", None)
    return DiscreteDistribution(
        t=float(o.t), states=np.asarray(o.states, dtype=np.int64),
        p=np.asarray(o.p, dtype=np.float64),
        bounds=None if bounds is None else np.asarray(bounds),
        sinks=None if sinks is None else np.asarray(sinks))


def distribution_to_reference(dist: DiscreteDistribution,
                              path: Optional[str] = None) -> Dict:
    """The reference package's ``DiscreteDistribution`` fields as numpy
    values (``DiscreteDistribution(**fields)`` there rebuilds it); with
    ``path``, also writes them as a checkpoint its ``load`` reads."""
    fields = {"t": float(dist.t),
              "states": np.asarray(dist.states, dtype=np.int64),
              "p": np.asarray(dist.p, dtype=np.float64),
              "bounds": None if dist.bounds is None
              else np.asarray(dist.bounds),
              "sinks": None if dist.sinks is None
              else np.asarray(dist.sinks)}
    if path is not None:
        dist.save(path)
    return fields


def sens_distribution_from_reference(obj_or_npz
                                     ) -> SensDiscreteDistribution:
    """A port sensitivity distribution from a reference-package one
    (``dp`` included) or from the path of a ``.npz`` checkpoint written
    by either package."""
    if isinstance(obj_or_npz, (str, os.PathLike)):
        return SensDiscreteDistribution.load(obj_or_npz)
    d = distribution_from_reference(obj_or_npz)
    dp = getattr(obj_or_npz, "dp", None)
    return SensDiscreteDistribution(
        t=d.t, states=d.states, p=d.p, bounds=d.bounds, sinks=d.sinks,
        dp=None if dp is None else np.asarray(dp, dtype=np.float64))


def sens_distribution_to_reference(dist: SensDiscreteDistribution,
                                   path: Optional[str] = None) -> Dict:
    """The reference package's ``SensDiscreteDistribution`` fields as
    numpy values (``dp`` included); with ``path``, also writes them as a
    checkpoint its ``load`` reads."""
    fields = distribution_to_reference(dist, path)
    fields["dp"] = (None if dist.dp is None
                    else np.asarray(dist.dp, dtype=np.float64))
    return fields


def _sparsity(lists) -> np.ndarray:
    """Per-parameter reaction lists as one ``[n_par, longest]`` int64
    array padded with -1."""
    width = max((len(s) for s in lists), default=0)
    out = np.full((len(lists), width), -1, np.int64)
    for j, s in enumerate(lists):
        out[j, :len(s)] = s
    return out


def bundle_arrays(bundle) -> Dict[str, np.ndarray]:
    """The numpy arrays that define a bundled model of either package:
    stoichiometry, time-varying reactions, bounds, expansion factors, the
    initial distribution, and for a sensitivity model its parameter count
    and the reactions of each parameter's derivative propensities and
    time coefficients (``[n_par, longest]``, padded with -1; 0 and empty
    for a plain model)."""
    m = bundle.model
    return {
        "stoichiometry": np.asarray(m.stoichiometry, np.int64),
        "tv_reactions": np.asarray(m.tv_reactions, np.int64),
        "bounds": np.asarray(bundle.bounds, np.int64),
        "expansion_factors": np.asarray(bundle.expansion_factors,
                                        np.float64),
        "x0": np.asarray(bundle.x0, np.int64),
        "p0": np.asarray(bundle.p0, np.float64),
        "num_parameters": np.asarray(getattr(m, "num_parameters", 0),
                                     np.int64),
        "dprop_sparsity": _sparsity(getattr(m, "dprop_sparsity", ())),
        "dtcoef_sparsity": _sparsity(getattr(m, "dtcoef_sparsity", ())),
    }
