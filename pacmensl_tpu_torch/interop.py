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


def bundle_arrays(bundle) -> Dict[str, np.ndarray]:
    """The numpy arrays that define a bundled model of either package:
    stoichiometry, time-varying reactions, bounds, expansion factors and
    the initial distribution."""
    return {
        "stoichiometry": np.asarray(bundle.model.stoichiometry, np.int64),
        "tv_reactions": np.asarray(bundle.model.tv_reactions, np.int64),
        "bounds": np.asarray(bundle.bounds, np.int64),
        "expansion_factors": np.asarray(bundle.expansion_factors,
                                        np.float64),
        "x0": np.asarray(bundle.x0, np.int64),
        "p0": np.asarray(bundle.p0, np.float64),
    }
