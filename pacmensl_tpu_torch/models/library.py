"""Bundled example models.

Counterpart of ``pacmensl_tpu/models/library.py``, with the same rate
constants, constraint functions and ``components``, bounds, expansion
factors and initial conditions:

* toggle switch            (``src/Models/toggle_model.h``)
* repressilator            (``src/Models/repressilator_model.h``)
* hog1p 3-species MAPK     (``src/Models/hog1p_3d_model.h``)
* hog1p 5-species MAPK     (``src/Models/hog1p_5d_model.h``)
* 6-species transcription regulation
  (``src/Models/transcription_regulation_6d_model.h``)

plus the analytic-oracle models of the reference test-suite (Poisson
pure-birth, birth-death, telegraph).  The sensitivity bundles are not
ported yet; ``telegraph`` is the plain model of the reference's telegraph
fixture.

Propensities are batched torch functions over ``states[n, S]``; the
arithmetic follows the reference package operation by operation, so the
fields agree with it to within an ulp.  Every custom constraint function
also carries ``form``, the closed form of its scores that the CUDA box
kernel evaluates (``statespace/constraints.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..statespace.constraints import coord, gated, linear, product
from .model import Model


def _f(x):
    """Cast states to a float dtype for propensity arithmetic, keeping the
    caller's dtype when it is already floating."""
    if x.is_floating_point():
        return x
    return x.to(torch.float64)


def _ind(cond, like):
    """Indicator of a boolean tensor in the dtype of ``like``."""
    return cond.to(like.dtype)


def _ipow(x, n: int):
    """x**n for small non-negative integer n by repeated squaring (the
    reference package's rounding for integer Hill exponents)."""
    assert n >= 1 and n == int(n)
    n = int(n)
    out = None
    sq = x
    while n:
        if n & 1:
            out = sq if out is None else out * sq
        n >>= 1
        if n:
            sq = sq * sq
    return out


@dataclass
class BundledModel:
    model: Model
    constraint: Optional[Callable]       # (states[n,S]) -> [n, n_c] int; None = coord bounds
    bounds: np.ndarray                   # [n_c] int
    expansion_factors: np.ndarray        # [n_c] float
    x0: np.ndarray                       # [n_init, S] int
    p0: np.ndarray                       # [n_init] float
    name: str
    # Optional hyper-rectangle variant (reference *_hyperrec)
    bounds_hyperrec: Optional[np.ndarray] = None
    expansion_factors_hyperrec: Optional[np.ndarray] = None


# --------------------------------------------------------------- toggle ---

def toggle() -> BundledModel:
    """Two-species genetic toggle switch (toggle_model.h:8-51)."""
    ayx, axy, nyx, nxy = 2.6e-3, 6.1e-3, 3.0, 2.1
    kx0, kx, dx = 2.2e-3, 1.7e-2, 3.8e-4
    ky0, ky, dy = 6.8e-5, 1.6e-2, 3.8e-4
    stoich = np.array([[1, 0], [1, 0], [-1, 0], [0, 1], [0, 1], [0, -1]])

    def prop(x, r):
        xf = _f(x)
        if r == 0:
            return torch.full_like(xf[:, 0], kx0)
        if r == 1:
            return kx / (1.0 + ayx * _ipow(xf[:, 1], 3))  # nyx = 3
        if r == 2:
            return dx * xf[:, 0]
        if r == 3:
            return torch.full_like(xf[:, 0], ky0)
        if r == 4:
            return ky / (1.0 + axy * torch.pow(xf[:, 0], nxy))
        if r == 5:
            return dy * xf[:, 1]
        raise ValueError(r)

    def constr(x):
        return torch.stack([x[:, 0], x[:, 1], x[:, 0] * x[:, 1]], dim=1)

    constr.components = (lambda x: x[:, 0], lambda x: x[:, 1],
                         lambda x: x[:, 0] * x[:, 1])
    constr.form = (coord(0), coord(1), product(0, 1))

    return BundledModel(
        model=Model(stoich, prop),
        constraint=constr,
        bounds=np.array([200, 200, 2000]),
        expansion_factors=np.array([0.2, 0.2, 0.2]),
        x0=np.array([[0, 0]]), p0=np.array([1.0]),
        name="toggle",
    )


# --------------------------------------------------------- repressilator ---

def repressilator() -> BundledModel:
    """Three-gene repressilator (repressilator_model.h:8-59)."""
    k1, ka, ket, kg = 100.0, 20.0, 6.0, 1.0
    stoich = np.array([
        [1, 0, 0], [-1, 0, 0],
        [0, 1, 0], [0, -1, 0],
        [0, 0, 1], [0, 0, -1],
    ])

    def prop(x, r):
        xf = _f(x)
        if r == 0:
            return k1 / (1.0 + ka * _ipow(xf[:, 1], 6))  # ket = 6
        if r == 1:
            return kg * xf[:, 0]
        if r == 2:
            return k1 / (1.0 + ka * _ipow(xf[:, 2], 6))
        if r == 3:
            return kg * xf[:, 1]
        if r == 4:
            return k1 / (1.0 + ka * _ipow(xf[:, 0], 6))
        if r == 5:
            return kg * xf[:, 2]
        raise ValueError(r)

    def constr(x):
        return torch.stack([
            x[:, 0], x[:, 1], x[:, 2],
            x[:, 0] * x[:, 1], x[:, 2] * x[:, 1], x[:, 0] * x[:, 2],
        ], dim=1)

    constr.components = (
        lambda x: x[:, 0], lambda x: x[:, 1], lambda x: x[:, 2],
        lambda x: x[:, 0] * x[:, 1], lambda x: x[:, 2] * x[:, 1],
        lambda x: x[:, 0] * x[:, 2])
    constr.form = (coord(0), coord(1), coord(2),
                   product(0, 1), product(2, 1), product(0, 2))

    return BundledModel(
        model=Model(stoich, prop),
        constraint=constr,
        bounds=np.array([22, 2, 2, 44, 4, 44]),
        expansion_factors=np.array([0.2] * 6),
        bounds_hyperrec=np.array([22, 2, 2]),
        expansion_factors_hyperrec=np.array([0.2, 0.2, 0.2]),
        x0=np.array([[21, 0, 0]]), p0=np.array([1.0]),
        name="repressilator",
    )


# ------------------------------------------------------------- hog1p 5d ---

def _hog_signal(t: float) -> torch.Tensor:
    """Time-varying Hog1p signal shared by the 3d/5d MAPK models
    (hog1p_5d_model.h:54-64)."""
    r1, r2, eta, Ahog, Mhog = 6.9e-5, 7.1e-3, 3.1, 9.3e9, 6.4e-4
    t = torch.as_tensor(t, dtype=torch.float64)
    h1 = (1.0 - torch.exp(-r1 * t)) * torch.exp(-r2 * t)
    hog1p = torch.pow(h1 / (1.0 + h1 / Mhog), eta) * Ahog
    return torch.clamp(3200.0 - 7710.0 * hog1p, min=0.0)


def hog1p_5d() -> BundledModel:
    """Five-species hog1p MAPK model with time-varying gene activation
    (hog1p_5d_model.h); reaction 2 is time-varying."""
    k12, k23, k34 = 1.29, 0.0067, 0.133
    k32, k43, k21 = 0.027, 0.0381, 1.0
    kr21, kr31, kr41 = 0.005, 0.45, 0.025
    kr22, kr32, kr42 = 0.0116, 0.987, 0.0538
    trans, gamma1, gamma2 = 0.01, 0.001, 0.0049

    stoich = np.array([
        [1, 0, 0, 0, 0], [-1, 0, 0, 0, 0], [-1, 0, 0, 0, 0],
        [0, 1, 0, 0, 0], [0, 0, 1, 0, 0],
        [0, -1, 0, 1, 0], [0, 0, -1, 0, 1],
        [0, 0, 0, -1, 0], [0, 0, 0, 0, -1],
    ])

    def prop(x, r):
        g = x[:, 0]
        xf = _f(x)
        if r == 0:
            return (k12 * _ind(g == 0, xf) + k23 * _ind(g == 1, xf)
                    + k34 * _ind(g == 2, xf))
        if r == 1:
            return k32 * _ind(g == 2, xf) + k43 * _ind(g == 3, xf)
        if r == 2:
            return 1.0 * _ind(g == 1, xf)       # x c_2(t) = signal
        if r == 3:
            return (kr21 * _ind(g == 1, xf) + kr31 * _ind(g == 2, xf)
                    + kr41 * _ind(g == 3, xf))
        if r == 4:
            return (kr22 * _ind(g == 1, xf) + kr32 * _ind(g == 2, xf)
                    + kr42 * _ind(g == 3, xf))
        if r == 5:
            return trans * xf[:, 1]
        if r == 6:
            return trans * xf[:, 2]
        if r == 7:
            return gamma1 * xf[:, 3]
        if r == 8:
            return gamma2 * xf[:, 4]
        raise ValueError(r)

    def t_coeff(t):
        c = torch.ones(9, dtype=torch.float64)
        c[2] = _hog_signal(t)
        return c

    def constr(x):
        return torch.stack([
            x[:, 0], x[:, 1], x[:, 2], x[:, 3], x[:, 4],
            x[:, 1] + x[:, 3], x[:, 2] + x[:, 4],
        ], dim=1)

    constr.components = (
        lambda x: x[:, 0], lambda x: x[:, 1], lambda x: x[:, 2],
        lambda x: x[:, 3], lambda x: x[:, 4],
        lambda x: x[:, 1] + x[:, 3], lambda x: x[:, 2] + x[:, 4])
    constr.form = tuple(coord(d) for d in range(5)) + (
        linear({1: 1, 3: 1}), linear({2: 1, 4: 1}))

    return BundledModel(
        model=Model(stoich, prop, t_coeff, tv_reactions=(2,)),
        constraint=constr,
        bounds=np.array([3, 10, 10, 10, 10, 10, 10]),
        expansion_factors=np.array([0.0, .25, .25, .25, .25, .25, .25]),
        bounds_hyperrec=np.array([3, 10, 10, 10, 10]),
        expansion_factors_hyperrec=np.array([0.0, .25, .25, .25, .25]),
        x0=np.array([[0, 0, 0, 0, 0]]), p0=np.array([1.0]),
        name="hog1p_5d",
    )


def hog1p_3d() -> BundledModel:
    """Three-species reduction of the hog1p model (hog1p_3d_model.h)."""
    k12, k21, k23 = 1.29, 1.0, 0.0067
    k32, k34, k43 = 0.027, 0.133, 0.0381
    kr2, kr3, kr4 = 0.0116, 0.987, 0.0538
    trans, gamma = 0.01, 0.0049

    stoich = np.array([
        [1, 0, 0], [-1, 0, 0], [-1, 0, 0],
        [0, 1, 0], [0, -1, 1], [0, -1, 0], [0, 0, -1],
    ])

    def prop(x, r):
        g = x[:, 0]
        xf = _f(x)
        if r == 0:
            return (k12 * _ind(g == 0, xf) + k23 * _ind(g == 1, xf)
                    + k34 * _ind(g == 2, xf))
        if r == 1:
            return k32 * _ind(g == 2, xf) + k43 * _ind(g == 3, xf)
        if r == 2:
            return 1.0 * _ind(g == 1, xf)
        if r == 3:
            return (kr2 * _ind(g == 1, xf) + kr3 * _ind(g == 2, xf)
                    + kr4 * _ind(g == 3, xf))
        if r == 4:
            return trans * xf[:, 1]
        if r == 5:
            return gamma * xf[:, 1]
        if r == 6:
            return gamma * xf[:, 2]
        raise ValueError(r)

    def t_coeff(t):
        c = torch.ones(7, dtype=torch.float64)
        c[2] = _hog_signal(t)
        return c

    def constr(x):
        rna = x[:, 1] + x[:, 2]
        return torch.stack([
            x[:, 0], x[:, 1], x[:, 2],
            (x[:, 0] == 0) * rna, (x[:, 0] == 1) * rna,
            (x[:, 0] == 2) * rna, (x[:, 0] == 3) * rna,
        ], dim=1)

    constr.components = tuple(
        [lambda x: x[:, 0], lambda x: x[:, 1], lambda x: x[:, 2]] +
        [(lambda x, _g=g: (x[:, 0] == _g) * (x[:, 1] + x[:, 2]))
         for g in range(4)])
    constr.form = tuple(coord(d) for d in range(3)) + tuple(
        gated(0, g, linear({1: 1, 2: 1})) for g in range(4))

    return BundledModel(
        model=Model(stoich, prop, t_coeff, tv_reactions=(2,)),
        constraint=constr,
        bounds=np.array([3, 4, 4, 1, 10, 10, 10]),
        expansion_factors=np.array([0.0, .5, .5, .5, .5, .5, .5]),
        x0=np.array([[0, 0, 0]]), p0=np.array([1.0]),
        name="hog1p_3d",
    )


# ----------------------------------------------- transcr reg (6d) ---

def transcription_regulation_6d() -> BundledModel:
    """Six-species transcription regulation with cell-volume growth
    (transcription_regulation_6d_model.h); reactions 4, 6, 8 time-varying."""
    c0, c1, c2, c3 = 0.043, 0.0007, 0.078, 0.0039
    c5, c7, c9 = 0.4791, 0.8765e-11, 0.5
    avg_cell_cyc_time = 35 * 60.0

    stoich = np.array([
        # species:  M    D   RNAP  DNA.D  DNA.2D  RNA
        [1, 0, 0, 0, 0, 0],        # 0: transcription RNA->M
        [-1, 0, 0, 0, 0, 0],       # 1: M degradation
        [0, 0, 0, 0, 0, 1],        # 2: RNA production from DNA.D
        [0, 0, 0, 0, 0, -1],       # 3: RNA degradation
        [0, -1, -1, 1, 0, 0],      # 4: D + RNAP -> DNA.D
        [0, 1, 1, -1, 0, 0],       # 5: DNA.D -> D + RNAP
        [0, -1, 0, -1, 1, 0],      # 6: DNA.D + D -> DNA.2D
        [0, 1, 0, 1, -1, 0],       # 7: DNA.2D -> DNA.D + D
        [-2, 1, 0, 0, 0, 0],       # 8: 2M -> D
        [2, -1, 0, 0, 0, 0],       # 9: D -> 2M
    ])

    def prop(x, r):
        xf = _f(x)
        if r == 0:
            return c0 * xf[:, 5]
        if r == 1:
            return c1 * xf[:, 0]
        if r == 2:
            return c2 * xf[:, 3]
        if r == 3:
            return c3 * xf[:, 5]
        if r == 4:
            return xf[:, 1] * xf[:, 2]
        if r == 5:
            return c5 * xf[:, 3]
        if r == 6:
            return xf[:, 3] * xf[:, 1]
        if r == 7:
            return c7 * xf[:, 4]
        if r == 8:
            return 0.5 * xf[:, 0] * (xf[:, 0] - 1.0)
        if r == 9:
            return c9 * xf[:, 1]
        raise ValueError(r)

    def t_coeff(t):
        av = 6.022140857e8 * torch.pow(
            torch.tensor(2.0, dtype=torch.float64),
            torch.as_tensor(t, dtype=torch.float64) / avg_cell_cyc_time)
        c = torch.ones(10, dtype=torch.float64)
        c[4] = 0.012e9 / av
        c[6] = 0.00012e9 / av
        c[8] = 0.05e9 / av
        return c

    return BundledModel(
        model=Model(stoich, prop, t_coeff, tv_reactions=(4, 6, 8)),
        constraint=None,   # default coordinate-wise bounds
        bounds=np.array([10, 6, 1, 2, 1, 1]),
        expansion_factors=np.array([0.5] * 6),
        bounds_hyperrec=np.array([10, 6, 1, 2, 1, 1]),
        expansion_factors_hyperrec=np.array([0.5] * 6),
        x0=np.array([[2, 6, 0, 2, 0, 0]]), p0=np.array([1.0]),
        name="transcr_reg_6d",
    )


# ------------------------------------------------------ analytic oracles ---

def poisson(rate: float = 2.0) -> BundledModel:
    """Pure-birth process; p(t) is exactly Poisson(rate*t) (the
    reference's main correctness oracle, tests/test_fsp_solver.cpp)."""
    stoich = np.array([[1]])

    def prop(x, r):
        return torch.full_like(_f(x)[:, 0], rate)

    return BundledModel(
        model=Model(stoich, prop),
        constraint=None,
        bounds=np.array([5]),
        expansion_factors=np.array([0.1]),
        x0=np.array([[0]]), p0=np.array([1.0]),
        name="poisson",
    )


def birth_death(birth: float = 1.0, death: float = 0.1) -> BundledModel:
    """Birth-death process; stationary law is Poisson(birth/death)."""
    stoich = np.array([[1], [-1]])

    def prop(x, r):
        if r == 0:
            return torch.full_like(_f(x)[:, 0], birth)
        return death * _f(x)[:, 0]

    return BundledModel(
        model=Model(stoich, prop),
        constraint=None,
        bounds=np.array([10]),
        expansion_factors=np.array([0.25]),
        x0=np.array([[0]]), p0=np.array([1.0]),
        name="birth_death",
    )


def telegraph(k01: float = 1.0e-2, k10: float = 1.0e-1,
              kr: float = 10.0, gamma: float = 1.0) -> BundledModel:
    """Telegraph (bursting gene) model: gene off/on + mRNA.
    Species: (g_off, g_on, rna)."""
    stoich = np.array([
        [-1, 1, 0], [1, -1, 0], [0, 0, 1], [0, 0, -1],
    ])

    def prop(x, r):
        xf = _f(x)
        if r == 0:
            return k01 * xf[:, 0]
        if r == 1:
            return k10 * xf[:, 1]
        if r == 2:
            return kr * xf[:, 1]
        if r == 3:
            return gamma * xf[:, 2]
        raise ValueError(r)

    return BundledModel(
        model=Model(stoich, prop), constraint=None,
        bounds=np.array([2, 2, 1]),
        expansion_factors=np.array([0.25, 0.25, 0.25]),
        x0=np.array([[1, 0, 0]]), p0=np.array([1.0]),
        name="telegraph",
    )


ALL_MODELS = {
    "toggle": toggle,
    "repressilator": repressilator,
    "hog1p_3d": hog1p_3d,
    "hog1p_5d": hog1p_5d,
    "transcr_reg_6d": transcription_regulation_6d,
    "poisson": poisson,
    "birth_death": birth_death,
    "telegraph": telegraph,
}
