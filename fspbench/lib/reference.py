"""The plain reference: an adaptive Finite State Projection solve of the
configuration's network in plain PyTorch, sharing no code with the
program.

It builds its own state set, the states of a box that satisfy every
constraint of the configuration at its own bounds, and its own generator
from the network (a CSR matrix, rows the targets): nothing the program
made.  Its truncation is certified by its own lost mass: the mass that
left the set, summed from the outflow as the solve runs, bounds the L1
distance of ``p`` to the CME's solution (up to rounding), and the solve
keeps it at most ``reference.tol`` by growing its bounds.

The integrator is the fourth-order commutator-free Magnus scheme (Blanes
and Moan): over a step ``[t, t + h]``, with ``A_i = A(t + g_i h)`` at the
two Gauss points,

    p <- exp(h (a2 A_1 + a1 A_2)) exp(h (a1 A_1 + a2 A_2)) p,
    a1 = 1/4 + sqrt(3)/6,  a2 = 1/4 - sqrt(3)/6,

each exponential taken by uniformization, ``exp(tau B) v = sum_k
Pois(k; L tau) (I + B/L)^k v`` with ``L`` the largest exit rate of ``B``.
Where the coefficients do not vary over the step the two factors are one
exponential of a generator, a series of non-negative terms, exact up to
the Poisson tail.  A step is ``L h <= STEP_TERMS`` long, at most
``TV_STEP`` where the coefficients vary, and ends where they stop varying
for good (the hog1p signal's clamp at 0), so no step straddles that kink.  A step that loses more than its
share of the budget (``tol * h / t_final``) is redone after the
constraints whose sinks took most of the step's outflow grow by their
expansion factors.  The sinks are the program's: each constraint's takes
the flow of every transition out of the set that violates it.  ``dtype`` is the vectors' and the generator's (float32 makes
the control).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .config import Config, constraint_values

#: the Poisson mean of one uniformization step
STEP_TERMS = 100.0
#: the longest step where the time coefficients vary
TV_STEP = 0.02
#: the Poisson tail left out of an exponential
TAIL = 1.0e-18
#: a constraint grows when its share of the outflow is at least this part
#: of the largest share
GROW_SHARE = 0.1

_A1 = 0.25 + math.sqrt(3.0) / 6.0
_A2 = 0.25 - math.sqrt(3.0) / 6.0
_G1 = 0.5 - math.sqrt(3.0) / 6.0
_G2 = 0.5 + math.sqrt(3.0) / 6.0


class StateBox:
    """The states of the box ``[0, b_d]`` (``b_d`` the bound of species
    d's coordinate constraint) that satisfy every constraint."""

    def __init__(self, cfg: Config, bounds, device, chunk: int = 1 << 24):
        self.cfg = cfg
        self.bounds = np.asarray(bounds, dtype=np.int64)
        self.device = torch.device(device)
        ext = np.full(cfg.num_species, -1, dtype=np.int64)
        for c, (weights, products) in enumerate(cfg.forms):
            if not products and len(weights) == 1 and weights[0][1] == 1:
                ext[weights[0][0]] = self.bounds[c]
        if (ext < 0).any():
            raise ValueError("every species needs a coordinate constraint")
        self.shape = tuple(int(e) + 1 for e in ext)
        self.strides = np.cumprod((1,) + self.shape[:0:-1])[::-1].copy()
        n_box = int(np.prod(self.shape))
        b = torch.as_tensor(self.bounds, device=self.device)
        lin = []
        for lo in range(0, n_box, chunk):
            ids = torch.arange(lo, min(lo + chunk, n_box), device=self.device)
            ok = (constraint_values(cfg.forms, self.decode(ids)) <= b).all(1)
            lin.append(ids[ok])
        lin = torch.cat(lin)
        self.n = int(lin.numel())
        self.lookup = torch.full((n_box,), -1, dtype=torch.int64,
                                 device=self.device)
        self.lookup[lin] = torch.arange(self.n, device=self.device)
        self.states = self.decode(lin)

    def decode(self, lin: torch.Tensor) -> torch.Tensor:
        """Coordinates [n, S] of linear box indices."""
        return torch.stack([(lin // int(st)) % sh for st, sh
                            in zip(self.strides, self.shape)], dim=1)

    def index(self, x) -> torch.Tensor:
        """Index in the set of states ``x [n, S]`` (int), -1 where a state
        is outside it."""
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.int64)
        shape = torch.as_tensor(self.shape, device=self.device)
        inside = ((x >= 0) & (x < shape)).all(1)
        st = torch.as_tensor(self.strides, device=self.device)
        lin = (torch.where(inside[:, None], x, 0) * st).sum(1)
        return torch.where(inside, self.lookup[lin], -1)


class Generator:
    """The CME generator on a :class:`StateBox` as one CSR pattern with a
    value array per group of reactions, the time-invariant reactions
    first, then each time-varying one, so ``A = sum_g w_g V_g`` for group
    weights ``w = [1, c_r(t) for each time-varying r]``.  Beside it, per
    group, the rates at which each state's mass leaves the set (row 0)
    and flows into each constraint's sink (row 1 + c): a transition out
    of the set adds its flow to the sink of every constraint it violates,
    as the program's sinks do, so the sinks can sum to more than the
    mass that left."""

    def __init__(self, box: StateBox, factors, dtype):
        cfg, n, dev = box.cfg, box.n, box.device
        R = cfg.num_reactions
        self.tv = list(cfg.tv_reactions)
        group = {r: 0 for r in range(R)}
        group.update({r: 1 + i for i, r in enumerate(self.tv)})
        xs = box.states.to(torch.float64)
        own = torch.arange(n, device=dev)
        cols = torch.empty((n, R + 1), dtype=torch.int64, device=dev)
        vals = torch.zeros((1 + len(self.tv), n, R + 1), dtype=torch.float64,
                           device=dev)
        b = torch.as_tensor(box.bounds, device=dev)
        flow = torch.zeros((1 + len(self.tv), 1 + len(box.bounds), n),
                           dtype=torch.float64, device=dev)
        cols[:, 0] = own
        for r in range(R):
            g = group[r]
            s = torch.as_tensor(cfg.stoich[r], device=dev)
            a = cfg.propensity(xs, r, factors)
            vals[g, :, 0] -= a
            y = box.states + s
            viol = (constraint_values(cfg.forms, y) > b) \
                & (y >= 0).all(1, keepdim=True)
            flow[g, 0] += torch.where(box.index(y) < 0, a, 0.0)
            flow[g, 1:] += (viol.to(torch.float64) * a[:, None]).T
            src = box.index(box.states - s)
            ok = src >= 0
            a_src = cfg.propensity((box.states - s).to(torch.float64), r,
                                   factors)
            cols[:, r + 1] = torch.where(ok, src, own)
            vals[g, :, r + 1] = torch.where(ok, a_src, 0.0)
        keep = (vals != 0).any(0)
        keep[:, 0] = True
        itype = torch.int32 if int(keep.sum()) < 2**31 - 1 else torch.int64
        self.crow = torch.zeros(n + 1, dtype=itype, device=dev)
        self.crow[1:] = torch.cumsum(keep.sum(1), 0)
        self.col = cols[keep].to(itype)
        self.vals = torch.stack([v[keep] for v in vals]).to(dtype)
        #: ``[groups, 1 + constraints, n]``: the outflow and sink rates
        self.flow = flow.to(dtype)
        self.diag_at = self.crow[:-1].to(torch.int64)
        self.n = n

    def weights(self, coeff) -> list:
        """Group weights at the coefficient vector ``coeff`` [R]."""
        return [1.0] + [float(coeff[r]) for r in self.tv]

    def matrix(self, w):
        """``(A, L)``: the CSR matrix sum_g w_g V_g and its largest exit
        rate."""
        v = self.vals[0] * w[0]
        for g in range(1, len(w)):
            v = v + self.vals[g] * w[g]
        lam = float(v[self.diag_at].abs().max()) * (1.0 + 1e-9)
        A = torch.sparse_csr_tensor(self.crow, self.col, v,
                                    size=(self.n, self.n))
        return A, max(lam, 1e-300)

    def flows(self, w) -> torch.Tensor:
        """``[1 + constraints, n]``: sum_g w_g of the groups' outflow
        and sink rates."""
        out = self.flow[0] * w[0]
        for g in range(1, len(w)):
            out = out + self.flow[g] * w[g]
        return out


def poisson_weights(x: float) -> np.ndarray:
    """Pois(k; x) for k = 0 .. K, past which the tail is below
    :data:`TAIL` (float64, from logs, so a large ``x`` does not
    underflow; scaled to sum to 1, which the left-out tail does not
    change in float64 and which cancels the logs' rounding)."""
    if x <= 0.0:
        return np.ones(1)
    K = int(x + 12.0 * math.sqrt(x) + 40.0)
    k = torch.arange(K + 1, dtype=torch.float64)
    w = torch.exp(-x + k * math.log(x) - torch.lgamma(k + 1.0)).numpy()
    tail = np.cumsum(w[::-1])[::-1]
    short = np.nonzero(tail < TAIL)[0]
    w = w[:short[0]] if short.size else w
    return w / w.sum()


def uniformize(A, lam: float, p: torch.Tensor, tau: float):
    """``(exp(tau A) p, u, terms)`` by uniformization at rate ``lam``.
    The mass that flows out through rates ``s`` (``[n]``, or one row per
    sink) over the step is ``s @ u``: with ``v_k = (I + A/L)^k p`` and
    Poisson weights ``w_k``, it is ``sum_k w_k sum_{i<k} s.v_i / L``, so
    ``u = sum_i v_i sum_{k>i} w_k / L``, summed as the series runs and
    free of the cancellation of the vector's sum."""
    w = poisson_weights(lam * tau)
    after = np.cumsum(w[::-1])[::-1]       # after[k] = sum_{j >= k} w_j
    v = p.clone()
    acc = v * float(w[0])
    u = torch.zeros_like(p)
    for k in range(1, len(w)):
        u.add_(v, alpha=float(after[k]) / lam)
        v = torch.addmv(v, A, v, alpha=1.0 / lam)
        acc.add_(v, alpha=float(w[k]))
    return acc, u, len(w) - 1


def _constant_from(cfg: Config, t_final: float) -> float:
    """The time from which the coefficients keep their value at
    ``t_final`` (0 for a time-invariant network), found by bisection and
    checked at 2,001 points.  Steps end there, so none straddles the
    point where, as the hog1p signal's clamp, the coefficients stop
    varying."""
    if not cfg.tv_reactions:
        return 0.0
    c_end = cfg.t_coeff(t_final)
    lo, hi = 0.0, t_final
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if torch.equal(cfg.t_coeff(mid), c_end):
            hi = mid
        else:
            lo = mid
    return t_final if _varies(cfg, hi, t_final - hi, 2001) else hi


def _varies(cfg: Config, t: float, h: float, points: int = 33) -> bool:
    """Whether the time coefficients take more than one value over
    ``[t, t + h]`` (sampled at ``points`` points, the ends included)."""
    c0 = cfg.t_coeff(t)
    return any(not torch.equal(cfg.t_coeff(t + h * x), c0)
               for x in np.linspace(0.0, 1.0, points)[1:])


@dataclass
class RefResult:
    box: StateBox
    p: torch.Tensor            # [n] on the box's device, in ``dtype``
    lost: float                # the mass that left: the truncation's bound
    sinks: np.ndarray          # [constraints]: the mass each sink took
    steps: int
    redone: int
    terms: int


def solve(cfg: Config, factors, device, dtype=torch.float64,
          t_final: Optional[float] = None) -> RefResult:
    """The reference distribution at ``t_final`` (default: the
    configuration's) for rate factors ``factors``."""
    tol = float(cfg.data["reference"]["tol"])
    t_final = cfg.t_final if t_final is None else float(t_final)
    device = torch.device(device)
    grow = cfg.expansion_factors
    bounds = cfg.bounds.copy()
    box = StateBox(cfg, bounds, device)
    p = torch.zeros(box.n, dtype=dtype, device=device)
    p[box.index(cfg.x0)] = torch.as_tensor(cfg.p0, dtype=dtype,
                                           device=device)
    gen = None
    t_const = _constant_from(cfg, t_final)
    t = 0.0
    taken = np.zeros(1 + len(bounds))      # [lost, sink per constraint]
    steps = redone = terms = 0
    while t < t_final * (1.0 - 1e-15):
        if gen is None:
            gen = Generator(box, factors, dtype)
        # L h <= STEP_TERMS at the rates the step starts with, and at most
        # TV_STEP where the coefficients vary over it
        h = min(t_final - t,
                STEP_TERMS / gen.matrix(gen.weights(cfg.t_coeff(t)))[1])
        if t < t_const:
            h = min(h, t_const - t)
        if _varies(cfg, t, h) and h > TV_STEP:
            h = TV_STEP
        c1, c2 = cfg.t_coeff(t + _G1 * h), cfg.t_coeff(t + _G2 * h)
        if not _varies(cfg, t, h):
            factors_h = [gen.weights(c1)]
        else:
            w1, w2 = gen.weights(c1), gen.weights(c2)
            factors_h = [[a * x + b * y for x, y in zip(w1, w2)]
                         for a, b in ((_A1, _A2), (_A2, _A1))]
        q, step = p, np.zeros_like(taken)
        for w in factors_h:
            A, lam = gen.matrix(w)
            q, u, k = uniformize(A, lam, q, h)
            step += (gen.flows(w) @ u).to(torch.float64).cpu().numpy()
            terms += k
        if step[0] > tol * h / t_final and (grow > 0).any():
            flux = step[1:].copy()
            flux[grow <= 0] = 0.0
            if flux.max() <= 0.0:
                raise RuntimeError("the reference loses mass through "
                                   "constraints it may not grow")
            up = flux >= GROW_SHARE * flux.max()
            new = bounds.copy()
            new[up] = bounds[up] + np.maximum(
                1, np.ceil(grow[up] * bounds[up]).astype(np.int64))
            nbox = StateBox(cfg, new, device)
            grown = torch.zeros(nbox.n, dtype=dtype, device=device)
            grown[nbox.index(box.states)] = p
            box, p, bounds, gen = nbox, grown, new, None
            redone += 1
            continue
        p, t = q, t + h
        taken += step
        steps += 1
    return RefResult(box=box, p=p, lost=float(taken[0]), sinks=taken[1:],
                     steps=steps, redone=redone, terms=terms)
