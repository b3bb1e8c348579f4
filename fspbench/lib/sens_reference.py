"""The plain reference of a forward-sensitivity solve: the probability
``p`` and its derivatives ``s_j = dp / d theta_j`` of the configuration's
network, in plain PyTorch, sharing no code with the program.

It reuses :mod:`.reference` by import: its state set (:class:`StateBox`),
its CSR generator with the sink rates (:class:`Generator`), its Poisson
weights and its step control.  Beside the generator ``A`` it builds, for
each parameter of the configuration's ``parameters``, the derivative
generator ``D_j = dA / d theta_j`` from the network's
``d_propensity(x, j, r, k)`` (times the request's rate factors) on the
parameter's reactions, sinks included, as a :class:`Generator` of a
network whose propensities are those derivatives.  It integrates the
block-lower-triangular system

    d/dt [p; s_j] = [A(t) p; A(t) s_j + D_j(t) p]

with ``s_j(0)`` from the configuration's ``dp0``.

Departures from the published method (the reference library's
``SensFspSolverMultiSinks``, which runs CVODE on the stacked system): the
steps are :mod:`.reference`'s, the fourth-order commutator-free Magnus
scheme applied to the block matrix ``M = [A, 0; D, A]`` (each of its
exponentials a combination of the two Gauss points' ``M``, so of the same
form), steps ending at t = 28.7 where the hog1p signal reaches 0; each
exponential is taken by uniformization at ``A``'s largest exit rate
``L``, which carries ``s`` beside ``p`` term by term:

    p_k = P p_{k-1},  s_k = P s_{k-1} + (D / L) p_{k-1},  P = I + A / L,

weighted by the same Poisson weights (``exp(tau M) = e^{-L tau}
sum_k (L tau)^k / k! (I + M / L)^k`` holds for any ``M``; the terms of
``s`` grow at most linearly in ``k``, so the Poisson tail left out stays
negligible).  The mass into each sink is integrated the same way: ``s_j``'s
sinks take ``A``'s sink rates on ``s_j`` plus ``D_j``'s on ``p``, as the
program's stacked action counts them.  Growth is decided on ``p``'s
outflow alone, as in :mod:`.reference`.

Its truncation is certified on ``p``'s mass only (the lost mass, at most
``reference.tol``, 1e-7 here, bounds ``p``'s L1 error).  The
sensitivities' truncation error has no such bound: it is small where the
left-out states hold little of ``p``, which the check's readings of sound
runs show, but nothing here certifies it.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from . import reference as ref
from .config import Config

#: the states a generator's building takes at a time
BLOCK = 1 << 23


@dataclass
class SensRefResult:
    box: ref.StateBox
    p: torch.Tensor            # [n] on the box's device, in ``dtype``
    s: torch.Tensor            # [Np, n]: dp / d theta_j
    lost: float                # p's mass that left: the truncation's bound
    sinks: np.ndarray          # [constraints]: the mass each sink took
    dsinks: np.ndarray         # [Np, constraints]: their derivatives
    steps: int
    redone: int
    terms: int


def parameters(cfg: Config) -> List[dict]:
    """The configuration's sensitivity parameters: ``name`` and
    ``reactions`` (those whose propensity depends on it)."""
    return cfg.data["parameters"]


def derivative_config(cfg: Config, j: int) -> Config:
    """A configuration whose propensities are d d_r / d theta_j on
    parameter j's reactions (0 on the others), with the network's time
    coefficients on its time-varying reactions among them: its generator
    is ``D_j``."""
    reactions = set(int(r) for r in parameters(cfg)[j]["reactions"])
    d_prop = cfg.net.d_propensity

    def propensity(x, r, k):
        if r not in reactions:
            return torch.zeros_like(x[:, 0])
        return d_prop(x, j, r, k)

    data = dict(cfg.data, tv_reactions=[r for r in cfg.tv_reactions
                                        if r in reactions])
    net = SimpleNamespace(propensity=propensity, t_coeff=cfg.net.t_coeff)
    return Config(name=f"{cfg.name}.d{j}", data=data, net=net)


def generator(box: ref.StateBox, factors, dtype,
              block: int = BLOCK) -> ref.Generator:
    """:class:`.reference.Generator` on ``box``, built ``block`` states
    at a time and joined: bitwise the one built at once (a row's entries
    depend on that row's state alone), with its building's scratch
    (about 230 B a state) held for one block only."""
    if box.n <= block:
        return ref.Generator(box, factors, dtype)
    parts = []
    for lo in range(0, box.n, block):
        part = copy.copy(box)
        part.states = box.states[lo:lo + block]
        part.n = int(part.states.shape[0])
        g = ref.Generator(part, factors, dtype)
        # the diagonal's column is the row within the block
        g.col[g.crow[:-1].to(torch.int64)] += lo
        parts.append(g)
    gen = parts[0]
    nnz = sum(int(g.col.numel()) for g in parts)
    itype = torch.int32 if nnz < 2**31 - 1 else torch.int64
    crow, at = [parts[0].crow[:1].to(itype)], 0
    for g in parts:
        crow.append(g.crow[1:].to(itype) + at)
        at += int(g.col.numel())
    gen.crow = torch.cat(crow)
    for name, dim in (("col", 0), ("vals", 1), ("flow", 2)):
        pieces = [getattr(g, name) for g in parts]
        for g in parts:
            setattr(g, name, None)
        joined = torch.cat(pieces, dim)
        del pieces
        setattr(gen, name, joined.to(itype) if name == "col" else joined)
    gen.diag_at = gen.crow[:-1].to(torch.int64)
    gen.n = box.n
    return gen


def derivative_generators(cfg: Config, box: ref.StateBox, factors,
                          dtype) -> List[ref.Generator]:
    """``D_j`` for each parameter, on ``box``."""
    out = []
    for j in range(len(parameters(cfg))):
        dbox = copy.copy(box)
        dbox.cfg = derivative_config(cfg, j)
        out.append(generator(dbox, factors, dtype))
    return out


def uniformize(A, lam: float, Ds, p: torch.Tensor, S, tau: float):
    """``(p', S', u, U, terms)``: ``exp(tau [A, 0; D_j, A])`` applied to
    ``[p; s_j]`` by uniformization at rate ``lam`` (``Ds``: each ``D_j``
    as CSR; ``S``: each ``s_j``), and the time integrals of ``p`` (``u``)
    and of each ``s_j`` (``U``) over the step, summed as
    :func:`.reference.uniformize` sums ``u``."""
    w = ref.poisson_weights(lam * tau)
    after = np.cumsum(w[::-1])[::-1]       # after[k] = sum_{j >= k} w_j
    v, W = p.clone(), [s.clone() for s in S]
    acc = v * float(w[0])
    accS = [x * float(w[0]) for x in W]
    u = torch.zeros_like(p)
    U = [torch.zeros_like(x) for x in S]
    for k in range(1, len(w)):
        a = float(after[k]) / lam
        u.add_(v, alpha=a)
        for Uj, Wj in zip(U, W):
            Uj.add_(Wj, alpha=a)
        # s_k = P s_{k-1} + (D / L) p_{k-1}: from the previous p
        W = [torch.addmv(torch.addmv(Wj, A, Wj, alpha=1.0 / lam), D, v,
                         alpha=1.0 / lam) for Wj, D in zip(W, Ds)]
        v = torch.addmv(v, A, v, alpha=1.0 / lam)
        acc.add_(v, alpha=float(w[k]))
        for x, Wj in zip(accS, W):
            x.add_(Wj, alpha=float(w[k]))
    return acc, accS, u, U, len(w) - 1


def _weights(gen, c1, c2, varies: bool):
    """A generator's group weights for each exponential of a step: one
    at the Gauss point where the coefficients do not vary, else the two
    commutator-free combinations."""
    if not varies:
        return [gen.weights(c1)]
    w1, w2 = gen.weights(c1), gen.weights(c2)
    return [[a * x + b * y for x, y in zip(w1, w2)]
            for a, b in ((ref._A1, ref._A2), (ref._A2, ref._A1))]


def solve(cfg: Config, factors, device, dtype=torch.float64,
          t_final: Optional[float] = None) -> SensRefResult:
    """The reference distribution and its sensitivities at ``t_final``
    (default: the configuration's) for rate factors ``factors``."""
    tol = float(cfg.data["reference"]["tol"])
    t_final = cfg.t_final if t_final is None else float(t_final)
    device = torch.device(device)
    n_par = len(parameters(cfg))
    grow = cfg.expansion_factors
    bounds = cfg.bounds.copy()
    box = ref.StateBox(cfg, bounds, device)
    at = box.index(cfg.x0)
    p = torch.zeros(box.n, dtype=dtype, device=device)
    p[at] = torch.as_tensor(cfg.p0, dtype=dtype, device=device)
    dp0 = np.asarray(cfg.data["dp0"], dtype=np.float64).reshape(n_par, -1)
    S = []
    for j in range(n_par):
        s = torch.zeros(box.n, dtype=dtype, device=device)
        s[at] = torch.as_tensor(dp0[j], dtype=dtype, device=device)
        S.append(s)
    gen = dgens = None
    t_const = ref._constant_from(cfg, t_final)
    t = 0.0
    taken = np.zeros(1 + len(bounds))            # [lost, sink per constraint]
    taken_s = np.zeros((n_par, 1 + len(bounds)))
    steps = redone = terms = 0
    while t < t_final * (1.0 - 1e-15):
        if gen is None:
            gen = generator(box, factors, dtype)
            dgens = derivative_generators(cfg, box, factors, dtype)
        h = min(t_final - t,
                ref.STEP_TERMS / gen.matrix(gen.weights(cfg.t_coeff(t)))[1])
        if t < t_const:
            h = min(h, t_const - t)
        if ref._varies(cfg, t, h) and h > ref.TV_STEP:
            h = ref.TV_STEP
        c1, c2 = cfg.t_coeff(t + ref._G1 * h), cfg.t_coeff(t + ref._G2 * h)
        varies = ref._varies(cfg, t, h)
        wA = _weights(gen, c1, c2, varies)
        wD = [_weights(g, c1, c2, varies) for g in dgens]
        q, Q = p, S
        step = np.zeros_like(taken)
        step_s = np.zeros_like(taken_s)
        for f, w in enumerate(wA):
            A, lam = gen.matrix(w)
            Ds = [g.matrix(wd[f])[0] for g, wd in zip(dgens, wD)]
            q, Q, u, U, k = uniformize(A, lam, Ds, q, Q, h)
            del A, Ds
            flows = gen.flows(w)
            step += (flows @ u).to(torch.float64).cpu().numpy()
            for j, (g, wd) in enumerate(zip(dgens, wD)):
                step_s[j] += (flows @ U[j] + g.flows(wd[f]) @ u).to(
                    torch.float64).cpu().numpy()
            del flows, u, U
            terms += k
        if step[0] > tol * h / t_final and (grow > 0).any():
            flux = step[1:].copy()
            flux[grow <= 0] = 0.0
            if flux.max() <= 0.0:
                raise RuntimeError("the reference loses mass through "
                                   "constraints it may not grow")
            up = flux >= ref.GROW_SHARE * flux.max()
            new = bounds.copy()
            new[up] = bounds[up] + np.maximum(
                1, np.ceil(grow[up] * bounds[up]).astype(np.int64))
            q = Q = gen = dgens = None
            nbox = ref.StateBox(cfg, new, device)
            into = nbox.index(box.states)
            grown = []
            for x in [p] + S:
                y = torch.zeros(nbox.n, dtype=dtype, device=device)
                y[into] = x
                grown.append(y)
            box, p, S, bounds = nbox, grown[0], grown[1:], new
            redone += 1
            continue
        p, S, t = q, Q, t + h
        taken += step
        taken_s += step_s
        steps += 1
    return SensRefResult(box=box, p=p, s=torch.stack(S), lost=float(taken[0]),
                         sinks=taken[1:], dsinks=taken_s[:, 1:], steps=steps,
                         redone=redone, terms=terms)
