"""The three-gene repressilator as plain torch: the reference model
header's propensities (``repressilator_model.h:8-59``) with the rates of
``repressilator.json``."""
import torch


def _ipow(x, n):
    """x**n for a small integer n by repeated squaring (the header's
    integer Hill exponent, rounded as the library rounds it)."""
    out, sq = None, x
    while n:
        if n & 1:
            out = sq if out is None else out * sq
        n >>= 1
        if n:
            sq = sq * sq
    return out


def propensity(x, r, k):
    """State factor d_r(x) at ``x [n, 3]`` (float64), rates ``k``."""
    k1, ka, ket, kg = k["k1"], k["ka"], int(k["ket"]), k["kg"]
    if r == 0:
        return k1 / (1.0 + ka * _ipow(x[:, 1], ket))
    if r == 1:
        return kg * x[:, 0]
    if r == 2:
        return k1 / (1.0 + ka * _ipow(x[:, 2], ket))
    if r == 3:
        return kg * x[:, 1]
    if r == 4:
        return k1 / (1.0 + ka * _ipow(x[:, 0], ket))
    if r == 5:
        return kg * x[:, 2]
    raise ValueError(r)


def t_coeff(t, k):
    """Time-invariant: every coefficient 1."""
    return torch.ones(6, dtype=torch.float64)
