"""The hog1p 5-species network as plain torch: the reference model
header's propensities (``hog1p_5d_model.h``) with the rates of
``hog1p_5d.json``.  Reaction 2 (gene 1 -> 0) scales with the time-varying
Hog1p signal."""
import torch


def _ind(cond, like):
    return cond.to(like.dtype)


def propensity(x, r, k):
    """State factor d_r(x) at ``x [n, 5]`` (float64), rates ``k``."""
    g = x[:, 0]
    if r == 0:
        return (k["k12"] * _ind(g == 0, x) + k["k23"] * _ind(g == 1, x)
                + k["k34"] * _ind(g == 2, x))
    if r == 1:
        return k["k32"] * _ind(g == 2, x) + k["k43"] * _ind(g == 3, x)
    if r == 2:
        return 1.0 * _ind(g == 1, x)
    if r == 3:
        return (k["kr21"] * _ind(g == 1, x) + k["kr31"] * _ind(g == 2, x)
                + k["kr41"] * _ind(g == 3, x))
    if r == 4:
        return (k["kr22"] * _ind(g == 1, x) + k["kr32"] * _ind(g == 2, x)
                + k["kr42"] * _ind(g == 3, x))
    if r == 5:
        return k["trans"] * x[:, 1]
    if r == 6:
        return k["trans"] * x[:, 2]
    if r == 7:
        return k["gamma1"] * x[:, 3]
    if r == 8:
        return k["gamma2"] * x[:, 4]
    raise ValueError(r)


def t_coeff(t, k):
    """Time coefficients c_r(t) [9]: the signal on reaction 2, else 1."""
    t = torch.as_tensor(t, dtype=torch.float64)
    h1 = (1.0 - torch.exp(-k["signal_r1"] * t)) * torch.exp(-k["signal_r2"] * t)
    hog1p = torch.pow(h1 / (1.0 + h1 / k["signal_M"]), k["signal_eta"]) \
        * k["signal_A"]
    c = torch.ones(9, dtype=torch.float64)
    c[2] = torch.clamp(3200.0 - 7710.0 * hog1p, min=0.0)
    return c
