"""A configuration: ``configs/<name>.json`` (the numbers) and the network
module it names (the propensity formulas as plain torch).  Nothing here
imports the program; the harness hands the same network to the program
(:mod:`.port`) and to the reference (:mod:`.reference`)."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

#: one constraint score, f(x) = sum_d w_d x_d + sum_k u_k x_i x_j
Form = Tuple[Tuple[Tuple[int, int], ...], Tuple[Tuple[int, int, int], ...]]


@dataclass
class Config:
    name: str
    data: dict
    net: ModuleType

    @property
    def stoich(self) -> np.ndarray:
        return np.asarray(self.data["stoichiometry"], dtype=np.int64)

    @property
    def num_reactions(self) -> int:
        return self.stoich.shape[0]

    @property
    def num_species(self) -> int:
        return self.stoich.shape[1]

    @property
    def rates(self) -> dict:
        return self.data["rates"]

    @property
    def forms(self) -> List[Form]:
        return [(tuple(tuple(int(v) for v in w) for w in c.get("weights", ())),
                 tuple(tuple(int(v) for v in u) for u in c.get("products", ())))
                for c in self.data["constraints"]]

    @property
    def bounds(self) -> np.ndarray:
        return np.asarray(self.data["bounds"], dtype=np.int64)

    @property
    def expansion_factors(self) -> np.ndarray:
        return np.asarray(self.data["expansion_factors"], dtype=np.float64)

    @property
    def x0(self) -> np.ndarray:
        return np.asarray(self.data["x0"], dtype=np.int64)

    @property
    def p0(self) -> np.ndarray:
        return np.asarray(self.data["p0"], dtype=np.float64)

    @property
    def t_final(self) -> float:
        return float(self.data["t_final"])

    @property
    def fsp_tol(self) -> float:
        return float(self.data["fsp_tol"])

    @property
    def tv_reactions(self) -> Tuple[int, ...]:
        return tuple(int(r) for r in self.data.get("tv_reactions", ()))

    def propensity(self, x: torch.Tensor, r: int, factors) -> torch.Tensor:
        """factor_r * d_r(x) at float states ``x [n, S]``."""
        return float(factors[r]) * self.net.propensity(x, r, self.rates)

    def t_coeff(self, t: float) -> torch.Tensor:
        """c(t) [R] (float64, host): 1 outside ``tv_reactions``."""
        c = torch.as_tensor(self.net.t_coeff(float(t), self.rates),
                            dtype=torch.float64).reshape(-1)
        ones = torch.ones(self.num_reactions, dtype=torch.float64)
        tv = torch.zeros(self.num_reactions, dtype=torch.bool)
        tv[list(self.tv_reactions)] = True
        return torch.where(tv, c, ones)


def constraint_values(forms, x: torch.Tensor) -> torch.Tensor:
    """Scores of ``forms`` at integer states ``x [n, S]``: [n, n_c]
    int64."""
    x = x.to(torch.int64)
    cols = []
    for weights, products in forms:
        v = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        for d, w in weights:
            v = v + w * x[:, d]
        for u, i, j in products:
            v = v + u * x[:, i] * x[:, j]
        cols.append(v)
    return torch.stack(cols, dim=1)


def _load_module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"fspbench_net_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(name: str) -> Config:
    """``configs/<name>.json`` and its network module."""
    path = ROOT / "configs" / f"{name}.json"
    data = json.loads(path.read_text())
    return Config(name=name, data=data,
                  net=_load_module(path.parent / data["network"]))
