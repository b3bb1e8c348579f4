"""The traffic: a mix (``traffic/<mix>.json``) names the kind of its
requests (``request``: a module ``requests/<kind>.py``), and the
generator yields each request's rate factors.

A request is one call of the program.  The generator drives the
program as a parameter fit does, one caller in a closed loop, since a fit
waits on each call: at the published point, request 0 solves the point
and request j (1 .. R) the point with reaction j-1's rate factor stepped
by :data:`FD_STEP` (the fit's forward-difference gradient); then the
cycle repeats.  The seed picks the request the cycle starts at, so every seed
sends the same requests in another order."""
from __future__ import annotations

import json
from typing import Iterator, Tuple

import numpy as np

from .config import ROOT

#: the relative step of the forward-difference gradient's requests
FD_STEP = 0.01


def load(name: str) -> dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run's seed (any integer)."""
    return np.random.default_rng([int(seed) % 2**64, stream])


def requests(seed: int, n_reactions: int
             ) -> Iterator[Tuple[int, np.ndarray]]:
    """Each request's place in the cycle and its rate factors ``[R]``,
    forever."""
    j = int(rng(seed, 0).integers(n_reactions + 1))
    while True:
        f = np.ones(n_reactions)
        if j > 0:
            f[j - 1] += FD_STEP
        yield j, f
        j = (j + 1) % (n_reactions + 1)
