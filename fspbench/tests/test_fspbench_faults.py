"""A run with its timed path broken underneath comes out not correct:
the harness (past its look for a card) on the host at a small size
(``hog1p_5d.fit`` to t = 2), with each fault the cell can have.  A solve
has no batch and runs on one card, so the batch and the exchange faults
have no place."""
import contextlib

import pytest
import torch

from fspbench.lib import port, runner
from pacmensl_tpu_torch import FspSolverMultiSinks
from pacmensl_tpu_torch.ops.vecops import FspVector

SMALL = {"t_final": 2.0, "warmup": [{"t_final": 0.1}]}


@contextlib.contextmanager
def unchanged():
    """Every step returns its state unchanged: the action is zero."""
    saved = [(c, c.action) for c in port.operator_classes()]

    def zero(self, t, y, c=None, out=None):
        return FspVector(p=torch.zeros_like(y.p),
                         sinks=torch.zeros_like(y.sinks))
    try:
        for c, _ in saved:
            c.action = zero
        yield
    finally:
        for c, orig in saved:
            c.action = orig


@contextlib.contextmanager
def answer_altered():
    """The distribution is altered where it is produced: 1e-4 more mass
    on its first state."""
    orig = FspSolverMultiSinks._make_distribution

    def make(self):
        d = orig(self)
        d.p = d.p.copy()
        d.p[0] += 1e-4
        return d
    FspSolverMultiSinks._make_distribution = make
    try:
        yield
    finally:
        FspSolverMultiSinks._make_distribution = orig


@pytest.mark.parametrize("fault", [None, unchanged, answer_altered])
def test_fault_makes_the_run_incorrect(fault):
    res = runner.run_cell("hog1p_5d.fit", 2**31 + 3, 0.2, False, "cpu",
                          0.0, log=lambda *a, **k: None, overrides=SMALL,
                          fault=fault)
    assert res["correct"] is (fault is None), res["checks"]
