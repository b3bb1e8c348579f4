"""The frozen count of an operator action's work, on a hand-counted
state set."""
import numpy as np

from fspbench.lib import config, counts, port


def test_action_work_by_hand():
    # 6 states, 3 sinks, 2 reactions
    assert counts.action_work(6, 3, 2) == (16 * 6 + 8 * 3, 4 * 2 * 6)


def test_action_work_on_the_programs_operator():
    # the repressilator at its initial bounds [22, 2, 2, 44, 4, 44]: every
    # x1, x2 in 0..2 (x1 x2 <= 4) and x0 in 0..22 (x0 x1, x0 x2 <= 44):
    # 23 * 3 * 3 = 207 states, 6 sinks, 6 reactions
    cfg = config.load("repressilator_box")
    s = port.new_solver(cfg, np.ones(6), "cpu", backend="box")
    s.set_up()
    assert s.num_states == 207
    assert port.action_work(s._operator) == (16 * 207 + 8 * 6,
                                             4 * 6 * 207)
    s = port.new_solver(cfg, np.ones(6), "cpu", backend="ell")
    s.set_up()
    assert port.action_work(s._operator) == (16 * 207 + 8 * 6,
                                             4 * 6 * 207)
