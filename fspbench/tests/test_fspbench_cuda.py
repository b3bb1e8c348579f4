"""On the card (marked ``cuda``; skipped without one): a traced run of
one solve reads the device trace, and at each cell's own size the
control fails while the program passes (about three minutes).

    python -m pytest --noconftest -m cuda fspbench/tests/test_fspbench_cuda.py
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from fspbench import control  # noqa: E402
from fspbench.lib import runner  # noqa: E402


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_traced_run_on_the_card(card):
    res = runner.run_cell(
        "hog1p_5d.fit", 2**31 + 21, 1.0, True, card, 0.0,
        log=lambda *a, **k: None)
    assert res["correct"] is True, res["checks"]
    dev = res["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    m = res["metrics"]
    assert 0 < m["operator_roofline"]["value"] <= 100
    assert 0 <= m["device_idle"]["value"] < 100
    assert res["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  runner.benchmark()["workloads"]])
def test_control_fails_on_the_card(card, cell):
    got = control.readings(cell, 2**31 + 23, card)
    lim = got["limits"]
    assert all(got["sound"][k] <= v for k, v in lim.items()), got["sound"]
    assert any(got["control"][k] > v for k, v in lim.items()), \
        got["control"]
