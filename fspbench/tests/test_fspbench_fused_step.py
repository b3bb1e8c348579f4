"""The reader of ``fused_step_share`` (BDF's step attempts that took the
fused CUDA passes) on hand-built solve records, None where the program
records no fused step, and its entry in BENCHMARK.json."""
import pytest

from fspbench.lib import runner

CELLS = ["hog1p_5d.fit", "hog1p_5d_sens.sensfit"]


def _solve(events):
    return runner.SolveRecord(seconds=1.0, events=events, n_states=10,
                              backend="box", capacity=(4, 4),
                              peak_bytes=0)


def test_reader():
    read = runner.metric_reader("fused_step_share")
    ctx = runner.Context(solves=[
        # every attempt fused, whatever the epochs and the stop-check's
        # refusals
        _solve({"ODESolve": (30, 9.0), "ODESteps": (1400, 0.0),
                "ODEStepsRejected": (50, 0.0),
                "HostSync.BDFErrorNorm": (1479, 1.0),
                "BDFFusedStep": (1479, 0.0)}),
        # half the attempts fused
        _solve({"ODESolve": (1, 2.0), "ODESteps": (90, 0.0),
                "ODEStepsRejected": (10, 0.0),
                "HostSync.BDFErrorNorm": (100, 0.1),
                "BDFFusedStep": (50, 0.0)}),
        # a solve without fused steps is left out of the mean
        _solve({"ODESolve": (2, 1.0), "ODESteps": (80, 0.0),
                "HostSync.BDFErrorNorm": (81, 0.1)})])
    assert read(ctx) == pytest.approx((100.0 + 50.0) / 2, rel=1e-12)


def test_reader_without_fused_steps():
    read = runner.metric_reader("fused_step_share")
    torch_ops = [_solve({"ODESolve": (3, 1.0), "ODESteps": (500, 0.0),
                         "ODEStepsRejected": (4, 0.0),
                         "HostSync.BDFErrorNorm": (506, 0.2),
                         "GMRES": (506, 0.5)})]
    assert read(runner.Context(solves=torch_ops)) is None
    assert read(runner.Context()) is None


def test_reader_listed():
    listed = {m["name"]: m for m in runner.benchmark()["per_layer"]}
    m = listed["fused_step_share"]
    assert m["moves"] == "solve_s" and m["workloads"] == CELLS
    assert m["layer"] == listed["ode_s"]["layer"] == "integrator"
    assert m["source"] == "program_counter" and m["unit"] == "%"
    assert m["better"] == "higher"
