"""The reader of ``sens_graph_hit`` (the sensitivity solve's Arnoldi
iterations replayed from CUDA graphs) on hand-built solve records, None
where the program records no replay, and its entry in BENCHMARK.json."""
import pytest

from fspbench.lib import runner

CELL = "hog1p_5d_sens.sensfit"


def _solve(events):
    return runner.SolveRecord(seconds=1.0, events=events, n_states=10,
                              backend="box", capacity=(4, 4),
                              peak_bytes=0)


def test_reader():
    ctx = runner.Context(solves=[
        _solve({"GMRESCapture": (40, 0.2), "GMRESReplay": (800, 0.1),
                "SensAction": (900, 1.0)}),
        _solve({"GMRESCapture": (30, 0.2), "GMRESReplay": (1000, 0.1)}),
        # a solve without replays is left out of the mean
        _solve({"SensAction": (100, 0.5)})])
    got = runner.metric_reader("sens_graph_hit")(ctx)
    assert got == pytest.approx(
        (100.0 * (1 - 40 / 800) + 100.0 * (1 - 30 / 1000)) / 2, rel=1e-12)


def test_reader_without_replays():
    read = runner.metric_reader("sens_graph_hit")
    eager = [_solve({"SensAction": (900, 1.0), "GMRES": (100, 0.5),
                     "GMRESOrthogonalize": (800, 0.4)})]
    assert read(runner.Context(solves=eager)) is None
    assert read(runner.Context()) is None


def test_reader_listed():
    listed = {m["name"]: m for m in runner.benchmark()["per_layer"]}
    m = listed["sens_graph_hit"]
    assert m["moves"] == "solve_s" and m["workloads"] == [CELL]
    assert m["layer"] == "sensitivity operator"
    assert m["source"] == "program_counter" and m["unit"] == "%"
    assert listed["arnoldi_graph_hit"]["workloads"] == ["hog1p_5d.fit"]
