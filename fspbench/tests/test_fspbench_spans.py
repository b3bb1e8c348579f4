"""The readers of the program's own spans and host-sync counters
(``host_syncs``, ``sync_wait_s``, ``orthogonalize_s``, ``action_us``,
``coefficients_us``) on hand-built solve records, and None where the
program records no such event (a checkout without the spans)."""
import pytest

from fspbench.lib import runner


def _solve(events):
    return runner.SolveRecord(seconds=1.0, events=events, n_states=10,
                              backend="box", capacity=(4, 4),
                              peak_bytes=0)


#: two solves as the program records them: (count, seconds) by name
WITH_SPANS = [
    _solve({"ODESolve": (1, 8.0), "RHSEvaluation": (100, 0.0),
            "HostSync.GMRESColumn": (80, 1.5),
            "HostSync.BDFErrorNorm": (10, 0.5),
            "GMRESOrthogonalize": (80, 2.0),
            "OperatorAction": (110, 0.22),
            "ModelCoefficients": (110, 0.011)}),
    _solve({"ODESolve": (1, 6.0), "RHSEvaluation": (60, 0.0),
            "HostSync.GMRESColumn": (40, 0.5),
            "HostSync.StopCheck": (10, 0.5),
            "GMRESOrthogonalize": (40, 1.0),
            "OperatorAction": (90, 0.18),
            "ModelCoefficients": (90, 0.009)}),
]
#: the same solves recorded by a program without the spans
WITHOUT = [_solve({"ODESolve": (1, 8.0), "RHSEvaluation": (100, 0.0),
                   "HostFetch": (1, 0.1)})] * 2

EXPECTED = {
    "host_syncs": (90 + 50) / 2,
    "sync_wait_s": (2.0 + 1.0) / 2,
    "orthogonalize_s": (2.0 + 1.0) / 2,
    "action_us": 1e6 * 0.40 / 200,
    "coefficients_us": 1e6 * 0.02 / 200,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    read = runner.metric_reader(name)
    assert read(runner.Context(solves=WITH_SPANS)) == pytest.approx(
        EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_spans(name):
    read = runner.metric_reader(name)
    assert read(runner.Context(solves=WITHOUT)) is None
    assert read(runner.Context()) is None


def test_readers_listed():
    listed = {m["name"]: m for m in runner.benchmark()["per_layer"]}
    for name in EXPECTED:
        assert listed[name]["moves"] == "solve_s"
        assert listed[name]["workloads"] == ["hog1p_5d.fit"]
