"""BENCHMARK.json keeps to the benchmark's rules (keys, names, units,
bounds), and one run on the host, at a small size, prints a result line
of the expected form."""
import json
import re

import pytest

from fspbench.lib import runner

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json():
    b = runner.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("fspbench/")
        assert NAME.match(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert (runner.ROOT / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(trace):
    res = runner.run_cell(
        "hog1p_5d.fit", 2**31 + 5, 0.5, bool(trace), "cpu", 0.0,
        log=lambda *a, **k: None,
        overrides={"t_final": 0.2, "warmup": [{"t_final": 0.02}]})
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = {"solve_s", "setup_s"} if not trace else {
        "expand_s", "n_states", "ell_share", "ode_s", "rhs_evals",
        "action_host_us"}
    assert set(line["metrics"]) == want
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
