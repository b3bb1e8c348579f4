"""No module of the benchmark imports JAX or the JAX package; names are
compared by their top-level part, whole, so the port
(``pacmensl_tpu_torch``) passes and ``pacmensl_tpu`` does not."""
import ast
import sys
from pathlib import Path

from fspbench.lib import runner

BENCH = Path(__file__).resolve().parents[1]


def imported_top_levels(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = set(imported_top_levels(f)) & set(runner.FORBIDDEN)
        assert not bad, (f, bad)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pacmensl_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxy", sys)
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pacmensl_tpu.ops", sys)
    assert runner.forbidden_modules() == ["pacmensl_tpu"]
