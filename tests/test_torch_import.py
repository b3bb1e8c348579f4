"""The PyTorch port imports without JAX and contains no JAX import."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "pacmensl_tpu_torch"


def test_port_imports_with_jax_absent():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import pacmensl_tpu_torch as pt\n"
        "import pacmensl_tpu_torch.ops.box_kernel\n"
        "import pacmensl_tpu_torch.ops.probes\n"
        "import pacmensl_tpu_torch.tools.bw_probe\n"
        "import pacmensl_tpu_torch.tools.time_k1\n"
        "assert 'pacmensl_tpu' not in sys.modules\n"
        "b = pt.models.poisson()\n"
        "s = pt.FspSolverMultiSinks(odes_type='krylov', device='cpu')\n"
        "s.set_model(b.model).set_initial_bounds(b.bounds)\n"
        "s.set_initial_distribution(b.x0, b.p0)\n"
        "d = s.solve(1.0, 1e-4)\n"
        "assert abs(d.sum() - 1.0) < 1e-4\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_no_jax_import_in_port_sources():
    """Neither the port nor the script that drives it on a card."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|pacmensl_tpu)\b",
                     re.M)
    files = [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
    hits = [str(f.relative_to(ROOT)) for f in files
            if pat.search(f.read_text())]
    assert not hits, hits


def test_cuda_request_without_cuda_raises():
    import torch
    import pacmensl_tpu_torch as pt
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(pt.SetupError):
        pt.FspSolverMultiSinks(device="cuda")
