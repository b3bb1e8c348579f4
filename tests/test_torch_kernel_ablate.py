"""The port's ablation and fixed-cost probes of the box kernel
(``pacmensl_tpu_torch/tools/kernel_ablate.py``, ``tools/base_probe.py``,
``ops/ablation.py``) on the CPU.

Each ablation variant's plain version is held against the reference
package's fused Pallas kernel (``PallasBoxKernel``, interpret mode on the
CPU, as ``tests/test_pallas.py`` runs it) built with the arguments of the
reference's ``tools/kernel_ablate.py`` (its ``build()``), in float64 at a
16^3 repressilator box, within rtol 1e-12 / atol 1e-13.  The reference's
operator passes its probed ``sink_active``; here every (reaction,
constraint) pair is evaluated (``sink_active=None``), which gives the same
sinks (the pairs the probe drops add zeros).  The two switch builds'
plain versions are held against straightforward numpy, and the tools run
end to end on the CPU."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.ops.pallas_box import PallasBoxKernel  # noqa: E402
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops import ablation  # noqa: E402
from pacmensl_tpu_torch.ops import box_kernel as bk  # noqa: E402
from pacmensl_tpu_torch.ops import cuda_build  # noqa: E402
from pacmensl_tpu_torch.ops.vecops import FspVector  # noqa: E402
from pacmensl_tpu_torch.sys.errors import SetupError  # noqa: E402
from pacmensl_tpu_torch.tools import base_probe  # noqa: E402
from pacmensl_tpu_torch.tools import kernel_ablate as ka  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-13)
SHAPE = (16, 16, 16)
ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bench():
    """The 16^3 bench box and its variants' plain outputs."""
    case = ka.bench_case(SHAPE, CPU, seed=11)
    return case, {k: v.plain() for k, v in ka.variants(case).items()}


# the reference's tools/kernel_ablate.py build() arguments, per variant
_REF = {"full": {}, "r1": {"enable_reactions": [0]},
        "r2": {"enable_reactions": [0, 1]},
        "nosink": {"components": None, "sink_active": None,
                   "synth_mask": False},
        "unitnosink": {"propensity": lambda x, r: jnp.ones_like(x[:, 0]),
                       "components": None, "sink_active": None,
                       "synth_mask": False}}


@pytest.mark.parametrize("name", list(_REF))
def test_variant_matches_the_reference_kernel(bench, name):
    case, outs = bench
    b = pm.models.repressilator()
    bounds = np.asarray(SHAPE) - 1
    cs = pm.ConstraintSet(None, bounds, np.full(3, 0.2))
    args = dict(propensity=b.model.propensity,
                stoichiometry=b.model.stoichiometry, shape=SHAPE,
                enable_reactions=range(6), dtype=jnp.float64,
                components=cs.components, synth_mask=True, sink_active=None,
                interpret=True)
    args.update(_REF[name])
    k = PallasBoxKernel(**args)
    p = case.p.numpy().reshape(SHAPE)
    dp, sinks = k(jnp.ones(len(k.reactions), jnp.float64),
                  jnp.asarray(bounds, jnp.int32), jnp.asarray(p),
                  jnp.ones(SHAPE, jnp.float64))
    got_dp, got_sk = outs[name]
    np.testing.assert_allclose(got_dp.numpy(), np.asarray(dp).reshape(-1),
                               **TOL)
    if sinks is None:
        assert got_sk.numel() == 0
    else:
        assert np.abs(np.asarray(sinks)).max() > 0
        np.testing.assert_allclose(got_sk.numpy(), np.asarray(sinks), **TOL)


def test_variants_are_the_operators_actions():
    """kernel_ablate's ``full``, ``r1`` and ``r2`` are the actions of the
    operators ``BoxOperator(enable_reactions=...)`` on the same space,
    bitwise (here their plain versions)."""
    b = pt.models.repressilator()
    cs = pt.ConstraintSet(b.constraint, np.array([22, 2, 2, 44, 4, 44]),
                          b.expansion_factors)
    space = pt.BoxStateSpace(b.model.stoichiometry, cs, b.x0, device="cpu")
    op = pt.BoxOperator(b.model, space)
    rng = np.random.default_rng(3)
    p = torch.as_tensor(np.where(space.mask_host.reshape(-1),
                                 rng.random(op.geom.n), 0.0))
    vs = ka.variants(ka.operator_case("repressilator", op, p, 0.0))
    for name, rs in (("full", None), ("r1", [0]), ("r2", [0, 1])):
        sub = pt.BoxOperator(b.model, space, enable_reactions=rs)
        want = sub.action(0.0, FspVector(p=p, sinks=torch.zeros(
            op.num_constraints, dtype=torch.float64)))
        got = vs[name].run()
        assert torch.equal(got[0], want.p) and torch.equal(got[1],
                                                           want.sinks)


def _small_operator(name, bounds):
    """A bundle's operator at small ``bounds``, from the origin (the
    bundles' initial states may lie outside them)."""
    b = pt.models.ALL_MODELS[name]()
    cs = pt.ConstraintSet(b.constraint, bounds, b.expansion_factors)
    S = b.model.num_species
    space = pt.BoxStateSpace(b.model.stoichiometry, cs,
                             np.zeros((1, S), np.int64), device="cpu")
    return b, pt.BoxOperator(b.model, space)


def _form_np(f, y):
    """One constraint form at the points ``y [m, S]``, in numpy."""
    v = np.zeros(y.shape[0], dtype=np.int64)
    for d, w in f.weights:
        v += w * y[:, d]
    for u, i, j in f.products:
        v += u * y[:, i] * y[:, j]
    if f.gate is not None:
        v = np.where(y[:, f.gate[0]] == f.gate[1], v, 0)
    return v


def _zero_coords_numpy(c, pbuf, a, bounds, geom):
    """The zero-coords action element by element."""
    shape, S, pad = geom.shape, len(geom.shape), ablation.source_pad(geom)
    tabs = [None if t is None else t.numpy().reshape(-1) for t in a.tables]

    def ok_at(y):
        return all(_form_np(f, y[None])[0] <= b
                   for f, b in zip(geom.form, bounds))

    def prop(r, y):
        ax = a.axis[r]
        return tabs[r][0] if ax == bk.CONST_AXIS else tabs[r][y[ax]]
    pb = pbuf.numpy()
    dp = np.zeros(geom.n)
    sinks = np.zeros(geom.nc)
    for i in range(geom.n):
        z = np.array(np.unravel_index(i, shape))
        z[1:S - 1] = 0
        if not ok_at(z):
            continue
        for r in range(geom.num_reactions):
            s = geom.stoich[r]
            ap = prop(r, z) * pb[pad + i]
            src = z - s
            inflow = 0.0
            if (np.all(src >= 0) and np.all(src < shape)
                    and ok_at(src)):
                inflow = prop(r, src) * pb[pad + i - geom.kflat[r]]
            dp[i] += c[r] * (inflow - ap)
            for cc, f in enumerate(geom.form):
                if _form_np(f, (z + s)[None])[0] > bounds[cc]:
                    sinks[cc] += c[r] * ap
    return dp, sinks


@pytest.mark.parametrize("name,bounds", [
    ("repressilator", [4, 2, 2, 8, 4, 8]),
    ("hog1p_5d", [1, 2, 2, 2, 2, 3, 3]),
])
def test_zero_coords_plain_version_against_numpy(name, bounds):
    b, op = _small_operator(name, bounds)
    cs = op.space.constraints
    assert op.synth_mask and op.props.num_field_rows == 0
    rng = np.random.default_rng(7)
    p = torch.as_tensor(rng.random(op.geom.n))
    pbuf = ablation.padded_p(p, op.geom)
    c = b.model.coefficients(5.0)
    got = ablation.zero_coords(c, pbuf, op.props, cs.bounds, op.geom)
    want = _zero_coords_numpy(c.tolist(), pbuf, op.props, cs.bounds,
                              op.geom)
    np.testing.assert_allclose(got[0].numpy(), want[0], **TOL)
    np.testing.assert_allclose(got[1].numpy(), want[1], **TOL)
    assert np.abs(want[1]).max() > 0
    # every row takes row 0's coordinates: not the production action
    assert not torch.equal(got[0], bk.box_action_synth_reference(
        c, p, op.props, cs.bounds, op.geom)[0])


def test_tail_sum_against_numpy():
    """The tail's order (a strided sum per thread, then a tree) sums the
    partial rows within 1e-12 of numpy; the no-tail wrapper's plain
    version returns the sinks as one partial row."""
    rng = np.random.default_rng(2)
    for rows in (1, 255, 256, 257, 1000, bk.SLOTS):
        part = rng.standard_normal((rows, 3))
        got = ablation.tail_sum(torch.as_tensor(part)).numpy()
        np.testing.assert_allclose(got, part.sum(axis=0), rtol=1e-12,
                                   atol=1e-13)
    case = ka.bench_case((4, 5, 6), CPU)
    pa = ka.parts(case)
    dp, part = ablation.no_tail(pa.c, case.p, pa.props, pa.geom, pa.bounds)
    want = bk.box_action_synth_reference(pa.c, case.p, pa.props, pa.bounds,
                                         pa.geom)
    assert torch.equal(dp, want[0])
    assert torch.equal(ablation.tail_sum(part), want[1])


@pytest.mark.parametrize("tool,lines", [("kernel_ablate", 7),
                                        ("base_probe", 6)])
def test_tool_runs_on_the_cpu(tool, lines):
    """``--device cpu``: exit 0, one line per variant."""
    got = subprocess.run(
        [sys.executable, "-m", f"pacmensl_tpu_torch.tools.{tool}",
         "--device", "cpu", "--shape", "8", "8", "8"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr
    rows = [ln for ln in got.stderr.splitlines()
            if ln.startswith(f"[{tool}] 8x8x8 repressilator box ")
            and "(the plain version)" in ln]
    assert len(rows) == lines, got.stderr


@pytest.mark.parametrize("tool", [ka, base_probe])
def test_tool_needs_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SetupError):
        tool.main([])


def test_tools_on_operators_of_both_modes():
    """What ``chip_smoke.py`` phase 14 runs on a solve's operators, here on
    the plain versions: a K3 operator (every variant) and a K1 operator
    with field rows (no full-K1).  Neither box is wholly valid, so neither
    times the zero-coords build (it would give every row row 0's valid
    elements) and each says why; the wholly valid bench box does time
    it."""
    for name, bounds, synth, why in (
            ("repressilator", [4, 2, 2, 8, 4, 8], True,
             "rows differ in validity"),
            ("transcr_reg_6d", [10, 6, 2, 3, 2, 4], False,
             "propensity tables only")):
        b, op = _small_operator(name, bounds)
        assert op.synth_mask == synth
        p = torch.as_tensor(np.random.default_rng(1).random(op.geom.n))
        case = ka.operator_case(name, op, p, 0.0)
        assert case.to("cpu").p is case.p and case.n_valid < case.n
        got = ka.ablate(case, "host", rounds=1, out=lambda s: None)
        assert list(got) == (["full", "r1", "r2", "nosink", "unitnosink"]
                             + (["full-K1"] if synth else []) + ["no-tail"])
        lines = []
        probe = base_probe.device_side(case, "host", rounds=1,
                                       out=lines.append)
        assert list(probe) == ["full", "no-tail", "K1, zero mask",
                               "K1, one row", "K1, one row, no tail"]
        assert "the decode: not timed (" in lines[-1] and why in lines[-1]
    bench = ka.bench_case((4, 5, 6), CPU)
    assert bench.n_valid == bench.n
    assert "zero-coords" in base_probe.device_side(bench, "host", rounds=1,
                                                   out=lambda s: None)


def test_ablation_builds_stay_out_of_production():
    """No production flag defines a switch; each ablation build is its own
    library object with its own build file and counters; only the two
    measurement tools import the ablation module."""
    assert not any("BOX_ABLATE" in f for f in cuda_build.NVCC_FLAGS)
    assert bk.KERNEL.flags == cuda_build.NVCC_FLAGS
    paths = {cuda_build.library_path(bk.SOURCE, bk.KERNEL.flags)}
    for kern in (ablation.NO_TAIL, ablation.ZERO_COORDS):
        assert kern is not bk.KERNEL and kern.launches is not \
            bk.KERNEL.launches
        assert f"-D{ablation.SWITCHES[kern.name]}" in kern.flags
        paths.add(cuda_build.library_path(kern.source, kern.flags))
    assert len(paths) == 3
    pkg = ROOT / "pacmensl_tpu_torch"
    users = sorted(str(f.relative_to(pkg)) for f in pkg.rglob("*.py")
                   if "ablation" in f.read_text()
                   and f.name != "ablation.py")
    assert users == ["tools/base_probe.py", "tools/kernel_ablate.py"]
