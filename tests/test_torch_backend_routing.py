"""Backend routing of the port's transient solver on the CPU: the box and
the compressed (ELL) backend give the same distribution, a box solve
migrates to the compressed backend mid-solve on the reference package's
memory budget (``PACMENSL_BOX_MEM_BUDGET``), the port's compressed solve
matches the reference package's, and ``"auto"`` routes as documented
(``tests/test_backend_routing.py`` on the port).  Every solve here pins
its backend; the routing cases call the routing methods.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pacmensl_tpu as pm  # noqa: E402
import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops import box_kernel as bk  # noqa: E402


def _solver(pkg, name, backend, odes_type="krylov", **kw):
    b = getattr(pkg.models, name)()
    s = pkg.FspSolverMultiSinks(backend=backend, odes_type=odes_type, **kw)
    s.set_model(b.model)
    s.set_constraint_functions(b.constraint)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors(b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    return s


def _as_dict(d):
    return {tuple(x): float(p) for x, p in zip(d.states, d.p)}


def _tv(d1, d2):
    a, b = _as_dict(d1), _as_dict(d2)
    return 0.5 * sum(abs(a.get(k, 0.0) - b.get(k, 0.0))
                     for k in set(a) | set(b))


@pytest.fixture(scope="module")
def rep_box():
    """The repressilator to t = 0.5 on the box (2,770 states)."""
    s = _solver(pt, "repressilator", "box", device="cpu")
    return s.solve(0.5, 1e-4), s


def test_repressilator_box_matches_ell(rep_box):
    d_box, s_box = rep_box
    s = _solver(pt, "repressilator", "ell", device="cpu")
    d_ell = s.solve(0.5, 1e-4)
    assert s_box._backend_used == "box" and s._backend_used == "ell"
    assert d_box.num_states == d_ell.num_states == 2770
    assert set(_as_dict(d_box)) == set(_as_dict(d_ell))
    assert _tv(d_box, d_ell) < 1e-5


def test_box_migrates_to_ell_on_budget(rep_box, monkeypatch):
    """A budget of 2.5 MB (5,040 box elements under Krylov) lets the
    first epochs run on the box, then the solve migrates."""
    monkeypatch.setenv("PACMENSL_BOX_MEM_BUDGET", "2.5e6")
    bk.KERNEL.reset_counts()
    s = _solver(pt, "repressilator", "box", device="cpu")
    d = s.solve(0.5, 1e-4)
    assert s._backend_used == "ell", "migration did not trigger"
    assert bk.KERNEL.plain_calls["synth"] > 0     # the box ran first
    assert isinstance(s._operator, pt.EllOperator)
    assert set(_as_dict(d)) == set(_as_dict(rep_box[0]))
    assert _tv(d, rep_box[0]) < 1e-5


def test_hog1p_3d_box_matches_ell():
    """hog1p_3d (time-varying, BDF) to t = 30 on both backends."""
    d1 = _solver(pt, "hog1p_3d", "box", "cvode", device="cpu").solve(
        30.0, 1e-4)
    d2 = _solver(pt, "hog1p_3d", "ell", "cvode", device="cpu").solve(
        30.0, 1e-4)
    assert d1.num_states == d2.num_states == 350
    assert _tv(d1, d2) < 1e-6


def test_ell_solve_matches_the_reference_package(monkeypatch):
    """The repressilator to t = 0.3 on both packages' compressed backend
    (the reference's plain gather): the same states in the same order."""
    monkeypatch.setenv("PACMENSL_ELL_GATHER", "plain")
    dj = _solver(pm, "repressilator", "ell").solve(0.3, 1e-4)
    dt = _solver(pt, "repressilator", "ell", device="cpu").solve(0.3, 1e-4)
    np.testing.assert_array_equal(dt.states, dj.states)
    np.testing.assert_array_equal(dt.bounds, dj.bounds)
    assert _tv(dt, dj) <= 1e-6


def test_fill_collapse_gate_ignores_headroom_padding():
    """The fill gate measures fill against the tight box of the current
    bounds, not the capacity (``tests/test_backend_routing.py:99``):
    36k states in a padded capacity of 2.5M elements, new bounds whose
    tight box is about 1.4e5 elements, stay on the box.  A sparse set
    in a large box leaves it under "auto", not under a pinned "box"."""
    s = _solver(pt, "repressilator", "box", device="cpu")
    s.solve(0.1, 1e-4)
    real_space = s._space

    class _Space:
        size = 2.5e6
        num_states = 36000

        def __getattr__(self, name):
            return getattr(real_space, name)

    s._space = _Space()
    s.backend = "auto"
    assert s._should_leave_box(
        np.asarray([51, 51, 51, 5000, 5000, 5000], np.int64)) is False
    # 36k states in a tight box of 150^3 = 3.4e6 elements (within the
    # memory budget): far below the floor
    big = np.asarray([149, 149, 149, 22201, 22201, 22201], np.int64)
    s.constraints = s.constraints.with_bounds(big)
    assert s._should_leave_box(big)
    s.backend = "box"
    assert not s._should_leave_box(big)


def test_auto_routing(monkeypatch):
    """On the host custom constraints take the compressed backend (the
    reference package's choice off the TPU), on a card the box;
    coordinate constraints the box unless it outgrows the budget; a mesh
    follows the same rule."""
    s = _solver(pt, "repressilator", "auto", device="cpu")
    assert s._choose_backend() == "ell"
    # the rule on a card (the device is only read, nothing is allocated)
    monkeypatch.setenv("PACMENSL_BOX_MEM_BUDGET", "8e9")
    s.device = torch.device("cuda", 0)
    assert s._choose_backend() == "box"
    monkeypatch.delenv("PACMENSL_BOX_MEM_BUDGET")
    b = pt.models.poisson(2.0)
    s = pt.FspSolverMultiSinks(device="cpu")
    assert s.backend == "auto"
    s.set_model(b.model)
    s.set_initial_bounds(b.bounds)
    s.set_initial_distribution(b.x0, b.p0)
    assert s._choose_backend() == "box"
    s.set_initial_bounds([10 ** 9])
    assert s._choose_backend() == "ell"
    s.mesh = object()
    assert s._choose_backend() == "ell"
    s.set_initial_bounds(b.bounds)
    assert s._choose_backend() == "box"


def test_mesh_with_ell_raises():
    """ELL takes a mesh (it raised before ``parallel/halo_ell.py``); a
    device other than the mesh's still raises."""
    from pacmensl_tpu_torch.parallel.mesh import StateMesh
    mesh = StateMesh(None, 0, 1, "cpu")
    s = pt.FspSolverMultiSinks(backend="ell", mesh=mesh)
    assert s.mesh is mesh and s.device == torch.device("cpu")
    s = pt.FspSolverMultiSinks(backend="ell", device="cpu")
    assert s.set_mesh(mesh).mesh is mesh
    with pytest.raises(pt.SetupError, match="device"):
        pt.FspSolverMultiSinks(backend="ell", device="cuda", mesh=mesh)
