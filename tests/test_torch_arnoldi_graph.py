"""GMRES's Arnoldi iterations replayed from CUDA graphs (``ops/gmres.py``
``ArnoldiGraphs``, driven by BDF on a box operator without a mesh, and on
a box sensitivity operator's stacked action).

On a card: a graph solve of hog1p_5d gives the eager solve's ``p`` and
sinks bitwise, with the same steps, RHS evaluations, expansions and box
kernel launches; so does a box sensitivity solve of hog1p_3d_sens, in
``p``, ``dp`` and the sinks, with the stacked action's counters
``SensActionStates`` and ``SensActionSinks`` counting each replayed
action as the eager solve counts it; a graph captured at one ``t`` and
replayed at another ``t`` and other bounds gives the eager iteration at
the new values (the kernel reads c(t) and the bounds from device memory,
not from its capture); the capture and replay counts follow the Arnoldi
iterations; and the solves that hand GMRES a callable (CN, the stationary
solve, BDF on ELL, the sensitivity solve on ELL) replay nothing.

This file imports no JAX, so it also runs on a GPU host without the
reference package (``pytest --noconftest -m cuda``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops import box_kernel as bk  # noqa: E402
from pacmensl_tpu_torch.ops import box_operator as bo  # noqa: E402
from pacmensl_tpu_torch.ops import gmres as gm  # noqa: E402
from pacmensl_tpu_torch.ops import vecops as vo  # noqa: E402
from pacmensl_tpu_torch.ops.box_operator import ShiftedAction  # noqa: E402

pytestmark = pytest.mark.cuda
DEV = "cuda"


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _solve(bundle, t_final, fsp_tol, cls=None, argv=(), **kw):
    """One solve on the card: (solver, distribution, event counts, box
    kernel launches by mode)."""
    s = (cls or pt.FspSolverMultiSinks)(device=DEV, **kw)
    if argv:
        s.set_from_options(pt.Options.from_argv(list(argv)))
    s.set_model(bundle.model)
    if bundle.constraint is not None:
        s.set_constraint_functions(bundle.constraint)
    s.set_initial_bounds(bundle.bounds)
    s.set_expansion_factors(bundle.expansion_factors)
    s.set_initial_distribution(bundle.x0, bundle.p0)
    before = dict(bk.KERNEL.launches)
    d = s.solve(t_final, fsp_tol) if t_final is not None else s.solve(
        fsp_tol)
    if DEV == "cuda":
        torch.cuda.synchronize()
    launches = {k: n - before[k] for k, n in bk.KERNEL.launches.items()
                if n != before[k]}
    n = {k: v.count for k, v in s.get_event_log().events.items()}
    return s, d, n, launches


@pytest.fixture(scope="module", params=["synth", "mask"])
def hog5_solves(request):
    """hog1p_5d to t = 10 with the graphs and eagerly, on K3 and on K1
    (whose epochs each bring new mask and violation bits, so the graphs
    are captured anew each epoch)."""
    _needs_cuda()
    b = pt.models.hog1p_5d()
    prev = bo.USE_SYNTH_MASK, gm.USE_ARNOLDI_GRAPHS
    bo.USE_SYNTH_MASK = request.param == "synth"
    try:
        graph = _solve(b, 10.0, 1e-4)
        gm.USE_ARNOLDI_GRAPHS = False
        eager = _solve(b, 10.0, 1e-4)
    finally:
        bo.USE_SYNTH_MASK, gm.USE_ARNOLDI_GRAPHS = prev
    return request.param, graph, eager


def test_graph_solve_is_bitwise_the_eager_solve(hog5_solves):
    mode, (sg, dg, ng, lg), (se, de, ne, le) = hog5_solves
    assert sg._backend_used == se._backend_used == "box"
    assert torch.equal(sg._y.p, se._y.p)
    assert torch.equal(sg._y.sinks, se._y.sinks)
    assert np.array_equal(dg.p, de.p)
    for k in ("ODESolve", "ODESteps", "ODEStepsRejected", "RHSEvaluation",
              "GMRES", "HostSync.GMRESColumn", "MatrixGeneration"):
        assert ng[k] == ne[k], k
    assert lg == le and lg[mode] > 0
    assert ng["GMRESReplay"] > 0 and "GMRESReplay" not in ne
    assert "GMRESCapture" not in ne


def test_captures_and_replays_follow_the_iterations(hog5_solves):
    _, (_, _, n, _), _ = hog5_solves
    arnoldi = n["HostSync.GMRESColumn"]
    assert n["GMRESReplay"] == arnoldi
    # a capture runs the eager iteration's code once, with its spans; at
    # most restart (16) graphs a BDF solver, one solver an epoch at most
    assert n["GMRESOrthogonalize"] == n["GMRESCapture"]
    assert 0 < n["GMRESCapture"] <= 16 * n["ODESolve"]
    assert n["GMRESCapture"] < arnoldi
    # actions: the eager ones (RHS evaluations outside the Arnoldi
    # iterations, the residual of each cycle that does not open from the
    # zero vector) and one per capture
    assert n["GMRESZeroGuess"] == n["GMRES"]
    assert n["OperatorAction"] == (n["RHSEvaluation"] - arnoldi
                                   + n.get("HostSync.GMRESResidual", 0)
                                   + n["GMRESCapture"])
    # c(t) once for each t: a step's matvecs share one
    assert n["ModelCoefficients"] <= n["ODESolve"] + n["GMRES"]


@pytest.fixture(scope="module")
def sens_solves():
    """hog1p_3d_sens on the box to t = 20 with the graphs and eagerly:
    K9 over p and both sensitivities, and a derivative launch for each
    parameter, an action."""
    _needs_cuda()
    b = pt.models.hog1p_3d_sens()
    prev = gm.USE_ARNOLDI_GRAPHS
    try:
        graph = _solve(b, 20.0, 1e-4, cls=pt.SensFspSolverMultiSinks,
                       backend="box")
        gm.USE_ARNOLDI_GRAPHS = False
        eager = _solve(b, 20.0, 1e-4, cls=pt.SensFspSolverMultiSinks,
                       backend="box")
    finally:
        gm.USE_ARNOLDI_GRAPHS = prev
    return graph, eager


def test_sens_graph_solve_is_bitwise_the_eager_solve(sens_solves):
    (sg, dg, ng, lg), (se, de, ne, le) = sens_solves
    assert sg._backend_used == se._backend_used == "box"
    assert torch.equal(sg._y.p, se._y.p)
    assert torch.equal(sg._y.sinks, se._y.sinks)
    assert np.array_equal(dg.p, de.p) and np.array_equal(dg.dp, de.dp)
    assert np.array_equal(dg.sinks, de.sinks)
    for k in ("ODESolve", "ODESteps", "ODEStepsRejected", "RHSEvaluation",
              "GMRES", "HostSync.GMRESColumn", "MatrixGeneration"):
        assert ng[k] == ne[k], k
    assert ng["ODESolve"] > 1                     # it expanded
    # the same K9 and derivative launches, counted at each replay
    assert lg == le
    assert {k.startswith("batched") for k in lg} == {True, False}
    assert ng["GMRESReplay"] > 0 and "GMRESReplay" not in ne
    assert "GMRESCapture" not in ne


def test_sens_captures_replays_and_counters(sens_solves):
    (_, _, n, _), (_, _, ne, _) = sens_solves
    arnoldi = n["HostSync.GMRESColumn"]
    assert n["GMRESReplay"] == arnoldi
    assert 0 < n["GMRESCapture"] <= 16 * n["ODESolve"]
    assert n["GMRESCapture"] < arnoldi
    # the stacked actions' spans: the eager ones and one per capture ...
    assert n["SensAction"] == (n["RHSEvaluation"] - arnoldi
                               + n.get("HostSync.GMRESResidual", 0)
                               + n["GMRESCapture"])
    assert ne["SensAction"] == (ne["RHSEvaluation"]
                                + ne.get("HostSync.GMRESResidual", 0))
    # ... and their counters every action, replayed ones included
    for k in ("SensActionStates", "SensActionSinks"):
        assert n[k] == ne[k], k
    # c(t) once for each t: a step's matvecs share one
    assert n["ModelCoefficients"] <= n["ODESolve"] + n["GMRES"]


def test_replay_reads_the_new_t_and_bounds():
    """A graph captured at t1 and the bounds b1, replayed after the map
    moved to t2 and the space to b2 (same capacity, no recapture), equals
    the eager iteration at t2 and b2, and differs from the capture's."""
    _needs_cuda()
    b = pt.models.hog1p_5d()
    cs = pt.ConstraintSet(b.constraint, np.array([3, 6, 6, 6, 6, 8, 8]),
                          b.expansion_factors)
    space = pt.BoxStateSpace(b.model.stoichiometry, cs, b.x0,
                             device=DEV)
    op = pt.BoxOperator(b.model, space)
    assert op.synth_mask
    rng = np.random.default_rng(5)
    v0 = vo.FspVector(
        p=torch.as_tensor(rng.random(op.local_n), device=DEV)
        * space.mask.reshape(-1),
        sinks=torch.as_tensor(rng.random(op.num_constraints),
                              device=DEV))
    V = vo.basis_empty(v0, 17)
    vo.basis_set(V, 0, v0)
    shifted, graphs = ShiftedAction(op), gm.ArnoldiGraphs()

    def eager(t, s):
        E = vo.basis_empty(v0, 17)
        vo.basis_set(E, 0, v0)
        shifted.set(t, s)
        work = gm._work(E)
        gm._arnoldi_step(shifted, E, 0, work)
        return E.p[1].clone(), E.sinks[1].clone(), work.col[:2].clone()

    t1, t2 = 3.0, 7.5
    assert not torch.equal(op.model.coefficients(t1),
                           op.model.coefficients(t2))
    want1 = eager(t1, -0.25)
    shifted.set(t1, -0.25)
    work = graphs.bind(shifted, V)
    graphs.run(shifted, V, 0)
    got1 = (V.p[1].clone(), V.sinks[1].clone(), work.col[:2].clone())
    space.set_bounds(np.array([3, 8, 8, 8, 8, 10, 10]))
    assert tuple(space.shape) == op.shape
    op.refresh_data()
    want2 = eager(t2, -0.5)
    shifted.set(t2, -0.5)
    assert graphs.bind(shifted, V) is work           # the graphs stay
    n0 = bk.KERNEL.launches["synth"]
    graphs.run(shifted, V, 0)                        # replay only
    assert bk.KERNEL.launches["synth"] == n0 + 1
    got2 = (V.p[1].clone(), V.sinks[1].clone(), work.col[:2].clone())
    for g, w in zip(got1 + got2, want1 + want2):
        assert torch.equal(g, w)
    assert not torch.equal(got1[2], got2[2])


@pytest.mark.parametrize("case", ["cn", "stationary", "ell", "sens"])
def test_callable_solves_replay_nothing(case):
    _needs_cuda()
    if case == "cn":
        b = pt.models.poisson(2.0)
        b.expansion_factors = [0.5]
        _, _, n, _ = _solve(b, 1.0, 1e-6, odes_type="petsc",
                            argv=("-fsp_odes_type", "petsc", "-ts_type",
                                  "cn"))
        assert n["GMRES" if "GMRES" in n else "ODESolve"] > 0
    elif case == "stationary":
        b = pt.models.birth_death(birth=1.0, death=0.1)
        b.bounds, b.expansion_factors = [10], [0.5]
        _, _, n, _ = _solve(b, None, 1e-7,
                            cls=pt.StationaryFspSolverMultiSinks,
                            backend="box")
        assert n["GMRES"] > 0
    elif case == "ell":
        s, _, n, _ = _solve(pt.models.hog1p_3d(), 5.0, 1e-6, backend="ell")
        assert s._backend_used == "ell" and n["GMRES"] > 0
    else:
        # a box sensitivity solve replays (the tests above); on ELL the
        # stacked action stays a callable
        s, _, n, _ = _solve(pt.models.hog1p_3d_sens(), 2.0, 1e-4,
                            cls=pt.SensFspSolverMultiSinks, backend="ell")
        assert s._backend_used == "ell" and n["GMRES"] > 0
    assert "GMRESReplay" not in n and "GMRESCapture" not in n
