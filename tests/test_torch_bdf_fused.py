"""The fused passes of a BDF step (``ops/bdf_step.py``, ``csrc/bdf_step.cu``)
against the PyTorch operations they replace, on a card.

Each pass is compared bit for bit (the int64 view of every output, so a
-0 where the operations give +0 counts, and the sha256 of the bytes) with
its plain version, ``BdfSolver._predict``, the right-hand side
``c a - psi``, ``y_pred + d`` with ``BdfSolver._err_norm_dev``'s terms and
sums, and ``BdfSolver._update_D``, at every order on hog1p_5d's box
vector (94 x 42 x 4 x 42 x 63 and 7 sinks) and on the stacked vector of
hog1p_5d_sens (3 x 94 x 42 x 4 x 42 x 94, 21 sinks).  A NaN or an Inf in
the right-hand side or in the new state clears the flag that
``vecops.isfinite`` would.  A BDF solve with the fused passes gives the
solve with the PyTorch operations bitwise, with the same steps,
rejections and matvecs, and GMRES's zero guess an explicit zero vector's
solution on the card.  A BDF solve sharded over two gloo ranks on the
card (each rank a process running this file with ``--worker``) takes the
fused passes on each rank's parts and gives every rank the PyTorch
operations' bits, and a non-finite entry on one rank clears the flag on
every rank.

This file imports no JAX, so it also runs on a GPU host without the
reference package (``pytest --noconftest -m cuda``)."""
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops import bdf_step as bs  # noqa: E402
from pacmensl_tpu_torch.ops import vecops as vo  # noqa: E402
from pacmensl_tpu_torch.ops.box_operator import ShiftedAction  # noqa: E402
from pacmensl_tpu_torch.ops.gmres import gmres  # noqa: E402
from pacmensl_tpu_torch.solvers import bdf  # noqa: E402
from pacmensl_tpu_torch.sys import events  # noqa: E402

pytestmark = pytest.mark.cuda
DEV = "cuda"
#: (box elements, sinks): hog1p_5d's largest box, and the stacked vector
#: of hog1p_5d_sens's largest box
SHAPES = {"hog1p_5d": (94 * 42 * 4 * 42 * 63, 7),
          "hog1p_5d_sens": (3 * 94 * 42 * 4 * 42 * 94, 21)}
ORDERS = range(1, bdf.MAX_ORDER + 1)


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int64)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _same(got: vo.FspVector, want: vo.FspVector, digest: bool) -> None:
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))
        if digest:
            assert _digest(g) == _digest(w)


def _random(n, nc, gen, scale=1.0) -> vo.FspVector:
    """Normal entries times ``scale`` with a tenth of them +0 and a tenth
    -0, as a box vector's masked states and small differences give."""
    def part(m):
        x = torch.randn(m, dtype=torch.float64, device=DEV,
                        generator=gen) * scale
        u = torch.rand(m, device=DEV, generator=gen)
        x[u < 0.1] = 0.0
        x[(u >= 0.1) & (u < 0.2)] = -0.0
        return x
    return vo.FspVector(p=part(n), sinks=part(nc))


@pytest.fixture(scope="module", params=list(SHAPES))
def arrays(request):
    """A difference array of ``bdf.ND`` rows (scaled as a BDF run's: each
    difference smaller than the last) and the step's vectors, for one
    shape; the card is freed after."""
    _needs_cuda()
    n, nc = SHAPES[request.param]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(7)
    D = vo.basis_empty(vo.FspVector(
        p=torch.empty(n, dtype=torch.float64, device=DEV),
        sinks=torch.empty(nc, dtype=torch.float64, device=DEV)), bdf.ND)
    for j in range(bdf.ND):
        vo.basis_set(D, j, _random(n, nc, gen, 10.0 ** -j))
    a = _random(n, nc, gen)
    d = _random(n, nc, gen, 1e-4)
    yield request.param, D, a, d
    del D, a, d
    torch.cuda.empty_cache()


def _digest_here(name, q) -> bool:
    """The sha256 of every output at hog1p_5d's shape, and at the stacked
    shape at order 3 (hashing 1.5 GB vectors takes seconds)."""
    return name == "hog1p_5d" or q == 3


@pytest.mark.parametrize("q", ORDERS)
def test_predict_is_bitwise_the_plain_version(arrays, q):
    name, D, _, _ = arrays
    want_y, want_psi = bdf.BdfSolver._predict(D, q)
    psi = vo.FspVector(p=torch.empty_like(D.p[0]),
                       sinks=torch.empty_like(D.sinks[0]))
    flags = torch.zeros(2, dtype=torch.float64, device=DEV)
    y = bs.predict(D, q, bdf._PSI[q], psi, flags)
    torch.cuda.synchronize()
    _same(y, want_y, _digest_here(name, q))
    _same(psi, want_psi, _digest_here(name, q))
    assert flags.tolist() == [1.0, 1.0]


@pytest.mark.parametrize("q", ORDERS)
def test_rhs_and_post_are_bitwise_the_plain_version(arrays, q):
    """The right-hand side at order q's ``c``, and the new state with the
    error norm's terms at ERRC[q]: the terms, their norm (the solver's
    ``_rms``) and the flags as the PyTorch step computes them."""
    name, D, a, d = arrays
    solver = bdf.BdfSolver(lambda t, v: v)
    y_pred, psi = bdf.BdfSolver._predict(D, q)
    c = float(0.37 / bdf._ALPHA[q])
    flags = torch.full((3,), 5.0, dtype=torch.float64, device=DEV)
    flags[1:] = 1.0
    rhs = bs.rhs(a, psi, c, flags[1])
    want_rhs = vo.sub(vo.scale(c, a), psi)
    _same(rhs, want_rhs, _digest_here(name, q))
    errc = float(bdf._ERRC[q])
    sq = vo.FspVector(p=torch.empty_like(d.p), sinks=torch.empty_like(
        d.sinks))
    out = vo.FspVector(p=torch.empty_like(d.p), sinks=torch.empty_like(
        d.sinks))
    y_new = bs.post(y_pred, d, errc, solver.atol, solver.rtol, out, sq,
                    flags[2])
    assert y_new.p.data_ptr() == out.p.data_ptr()
    e = vo.scale(errc, d)
    want_sq = vo.FspVector(p=solver._err_terms(e.p, y_pred.p),
                           sinks=solver._err_terms(e.sinks, y_pred.sinks))
    _same(y_new, vo.add(y_pred, d), _digest_here(name, q))
    _same(sq, want_sq, _digest_here(name, q))
    solver._rms(sq, out=flags[0])
    want_err = solver._err_norm_dev(e, y_pred)
    assert torch.equal(_bits(flags[0]), _bits(want_err))
    assert flags[1:].tolist() == [1.0, 1.0]


@pytest.mark.parametrize("q", ORDERS)
def test_update_is_bitwise_the_plain_version(arrays, q):
    name, D, _, d = arrays
    # the rows the update reads and writes, kept and restored, so every
    # case starts from the fixture's array
    rows = slice(0, q + 3)
    keep = vo.FspBasis(p=D.p[rows].clone(), sinks=D.sinks[rows].clone())
    bdf.BdfSolver._update_D(D, q, d)
    want = vo.FspBasis(p=D.p[rows].clone(), sinks=D.sinks[rows].clone())
    D.p[rows].copy_(keep.p)
    D.sinks[rows].copy_(keep.sinks)
    del keep
    bs.update(D, q, d)
    torch.cuda.synchronize()
    got = vo.FspBasis(p=D.p[rows], sinks=D.sinks[rows])
    _same(got, want, name == "hog1p_5d")
    del want


@pytest.mark.parametrize("where", ["p", "sinks"])
@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_flags_follow_isfinite(where, bad):
    """A NaN or an Inf planted in the action (so in the right-hand side)
    or in d (so in the new state) clears the flag ``vecops.isfinite``
    clears; the other flag stays 1."""
    _needs_cuda()
    n, nc = 1000003, 7
    gen = torch.Generator(device=DEV)
    gen.manual_seed(11)
    D = vo.basis_empty(_random(n, nc, gen), bdf.ND)
    for j in range(bdf.ND):
        vo.basis_set(D, j, _random(n, nc, gen, 10.0 ** -j))
    for planted in ("rhs", "y_new"):
        a, d = _random(n, nc, gen), _random(n, nc, gen, 1e-4)
        getattr(a if planted == "rhs" else d, where)[n // 3 if where == "p"
                                                     else 2] = bad
        flags = torch.zeros(3, dtype=torch.float64, device=DEV)
        S = vo.FspVector(p=torch.empty_like(a.p),
                         sinks=torch.empty_like(a.sinks))
        y = bs.predict(D, 2, bdf._PSI[2], S, flags[1:])
        rhs = bs.rhs(a, S, 0.5, flags[1])
        want = [bool(vo.isfinite(vo.sub(vo.scale(0.5, a), S))),
                bool(vo.isfinite(vo.add(y, d)))]
        y_new = bs.post(y, d, 0.25, 1e-14, 1e-6, rhs, S, flags[2])
        assert want == [planted != "rhs", planted != "y_new"]
        assert [v == 1.0 for v in flags[1:].tolist()] == want
        del y_new


def _hog5_solve(bundle, t_final, cls=pt.FspSolverMultiSinks, **kw):
    s = cls(device=DEV, **kw)
    s.set_model(bundle.model)
    if bundle.constraint is not None:
        s.set_constraint_functions(bundle.constraint)
    s.set_initial_bounds(bundle.bounds)
    s.set_expansion_factors(bundle.expansion_factors)
    s.set_initial_distribution(bundle.x0, bundle.p0)
    before = dict(bs.KERNELS.launches)
    d = s.solve(t_final, 1e-4)
    torch.cuda.synchronize()
    n = {k: v.count for k, v in s.get_event_log().events.items()}
    launched = {k: bs.KERNELS.launches[k] - before[k] for k in before}
    return s, d, n, launched


@pytest.mark.parametrize("name,t_final,cls,epochs", [
    ("hog1p_5d", 10.0, pt.FspSolverMultiSinks, 1),
    ("hog1p_3d_sens", 20.0, pt.SensFspSolverMultiSinks, 2)])
def test_fused_solve_is_bitwise_the_torch_solve(name, t_final, cls, epochs,
                                                monkeypatch):
    """The same solve with the fused passes and with the PyTorch
    operations (``fusable`` held False): the same sha256 of p and the
    sinks, the same steps, rejections and matvecs; every attempt of the
    first took the fused passes.  The sensitivity solve expands its box,
    so the scratch vector is allocated anew for each capacity."""
    _needs_cuda()
    b = getattr(pt.models, name)()
    kw = {"backend": "box"} if cls is pt.SensFspSolverMultiSinks else {}
    sf, df, nf, lf = _hog5_solve(b, t_final, cls, **kw)
    monkeypatch.setattr(bs, "fusable", lambda y: False)
    st, dt, nt, lt = _hog5_solve(b, t_final, cls, **kw)
    for part in ("p", "sinks"):
        assert _digest(getattr(sf._y, part)) == _digest(getattr(st._y,
                                                                part))
    assert np.array_equal(df.p, dt.p)
    for k in ("ODESolve", "ODESteps", "ODEStepsRejected", "RHSEvaluation",
              "GMRES", "HostSync.GMRESColumn", "HostSync.BDFErrorNorm",
              "GMRESZeroGuess"):
        assert nf[k] == nt[k], k
    assert nf["ODESolve"] >= epochs
    attempts = nf["HostSync.BDFErrorNorm"]
    assert nf["BDFFusedStep"] == attempts and "BDFFusedStep" not in nt
    assert lf["predict"] == lf["rhs"] == lf["post"] == attempts
    assert lf["update"] == nf["ODESteps"]
    assert not any(lt.values())


def test_zero_guess_on_the_card_is_bitwise_the_zero_vector():
    """GMRES from ``x0=None`` on the capturable map on the card, with its
    Arnoldi iterations replayed from CUDA graphs, gives the solution of an
    explicit zero vector bit for bit (signs of zero included)."""
    _needs_cuda()
    b = pt.models.hog1p_5d()
    cs = pt.ConstraintSet(b.constraint, np.array([3, 10, 10, 10, 10, 10, 10]),
                          b.expansion_factors)
    space = pt.BoxStateSpace(b.model.stoichiometry, cs, b.x0, device=DEV)
    op = pt.BoxOperator(b.model, space)
    rng = np.random.default_rng(3)
    rhs = vo.FspVector(
        p=torch.as_tensor(rng.standard_normal(op.local_n), device=DEV)
        * space.mask.reshape(-1),
        sinks=torch.as_tensor(rng.standard_normal(op.num_constraints),
                              device=DEV))
    shifted = ShiftedAction(op)
    shifted.set(2.0, -0.05)
    kw = dict(restart=4, tol=1e-12)
    want = gmres(shifted, rhs, vo.zeros_like(rhs), **kw)
    log = events.EventLog()
    with events.active(log):
        got = gmres(shifted, rhs, None, **kw)
    _same(got.x, want.x, True)
    assert (got.n_matvecs, got.converged, got.res_norm) == (
        want.n_matvecs, want.converged, want.res_norm)
    assert log.events["GMRESZeroGuess"].count == 1


# ------------------------------------------------------- sharded solves
ROOT = Path(__file__).resolve().parents[1]
#: hog1p_3d to this time over the ranks: a few epochs of BDF
SHARDED_T = 5.0
#: seconds a worker may take before the test stops every worker
WORKER_TIMEOUT = 300
COUNTS = ("ODESolve", "ODESteps", "ODEStepsRejected", "RHSEvaluation",
          "HostSync.BDFErrorNorm", "BDFFusedStep")


def _worker(rank, world, tmp):
    """One rank: hog1p_3d's BDF solve over the mesh with the fused passes
    and with the PyTorch operations, then the flags of a NaN planted on
    the last rank only; the results into ``rank_<rank>.npz``."""
    pt.environment.init(backend="gloo", init_method=f"file://{tmp}/pg",
                        world_size=world, rank=rank, timeout=120)
    try:
        mesh = pt.make_mesh("cuda")
        out = {}
        fusable = bs.fusable
        for tag in ("fused", "torch"):
            if tag == "torch":
                bs.fusable = lambda y: False
            b = pt.models.hog1p_3d()
            s = pt.FspSolverMultiSinks(backend="box", mesh=mesh)
            s.set_model(b.model)
            s.set_constraint_functions(b.constraint)
            s.set_initial_bounds(b.bounds)
            s.set_expansion_factors(b.expansion_factors)
            s.set_initial_distribution(b.x0, b.p0)
            before = dict(bs.KERNELS.launches)
            s.solve(SHARDED_T, 1e-4)
            torch.cuda.synchronize()
            assert isinstance(s._ode_solver, pt.BdfSolver)
            ev = s.get_event_log().events
            out[f"{tag}_p"] = _bits(s._y.p).cpu().numpy()
            out[f"{tag}_sinks"] = _bits(s._y.sinks).cpu().numpy()
            out[f"{tag}_steps"] = np.array(s.step_trace.step_h)
            out[f"{tag}_counts"] = np.array(
                [ev[k].count if k in ev else 0 for k in COUNTS])
            out[f"{tag}_launches"] = np.array(
                [bs.KERNELS.launches[k] - before[k] for k in bs.NAMES])
            del s
        bs.fusable = fusable
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(5 + rank)
        n, nc = 100003, 3
        D = vo.basis_empty(vo.FspVector(
            p=torch.empty(n, dtype=torch.float64, device=mesh.device),
            sinks=torch.empty(nc, dtype=torch.float64, device=mesh.device)),
            bdf.ND)
        for j in range(bdf.ND):
            vo.basis_set(D, j, _random(n, nc, gen, 10.0 ** -j))
        flags = []
        for planted in ("rhs", "y_new"):
            a, d = _random(n, nc, gen), _random(n, nc, gen, 1e-4)
            if rank == world - 1:
                (a if planted == "rhs" else d).p[n // 2] = float("nan")
            stat = torch.zeros(3, dtype=torch.float64, device=mesh.device)
            S = vo.FspVector(p=torch.empty_like(a.p),
                             sinks=torch.empty_like(a.sinks))
            y = bs.predict(D, 2, bdf._PSI[2], S, stat[1:])
            rhs = bs.rhs(a, S, 0.5, stat[1])
            bs.post(y, d, 0.25, 1e-14, 1e-6, rhs, S, stat[2])
            with vo.reductions_over(mesh):
                vo.min_ranks(stat[1:])
            flags.append(stat[1:].tolist())
        out["flags"] = np.array(flags)
        np.savez(Path(tmp) / f"rank_{rank}.npz", **out)
    finally:
        pt.environment.finalize()


def test_sharded_fused_solve_is_bitwise_the_torch_solve(tmp_path):
    """Two gloo ranks on the card: on each rank the fused solve's p and
    sinks are the PyTorch solve's bits, with the same steps and counts;
    every attempt took the fused passes (one launch of the prediction,
    the right-hand side and the new state per attempt, one update per
    accepted step) and the PyTorch solve none; a NaN on the last rank
    clears its flag on both."""
    _needs_cuda()
    world = 2
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r), str(world),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, cwd=str(ROOT)) for r in range(world)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=WORKER_TIMEOUT)[0].decode())
    except subprocess.TimeoutExpired:
        for pr in procs:
            pr.kill()
            pr.communicate()
        pytest.fail(f"a worker took over {WORKER_TIMEOUT} s")
    for r, pr in enumerate(procs):
        assert pr.returncode == 0, f"rank {r}:\n{logs[r]}"
    outs = [dict(np.load(tmp_path / f"rank_{r}.npz")) for r in range(world)]
    for o in outs:
        for k in ("p", "sinks", "steps"):
            assert np.array_equal(o[f"fused_{k}"], o[f"torch_{k}"]), k
        f, t = (dict(zip(COUNTS, o[f"{tag}_counts"].tolist()))
                for tag in ("fused", "torch"))
        assert {k: v for k, v in f.items() if k != "BDFFusedStep"} == {
            k: v for k, v in t.items() if k != "BDFFusedStep"}
        attempts = f["HostSync.BDFErrorNorm"]
        assert attempts > 0 and f["BDFFusedStep"] == attempts
        assert t["BDFFusedStep"] == 0
        launched = dict(zip(bs.NAMES, o["fused_launches"].tolist()))
        assert (launched["predict"] == launched["rhs"] == launched["post"]
                == attempts)
        assert launched["update"] == f["ODESteps"]
        assert not o["torch_launches"].any()
        assert o["flags"].tolist() == [[0.0, 1.0], [1.0, 0.0]]
    assert np.array_equal(outs[0]["fused_steps"], outs[1]["fused_steps"])


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        sys.exit("usage: test_torch_bdf_fused.py --worker RANK WORLD DIR")
