"""The port's sharded box path over ``torch.distributed`` (gloo, CPU).

Each case runs this file as a script in 2 or 3 processes (``--worker``),
one rank each, joined through a ``file://`` rendezvous in the test's
temporary directory; the workers write their results as ``.npz`` files
and the test compares them with single-device results and with the
reference package.  The workers import no JAX.

* The sharded matvec's ``dp`` is bitwise the single-device one (the
  kernel's sharded mode computes each slab's rows with the whole box's
  arithmetic); the sinks, summed in another order, agree to 1e-12.
* A sharded Poisson solve has the single-device solve's states, its
  ``p`` within 1e-12, and lies within 1e-6 in L1 of Poisson(20)
  (``tests/test_multichip.py:48-68``); it also agrees with the
  reference package's solve.
* A BDF solve of hog1p_3d (time-varying) at a CPU size agrees with the
  single-device solve; its box is sharded along its largest extent, in
  the same axis order on every rank.
* Every rank takes the same steps (the same times, sizes and Krylov
  dimensions or BDF orders, bit for bit).
* Slabs thinner than the halo, and an axis 0 that does not divide by the
  rank count, raise ``SetupError``.
* The dry run's rank body (``tools/dryrun.py``) over the ranks.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
#: seconds a worker may take before the test kills every worker
WORKER_TIMEOUT = 120
#: hog1p_3d to this time: a few epochs of BDF at a CPU size
BDF_T = 5.0

MATVEC_CASES = [                 # (bundle, bounds, custom constraints)
    ("toggle", [39, 17], False),
    ("repressilator", [31, 7, 7, 99, 21, 99], True),
]


# ------------------------------------------------------------------ workers
def _bundle_space(pt, name, bounds, custom, world):
    b = pt.models.ALL_MODELS[name]()
    cs = (pt.ConstraintSet(b.constraint, bounds, b.expansion_factors)
          if custom else
          pt.ConstraintSet(None, bounds, None, b.model.num_species))
    pad = np.ones(b.model.num_species, np.int64)
    pad[0] = world
    space = pt.BoxStateSpace(b.model.stoichiometry, cs, b.x0, device="cpu",
                             pad_quanta=pad)
    return b, space


def _work_matvec(pt, mesh):
    """Sharded and single-device actions on seeded vectors, every
    mode."""
    import torch
    from pacmensl_tpu_torch.ops import box_kernel as bk
    from pacmensl_tpu_torch.ops import box_operator as bo
    from pacmensl_tpu_torch.parallel.mesh import gather_global
    from pacmensl_tpu_torch.sys.errors import SetupError
    out = {}
    for name, bounds, custom in MATVEC_CASES:
        b, space = _bundle_space(pt, name, bounds, custom, mesh.size)
        rng = np.random.default_rng(7)
        p = (torch.as_tensor(rng.random(space.size))
             * space.mask.reshape(-1))
        y = pt.FspVector(p=p, sinks=torch.zeros(space.num_constraints,
                                                dtype=torch.float64))
        for synth in (True, False):
            bo.USE_SYNTH_MASK = synth
            one = pt.BoxOperator(b.model, space).action(0.3, y)
            op = pt.BoxOperator(b.model, space, mesh=mesh)
            sh = op.sharded
            key = f"{name}_{int(synth)}"
            lo, hi = sh.origin0 + sh.w0, sh.origin0 + sh.w0 + sh.L0
            loc = p.reshape(space.shape)[lo:hi].reshape(-1)
            n0 = sum(bk.KERNEL.plain_calls.values())
            d = op.action(0.3, pt.FspVector(p=loc, sinks=y.sinks))
            out[key + "_calls"] = np.array(
                sum(bk.KERNEL.plain_calls.values()) - n0)
            out[key + "_dp"] = gather_global(d.p, mesh).numpy()
            out[key + "_sinks"] = d.sinks.numpy()
            out[key + "_dp1"] = one.p.numpy()
            out[key + "_sinks1"] = one.sinks.numpy()
            out[key + "_mode"] = np.array([op.synth_mask, sh.L0, sh.w0])
        bo.USE_SYNTH_MASK = True
    # slabs thinner than the halo: axis-0 moves of 4 need w0 = 5 planes
    jump = pt.Model(np.array([[4], [-4]]),
                    lambda x, r: torch.ones(x.shape[0], dtype=x.dtype))
    cs = pt.ConstraintSet(None, [4], None, 1)
    space = pt.BoxStateSpace(jump.stoichiometry, cs, [[0]], device="cpu",
                             pad_quanta=[mesh.size])
    try:
        pt.BoxOperator(jump, space, mesh=mesh)
        out["thin"] = np.array("no error")
    except SetupError as e:
        out["thin"] = np.array(str(e))
    # an axis 0 that does not divide by the rank count
    space = pt.BoxStateSpace(jump.stoichiometry,
                             pt.ConstraintSet(None, [mesh.size * 9], None,
                                              1), [[0]], device="cpu")
    try:
        pt.BoxOperator(jump, space, mesh=mesh)
        out["ragged"] = np.array(f"no error, shape {space.shape}")
    except SetupError as e:
        out["ragged"] = np.array(str(e))
    # sequential_action: the ranks in order, behind barriers
    log = Path(os.environ["PACMENSL_TEST_DIR"]) / "order.txt"

    def note():
        with open(log, "a") as f:
            f.write(f"{mesh.rank}\n")
    for _ in range(2):
        pt.Environment.sequential_action(note)
    return out


def _solve_out(pt, s, d):
    ev = s.get_event_log().events
    tr = s.step_trace
    return {"states": d.states, "p": d.p, "sinks": np.asarray(d.sinks),
            "t": np.array(tr.model_time), "h": np.array(tr.step_h),
            "aux": np.array(tr.aux),
            "halo": np.array(ev["HaloValuesPerMatvec"].count
                             if "HaloValuesPerMatvec" in ev else -1),
            "epochs": np.array(ev["ODESolve"].count)}


def _work_poisson(pt, mesh):
    b = pt.models.poisson(2.0)
    s = pt.FspSolverMultiSinks(odes_type="krylov", mesh=mesh)
    s.set_model(b.model)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors([0.5])
    s.set_initial_distribution(b.x0, b.p0)
    out = _solve_out(pt, s, s.solve(10.0, 1.0e-6))
    # the dry run's rank body (tools/dryrun.py), as dryrun_multichip(n)
    # runs it in each spawned rank
    from pacmensl_tpu_torch.tools.dryrun import dryrun_rank
    for k, v in dryrun_rank(mesh).items():
        if k != "launches":
            out["dry_" + k] = np.asarray(v)
    return out


def _hog_solver(pt, mesh=None):
    h = pt.models.hog1p_3d()
    s = pt.FspSolverMultiSinks(backend="box", device="cpu", mesh=mesh)
    s.set_model(h.model)
    s.set_constraint_functions(h.constraint)
    s.set_initial_bounds(h.bounds)
    s.set_expansion_factors(h.expansion_factors)
    s.set_initial_distribution(h.x0, h.p0)
    return s


def _work_bdf(pt, mesh):
    s = _hog_solver(pt, mesh)
    out = _solve_out(pt, s, s.solve(BDF_T, 1.0e-4))
    out["bdf"] = np.array(isinstance(s._ode_solver, pt.BdfSolver))
    out["orders"] = np.array([o for _, o in s.axis_orders_])
    out["extents"] = np.asarray(s._space._box_bounds) + 1
    out["shape"] = np.array(s._space.shape)
    return out


WORK = {"matvec": _work_matvec, "poisson": _work_poisson, "bdf": _work_bdf}


def _worker(case, rank, world, tmp):
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    import pacmensl_tpu_torch as pt
    pt.environment.init(backend="gloo", init_method=f"file://{tmp}/pg",
                        world_size=world, rank=rank, timeout=60)
    try:
        mesh = pt.make_mesh("cpu")
        out = WORK[case](pt, mesh)
        np.savez(Path(tmp) / f"{case}_{rank}.npz", **out)
    finally:
        pt.environment.finalize()


# ---------------------------------------------------------------- launcher
def _launch(case, world, tmp):
    """Run ``case`` in ``world`` worker processes; their results by
    rank."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PACMENSL_TEST_DIR=str(tmp))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", case, str(r), str(world),
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, cwd=str(ROOT)) for r in range(world)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=WORKER_TIMEOUT)[0].decode())
    except subprocess.TimeoutExpired:
        for pr in procs:
            pr.kill()
            pr.communicate()
        pytest.fail(f"{case} on {world} ranks: a worker took over "
                    f"{WORKER_TIMEOUT} s")
    for r, pr in enumerate(procs):
        assert pr.returncode == 0, f"rank {r} of {world}:\n{logs[r]}"
    return [dict(np.load(Path(tmp) / f"{case}_{r}.npz"))
            for r in range(world)]


@pytest.fixture(scope="module", params=[2, 3])
def matvec_run(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("matvec")
    return request.param, _launch("matvec", request.param, tmp), tmp


@pytest.fixture(scope="module", params=[2, 3])
def poisson_run(request, tmp_path_factory):
    return request.param, _launch("poisson", request.param,
                                  tmp_path_factory.mktemp("poisson"))


@pytest.fixture(scope="module")
def bdf_run(tmp_path_factory):
    return _launch("bdf", 2, tmp_path_factory.mktemp("bdf"))


def test_sharded_matvec_matches_single_device(matvec_run):
    world, outs, _ = matvec_run
    o = outs[0]
    for name, _, _ in MATVEC_CASES:
        for synth in (1, 0):
            key = f"{name}_{synth}"
            assert bool(o[key + "_mode"][0]) == bool(synth), key
            assert np.array_equal(o[key + "_dp"], o[key + "_dp1"]), key
            np.testing.assert_allclose(o[key + "_sinks"],
                                       o[key + "_sinks1"], rtol=1e-12,
                                       atol=1e-13, err_msg=key)
            for other in outs[1:]:      # sinks replicated bit for bit
                assert np.array_equal(other[key + "_sinks"],
                                      o[key + "_sinks"]), key
    # the repressilator's slabs have an interior; the action takes one
    # launch there all the same
    L0, w0 = o["repressilator_1_mode"][1:]
    assert L0 >= 2 * w0


def test_sharded_matvec_calls_per_matvec(matvec_run):
    """A matvec is one call of the box action on every rank, also where
    a slab has an interior: one launch on the window after the exchange,
    the sinks reduced in it."""
    world, outs, _ = matvec_run
    for o in outs:
        for name, _, _ in MATVEC_CASES:
            for synth in (1, 0):
                key = f"{name}_{synth}"
                assert int(o[key + "_calls"]) == 1, key


def test_thin_or_ragged_slabs_raise(matvec_run):
    world, outs, _ = matvec_run
    for o in outs:
        assert "thinner than the halo" in str(o["thin"]), o["thin"]
        assert "does not divide" in str(o["ragged"]), o["ragged"]


def test_sequential_action_runs_ranks_in_order(matvec_run):
    world, _, tmp = matvec_run
    order = (tmp / "order.txt").read_text().split()
    assert order == [str(r) for r in range(world)] * 2


def _poisson_pmf(k, lam):
    return np.exp(k * math.log(lam) - lam
                  - np.array([math.lgamma(v + 1.0) for v in k]))


def _single(pkg, **kw):
    b = pkg.models.poisson(2.0)
    s = pkg.FspSolverMultiSinks(odes_type="krylov", **kw)
    s.set_model(b.model)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors([0.5])
    s.set_initial_distribution(b.x0, b.p0)
    return s.solve(10.0, 1.0e-6)


def test_sharded_poisson_matches_single_device(poisson_run):
    import torch
    torch.set_num_threads(2)
    import pacmensl_tpu_torch as pt
    world, outs = poisson_run
    o = outs[0]
    d1 = _single(pt, device="cpu")
    assert o["states"].shape == d1.states.shape
    assert np.array_equal(o["states"], d1.states)
    assert np.abs(o["p"] - d1.p).max() <= 1e-12
    assert np.abs(o["p"] - _poisson_pmf(o["states"][:, 0], 20.0)).sum() \
        <= 1e-6
    assert int(o["halo"]) > 0 and int(o["epochs"]) > 1
    for other in outs[1:]:
        assert np.array_equal(other["p"], o["p"])


def test_sharded_poisson_matches_reference_package(poisson_run):
    import pacmensl_tpu as pm
    world, outs = poisson_run
    o = outs[0]
    dj = _single(pm)
    order = np.lexsort(dj.states.T[::-1])
    assert np.array_equal(o["states"], dj.states[order])
    assert np.abs(o["p"] - np.asarray(dj.p)[order]).max() <= 1e-12


def test_dryrun_over_the_ranks(poisson_run):
    """``tools/dryrun.py``'s rank body over 2 and 3 gloo ranks: one box
    epoch without expansion, the mass within 1e-4; Poisson on ELL under
    GRAPH through two or more epochs within 1e-3 of Poisson(4) (the
    checks raise in the worker), the same law on every rank."""
    world, outs = poisson_run
    for r, o in enumerate(outs):
        assert int(o["dry_rank"]) == r
        assert abs(float(o["dry_mass"]) - 1.0) < 1e-4
        assert float(o["dry_t"]) >= 0.05 - 1e-9
        assert int(o["dry_poisson_epochs"]) >= 2
        assert float(o["dry_poisson_l1"]) <= 1e-3
    for other in outs[1:]:
        assert np.array_equal(other["dry_poisson_p"],
                              outs[0]["dry_poisson_p"])


def test_ranks_take_the_same_steps(poisson_run, bdf_run):
    for outs in (poisson_run[1], bdf_run):
        o = outs[0]
        assert o["t"].size > 0
        for other in outs[1:]:
            for k in ("t", "h", "aux"):
                assert np.array_equal(other[k], o[k]), k


def test_sharded_box_takes_the_largest_extent_as_slab_axis(bdf_run):
    """hog1p_3d's box over two ranks is laid out by descending extent:
    its slab axis, axis 0, is the largest extent (not the 4-state gene),
    its capacity divides by the rank count, and every rank took the same
    orders."""
    o = bdf_run[0]
    assert o["orders"][0].tolist() == [1, 0, 2]
    assert o["extents"][0] == o["extents"].max() > 4
    assert o["shape"][0] % 2 == 0
    for other in bdf_run[1:]:
        assert np.array_equal(other["orders"], o["orders"])
        assert np.array_equal(other["shape"], o["shape"])


def test_sharded_bdf_solve_matches_single_device(bdf_run):
    import torch
    torch.set_num_threads(2)
    import pacmensl_tpu_torch as pt
    o = bdf_run[0]
    assert bool(o["bdf"])
    s = _hog_solver(pt)
    d1 = s.solve(BDF_T, 1.0e-4)
    assert np.array_equal(o["states"], d1.states)
    assert np.abs(o["p"] - d1.p).max() <= 1e-12
    np.testing.assert_allclose(o["sinks"], np.asarray(d1.sinks), rtol=1e-9,
                               atol=1e-15)


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--worker":
        _worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                sys.argv[5])
    else:
        sys.exit("usage: test_torch_distributed.py --worker CASE RANK "
                 "WORLD DIR")
