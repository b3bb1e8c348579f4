"""The compressed backend and the sensitivity solve over the ranks of a
``torch.distributed`` group (gloo, CPU): ``parallel/halo_ell.py`` and the
driver's mesh routing.

Each case runs this file as a script in 2 or 3 processes (``--worker``),
one rank each, joined through a ``file://`` rendezvous in the test's
temporary directory; the workers write ``.npz`` results, which the tests
compare with one-device results and with the reference package.  The
workers import no JAX.

* ``ShardedEllOperator`` against ``EllOperator`` on the toggle: ``dp``
  within 1e-12 (the same products, gathered from a halo), sinks within
  1e-12, one vector and a batch; the halo is a thin band
  (``halo_width < shard_len``, ``tests/test_multichip.py:71-103``).
* The Poisson solve on ELL over the ranks: the one-device solve's states,
  ``p`` within 1e-12, Poisson(20) within 1e-6 in L1.
* The repressilator on the box over 2 ranks under a memory budget that
  makes it migrate to ELL: the one-device migrating solve's states and
  ``p`` within 1e-12; every rank takes the same steps and holds the same
  state set (count and checksum) after every expansion.
* The sensitivity solve over 2 ranks on both backends (the box: K9w's
  plain version behind the halo exchange of every vector) against one
  device within 1e-10 (``tests/test_sensfsp.py:196-223``).
* The batched window plain version against the sharded plain version
  applied to each vector: one launch on the window, one halo exchange
  and one all-reduce a call, the sinks bitwise one K4 launch's a vector
  and within 1e-12 of one device, and the same on every rank.
* HYPERGRAPH's order the same on every rank, and the solver's check of
  the ranks' orders; the scaling sweep's rank body
  (``examples/scaling_sweep.py``) at a tiny box.
* A sensitivity action on the box over 2 ranks (poisson_sens, whose slabs
  have an interior; hog1p_3d_sens, whose derivative operators read no
  halo; and births of one and two molecules, whose derivative operator
  reads a halo one plane narrower than the base operator's): one halo
  exchange and one all-reduce a call by the mesh's counters, ``p`` and
  the sinks bitwise the sub-operators called one by one with their own
  exchanges and all-reduces; on each rank one ``SensAction`` span with
  one ``SensDerivative`` span inside it, and the counters
  ``SensActionStates`` and ``SensActionSinks`` at (1 + Np) x the whole
  state set and (1 + Np) x the constraints.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
#: seconds a worker may take before the test kills every worker
WORKER_TIMEOUT = 120
#: the repressilator's box solve to t = 0.5 under this vector-memory budget
#: (bytes, PACMENSL_BOX_MEM_BUDGET) migrates to ELL partway
MIGRATE_BUDGET = "2.5e6"


def _checksum(states):
    return int((states.astype(np.int64)
                * np.arange(1, states.shape[1] + 1)).sum())


# ------------------------------------------------------------------ workers
def _work_operator(pt, mesh):
    import torch
    b = pt.models.toggle()
    cs = pt.ConstraintSet(b.constraint, b.bounds, b.expansion_factors)
    ss = pt.StateSet(b.model.stoichiometry, cs, init_states=b.x0)
    ss.expand()
    one = pt.EllOperator(b.model, ss, device="cpu")
    op = pt.ShardedEllOperator(b.model, ss, mesh)
    n, L = ss.num_states, op.local_n
    rng = np.random.default_rng(1)
    P = np.zeros((3, op.n_pad))
    P[:, :n] = rng.random((3, n))
    lo = mesh.rank * L
    loc = torch.as_tensor(P[:, lo:lo + L].copy())
    zs = torch.zeros(cs.num_constraints, dtype=torch.float64)
    out = {"n": np.array(n), "L": np.array(L), "n_pad": np.array(op.n_pad),
           "halo": np.array(op.halo_width),
           "comm": np.array(op.comm_values_per_matvec()),
           "sent": np.array(op.values_sent_per_matvec()),
           "nnz": np.array(op.nnz()), "nnz1": np.array(one.nnz())}
    # the one-device operator pads to another capacity: its vectors hold
    # the same states, its dp is cut to this rank's block
    P1 = torch.zeros((3, one.n_pad), dtype=torch.float64)
    P1[:, :n] = torch.as_tensor(P[:, :n])

    def block(dp1):
        full = torch.zeros(dp1.shape[:-1] + (op.n_pad,), dtype=dp1.dtype)
        full[..., :n] = dp1[..., :n]
        return full[..., lo:lo + L].numpy()
    d = op.action(0.5, pt.FspVector(p=loc[0], sinks=zs))
    d1 = one.action(0.5, pt.FspVector(p=P1[0], sinks=zs))
    out.update(dp=d.p.numpy(), sinks=d.sinks.numpy(), dp1=block(d1.p),
               sinks1=d1.sinks.numpy())
    dpb, skb = op.action_batched(0.5, loc)
    dpb1, skb1 = one.action_batched(0.5, P1)
    out.update(dpb=dpb.numpy(), skb=skb.numpy(), dpb1=block(dpb1),
               skb1=skb1.numpy())
    out.update(_hypergraph(pt, mesh))
    # the scaling sweep's rank body (examples/scaling_sweep.py) at a
    # tiny box, as its main runs it in each spawned rank
    from pacmensl_tpu_torch.examples.scaling_sweep import sweep_rank
    rows = sweep_rank(mesh, bound=23, iters=2)["rows"]
    out["sweep_rows"] = np.array(len(rows))
    for k in ("n", "us", "eff", "comm"):
        out["sweep_" + k] = np.array([r.get(k, False) for r in rows])
    out["sweep_path"] = np.array([r["path"] for r in rows])
    out["sweep_same"] = np.array([r.get("same", True) for r in rows])
    out["sweep_rel"] = np.array([r.get("rel_err", 0.0) for r in rows])
    out["sweep_halo"] = np.array([r.get("halo", 0) for r in rows])
    return out


def _hypergraph(pt, mesh):
    """Each rank's HYPERGRAPH order of the toggle's 32 x 32 grid (whose
    Fiedler eigenvalue is tied) and of the repressilator's set, the
    solver's agreement check on them, and the check on orders that
    differ by rank."""
    from pacmensl_tpu_torch.statespace.partitioner import (
        StatePartitioner, PartitioningType)
    out = {}
    for name, bounds in (("toggle", None),
                         ("repressilator", [22, 6, 6, 44, 12, 44])):
        b = getattr(pt.models, name)()
        cs = (pt.ConstraintSet(None, [31, 31]) if bounds is None
              else pt.ConstraintSet(b.constraint, bounds))
        ss = pt.StateSet(b.model.stoichiometry, cs, init_states=b.x0)
        ss.expand()
        res = StatePartitioner(PartitioningType.HYPERGRAPH).partition(
            ss.states, b.model.stoichiometry, mesh.size,
            state2index=ss.state2index)
        out[f"hyper_{name}"] = res.order
    s = pt.FspSolverMultiSinks(backend="ell", mesh=mesh)
    s.set_load_balancing_method("hyper_graph")
    s._check_same_order(out["hyper_toggle"])
    try:
        s._check_same_order(np.roll(out["hyper_toggle"], mesh.rank))
        out["hyper_mismatch_raises"] = np.array(False)
    except pt.StateSpaceError:
        out["hyper_mismatch_raises"] = np.array(True)
    return out


def _solver(pt, name, backend, mesh, sens=False):
    b = getattr(pt.models, name)()
    cls = pt.SensFspSolverMultiSinks if sens else pt.FspSolverMultiSinks
    s = cls(backend=backend, odes_type="krylov", mesh=mesh,
            device=None if mesh is not None else "cpu")
    s.set_model(b.model)
    if name == "poisson":
        s.set_initial_bounds(b.bounds)
        s.set_expansion_factors([0.5])
    elif name == "poisson_sens":
        s.set_initial_bounds([5])
        s.set_expansion_factors([0.5])
        s.set_ode_tolerances(1e-8, 1e-14)
    else:
        s.set_constraint_functions(b.constraint)
        s.set_initial_bounds(b.bounds)
        s.set_expansion_factors(b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    return s


def _traced(s):
    """Record the state count and checksum after every expansion."""
    log = []
    expand = s._expand

    def hooked(*args, **kw):
        expand(*args, **kw)
        st = (s._space.copy_states() if s._backend_used == "ell"
              else s._space.states())
        log.append((st.shape[0], _checksum(st)))
    s._expand = hooked
    return log


def _solve_out(s, d, log):
    tr = s.step_trace
    ev = s.get_event_log().events
    return {"states": d.states, "p": d.p, "sinks": np.asarray(d.sinks),
            "t": np.array(tr.model_time), "h": np.array(tr.step_h),
            "expansions": np.array(log, dtype=np.int64).reshape(-1, 2),
            "backend": np.array(s._backend_used),
            "halo": np.array(ev["HaloValuesPerMatvec"].count
                             if "HaloValuesPerMatvec" in ev else -1)}


def _work_solves(pt, mesh):
    out = {}
    s = _solver(pt, "poisson", "ell", mesh)
    log = _traced(s)
    for k, v in _solve_out(s, s.solve(10.0, 1e-6), log).items():
        out["poisson_" + k] = v
    os.environ["PACMENSL_BOX_MEM_BUDGET"] = MIGRATE_BUDGET
    s = _solver(pt, "repressilator", "box", mesh)
    log = _traced(s)
    for k, v in _solve_out(s, s.solve(0.5, 1e-4), log).items():
        out["migrate_" + k] = v
    del os.environ["PACMENSL_BOX_MEM_BUDGET"]
    for backend in ("box", "ell"):
        s = _solver(pt, "poisson_sens", backend, mesh, sens=True)
        d = s.solve(1.0, 1e-7)
        out[f"sens_{backend}_states"] = d.states
        out[f"sens_{backend}_p"] = d.p
        out[f"sens_{backend}_dp"] = d.dp
    out.update(_sens_actions(pt, mesh))
    return out


def _sens_actions(pt, mesh):
    """One sensitivity action on the box over the ranks, against its
    sub-operators called one by one (the batched action, then each
    parameter's derivative operators, each with its own exchange and
    all-reduce)."""
    import torch
    from pacmensl_tpu_torch.ops.sens_operator import SensOperator
    from pacmensl_tpu_torch.parallel.mesh import shard_rows
    from pacmensl_tpu_torch.sys import events
    out = {}
    rng = np.random.default_rng(9)
    for name, bounds in (("poisson_sens", [39]),
                         ("hog1p_3d_sens", [3, 4, 4, 1, 10, 10, 10]),
                         ("births_1_2", [47])):
        b = (_births_1_2(pt) if name == "births_1_2"
             else getattr(pt.models, name)())
        cs = (pt.ConstraintSet(None, bounds, None, 1) if b.constraint is None
              else pt.ConstraintSet(b.constraint, bounds,
                                    b.expansion_factors))
        pad = np.ones(b.model.num_species, np.int64)
        pad[0] = mesh.size
        space = pt.BoxStateSpace(b.model.stoichiometry, cs, b.x0,
                                 device="cpu", pad_quanta=pad)
        m = 1 + b.model.num_parameters
        Y = torch.as_tensor(rng.random((m, space.size))) \
            * space.mask.reshape(1, -1)
        sop = SensOperator(b.model, space, mesh=mesh)
        n, nc = sop.local_n, sop.num_constraints
        y = pt.FspVector(p=shard_rows(Y.reshape(-1), m, mesh),
                         sinks=torch.zeros(m * nc, dtype=torch.float64))
        t = 0.7
        ex, ar = mesh.halo_exchanges, mesh.all_reduces
        log = pt.EventLog()
        with events.active(log):
            got = sop.action(t, y)
        counts = (mesh.halo_exchanges - ex, mesh.all_reduces - ar)
        out[f"act_{name}_spans"] = np.array(
            [log.events[k].count for k in ("SensAction", "SensDerivative",
                                            "SensActionStates",
                                            "SensActionSinks")]
            + [m * space.num_states, m * nc])
        c = sop.model.coefficients(t, torch.float64)
        want = torch.empty_like(y.p)
        _, sk = sop.base.action_batched(t, y.p.view(m, n), c=c,
                                        out=want.view(m, n))
        sk = sk.reshape(-1)
        pv = pt.FspVector(p=y.p.view(m, n)[0], sinks=y.sinks[:nc])
        for j in range(sop.n_par):
            if sop.dcxA[j] is None and sop.cxdA[j] is None:
                continue
            g = sop.sens_action(j, t, pv)
            want[(j + 1) * n:(j + 2) * n].add_(g.p)
            sk[(j + 1) * nc:(j + 2) * nc].add_(g.sinks)
        key = f"act_{name}_"
        out[key + "counts"] = np.array(counts)
        out[key + "interior"] = np.array(
            [op.sharded.L0 >= 2 * op.sharded.w0 for op in sop.sub_ops()])
        out[key + "p"] = got.p.numpy()
        out[key + "sinks"] = got.sinks.numpy()
        out[key + "p_each"] = want.numpy()
        out[key + "sinks_each"] = sk.numpy()
    return out


def _births_1_2(pt):
    """Births of one and of two molecules and deaths, sensitive to the
    rate of the first: the base operator's halo is 3 planes, the
    derivative operator's (births of one) 2."""
    import torch
    from types import SimpleNamespace
    stoich = np.array([[1], [2], [-1]])

    def prop(x, r):
        x = x.to(torch.float64)
        return x[:, 0] if r == 2 else torch.ones_like(x[:, 0])
    m = pt.SensModel(stoich, prop,
                     lambda t: torch.tensor([2.0, 0.5, 0.3],
                                            dtype=torch.float64),
                     tv_reactions=(0,), num_parameters=1,
                     d_t_coeff=lambda j, t: torch.tensor(
                         [1.0], dtype=torch.float64),
                     dtcoef_sparsity=((0,),), d_propensity=None,
                     dprop_sparsity=())
    return SimpleNamespace(model=m, constraint=None, x0=np.array([[0]]))


def _work_window(pt, mesh):
    """ShardedBoxAction.batched (K9w's plain version behind one halo
    exchange of every vector) against the sharded action on each vector
    (keys ``s1_*``, ``s0_*``)."""
    import torch
    from pacmensl_tpu_torch.ops import box_kernel as bk
    from pacmensl_tpu_torch.ops import box_operator as bo
    from pacmensl_tpu_torch.parallel.mesh import gather_rows
    b = pt.models.repressilator()
    cs = pt.ConstraintSet(b.constraint, [31, 7, 7, 99, 21, 99],
                          b.expansion_factors)
    pad = np.ones(3, np.int64)
    pad[0] = mesh.size
    space = pt.BoxStateSpace(b.model.stoichiometry, cs, b.x0, device="cpu",
                             pad_quanta=pad)
    rng = np.random.default_rng(5)
    P = torch.as_tensor(rng.random((3, space.size))) \
        * space.mask.reshape(1, -1)
    out = {}
    for synth in (True, False):
        bo.USE_SYNTH_MASK = synth
        op = pt.BoxOperator(b.model, space, mesh=mesh)
        sh = op.sharded
        lo = (sh.origin0 + sh.w0) * sh.plane
        loc = P[:, lo:lo + op.local_n].contiguous()
        ex, ar = mesh.halo_exchanges, mesh.all_reduces
        k9w = "batched_sharded_" + ("synth" if synth else "mask")
        n0 = dict(bk.KERNEL.plain_calls)
        dp, sk = op.action_batched(0.3, loc)
        counts = (mesh.halo_exchanges - ex, mesh.all_reduces - ar)
        calls = [bk.KERNEL.plain_calls[k9w] - n0[k9w],
                 sum(bk.KERNEL.plain_calls.values()) - sum(n0.values())]
        each = [op.action(0.3, pt.FspVector(p=loc[i], sinks=None))
                for i in range(3)]
        key = f"s{int(synth)}"
        out[key + "_calls"] = np.array(calls)
        out[key + "_counts"] = np.array(counts)
        out[key + "_mode"] = np.array(op.synth_mask)
        out[key + "_dp"] = gather_rows(dp.reshape(-1), 3, mesh).numpy()
        out[key + "_dp_each"] = gather_rows(
            torch.stack([e.p for e in each]).reshape(-1), 3, mesh).numpy()
        out[key + "_sk"] = sk.numpy()
        out[key + "_sk_each"] = torch.stack([e.sinks for e in each]).numpy()
        one = pt.BoxOperator(b.model, space)
        d1, s1 = one.action_batched(0.3, P)
        out[key + "_dp1"] = d1.numpy().reshape(-1)
        out[key + "_sk1"] = s1.numpy()
    bo.USE_SYNTH_MASK = True
    return out


WORK = {"operator": _work_operator, "solves": _work_solves,
        "window": _work_window}


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
    env = dict(os.environ, OMP_NUM_THREADS="1")
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
def operator_run(request, tmp_path_factory):
    return request.param, _launch("operator", request.param,
                                  tmp_path_factory.mktemp("operator"))


@pytest.fixture(scope="module")
def solves_run(tmp_path_factory):
    return _launch("solves", 2, tmp_path_factory.mktemp("solves"))


@pytest.fixture(scope="module")
def window_run(tmp_path_factory):
    return _launch("window", 2, tmp_path_factory.mktemp("window"))


def test_sharded_ell_matches_single_device(operator_run):
    world, outs = operator_run
    for r, o in enumerate(outs):
        assert int(o["n_pad"]) % (128 * world) == 0
        assert int(o["L"]) * world == int(o["n_pad"])
        # surface-not-volume communication: the halo is a thin band
        assert 0 < int(o["halo"]) < int(o["L"])
        assert int(o["comm"]) == world * world * int(o["halo"])
        assert 0 < int(o["sent"]) <= int(o["comm"])
        assert int(o["nnz"]) == int(o["nnz1"])
        for k in ("dp", "dpb"):
            np.testing.assert_allclose(o[k], o[k + "1"], rtol=1e-12,
                                       atol=1e-14, err_msg=f"rank {r} {k}")
        np.testing.assert_allclose(o["sinks"], o["sinks1"], rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(o["skb"], o["skb1"], rtol=1e-12,
                                   atol=1e-14)
        # the batch's first row is the single action, bit for bit
        assert np.array_equal(o["dpb"][0], o["dp"])
        assert np.array_equal(o["skb"][0], o["sinks"])
        assert np.array_equal(o["sinks"], outs[0]["sinks"])


def _one_device(name, backend, **kw):
    import torch
    torch.set_num_threads(2)
    import pacmensl_tpu_torch as pt
    sens = name.endswith("_sens")
    s = _solver(pt, name, backend, None, sens=sens)
    return s


def test_hypergraph_order_is_the_same_on_every_rank(operator_run):
    """HYPERGRAPH is the same on every rank (a fixed ARPACK start and a
    rule for a tied Fiedler eigenvalue) and the one-device order; orders
    that differ by rank raise ``StateSpaceError`` in the solver."""
    from pacmensl_tpu_torch.statespace.partitioner import (
        StatePartitioner, PartitioningType)
    import pacmensl_tpu_torch as pt
    world, outs = operator_run
    for name in ("toggle", "repressilator"):
        for o in outs[1:]:
            assert np.array_equal(o[f"hyper_{name}"],
                                  outs[0][f"hyper_{name}"])
    b = pt.models.toggle()
    ss = pt.StateSet(b.model.stoichiometry, pt.ConstraintSet(None, [31, 31]),
                     init_states=b.x0)
    ss.expand()
    one = StatePartitioner(PartitioningType.HYPERGRAPH).partition(
        ss.states, b.model.stoichiometry, world, state2index=ss.state2index)
    assert np.array_equal(one.order, outs[0]["hyper_toggle"])
    assert all(bool(o["hyper_mismatch_raises"]) for o in outs)


def test_scaling_sweep_over_ranks(operator_run):
    """``examples/scaling_sweep.py``'s rank body at a 24^3 box over the
    group's first 1 and 2 ranks: the assembled box dp bitwise one rank's
    (K4 in one launch), the ELL dp within 1e-12 of one rank's under BLOCK
    and GRAPH; rows only on rank 0."""
    world, outs = operator_run
    o = outs[0]
    for other in outs[1:]:
        assert int(other["sweep_rows"]) == 0
    path, n = o["sweep_path"], o["sweep_n"]
    box, ell = path == "box", path == "ell"
    # box: n = 1 (K3), n = 2 (K4)
    assert n[box].tolist() == [1, 2]
    assert o["sweep_same"][box].all()
    assert (o["sweep_comm"][box][1:] > 0).all()
    # ELL: BLOCK then GRAPH, n = 1 and 2 each
    assert n[ell].tolist() == [1, 2, 1, 2]
    assert (o["sweep_rel"][ell] <= 1e-12).all()
    assert (o["sweep_halo"][ell][[1, 3]] > 0).all()
    assert (o["sweep_us"] > 0).all() and (o["sweep_eff"] > 0).all()


def test_ell_poisson_over_ranks_matches_single_device(solves_run):
    import math
    o = solves_run[0]
    d1 = _one_device("poisson", "ell").solve(10.0, 1e-6)
    assert str(o["poisson_backend"]) == "ell"
    assert np.array_equal(o["poisson_states"], d1.states)
    assert np.abs(o["poisson_p"] - d1.p).max() <= 1e-12
    k = o["poisson_states"][:, 0]
    pmf = np.exp(k * math.log(20.0) - 20.0
                 - np.array([math.lgamma(v + 1.0) for v in k]))
    assert np.abs(o["poisson_p"] - pmf).sum() <= 1e-6
    assert int(o["poisson_halo"]) > 0
    for other in solves_run[1:]:
        assert np.array_equal(other["poisson_p"], o["poisson_p"])


def test_box_to_ell_migration_over_ranks(solves_run, monkeypatch):
    o = solves_run[0]
    monkeypatch.setenv("PACMENSL_BOX_MEM_BUDGET", MIGRATE_BUDGET)
    s1 = _one_device("repressilator", "box")
    d1 = s1.solve(0.5, 1e-4)
    assert s1._backend_used == "ell"
    assert str(o["migrate_backend"]) == "ell"
    assert np.array_equal(o["migrate_states"], d1.states)
    assert np.abs(o["migrate_p"] - d1.p).max() <= 1e-12
    assert o["migrate_expansions"].shape[0] > 1


def test_ranks_hold_the_same_state_sets(solves_run):
    o = solves_run[0]
    for other in solves_run[1:]:
        for case in ("poisson", "migrate"):
            for k in ("expansions", "t", "h", "sinks"):
                assert np.array_equal(other[f"{case}_{k}"],
                                      o[f"{case}_{k}"]), (case, k)


@pytest.mark.parametrize("backend", ["box", "ell"])
def test_sensitivity_solve_over_ranks(solves_run, backend):
    o = solves_run[0]
    d1 = _one_device("poisson_sens", backend).solve(1.0, 1e-7)
    assert np.array_equal(o[f"sens_{backend}_states"], d1.states)
    np.testing.assert_allclose(o[f"sens_{backend}_p"], d1.p, rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_allclose(o[f"sens_{backend}_dp"], d1.dp, rtol=1e-10,
                               atol=1e-14)
    for other in solves_run[1:]:
        assert np.array_equal(other[f"sens_{backend}_dp"],
                              o[f"sens_{backend}_dp"])


def test_batched_window_plain_matches_sharded_each(window_run):
    for o in window_run:
        for synth in (1, 0):
            key = f"s{synth}"
            assert bool(o[key + "_mode"]) == bool(synth)
            assert np.array_equal(o[key + "_dp"], o[key + "_dp_each"])
            assert np.array_equal(o[key + "_sk"], o[key + "_sk_each"])
            # and the whole box's batched action, rows bitwise
            assert np.array_equal(o[key + "_dp"], o[key + "_dp1"])
            np.testing.assert_allclose(o[key + "_sk"], o[key + "_sk1"],
                                       rtol=1e-12, atol=1e-13)


def test_batched_window_over_ranks(window_run):
    """ShardedBoxAction.batched in one K9w launch on the window and no
    other call, one exchange and one all-reduce: dp and the reduced sinks
    the same on every rank, the sinks within 1e-12 of one device's."""
    for o in window_run:
        for synth in (1, 0):
            key = f"s{synth}"
            assert o[key + "_calls"].tolist() == [1, 1]
            assert bool(o[key + "_mode"]) == bool(synth)
            assert o[key + "_counts"].tolist() == [1, 1]
            assert np.array_equal(o[key + "_dp"], window_run[0][key + "_dp"])
            assert np.array_equal(o[key + "_sk"], window_run[0][key + "_sk"])
            np.testing.assert_allclose(o[key + "_sk"], o[key + "_sk1"],
                                       rtol=1e-12, atol=1e-13)


def test_sensitivity_action_over_ranks_makes_one_exchange(solves_run):
    """One action on the box over 2 ranks: one halo exchange and one
    all-reduce, p and the sinks bitwise the sub-operators called one by
    one, each in one launch on its window; poisson_sens's slabs have an
    interior, hog1p_3d_sens's base operator's none, its derivative
    operators' (halos of one plane) do; births of one and two take the
    base operator's halos of 3 planes to a derivative operator's of 2."""
    want_interior = {"poisson_sens": [True, True],
                     "hog1p_3d_sens": [False, True, True],
                     "births_1_2": [True, True]}
    for o in solves_run:
        for name in want_interior:
            key = f"act_{name}_"
            assert o[key + "counts"].tolist() == [1, 1], key
            assert o[key + "interior"].tolist() == want_interior[name], key
            assert np.array_equal(o[key + "p"], o[key + "p_each"]), key
            assert np.array_equal(o[key + "sinks"], o[key + "sinks_each"])
            assert np.array_equal(o[key + "sinks"],
                                  solves_run[0][key + "sinks"])


def test_sensitivity_action_over_ranks_spans(solves_run):
    """Over 2 ranks each rank's action is one ``SensAction`` span holding
    one ``SensDerivative`` span, and counts (1 + Np) x the whole state
    set and (1 + Np) x the constraints."""
    for o in solves_run:
        for name in ("poisson_sens", "hog1p_3d_sens", "births_1_2"):
            spans = o[f"act_{name}_spans"].tolist()
            assert spans[:2] == [1, 1], name
            assert spans[2:4] == spans[4:6], name


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--worker":
        _worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                sys.argv[5])
