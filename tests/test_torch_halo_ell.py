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
* The batched window plain version bitwise against the sharded plain
  version applied to each vector.
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
    return out


def _work_window(pt, mesh):
    """ShardedBoxAction.batched (K9w's plain version behind one halo
    exchange of every vector) against the sharded action on each vector,
    in its single-launch geometry (the batched call's own)."""
    import torch
    os.environ["PACMENSL_HALO_OVERLAP"] = "0"
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
        dp, sk = op.action_batched(0.3, loc)
        each = [op.action(0.3, pt.FspVector(p=loc[i], sinks=None))
                for i in range(3)]
        key = f"s{int(synth)}"
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


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--worker":
        _worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                sys.argv[5])
