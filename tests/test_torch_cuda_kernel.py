"""The box kernel's wrappers: device dispatch on the CPU, and on a card
both kernel modes against their plain PyTorch versions.

This file imports no JAX, so its CUDA cases also run on a GPU host without
the reference package (see README: ``pytest --noconftest -m cuda``).  The
kernel's ``dp`` rounds as its plain version's does and must equal it
bitwise; its sinks are summed in another order, hence rtol 1e-12 /
atol 1e-13.  Two launches of the kernel must agree bitwise, and on a box
whose mask is constraint-only the synthesized-mask mode (K3) must give
the mask-reading mode's (K1) ``dp`` and sinks bitwise.  The sharded mode
(K4) on slabs of a box gives the whole box's ``dp`` bitwise.  Every case
runs on the operators' propensity tables (``tables``) and on their
``[R, n]`` fields read as field rows.  A one-rank mesh on the card uses
NCCL."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops import box_kernel as bk  # noqa: E402
from pacmensl_tpu_torch.ops import box_operator as bo  # noqa: E402
from pacmensl_tpu_torch.parallel.halo_box import (  # noqa: E402
    halo_width, window_rows)
from pacmensl_tpu_torch.parallel.mesh import StateMesh  # noqa: E402
from pacmensl_tpu_torch.statespace.constraints import (  # noqa: E402
    coord, product)

TOL = dict(rtol=1e-12, atol=1e-13)


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _operator(name, bounds, device):
    b = pt.models.ALL_MODELS[name]()
    cs = pt.ConstraintSet(b.constraint, bounds, b.expansion_factors)
    space = pt.BoxStateSpace(b.model.stoichiometry, cs, b.x0, device=device)
    return b, pt.BoxOperator(b.model, space)


def _k1_data(op):
    """The mask-reading kernel's inputs for ``op``'s epoch."""
    return (op.space.mask.reshape(-1).to(torch.uint8),
            bo.violation_bits(op.space.constraints, op.model.stoichiometry,
                              op.shape, op.device))


def test_cpu_tensors_run_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    b, op = _operator("toggle", [12, 9, 40], "cpu")
    d = op.data()
    mask, viol = _k1_data(op)
    rng = np.random.default_rng(5)
    p = torch.as_tensor(rng.random(op.geom.n)) * mask
    c = b.model.coefficients(0.0)
    n0, m0 = dict(bk.KERNEL.launches), dict(bk.KERNEL.plain_cuda_calls)
    got = bk.box_action(c, p, mask, op.prop_fields, viol, op.geom)
    want = bk.box_action_reference(c, p, mask, op.prop_fields, viol,
                                   op.geom)
    got3 = bk.box_action_synth(c, p, op.prop_fields, d.bounds, op.geom)
    want3 = bk.box_action_synth_reference(c, p, op.prop_fields, d.bounds,
                                          op.geom)
    assert (bk.KERNEL.launches, bk.KERNEL.plain_cuda_calls) == (n0, m0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got3[0], want3[0]) and torch.equal(got3[1], want3[1])
    assert torch.equal(got3[0], got[0]) and torch.equal(got3[1], got[1])


def test_index_decode_constants():
    """The kernel decodes a flat index below 2^31 with one multiply and
    shift per axis, q = (x * dmul) >> dshift; the wrapper's constants give
    exact quotients, here checked with Python integers."""
    rng = np.random.default_rng(3)
    shapes = [(4, 42, 94, 42, 63), (211, 316, 211), (1, 2, 3, 5, 7, 64),
              (1 << 20, 3), ((1 << 30) - 1,)]
    for shape in shapes:
        geom = bk.BoxGeometry(shape, np.zeros((1, len(shape)), int), 0)
        prm = geom.params([0.0])
        xs = [0, 1, (1 << 31) - 1] + rng.integers(0, 1 << 31, 400).tolist()
        for d, e in enumerate(shape):
            m, sh = int(prm.dmul[d]), int(prm.dshift[d])
            for x in xs + [e - 1, e, 2 * e - 1]:
                assert (x * m) >> sh == x // e, (shape, d, x)
                assert x * m < 1 << 64


def test_form_arithmetic_width():
    """K3 evaluates the forms in int32 only where no value at a box point
    or its neighbours, and no bound, can overflow it."""
    _, op = _operator("hog1p_5d", [3, 6, 6, 6, 6, 8, 8], "cpu")
    assert op.geom.narrow(op.data().bounds)
    assert not op.geom.narrow([3, 6, 6, 6, 6, 8, 1 << 31])
    rep = pt.models.repressilator()
    small = bk.BoxGeometry((300, 300, 300), rep.model.stoichiometry, 6,
                           rep.constraint.form)
    assert small.narrow([1] * 6)
    big = bk.BoxGeometry((1 << 16, 2, 2), rep.model.stoichiometry, 6,
                         rep.constraint.form)
    assert not big.narrow([1] * 6)      # x0 * x2 may reach 2^32


def test_kernel_limits():
    stoich = np.array([[1, 0], [0, -1]])
    ok = (product(0, 1),)
    assert bk.form_fits_kernel(ok, stoich)
    assert not bk.form_fits_kernel(None, stoich)
    huge = (product(0, 1, u=1 << 30),)
    assert not bk.form_fits_kernel(huge, stoich)     # u s_j leaves int32
    outside = (coord(2),)
    assert not bk.form_fits_kernel(outside, stoich)
    many = (coord(0),) * (bk.MAX_FORM_NC + 1)
    assert not bk.form_fits_kernel(many, stoich)
    bk.BoxGeometry((1 << 16, (1 << 15) - 1), stoich, 0).params([0.0, 0.0])
    with pytest.raises(bk.KernelError, match="elements"):
        bk.BoxGeometry((1 << 16, 1 << 15), stoich, 0).params([0.0, 0.0])


CASES = [
    ("toggle", [12, 9, 40], 0.0),
    ("repressilator", [25, 15, 15, 60, 30, 60], 0.0),
    ("hog1p_3d", [3, 8, 8, 4, 12, 12, 12], 30.0),
    ("hog1p_5d", [3, 6, 6, 6, 6, 8, 8], 60.0),
]
#: K1 only: reachability prunes its mask, and reactions 4 and 6 keep field
#: rows beside the tables
MIXED = [("transcr_reg_6d", [10, 6, 2, 3, 2, 4], 600.0)]


def _props(op, tables):
    return op.props if tables else op.prop_fields


@pytest.mark.cuda
@pytest.mark.parametrize("tables", [True, False])
@pytest.mark.parametrize("name,bounds,t", CASES + MIXED)
def test_cuda_kernel_matches_plain_version(name, bounds, t, tables):
    _needs_cuda()
    b, op = _operator(name, bounds, "cuda")
    mask, viol = _k1_data(op)
    a = _props(op, tables)
    rng = np.random.default_rng(11)
    p = torch.as_tensor(rng.random(op.geom.n), device="cuda") * mask
    c = b.model.coefficients(t)
    n0 = bk.KERNEL.launches["mask"]
    kp, ks = bk.box_action(c, p, mask, a, viol, op.geom)
    kp2, ks2 = bk.box_action(c, p, mask, a, viol, op.geom)
    rp, rs = bk.box_action_reference(c, p, mask, a, viol, op.geom)
    torch.cuda.synchronize()
    assert bk.KERNEL.launches["mask"] == n0 + 2
    assert torch.equal(kp, rp)
    np.testing.assert_allclose(ks.cpu().numpy(), rs.cpu().numpy(), **TOL)
    assert torch.equal(kp, kp2) and torch.equal(ks, ks2)


@pytest.mark.cuda
@pytest.mark.parametrize("tables", [True, False])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("name,bounds,t", CASES)
def test_cuda_synth_kernel_matches_plain_version_and_k1(name, bounds, t,
                                                        wide, tables):
    """``wide`` forces the int64 form arithmetic where int32 would do."""
    _needs_cuda()
    b, op = _operator(name, bounds, "cuda")
    a = _props(op, tables)
    assert op.synth_mask
    assert op.geom.narrow(op.data().bounds)
    if wide:
        op.geom.narrow = lambda bounds: False
    mask, viol = _k1_data(op)
    bounds_now = op.data().bounds
    rng = np.random.default_rng(12)
    p = torch.as_tensor(rng.random(op.geom.n), device="cuda") * mask
    c = b.model.coefficients(t)
    n0 = bk.KERNEL.launches["synth"]
    kp, ks = bk.box_action_synth(c, p, a, bounds_now, op.geom)
    kp2, ks2 = bk.box_action_synth(c, p, a, bounds_now, op.geom)
    rp, rs = bk.box_action_synth_reference(c, p, a, bounds_now, op.geom)
    k1p, k1s = bk.box_action(c, p, mask, a, viol, op.geom)
    torch.cuda.synchronize()
    assert bk.KERNEL.launches["synth"] == n0 + 2
    assert torch.equal(kp, rp)
    np.testing.assert_allclose(ks.cpu().numpy(), rs.cpu().numpy(), **TOL)
    assert torch.equal(kp, kp2) and torch.equal(ks, ks2)
    assert torch.equal(kp, k1p) and torch.equal(ks, k1s)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    _needs_cuda()
    b, op = _operator("toggle", [12, 9, 40], "cuda")
    mask, viol = _k1_data(op)
    c = b.model.coefficients(0.0)
    p = torch.zeros(op.geom.n, dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):
        bk.box_action(c, p.float(), mask, op.prop_fields, viol, op.geom)
    with pytest.raises(ValueError):
        bk.box_action(c, p[:-1], mask, op.prop_fields, viol, op.geom)
    with pytest.raises(ValueError):
        bk.box_action(c, p, mask, op.prop_fields.t().contiguous().t(),
                      viol, op.geom)
    with pytest.raises(ValueError):
        bk.box_action(c, p, mask.cpu(), op.prop_fields, viol, op.geom)
    with pytest.raises(ValueError):
        bk.box_action_synth(c, p, op.prop_fields, [1, 2], op.geom)
    with pytest.raises(TypeError):
        bk.box_action_synth(c, p.float(), op.prop_fields, op.data().bounds,
                            op.geom)


def _slab_windows(op, p, mask, viol, slabs=4, tables=True):
    """The box of ``op`` cut into ``slabs`` axis-0 slabs, each with the
    halo planes of its neighbours as the exchange delivers them: (K4
    geometry, p, mask, propensities, violation bits) of each window."""
    shape, g0 = op.shape, op.shape[0]
    w0 = halo_width(op.model.stoichiometry)
    cuts = np.linspace(0, g0, slabs + 1).astype(int)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        o, rows = int(lo) - w0, int(hi - lo) + 2 * w0
        geom = bk.BoxGeometry((rows,) + shape[1:], op.model.stoichiometry,
                              op.geom.nc, op.geom.form, origin0=o, g0=g0,
                              out_rows=(w0, w0 + int(hi - lo)))

        def win(t):
            return window_rows(t.reshape(shape), o, rows).reshape(-1)
        yield (geom, win(p), win(mask),
               (op.props.window(o, rows) if tables
                else torch.stack([win(f) for f in op.prop_fields])),
               torch.stack([win(v) for v in viol]))


@pytest.mark.cuda
@pytest.mark.parametrize("tables", [True, False])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("name,bounds,t", CASES)
def test_cuda_sharded_kernel_matches_plain_version_and_whole_box(
        name, bounds, t, wide, tables):
    """K4 in both modes on 4 slabs: each slab's dp bitwise its plain
    version's, the assembled dp bitwise the whole box's K1 and K3, the
    summed sinks within TOL; ``wide`` forces the int64 forms."""
    _needs_cuda()
    b, op = _operator(name, bounds, "cuda")
    mask, viol = _k1_data(op)
    bounds_now = op.data().bounds
    rng = np.random.default_rng(13)
    p = torch.as_tensor(rng.random(op.geom.n), device="cuda") * mask
    c = b.model.coefficients(t)
    k1 = bk.box_action(c, p, mask, op.props, viol, op.geom)
    k3 = bk.box_action_synth(c, p, op.props, bounds_now, op.geom)
    got = {"mask": ([], 0), "synth": ([], 0)}
    n0 = dict(bk.KERNEL.launches)
    for geom, wp, wm, wa, wv in _slab_windows(op, p, mask, viol,
                                              tables=tables):
        if wide:
            geom.narrow = lambda bounds: False
        for mode, run, plain in (
                ("mask", lambda: bk.box_action(c, wp, wm, wa, wv, geom),
                 lambda: bk.box_action_reference(c, wp, wm, wa, wv, geom)),
                ("synth", lambda: bk.box_action_synth(c, wp, wa, bounds_now,
                                                      geom),
                 lambda: bk.box_action_synth_reference(c, wp, wa,
                                                       bounds_now, geom))):
            kp, ks = run()
            kp2, ks2 = run()
            rp, rs = plain()
            torch.cuda.synchronize()
            assert torch.equal(kp, rp) and torch.equal(kp, kp2), mode
            assert torch.equal(ks, ks2), mode
            np.testing.assert_allclose(ks.cpu().numpy(), rs.cpu().numpy(),
                                       **TOL)
            dps, sk = got[mode]
            got[mode] = (dps + [kp], sk + ks)
    assert bk.KERNEL.launches["sharded_mask"] == n0["sharded_mask"] + 8
    assert bk.KERNEL.launches["sharded_synth"] == n0["sharded_synth"] + 8
    for mode, (dps, sk) in got.items():
        dp = torch.cat(dps)
        assert torch.equal(dp, k1[0]) and torch.equal(dp, k3[0]), mode
        np.testing.assert_allclose(sk.cpu().numpy(), k1[1].cpu().numpy(),
                                   **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("synth", [True, False])
def test_cuda_one_rank_sharded_matvec_is_one_launch(synth, monkeypatch):
    """One rank: one K4 launch per matvec, no exchange, no collective, no
    second launch for the sinks; dp and sinks bitwise the whole box's."""
    _needs_cuda()
    monkeypatch.setattr(bo, "USE_SYNTH_MASK", synth)
    b, one = _operator("repressilator", [31, 7, 7, 99, 21, 99], "cuda")
    mesh = StateMesh(None, 0, 1, "cuda")
    mesh.halo_start = mesh.all_reduce = None     # never called
    sh = pt.BoxOperator(b.model, one.space, mesh=mesh)
    rng = np.random.default_rng(2)
    p = (torch.as_tensor(rng.random(one.geom.n), device="cuda")
         * one.space.mask.reshape(-1))
    y = pt.FspVector(p=p, sinks=torch.zeros(6, dtype=torch.float64,
                                            device="cuda"))
    want = one.action(0.0, y)
    n0 = dict(bk.KERNEL.launches)
    got = sh.action(0.0, y)
    torch.cuda.synchronize()
    key = "sharded_synth" if synth else "sharded_mask"
    assert bk.KERNEL.launches[key] == n0[key] + 1
    assert sum(bk.KERNEL.launches.values()) == sum(n0.values()) + 1
    assert torch.equal(got.p, want.p) and torch.equal(got.sinks, want.sinks)


@pytest.mark.cuda
def test_cuda_kernel_at_the_bench_box():
    """The fixed-bounds 128^3 repressilator box: K1 and K3 on the tables
    bitwise their plain versions and each other."""
    _needs_cuda()
    rep = pt.models.repressilator()
    shape = (128,) * 3
    bnd = np.array([127] * 3)
    cs = pt.ConstraintSet(None, bnd, None, 3)
    geom = bk.BoxGeometry(shape, rep.model.stoichiometry, 3, cs.form)
    props = bo.propensity_tables(rep.model, shape, "cuda")
    assert props.num_field_rows == 0
    mask, viol = bk.form_mask_and_bits(geom, bnd, "cuda")
    p = torch.as_tensor(np.random.default_rng(3).random(geom.n),
                        device="cuda")
    c = rep.model.coefficients(0.0)
    k1 = bk.box_action(c, p, mask, props, viol, geom)
    k3 = bk.box_action_synth(c, p, props, bnd, geom)
    r1 = bk.box_action_reference(c, p, mask, props, viol, geom)
    torch.cuda.synchronize()
    assert torch.equal(k1[0], r1[0])
    np.testing.assert_allclose(k1[1].cpu().numpy(), r1[1].cpu().numpy(),
                               **TOL)
    assert torch.equal(k3[0], k1[0]) and torch.equal(k3[1], k1[1])


def test_sharded_window_rejected():
    """The wrappers take a window only where every source an output row
    reads lies in it or outside the box, and the output rows in the
    box."""
    stoich = np.array([[2, 0], [-1, 1], [0, -1]])    # sources 2 up, 1 down

    def geom(rows, origin0, out, g0=40):
        return bk.BoxGeometry((rows, 5), stoich, 0, origin0=origin0, g0=g0,
                              out_rows=out)
    g = geom(14, 7, (3, 11))
    assert g.sharded and g.n_out == 8 * 5 and g.mode_key("synth") == \
        "sharded_synth"
    geom(12, -1, (1, 11))          # rows above the box are not read
    geom(10, 30, (2, 10))          # nor rows below it
    for rows, origin0, out in [
            (14, 7, (1, 11)),      # row 1 reads row -1 of the window
            (14, 7, (3, 14)),      # row 13 reads row 14
            (14, 7, (3, 15)),      # past the window
            (14, -4, (3, 11)),     # output row -1 (global)
            (14, 30, (3, 11)),     # output row 40 (global)
            (14, 7, (9, 8))]:      # reversed
        with pytest.raises(ValueError, match="window"):
            geom(rows, origin0, out)
    assert not bk.BoxGeometry((14, 5), stoich, 0).sharded


@pytest.mark.cuda
def test_cuda_sharded_solve_runs_k4():
    """A one-rank NCCL mesh: the Poisson oracle through the sharded path,
    every matvec on K4."""
    _needs_cuda()
    pt.environment.init(backend="nccl")
    try:
        b = pt.models.poisson(2.0)
        s = pt.FspSolverMultiSinks(odes_type="krylov", mesh=pt.make_mesh())
        s.set_model(b.model)
        s.set_initial_bounds(b.bounds)
        s.set_expansion_factors([0.5])
        s.set_initial_distribution(b.x0, b.p0)
        bk.KERNEL.reset_counts()
        d = s.solve(10.0, 1.0e-6)
        assert bk.KERNEL.launches["sharded_synth"] > 0
        assert bk.KERNEL.launches["synth"] == 0
        assert sum(bk.KERNEL.plain_cuda_calls.values()) == 0
        k = d.states[:, 0]
        pmf = np.exp(k * math.log(20.0) - 20.0
                     - np.array([math.lgamma(v + 1.0) for v in k]))
        assert np.abs(d.p - pmf).sum() <= 1e-6
    finally:
        pt.environment.finalize()


@pytest.mark.cuda
def test_cuda_solve_runs_the_kernel():
    """The Poisson oracle on the card goes through the kernel only."""
    _needs_cuda()
    b = pt.models.poisson(2.0)
    s = pt.FspSolverMultiSinks(odes_type="krylov", device="cuda")
    s.set_model(b.model)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors([0.5])
    s.set_initial_distribution(b.x0, b.p0)
    bk.KERNEL.reset_counts()
    d = s.solve(10.0, 1.0e-6)
    assert bk.KERNEL.launches["synth"] > 0
    assert sum(bk.KERNEL.plain_cuda_calls.values()) == 0
    k = d.states[:, 0]
    pmf = np.exp(k * math.log(20.0) - 20.0
                 - np.array([math.lgamma(v + 1.0) for v in k]))
    assert np.abs(d.p - pmf).sum() <= 1e-6


@pytest.mark.cuda
def test_cuda_bdf_solve_runs_the_synthesized_mask_kernel():
    """hog1p_3d to t = 30 on the card: "auto" picks BDF, and every matvec
    launches K3 (the mask stays constraint-only)."""
    _needs_cuda()
    b = pt.models.hog1p_3d()
    s = pt.FspSolverMultiSinks(device="cuda")
    s.set_model(b.model)
    s.set_constraint_functions(b.constraint)
    s.set_initial_bounds(b.bounds)
    s.set_expansion_factors(b.expansion_factors)
    s.set_initial_distribution(b.x0, b.p0)
    bk.KERNEL.reset_counts()
    d = s.solve(30.0, 1.0e-4)
    assert isinstance(s._ode_solver, pt.BdfSolver)
    assert bk.KERNEL.launches["synth"] > 0
    assert bk.KERNEL.launches["mask"] == 0
    assert sum(bk.KERNEL.plain_cuda_calls.values()) == 0
    assert d.num_states == 350 and d.sum() >= 1.0 - 1.0e-4


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 2, 3])
@pytest.mark.parametrize("synth", [True, False])
@pytest.mark.parametrize("name,bounds,t", CASES + MIXED)
def test_cuda_batched_kernel_matches_plain_and_single_launches(
        name, bounds, t, synth, nb):
    """The batched launch (K9): dp bitwise its plain version's, dp and
    sinks bitwise nb single launches', two launches bitwise equal."""
    _needs_cuda()
    b, op = _operator(name, bounds, "cuda")
    if synth and not op.synth_mask:
        pytest.skip("the mask is not constraint-only: K1 only")
    mask, viol = _k1_data(op)
    rng = np.random.default_rng(21)
    P = torch.as_tensor(rng.random((nb, op.geom.n)), device="cuda") * mask
    c, bnd = b.model.coefficients(t), op.data().bounds
    if synth:
        def run():
            return bk.box_action_synth_batched(c, P, op.props, bnd, op.geom)
        want = bk.box_action_synth_batched_reference(c, P, op.props, bnd,
                                                     op.geom)
        one = [bk.box_action_synth(c, P[i], op.props, bnd, op.geom)
               for i in range(nb)]
    else:
        def run():
            return bk.box_action_batched(c, P, mask, op.props, viol, op.geom)
        want = bk.box_action_batched_reference(c, P, mask, op.props, viol,
                                               op.geom)
        one = [bk.box_action(c, P[i], mask, op.props, viol, op.geom)
               for i in range(nb)]
    key = "batched_synth" if synth else "batched_mask"
    n0 = bk.KERNEL.launches[key]
    kp, ks = run()
    kp2, ks2 = run()
    torch.cuda.synchronize()
    assert bk.KERNEL.launches[key] == n0 + 2
    assert kp.shape == (nb, op.geom.n) and ks.shape == (nb, op.geom.nc)
    assert torch.equal(kp, want[0])
    np.testing.assert_allclose(ks.cpu().numpy(), want[1].cpu().numpy(),
                               **TOL)
    assert torch.equal(kp, torch.stack([o[0] for o in one]))
    assert torch.equal(ks, torch.stack([o[1] for o in one]))
    assert torch.equal(kp, kp2) and torch.equal(ks, ks2)


@pytest.mark.cuda
def test_cuda_batched_wrapper_rejects_windows_and_bad_shapes():
    _needs_cuda()
    b, op = _operator("hog1p_5d", [3, 6, 6, 6, 6, 8, 8], "cuda")
    mask, viol = _k1_data(op)
    c, bnd = b.model.coefficients(0.0), op.data().bounds
    P = torch.zeros((2, op.geom.n), dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError):
        bk.box_action_synth_batched(c, P[:, :-1].contiguous(), op.props,
                                    bnd, op.geom)
    with pytest.raises(ValueError):
        bk.box_action_synth_batched(c, P.t().contiguous().t(), op.props,
                                    bnd, op.geom)
    g0 = op.shape[0]
    win = bk.BoxGeometry((g0 + 2,) + op.shape[1:], op.geom.stoich,
                         op.geom.nc, op.geom.form, origin0=-1, g0=g0,
                         out_rows=(1, 1 + g0))
    Pw = torch.zeros((2, win.n), dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError, match="whole box"):
        bk.box_action_synth_batched(c, Pw, op.props.window(-1, g0 + 2),
                                    bnd, win)


@pytest.mark.cuda
def test_cuda_sens_solve_runs_the_batched_kernel():
    """hog1p_3d_sens to t = 30 on the card: every action is one K3 launch
    for p, one batched launch for the sensitivities and one per
    derivative operator, and the result is the CPU plain versions'."""
    _needs_cuda()
    out = {}
    for dev in ("cuda", "cpu"):
        b = pt.models.hog1p_3d_sens()
        s = pt.SensFspSolverMultiSinks(odes_type="auto", device=dev)
        s.set_model(b.model)
        s.set_constraint_functions(b.constraint)
        s.set_initial_bounds(b.bounds)
        s.set_expansion_factors(b.expansion_factors)
        s.set_initial_distribution(b.x0, b.p0)
        bk.KERNEL.reset_counts()
        out[dev] = s.solve(30.0, 1.0e-4)
        if dev == "cuda":
            n = bk.KERNEL.launches["batched_synth"]
            assert n > 0 and bk.KERNEL.launches["synth"] == 3 * n
            assert sum(bk.KERNEL.plain_cuda_calls.values()) == 0
    # The sinks are summed in another order on the card and enter BDF's
    # error norm, so the two solves take other steps: both are certified
    # to fsp_tol (L1 of p within 2 fsp_tol) and integrate to BDF's rtol
    # 1e-6 (dp within 1e-3 relative in L1).
    g, w = out["cuda"], out["cpu"]
    assert np.array_equal(g.states, w.states)
    assert np.abs(g.p - w.p).sum() <= 2e-4
    for j in range(2):
        assert np.abs(g.dp[j] - w.dp[j]).sum() <= \
            1e-3 * np.abs(w.dp[j]).sum()
