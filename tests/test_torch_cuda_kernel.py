"""The box kernel's wrapper: device dispatch on the CPU, and on a card the
CUDA kernel against its plain PyTorch version.

This file imports no JAX, so its CUDA cases also run on a GPU host without
the reference package (see README: ``pytest --noconftest -m cuda``).  The
kernel's ``dp`` rounds as its plain version's does and must equal it
bitwise; its sinks are summed in another order, hence rtol 1e-12 /
atol 1e-13.  Two launches of the kernel must agree bitwise."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops import box_kernel as bk  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-13)


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _operator(name, bounds, device):
    b = pt.models.ALL_MODELS[name]()
    cs = pt.ConstraintSet(b.constraint, bounds, b.expansion_factors)
    space = pt.BoxStateSpace(b.model.stoichiometry, cs, b.x0, device=device)
    return b, pt.BoxOperator(b.model, space)


def test_cpu_tensors_run_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    b, op = _operator("toggle", [12, 9, 40], "cpu")
    d = op.data()
    rng = np.random.default_rng(5)
    p = torch.as_tensor(rng.random(op.geom.n)) * d.mask
    c = b.model.coefficients(0.0)
    n0, m0 = bk.KERNEL.launches, bk.KERNEL.plain_cuda_calls
    got = bk.box_action(c, p, d.mask, op.prop_fields, d.viol, op.geom)
    want = bk.box_action_reference(c, p, d.mask, op.prop_fields, d.viol,
                                   op.geom)
    assert (bk.KERNEL.launches, bk.KERNEL.plain_cuda_calls) == (n0, m0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name,bounds,t", [
    ("toggle", [12, 9, 40], 0.0),
    ("repressilator", [25, 15, 15, 60, 30, 60], 0.0),
    ("hog1p_3d", [3, 8, 8, 4, 12, 12, 12], 30.0),
    ("hog1p_5d", [3, 6, 6, 6, 6, 8, 8], 60.0),
])
def test_cuda_kernel_matches_plain_version(name, bounds, t):
    _needs_cuda()
    b, op = _operator(name, bounds, "cuda")
    d = op.data()
    rng = np.random.default_rng(11)
    p = torch.as_tensor(rng.random(op.geom.n), device="cuda") * d.mask
    c = b.model.coefficients(t)
    n0 = bk.KERNEL.launches
    kp, ks = bk.box_action(c, p, d.mask, op.prop_fields, d.viol, op.geom)
    kp2, ks2 = bk.box_action(c, p, d.mask, op.prop_fields, d.viol, op.geom)
    rp, rs = bk.box_action_reference(c, p, d.mask, op.prop_fields, d.viol,
                                     op.geom)
    torch.cuda.synchronize()
    assert bk.KERNEL.launches == n0 + 2
    assert torch.equal(kp, rp)
    np.testing.assert_allclose(ks.cpu().numpy(), rs.cpu().numpy(), **TOL)
    assert torch.equal(kp, kp2) and torch.equal(ks, ks2)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    _needs_cuda()
    b, op = _operator("toggle", [12, 9, 40], "cuda")
    d = op.data()
    c = b.model.coefficients(0.0)
    p = torch.zeros(op.geom.n, dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):
        bk.box_action(c, p.float(), d.mask, op.prop_fields, d.viol, op.geom)
    with pytest.raises(ValueError):
        bk.box_action(c, p[:-1], d.mask, op.prop_fields, d.viol, op.geom)
    with pytest.raises(ValueError):
        bk.box_action(c, p, d.mask, op.prop_fields.t().contiguous().t(),
                      d.viol, op.geom)
    with pytest.raises(ValueError):
        bk.box_action(c, p, d.mask.cpu(), op.prop_fields, d.viol, op.geom)


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
    assert bk.KERNEL.launches > 0 and bk.KERNEL.plain_cuda_calls == 0
    k = d.states[:, 0]
    pmf = np.exp(k * math.log(20.0) - 20.0
                 - np.array([math.lgamma(v + 1.0) for v in k]))
    assert np.abs(d.p - pmf).sum() <= 1e-6
