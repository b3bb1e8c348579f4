"""The box kernel's sharded mode (K4), plain version, against the
reference package's sharded kernel, in one process.

The reference's ``ShardedPallasBoxAction`` runs on ``make_mesh(4)`` of the
virtual CPU devices, in interpret mode at float64.  The port's operator is
built for each of 4 ranks with a mesh that has no process group: its halo
exchange hands the rank the neighbours' planes of the global vector, as
the exchange would deliver them, and the test sums the sinks over the
ranks.  The assembled ``dp`` is bitwise the port's single-device ``dp``,
and both agree with the reference within 1e-12 relative; so do the sinks
(summed in another order).  Cases: the toggle ``[39, 17]`` box of
``tests/test_sharded_pallas.py:19-74`` in both kernel modes, and the
repressilator case of ``:105-145``, whose overlap split (the reference's
default) the action's one launch on each rank's window matches.  On the
repressilator's slabs the batched action takes one launch on the window
(K9w's plain version), against each vector's K4 action.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import pacmensl_tpu as pm  # noqa: E402
from pacmensl_tpu.parallel.halo_box import ShardedPallasBoxAction  # noqa
from pacmensl_tpu.parallel import mesh as jmesh  # noqa: E402
from pacmensl_tpu.parallel.mesh import make_mesh  # noqa: E402
from pacmensl_tpu.statespace.box_space import (  # noqa: E402
    BoxStateSpace as JBoxStateSpace)
from pacmensl_tpu.statespace.constraints import (  # noqa: E402
    ConstraintSet as JConstraintSet)

import pacmensl_tpu_torch as pt  # noqa: E402
from pacmensl_tpu_torch.ops import box_kernel as bk  # noqa: E402
from pacmensl_tpu_torch.ops import box_operator as bo  # noqa: E402
from pacmensl_tpu_torch.parallel.halo_box import window_rows  # noqa: E402
from pacmensl_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from pacmensl_tpu_torch.parallel.mesh import StateMesh  # noqa: E402

RANKS = 4
TOL = dict(rtol=1e-12, atol=1e-13)


class _LocalMesh(StateMesh):
    """One rank of a mesh with no process group: the halo exchange reads
    the neighbours' planes from the global box ``p_box``, and all-reduces
    leave the rank's partial sums for the test to add."""

    def __init__(self, rank, p_box):
        super().__init__(None, rank, RANKS, "cpu")
        self.p_box = p_box

    def all_reduce(self, t, op="sum"):
        return t

    def halo_start(self, first, last, up=None, dn=None):
        w0 = first.numel() // int(np.prod(self.p_box.shape[1:]))
        L0 = self.p_box.shape[0] // RANKS
        got = (window_rows(self.p_box, self.rank * L0 - w0, w0).reshape(-1),
               window_rows(self.p_box, (self.rank + 1) * L0, w0).reshape(-1))
        up, dn = [g if b is None else b.copy_(g)
                  for g, b in zip(got, (up, dn))]

        class _Done:
            def wait(self):
                return up, dn
        return _Done()


class _LocalBatchMesh(_LocalMesh):
    """:class:`_LocalMesh` for a batch: ``p_box`` is ``[nb, *shape]``, the
    halos ``[nb, w0 P]``."""

    def halo_start(self, first, last, up=None, dn=None):
        w0 = first.shape[-1] // int(np.prod(self.p_box.shape[2:]))
        L0 = self.p_box.shape[1] // RANKS
        got = [torch.stack([window_rows(b, o, w0).reshape(-1)
                            for b in self.p_box])
               for o in (self.rank * L0 - w0, (self.rank + 1) * L0)]
        up, dn = [g if b is None else b.copy_(g)
                  for g, b in zip(got, (up, dn))]

        class _Done:
            def wait(self):
                return up, dn
        return _Done()


def _spaces(name, bounds, custom):
    """The two packages' spaces for one bundle, axis 0 padded to the rank
    count; the same capacity."""
    jb, tb = pm.models.ALL_MODELS[name](), pt.models.ALL_MODELS[name]()
    pad = np.ones(tb.model.num_species, np.int64)
    pad[0] = RANKS
    if custom:
        jcs = JConstraintSet(jb.constraint, bounds, jb.expansion_factors)
        tcs = pt.ConstraintSet(tb.constraint, bounds, tb.expansion_factors)
    else:
        jcs = JConstraintSet(None, bounds)
        tcs = pt.ConstraintSet(None, bounds, None, tb.model.num_species)
    jsp = JBoxStateSpace(jb.model.stoichiometry, jcs, jb.x0,
                         pad_quanta=pad)
    tsp = pt.BoxStateSpace(tb.model.stoichiometry, tcs, tb.x0,
                           device="cpu", pad_quanta=pad)
    assert tuple(jsp.shape) == tuple(tsp.shape)
    assert tsp.shape[0] % RANKS == 0
    return jb, jcs, jsp, tb, tsp


def _sharded_port(tb, tsp, p, c):
    """The port's sharded action over RANKS ranks: (dp, summed sinks,
    the rank operators)."""
    p_box = p.reshape(tsp.shape)
    dps, sinks, ops = [], 0, []
    for r in range(RANKS):
        op = pt.BoxOperator(tb.model, tsp, mesh=_LocalMesh(r, p_box))
        sh = op.sharded
        lo = sh.origin0 + sh.w0
        loc = p_box[lo:lo + sh.L0].reshape(-1)
        dp, ks = sh(c, loc, op.prop_fields, op.data().mask, op.data().viol,
                    op.data().bounds)
        dps.append(dp)
        sinks = sinks + ks
        ops.append(op)
    return torch.cat(dps), sinks, ops


def _seeded_p(tsp, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.random(tsp.size))
            * tsp.mask.reshape(-1)).to(torch.float64)


def _reference(jb, jcs, jsp, c, p, synth):
    act = ShardedPallasBoxAction(
        jb.model.propensity, jb.model.stoichiometry, jsp.shape,
        range(jb.model.num_reactions), make_mesh(RANKS), dtype=jnp.float64,
        components=jcs.components, synth_mask=synth)
    assert act.synth_mask == synth
    dp, ks = act(jnp.asarray(c), jnp.asarray(jcs.bounds),
                 jnp.asarray(p.numpy().reshape(jsp.shape)),
                 jsp.mask.astype(jnp.float64))
    return act, np.asarray(dp).reshape(-1), np.asarray(ks)


@pytest.mark.parametrize("synth", [True, False])
def test_sharded_kernel_matches_reference(synth, monkeypatch):
    monkeypatch.setattr(bo, "USE_SYNTH_MASK", synth)
    jb, jcs, jsp, tb, tsp = _spaces("toggle", [39, 17], custom=False)
    rng = np.random.default_rng(11)
    c = rng.random(tb.model.num_reactions) + 0.5
    p = _seeded_p(tsp)
    dp, sinks, ops = _sharded_port(tb, tsp, p, c)
    assert all(op.synth_mask == synth for op in ops)
    one = pt.BoxOperator(tb.model, tsp)
    dp1, sinks1 = (bo.box_action_synth(c, p, one.prop_fields,
                                       one.data().bounds, one.geom)
                   if synth else
                   bo.box_action(c, p, one.data().mask, one.prop_fields,
                                 one.data().viol, one.geom))
    assert torch.equal(dp, dp1)
    np.testing.assert_allclose(sinks.numpy(), sinks1.numpy(), **TOL)
    _, jdp, jks = _reference(jb, jcs, jsp, c, p, synth)
    np.testing.assert_allclose(dp.numpy(), jdp, **TOL)
    np.testing.assert_allclose(sinks.numpy(), jks, **TOL)


def test_overlap_split_matches_monolithic(monkeypatch):
    """The action's one launch on each rank's window, where every slab
    has an interior (``L0 >= 2 w0``): one plain call a rank, dp bitwise
    the whole box's, the summed sinks within TOL of its; both within TOL
    of the reference's overlap split (the interior rows under the
    exchange, then the edge strips)."""
    jb, jcs, jsp, tb, tsp = _spaces(
        "repressilator", np.array([31, 7, 7, 99, 21, 99]), custom=True)
    assert tsp.mask_is_constraint_only
    c = np.ones(tb.model.num_reactions)
    p = _seeded_p(tsp)
    n0 = dict(bk.KERNEL.plain_calls)
    dp, sinks, ops = _sharded_port(tb, tsp, p, c)
    assert bk.KERNEL.plain_calls["sharded_synth"] == \
        n0["sharded_synth"] + RANKS
    assert sum(bk.KERNEL.plain_calls.values()) == \
        sum(n0.values()) + RANKS
    for op in ops:
        sh = op.sharded
        assert op.synth_mask and sh.L0 >= 2 * sh.w0
    one = pt.BoxOperator(tb.model, tsp)
    dp1, sinks1 = bo.box_action_synth(c, p, one.prop_fields,
                                      one.data().bounds, one.geom)
    assert torch.equal(dp, dp1)
    np.testing.assert_allclose(sinks.numpy(), sinks1.numpy(), **TOL)
    monkeypatch.setenv("PACMENSL_HALO_OVERLAP", "1")
    act, jdp, jks = _reference(jb, jcs, jsp, c, p, synth=True)
    assert act.overlap
    np.testing.assert_allclose(dp.numpy(), jdp, **TOL)
    np.testing.assert_allclose(sinks.numpy(), jks, **TOL)


def test_window_geometry():
    """The window fields of the one launch on a rank's window: the slab's
    rows over the rank's window at global origin ``r L0 - w0``, with the
    halo width of the reference, reading the halos where a neighbour
    holds them."""
    _, _, _, tb, tsp = _spaces("repressilator",
                               np.array([31, 7, 7, 99, 21, 99]), custom=True)
    p_box = _seeded_p(tsp).reshape(tsp.shape)
    for r in range(RANKS):
        op = pt.BoxOperator(tb.model, tsp, mesh=_LocalMesh(r, p_box))
        sh = op.sharded
        L0, w0 = sh.L0, sh.w0
        assert w0 == int(np.abs(tb.model.stoichiometry[:, 0]).max()) + 1
        assert sh.origin0 == r * L0 - w0
        g = sh.geom
        assert (g.origin0, g.out_lo, g.out_hi) == (r * L0 - w0, w0, w0 + L0)
        assert g.halo_rows == (w0, L0) and g.n_out == L0 * sh.plane
        assert g.reads_halo == (r > 0, r < RANKS - 1)
        assert op.prop_fields.shape[1] == (L0 + 2 * w0) * sh.plane
        assert op.props.shape == sh.window_shape
        assert sh.comm_values_per_matvec() == 2 * w0 * sh.plane * (RANKS - 1)


@pytest.mark.parametrize("synth,nb", [(True, 3), (False, 3), (True, 2),
                                      (False, 2)])
def test_batched_action_takes_one_launch_on_the_window(synth, nb,
                                                       monkeypatch):
    """ShardedBoxAction.batched runs K9w in one launch on each rank's
    window after the exchange, where the slabs have an interior too: one
    batched plain call and no other; dp bitwise each vector's K4 action,
    the sinks within TOL of its."""
    monkeypatch.setattr(bo, "USE_SYNTH_MASK", synth)
    _, _, _, tb, tsp = _spaces(
        "repressilator", np.array([31, 7, 7, 99, 21, 99]), custom=True)
    rng = np.random.default_rng(5)
    P = (torch.as_tensor(rng.random((nb, tsp.size)))
         * tsp.mask.reshape(1, -1)).to(torch.float64)
    key = "batched_sharded_" + ("synth" if synth else "mask")
    for r in range(RANKS):
        op = pt.BoxOperator(tb.model, tsp, mesh=_LocalBatchMesh(
            r, P.reshape((nb,) + tuple(tsp.shape))))
        sh = op.sharded
        assert sh.L0 >= 2 * sh.w0
        lo = sh.origin0 + sh.w0
        loc = P[:, lo * sh.plane:(lo + sh.L0) * sh.plane].contiguous()
        n0 = dict(bk.KERNEL.plain_calls)
        dp, sk = op.action_batched(0.3, loc)
        assert bk.KERNEL.plain_calls[key] == n0[key] + 1
        assert sum(bk.KERNEL.plain_calls.values()) == sum(n0.values()) + 1
        for i in range(nb):
            one = pt.BoxOperator(tb.model, tsp, mesh=_LocalMesh(
                r, P[i].reshape(tsp.shape)))
            want = one.action(0.3, pt.FspVector(p=loc[i], sinks=None))
            assert torch.equal(dp[i], want.p)
            np.testing.assert_allclose(sk[i].numpy(), want.sinks.numpy(),
                                       **TOL)


@pytest.mark.parametrize("shape,n", [((211, 316, 211), 4), ((40, 18), 4),
                                     ((9, 12, 7), 4), ((3, 5), 8),
                                     ((), 2)])
def test_shard_axis_rule_matches_reference(shape, n):
    """``choose_shard_axis`` and ``box_spec`` keep the reference's rule:
    axis 0 where it divides, else the largest divisible axis."""
    axis = tmesh.choose_shard_axis(shape, n)
    assert axis == jmesh.choose_shard_axis(shape, n)
    want = tuple(jmesh.box_spec(shape, n))
    want = want + (None,) * (len(shape) - len(want))
    assert tmesh.box_spec(shape, n) == want


def test_halo_exchange_keeps_the_tensors_it_sends(monkeypatch):
    """A batch's edge planes are strided views, copied for the sends; the
    exchange keeps those very copies alive until ``wait``, not the
    views (rank 1 of 3 sends both ways)."""
    sent = []

    class P2POp:
        def __init__(self, op, tensor, peer, group=None):
            if op is tmesh.dist.isend:
                sent.append((tensor, peer))

    monkeypatch.setattr(tmesh.dist, "P2POp", P2POp)
    monkeypatch.setattr(tmesh.dist, "batch_isend_irecv", lambda ops: [])
    mesh = tmesh.StateMesh(None, 1, 3, "cpu")
    p = torch.arange(3 * 40, dtype=torch.float64).view(3, 40)
    first, last = p[:, :8], p[:, 32:]
    assert not first.is_contiguous() and not last.is_contiguous()
    ex = mesh.halo_start(first, last)
    assert [peer for _, peer in sent] == [0, 2]
    assert ex._sent[0] is sent[0][0] and ex._sent[1] is sent[1][0]
    assert torch.equal(sent[0][0], first) and torch.equal(sent[1][0], last)
    up, dn = ex.wait()
    assert ex._sent is None and up.shape == last.shape
