"""The probe kernels' plain versions (K5-K8, ``ops/probes.py``) against
the reference's Pallas probes in interpret mode, and the port's probe
tool on the CPU.

The reference's kernels are closures inside ``main()`` of ``bench.py``
and ``tools/bw_probe.py``, so their bodies are copied here verbatim (lines
cited), at T = 64, H = 8, G = 3, L = 128.  The same seeded numpy inputs
go through both.  K5-K7 must agree bitwise.  K8 is held to rtol 1e-6 in
float32 and 1e-14 in float64: XLA may reorder or contract the reference's
sum of six products (interpret mode differed from a numpy model of the
formula by 9.5e-7 and 1.8e-15 on values of about 9)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from pacmensl_tpu_torch import SetupError  # noqa: E402
from pacmensl_tpu_torch.ops import cuda_build  # noqa: E402
from pacmensl_tpu_torch.ops import probes as pr  # noqa: E402
from pacmensl_tpu_torch.tools import bw_probe  # noqa: E402

T, H, G, L = 64, 8, 3, 128
rows = G * T
DTYPES = {"f32": (jnp.float32, np.float32), "f64": (jnp.float64, np.float64)}
#: K8's shift sets (k, k1, k2) with (k1, k2) = divmod(k, L), as the
#: reference's tuples (tools/bw_probe.py:95-96): the strides of a 30^3
#: box (row rolls, max |k| = 900 <= H L = 1024) and of a 7^3 box
SHIFTS = {e: tuple((k,) + divmod(k, L)
                   for k in (e * e, e, 1, -e * e, -e, -1))
          for e in (30, 7)}


def _ref_pcopy(dtype):
    """bench.py:162-179 at PROBE_T = T, in interpret mode."""
    PROBE_T = T
    rows_probe = rows

    def _copy_kernel(src_ref, dst_ref):
        dst_ref[:] = src_ref[:]

    return pl.pallas_call(
        _copy_kernel,
        out_shape=jax.ShapeDtypeStruct((rows_probe, 128), dtype),
        in_specs=[pl.BlockSpec((PROBE_T, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((PROBE_T, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        grid=(rows_probe // PROBE_T,),
        interpret=True,
    )


def _ref_copy(dtype):
    """tools/bw_probe.py:53-59."""
    def copy_kernel(p_ref, o_ref):
        o_ref[:] = p_ref[:] * 1.0000001

    blk = pl.BlockSpec((T, L), lambda i: (i, 0), memory_space=pltpu.VMEM)
    return pl.pallas_call(
        copy_kernel, grid=(G,), in_specs=[blk], out_specs=blk,
        out_shape=jax.ShapeDtypeStruct((rows, L), dtype), interpret=True)


def _ref_win(dtype):
    """tools/bw_probe.py:69-78."""
    def win_kernel(c_ref, p_cu, p_pv, p_nx, o_ref):
        w = jnp.concatenate([p_pv[:], p_cu[:], p_nx[:]], axis=0)
        o_ref[:] = w[H:H + T] * c_ref[0, 0]

    blk = pl.BlockSpec((T, L), lambda i: (i, 0), memory_space=pltpu.VMEM)
    blkH = pl.BlockSpec((H, L), lambda i: (i, 0), memory_space=pltpu.VMEM)
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    return pl.pallas_call(
        win_kernel, grid=(G,), in_specs=[smem, blk, blkH, blkH],
        out_specs=blk,
        out_shape=jax.ShapeDtypeStruct((rows, L), dtype), interpret=True)


def _ref_roll(dtype, shifts):
    """tools/bw_probe.py:91-107, the shift tuples a parameter and the
    accumulator in ``dtype``."""
    def roll_kernel(c_ref, p_cu, p_pv, p_nx, o_ref):
        w = jnp.concatenate([p_pv[:], p_cu[:], p_nx[:]], axis=0)
        lane_iota = lax.broadcasted_iota(jnp.int32, (T + 2 * H, L), 1)
        acc = jnp.zeros((T, L), dtype)
        for k, k1, k2 in shifts:
            b = pltpu.roll(w, k2 % L, 1)
            lo = pltpu.roll(b, k1 % w.shape[0], 0)
            hi = pltpu.roll(b, (k1 + 1) % w.shape[0], 0)
            sh = jnp.where(lane_iota >= k2, lo, hi)
            acc = acc + c_ref[0, 0] * sh[H:H + T]
        o_ref[:] = acc

    blk = pl.BlockSpec((T, L), lambda i: (i, 0), memory_space=pltpu.VMEM)
    blkH = pl.BlockSpec((H, L), lambda i: (i, 0), memory_space=pltpu.VMEM)
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    return pl.pallas_call(
        roll_kernel, grid=(G,), in_specs=[smem, blk, blkH, blkH],
        out_specs=blk,
        out_shape=jax.ShapeDtypeStruct((rows, L), dtype), interpret=True)


def _inputs(npdt, seed=0):
    """x [G T, L], random nonzero halos [G H, L] and c, in ``npdt``."""
    rng = np.random.default_rng(seed)
    x = (rng.random((rows, L)) + 0.5).astype(npdt)
    pv = (rng.random((G * H, L)) + 0.5).astype(npdt)
    nx = (rng.random((G * H, L)) + 0.5).astype(npdt)
    c = npdt(rng.uniform(0.5, 2.0))
    return c, x, pv, nx


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_stream_copy_matches_pcopy(dtype):
    jdt, npdt = DTYPES[dtype]
    _, x, _, _ = _inputs(npdt)
    want = np.asarray(_ref_pcopy(jdt)(jnp.asarray(x)))
    got = pr.stream_copy(_t(x)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_scaled_copy_matches_copy(dtype):
    jdt, npdt = DTYPES[dtype]
    _, x, _, _ = _inputs(npdt)
    want = np.asarray(_ref_copy(jdt)(jnp.asarray(x)))
    got = pr.scaled_copy(_t(x)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert not np.array_equal(got, x)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_window_copy_matches_win(dtype):
    jdt, npdt = DTYPES[dtype]
    c, x, pv, nx = _inputs(npdt)
    want = np.asarray(_ref_win(jdt)(jnp.full((1, 1), c, jdt),
                                    jnp.asarray(x), jnp.asarray(pv),
                                    jnp.asarray(nx)))
    got = pr.window_copy(float(c), _t(x), _t(pv), _t(nx), G).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("edge", sorted(SHIFTS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_roll_window_matches_roll(dtype, edge):
    jdt, npdt = DTYPES[dtype]
    c, x, pv, nx = _inputs(npdt, seed=edge)
    shifts = SHIFTS[edge]
    want = np.asarray(_ref_roll(jdt, shifts)(
        jnp.full((1, 1), c, jdt), jnp.asarray(x), jnp.asarray(pv),
        jnp.asarray(nx)))
    got = pr.roll_window(float(c), _t(x), _t(pv), _t(nx), G,
                         [k for k, _, _ in shifts]).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=0,
                               rtol=1e-6 if dtype == "f32" else 1e-14)


def test_cpu_tensors_launch_nothing():
    c, x, pv, nx = _inputs(np.float64)
    before, lib = dict(pr.PROBES.launches), pr.PROBES.lib
    pr.stream_copy(_t(x))
    pr.scaled_copy(_t(x))
    pr.window_copy(float(c), _t(x), _t(pv), _t(nx), G)
    pr.roll_window(float(c), _t(x), _t(pv), _t(nx), G, (1, -1))
    assert pr.PROBES.launches == before and pr.PROBES.lib is lib


def test_roll_window_refuses_shifts_beyond_the_halo():
    c, x, pv, nx = _inputs(np.float32)
    pr.roll_window(float(c), _t(x), _t(pv), _t(nx), G, (H * L, -H * L))
    for k in (H * L + 1, -H * L - 1):
        with pytest.raises(ValueError, match="halo"):
            pr.roll_window(float(c), _t(x), _t(pv), _t(nx), G, (1, k))


def test_window_operands_are_checked():
    c, x, pv, nx = _inputs(np.float32)
    with pytest.raises(ValueError, match="blocks"):
        pr.window_copy(float(c), _t(x), _t(pv), _t(nx), 5)
    with pytest.raises(TypeError, match="dtype"):
        pr.window_copy(float(c), _t(x), _t(pv).double(), _t(nx), G)


def test_misaligned_base_pointer_is_refused():
    x = torch.zeros(129, dtype=torch.float32)
    pr.check_vector_aligned(x)
    with pytest.raises(cuda_build.KernelError, match="aligned"):
        pr.check_vector_aligned(x[1:])


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(cuda_build.KernelError, match="nvcc"):
        cuda_build.nvcc()
    with pytest.raises(cuda_build.KernelError, match="nvcc"):
        pr.ProbeKernels().load()


def test_stream_size_rule_and_box_bytes():
    assert pr.stream_elems() == 1 << 26
    assert pr.stream_elems(128 ** 3) == 1 << 26
    big = 141 ** 3 * 40
    assert pr.stream_elems(big) == (big // 128 // 4096) * 4096 * 128
    n = 128 ** 3
    assert pr.field_box_action_bytes(n, n, 6, False) == 89 * n
    assert pr.field_box_action_bytes(n, n, 6, True) == 64 * n
    tab = 6 * 128 * 8
    assert pr.box_action_bytes(n, n, 6, False, table_bytes=tab) == \
        41 * n + tab
    assert pr.box_action_bytes(n, n, 6, True, table_bytes=tab) == \
        16 * n + tab
    # K3 at a box of which a tenth is valid, one reaction on a field row
    assert pr.box_action_bytes(10 * n, 10 * n, 6, True, n_valid=n,
                               field_rows=1) == 16 * n + 80 * n


def test_measurements_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(SetupError):
        pr.stream_bandwidth()
    with pytest.raises(SetupError):
        pr.stream_bandwidth(device="cpu")
    with pytest.raises(SetupError):
        bw_probe.main([])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bw_probe_tool_on_the_cpu(dtype, capsys, monkeypatch):
    # the tool's shape cut to T = 64, H = 8 and a 30^3 box (30^2 <= H L)
    monkeypatch.setattr(bw_probe, "TILE_ROWS", 64)
    monkeypatch.setattr(bw_probe, "HALO_ROWS", 8)
    monkeypatch.setattr(bw_probe, "EDGE", 30)
    out = bw_probe.main(["--device", "cpu", "--dtype", dtype, "--tiles",
                         "4"])
    err = capsys.readouterr().err
    labels = ("torch stream", "K6 scaled_copy", "K7 window_copy",
              "K8 roll_window", "torch pad+halo")
    for label in labels:
        assert label in err
    assert sorted(out) == sorted([(lb, g) for lb in labels[:4]
                                  for g in (6, 4)] + [(labels[4], 6)])
    assert all(v > 0 for v in out.values())
    assert "not a device number" in err


def test_bw_probe_pad_halo_matches_the_reference_formula():
    E, Tt, Hh = 30, 64, 8
    xb = torch.arange(E ** 3, dtype=torch.float64).reshape(E, E, E) * 1e-6
    got = bw_probe.pad_halo(xb, 6, Tt, Hh, L)
    a3 = np.pad(xb.numpy().reshape(-1), (0, 6 * Tt * L - E ** 3)).reshape(
        6, Tt, L)
    s = a3[:-1, Tt - Hh:].sum() + a3[1:, :Hh].sum()
    want = (xb.numpy() + s) * 0.9999
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)

