"""The probe kernels (K5-K8, ``csrc/probes.cu``) against their plain
PyTorch versions on a card.

This file imports no JAX, so it also runs on a GPU host without the
reference package (see README: ``pytest --noconftest -m cuda``).  Each
kernel's output must equal its plain version's bitwise, in float32 and
float64, at a size that divides into 16-byte vectors and at an odd size
that leaves a scalar tail; two launches must agree bitwise.  K7 and K8
get random nonzero halos."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pacmensl_tpu_torch.ops import probes as pr  # noqa: E402
from pacmensl_tpu_torch.ops.cuda_build import KernelError  # noqa: E402

pytestmark = pytest.mark.cuda

#: (G, T, H, L, edge of the box whose strides K8 shifts by)
SIZES = {"even": (3, 64, 8, 128, 30), "odd": (3, 37, 5, 33, 7)}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(size, dtype, dev, seed=0):
    G, T, H, L, E = SIZES[size]
    rng = np.random.default_rng(seed)

    def rand(rows):
        return torch.as_tensor(rng.random((rows, L)) + 0.5, dtype=dtype,
                               device=dev)
    return dict(c=float(rng.uniform(0.5, 2.0)), x=rand(G * T),
                prev=rand(G * H), next_=rand(G * H), tiles=G,
                shifts=(E * E, E, 1, -E * E, -E, -1))


def _call(name, plain, a):
    fn = getattr(pr, name + ("_reference" if plain else ""))
    if name in ("stream_copy", "scaled_copy"):
        return fn(a["x"])
    if name == "window_copy":
        return fn(a["c"], a["x"], a["prev"], a["next_"], a["tiles"])
    return fn(a["c"], a["x"], a["prev"], a["next_"], a["tiles"],
              a["shifts"])


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", pr.NAMES)
def test_kernel_is_bitwise_its_plain_version(name, dtype, size):
    dev = _dev()
    a = _inputs(size, DTYPES[dtype], dev)
    n0 = pr.PROBES.launches[name]
    got = _call(name, False, a)
    again = _call(name, False, a)
    want = _call(name, True, a)
    torch.cuda.synchronize()
    assert pr.PROBES.launches[name] == n0 + 2
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(got, again)


#: K8's staged reads: (G, T, H, L) whose T L is no multiple of the span
#: a block stages (4,096 float32 or 2,048 float64 outputs, or a quarter of
#: that), with a halo wide enough for shifts in up to eight groups (the
#: kernel groups shifts within 1,024 elements of each other), and shifts
#: in the caller's order: five groups, where the spans of four vectors a
#: thread fit shared memory, and eight, where they do not
ROLL_SIZE = (2, 37, 80, 64)
ROLL_SHIFTS = {"five groups": (2560, -1, 64, -2560, 1300, 0, -64, -1301),
               "eight groups": (4400, -1100, 2200, -3300, 1100, -4400,
                                3300, -2200)}


def _offset(rows, L, dtype, dev, offset, fill=None):
    """A [rows, L] tensor that starts ``offset`` elements into its buffer
    (not 16-byte aligned where offset is odd)."""
    buf = torch.empty(rows * L + offset, dtype=dtype, device=dev)
    t = buf[offset:].view(rows, L)
    if fill is not None:
        t.copy_(fill)
    return t


@pytest.mark.parametrize("groups", sorted(ROLL_SHIFTS))
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("nshifts", range(1, 9))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_roll_window_staged_reads_are_bitwise(dtype, nshifts, offset,
                                              groups):
    """K8 on windows whose outputs are no multiple of the staged span,
    whose x, prev, next and out start off a 16-byte boundary (offset
    elements into their buffers, each by another amount), with 1 to 8
    shifts, some in groups of their own: bitwise its plain version."""
    dev = _dev()
    dt = DTYPES[dtype]
    G, T, H, L = ROLL_SIZE
    rng = np.random.default_rng(nshifts + 10 * offset)

    def rand(rows, off):
        return _offset(rows, L, dt, dev, off, torch.as_tensor(
            rng.random((rows, L)) + 0.5, dtype=dt))
    x, prev = rand(G * T, offset), rand(G * H, 2 * offset)
    nxt = rand(G * H, 3 * offset)
    out = _offset(G * T, L, dt, dev, offset + 1)
    c = float(rng.uniform(0.5, 2.0))
    ks = ROLL_SHIFTS[groups][:nshifts]
    got = pr.roll_window(c, x, prev, nxt, G, ks, out=out)
    want = pr.roll_window_reference(c, x, prev, nxt, G, ks)
    torch.cuda.synchronize()
    assert got is out
    assert torch.equal(got, want), float((got - want).abs().max())


def test_misaligned_base_pointer_raises():
    dev = _dev()
    x = torch.zeros(129, dtype=torch.float32, device=dev)[1:]
    for fn in (pr.stream_copy, pr.scaled_copy):
        with pytest.raises(KernelError, match="aligned"):
            fn(x)
    hv = torch.zeros((2, 128), dtype=torch.float32, device=dev)
    with pytest.raises(KernelError, match="aligned"):
        pr.window_copy(1.0, x.view(1, 128), hv, hv, 1)


def test_shift_beyond_the_halo_raises():
    dev = _dev()
    a = _inputs("even", torch.float32, dev)
    G, T, H, L, _ = SIZES["even"]
    with pytest.raises(ValueError, match="halo"):
        pr.roll_window(a["c"], a["x"], a["prev"], a["next_"], G,
                       (H * L + 1,))


def test_stream_bandwidth_times_the_copy_kernel():
    _dev()
    n0 = pr.PROBES.launches["stream_copy"]
    bw = pr.stream_bandwidth(reps=10)
    assert math.isfinite(bw) and bw > 0
    assert pr.PROBES.launches["stream_copy"] == n0 + 16
