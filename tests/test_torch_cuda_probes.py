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
