"""The control: the plain reference computed in float32, put in the
program's place, fails the comparison, while the program's float64 solve
of the same request passes it.  On the host at a size a test run holds:
hog1p_5d to t = 5, where float32's drift (1.3e-5 at t = 2) already
passes the limits.  ``test_fspbench_cuda.py`` holds every cell at its
own size on the card, and ``fspbench/control.py`` makes the readings that
set the limits."""
from fspbench import control


def test_control_fails_and_the_program_passes():
    got = control.readings("hog1p_5d.fit", 2**31 + 11, "cpu", 5.0)
    lim = got["limits"]
    assert all(got["sound"][k] <= v for k, v in lim.items()), got["sound"]
    assert any(got["control"][k] > v for k, v in lim.items()), \
        got["control"]
