"""The trace reduction on a synthetic trace: the device's busy union, the
device time launched inside operator actions, and the idle gaps labelled
with the innermost host span."""
from fspbench.lib import trace


class Ev:
    def __init__(self, name, start, dur, device=False, corr=0):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._c = device, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def correlation_id(self):
        return self._c


def test_reduce():
    evs = [
        Ev("fspbench.window", 0, 1000),
        Ev("fspbench.solve", 0, 1000),
        Ev("phase.StatePartitioning", 100, 200),
        Ev("fspbench.action", 400, 50),
        Ev("cudaLaunchKernel", 410, 5, corr=7),
        Ev("cudaLaunchKernel", 600, 5, corr=8),
        Ev("cudaLaunchKernel", 620, 5, corr=9),
        Ev("box_action_kernel", 420, 100, device=True, corr=7),
        Ev("fspbench.action", 420, 100, device=True),  # device annotation
        Ev("elementwise", 610, 40, device=True, corr=8),
        Ev("elementwise", 630, 40, device=True, corr=9),
    ]
    t = trace.reduce(evs)
    assert t.window_s == 1e-6
    assert t.busy_s == (100 + 60) / 1e9
    assert t.action_device_s == 100 / 1e9
    assert dict(t.device_ops) == {"box_action_kernel": 1e-7,
                                  "elementwise": 8e-8}
    # gaps [0, 420) (middle 210: in the partitioning phase), [520, 610)
    # and [670, 1000) (in the solve span only)
    assert dict(t.idle_gaps) == {"phase.StatePartitioning": 4.2e-7,
                                 "fspbench.solve": (90 + 330) / 1e9}


def test_reduce_without_device_operations():
    assert trace.reduce([Ev("fspbench.window", 0, 10)]) is None
