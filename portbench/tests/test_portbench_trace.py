"""The traced run's reading on a hand-made trace: copies count as device
operations in ``busy_s`` but leave the device idle in the idle share and
its gaps; device time is charged to the span that launched it."""

from torch.autograd import DeviceType

from portbench.trace import TraceView


class Ev:
    def __init__(self, name, start, dur, device, corr=0):
        self._n, self._s, self._d, self._dev, self._c = name, start, dur, device, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._c


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def view():
    # A 100 ns window: an upload (copy) over 10-50, a kernel over 50-70 and a
    # set over 80-90; the copy launched in span "request", the kernel in "unet".
    return TraceView([
        Ev("pb.window", 0, 100, CPU),
        Ev("pb.request", 5, 60, CPU),
        Ev("pb.unet", 40, 10, CPU),
        Ev("cudaMemcpyAsync", 8, 1, CPU, corr=1),
        Ev("cudaLaunchKernel", 45, 1, CPU, corr=2),
        Ev("cudaMemsetAsync", 75, 1, CPU, corr=3),
        Ev("Memcpy HtoD (Pageable -> Device)", 10, 40, CUDA, corr=1),
        Ev("conv_kernel", 50, 20, CUDA, corr=2),
        Ev("Memset (Device)", 80, 10, CUDA, corr=3),
    ])


def test_busy_counts_every_operation_and_idle_only_kernels():
    v = view()
    assert v.window_s == 100e-9
    assert abs(v.busy_s - 70e-9) < 1e-18
    assert abs(v.kernel_busy_s - 20e-9) < 1e-18
    assert abs(v.idle_share() - 0.8) < 1e-12
    assert v.idle_gaps() == [(0, 50), (70, 100)]


def test_device_time_by_launching_span():
    v = view()
    assert v.device_ns_launched_in("request") == 60
    assert v.device_ns_launched_in("request", kernels_only=True) == 20
    assert v.device_ns_launched_in("unet") == 20


def test_breakdown_lists_copies_and_labels_gaps():
    b = view().breakdown()
    assert [n for n, _ in b["device_ops"]][0] == "Memcpy HtoD (Pageable -> Device)"
    assert b["idle_gaps"][0] == ["request", 50e-9]
