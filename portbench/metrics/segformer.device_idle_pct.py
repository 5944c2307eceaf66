"""Share of the SegFormer cell's traced window in which no kernel ran on
the device (copies and sets leave it idle: ``TraceView.idle_share``)."""


def read(bundle):
    trace = bundle["trace"]
    return 100.0 * trace.idle_share() if trace.kernel_busy_s > 0 else None
