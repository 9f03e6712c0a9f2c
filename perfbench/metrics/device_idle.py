"""Device: the share of the traced window in which no kernel, copy or
memset ran on any stream."""
from perfbench import devtrace


def read(r):
    if r.device is None:
        return None
    busy = devtrace.busy_ns(r.device.ops, r.t0_ns, r.t1_ns)
    return 100.0 * (1.0 - busy / (r.t1_ns - r.t0_ns))
