"""Device: the device's idle time inside the layer loop's own host phases
(``attn_route``, ``probe``, ``execute``, ``post_fetch`` and, with
prefetch, ``prefetch``; not ``picks``, where the host waits on the
device) a decode step, mean over the window's steps."""
from perfbench import devtrace
from perfbench.metrics._phases import inside, overlap_ns

HOST = ("attn_route", "probe", "execute", "post_fetch", "prefetch")


def read(r):
    if r.device is None:
        return None
    steps = r.spans("engine", "dispatch")
    host = sorted(s for name in HOST
                  for s in inside(steps, r.spans("engine", name)))
    if not host:
        return None
    idle = devtrace.idle_intervals(r.device.ops, r.t0_ns, r.t1_ns)
    return overlap_ns(idle, host) / len(steps) / 1e6
