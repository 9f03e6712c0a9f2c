"""Engine: the ``picks`` spans a decode step (each layer's blocking
device->host read of its top-k, where the host waits for the device's
queue to drain), mean over the window's steps."""
from perfbench.metrics._phases import step_ms


def read(r):
    return step_ms(r, "picks")
