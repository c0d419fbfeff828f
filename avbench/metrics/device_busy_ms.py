"""device_busy_ms (ms/frame; device programs): the union of the device's
kernel, copy and fill time in the window (torch.profiler), per
picture."""

from avbench.metrics._common import device


def read(run):
    d = device(run)
    return None if d is None else 1e3 * d["busy_s"] / run.window.pictures
