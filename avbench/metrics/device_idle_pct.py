"""device_idle_pct (%; device): 100 x (1 - the device's busy union over
the traced window)."""

from avbench.metrics._common import device


def read(run):
    d = device(run)
    return None if d is None else 100.0 * (1.0 - d["busy_s"] / d["window_s"])
