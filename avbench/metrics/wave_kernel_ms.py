"""wave_kernel_ms (ms/frame; kernels): the device time of the wave
kernels (kernels.json family "wave": rav1d_wave_frame's kernel) in the
window, per picture."""

from avbench.metrics._common import device


def read(run):
    d = device(run)
    if d is None or not d["by_family"].get("wave"):
        return None
    return 1e3 * d["by_family"]["wave"] / run.window.pictures
