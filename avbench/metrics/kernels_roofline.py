"""kernels_roofline (%; kernels): the least time the window's device work
needs over the kernels' summed device time. The least time is the bytes
that roofline.py counts from the geometry and headers of the pictures
handed out in the window, over the published memory bandwidth
(peaks.json). The time is every kernel that started in the window, whole
(copies and fills left out), which holds at least all the kernels of
those pictures, so the share is never above the true one."""

from avbench.metrics._common import device


def read(run):
    d = device(run)
    t = run.tracer
    if d is None or t is None or not run.peak_bytes_per_s or not d["kernel_s"]:
        return None
    nbytes = sum(t.bytes_by_unit.get(u, 0) for u in run.window.digests)
    if not nbytes:
        return None
    return 100.0 * nbytes / run.peak_bytes_per_s / d["kernel_s"]
