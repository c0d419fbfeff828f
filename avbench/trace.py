"""The device's side of a traced run: torch.profiler over the window,
reduced to device busy time, time by kernel family, the operations that
took most time, and the device's idle time labelled with the host span
that was open.

The profiler's clock is tied to the host clock by one marker
(`record_function("avbench.mark")`) whose host time the harness takes as
it is recorded.
"""

from __future__ import annotations

# the label an idle moment takes: the first of these spans open then (on
# any thread), else "harness" (the caller between decoder calls)
PRIORITY = ("gc", "grain", "upload", "pack", "plan", "syntax", "execute",
            "get_picture", "send_data")
MARK = "avbench.mark"


class DeviceTrace:
    """torch.profiler around the window (CPU and CUDA activities)."""

    def __init__(self):
        self.prof = None
        self.host_mark = None

    @staticmethod
    def warm():
        """One short session in set-up, so that the profiler's own start
        (CUPTI) is not paid inside the window."""
        import torch

        with torch.profiler.profile(activities=_activities()):
            torch.zeros(1024, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self, clock):
        import torch

        self.prof = torch.profiler.profile(activities=_activities())
        self.prof.__enter__()
        a = clock()
        with torch.profiler.record_function(MARK):
            pass
        self.host_mark = (a + clock()) / 2

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def device_ops(self):
        """[(name, start, end)] of every device operation, on the host
        clock (seconds)."""
        raw = _raw_events(self.prof)
        mark = [s for name, dev, s, e in raw if not dev and name == MARK]
        if not mark:
            raise RuntimeError("the profiler's trace lacks its marker")
        off = self.host_mark - mark[0] * 1e-9
        return [(name, s * 1e-9 + off, e * 1e-9 + off)
                for name, dev, s, e in raw if dev]


def _activities():
    import torch

    return [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]


def _raw_events(prof):
    """(name, on_device, start_ns, end_ns) of each event of the trace."""
    from torch.autograd import DeviceType

    res = prof.profiler.kineto_results
    out = []
    for ev in res.events():
        dev = ev.device_type() == DeviceType.CUDA
        out.append((ev.name(), dev, ev.start_ns(), ev.end_ns()))
    return out


def union(intervals, lo, hi):
    """The merged intervals of [(start, end)], clipped to [lo, hi]."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_by_label(busy, spans, lo, hi):
    """Seconds of [lo, hi] outside `busy` (merged intervals), by the
    label of the host span open then (PRIORITY)."""
    rank = {name: i for i, name in enumerate(PRIORITY)}
    ev = []
    for name, s, e in spans:
        if name in rank and e > lo and s < hi:
            ev.append((max(s, lo), 1, rank[name]))
            ev.append((min(e, hi), -1, rank[name]))
    for s, e in busy:
        ev.append((s, 2, None))
        ev.append((e, -2, None))
    ev.append((lo, 0, None))
    ev.append((hi, 0, None))
    ev.sort(key=lambda x: x[0])
    open_n = [0] * len(PRIORITY)
    busy_n = 0
    out = {}
    prev = lo
    for t, kind, r in ev:
        if t > prev and busy_n == 0:
            label = next((PRIORITY[i] for i, n in enumerate(open_n) if n),
                         "harness")
            out[label] = out.get(label, 0.0) + (t - prev)
        prev = max(prev, t)
        if kind == 1:
            open_n[r] += 1
        elif kind == -1:
            open_n[r] -= 1
        elif kind == 2:
            busy_n += 1
        elif kind == -2:
            busy_n -= 1
    return out


def reduce(ops, spans, kernels, lo, hi):
    """The device readings of the window [lo, hi] from `ops` (device
    operations on the host clock), `spans` (Tracer.spans plus the
    caller's) and `kernels` (roofline.Kernels)."""
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in ops
              if e > lo and s < hi]
    busy = union([(s, e) for _, s, e in inside], lo, hi)
    # kernels that start in the window, whole: every kernel of a picture
    # handed out in it, and perhaps some of the frames still in flight
    kernel_s = sum(e - s for n, s, e in ops
                   if lo <= s < hi and kernels.family(n) != "copy")
    by_name, by_family = {}, {}
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
        fam = kernels.family(n)
        by_family[fam] = by_family.get(fam, 0.0) + (e - s)
    return {
        "busy_s": sum(e - s for s, e in busy),
        "window_s": hi - lo,
        "ops": len(inside),
        "kernel_s": kernel_s,
        "by_name": by_name,
        "by_family": by_family,
        "idle": idle_by_label(busy, spans, lo, hi),
    }
