"""grain_ms (ms per grained picture; grain): engine/grain.py apply on the
host clock, over the pictures it grained in the window."""


def read(run):
    t = run.tracer
    if t is None or not t.counts.get("grain"):
        return None
    return 1e3 * t.totals["grain"] / t.counts["grain"]
