"""Helpers of the metric readers."""


def span_ms_per_picture(run, name):
    """A host span's total over the window (spans.py), ms per picture;
    None without a trace or without the span."""
    t = run.tracer
    if t is None or name not in t.totals or not run.window.pictures:
        return None
    return 1e3 * t.totals[name] / run.window.pictures


def stage_ms_per_picture(run, name):
    """A stage of the port's own stage_ms (engine/run.py), accumulated
    over the window, per picture."""
    if not run.window.pictures or run.tracer is None:
        return None
    return run.stage[name] / run.window.pictures


def device(run):
    """The device readings (trace.py reduce), or None."""
    return run.device if run.window.pictures else None
